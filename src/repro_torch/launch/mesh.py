"""The production mesh and the hardware model of the report, the twin of
``repro/launch/mesh.py``.

``production_mesh(multi_pod)`` is a stand-in of the production mesh: its
``shape`` is all that ``sharding.spec`` reads, so specs and per-device
bytes at 256 or 512 devices resolve on one process, and no device state
is touched.

  single-pod:  {"data": 16, "model": 16}              = 256 devices
  multi-pod:   {"pod": 2, "data": 16, "model": 16}    = 512 devices

The hardware model is one NVIDIA H100 SXM from NVIDIA's data sheet
(dense rates without sparsity, at its 700 W power limit).
"""
from __future__ import annotations

import math
import types
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 FLOP/s (tensor cores, dense)
HBM_BW = 3.35e12             # bytes/s of HBM3
LINK_BW = 450e9              # bytes/s of NVLink, one way
# bytes of device memory: the capacity an H100 80GB HBM3 reports (85.0 GB;
# ``report --measure`` reads the card's own)
HBM_BYTES = 85.0e9


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def production_mesh(multi_pod: bool = False, shape: Dict[str, int] = None):
    """A stand-in mesh: an object whose ``shape`` maps axis name to size
    (``shape`` overrides the production one, e.g. {"data": 1, "model": 1})
    and whose ``size`` is the device count."""
    shape = dict(shape or production_mesh_shape(multi_pod))
    return types.SimpleNamespace(shape=shape, size=math.prod(shape.values()))
