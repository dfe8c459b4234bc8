"""The twin of ``tests/test_elastic_mesh_devices.py`` over a real process
world: 8 CPU processes in a gloo world (``torch_dp_workers.py``).

* A tree of DTensors sharded ``Shard(0)`` over a 4-rank mesh (f32 and a
  bfloat16 leaf) is committed as 4 parts: the snapshot bridge gathers each
  rank's distinct shard to rank 0.  It is then redistributed through the
  agents onto an 8-rank mesh and onto a 2-rank mesh, rank 0 sending each
  rank its box: every rank's shard is bit-equal to its box of the
  original.
* ``constrain`` redistributes a replicated DTensor to the placements its
  logical axes resolve to on a (2, 4) mesh.
* The port's ``NamedSharding.devices_indices_map`` gives every rank the
  box JAX's ``NamedSharding`` gives the device of the same index, on
  meshes (4,), (8,) and (2, 4), with specs ``P("data")``,
  ``P("data", "model")`` and ``P(("pod", "data"))``.  JAX runs in a
  subprocess with 8 forced host devices.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch_dp_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

JAX_BOXES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

out = []
for shape, names, spec in json.loads(sys.argv[1]):
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(names))
    spec = P(*[tuple(s) if isinstance(s, list) else s for s in spec])
    for arr_shape in ((64, 32), (16, 8, 4)):
        m = NamedSharding(mesh, spec).devices_indices_map(arr_shape)
        boxes = {}
        for dev, idx in m.items():
            boxes[dev.id] = [[0 if s.start is None else s.start,
                              d if s.stop is None else s.stop]
                             for s, d in zip(idx, arr_shape)]
        out.append([shape, names, arr_shape, boxes])
print("BOXES" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    return workers.spawn_world(workers.mesh_redistribution, 8,
                               tmp_path_factory.mktemp("mesh"))


def test_sharded_tree_commits_as_its_distinct_shards(report):
    assert report["parts"] == {"w": 4, "b": 4, "h": 4}


@pytest.mark.parametrize("new_n", [8, 2])
def test_redistribution_across_rank_counts_is_bit_equal(report, new_n):
    assert all(report["moved"][(new_n, name)] == new_n
               for name in ("w", "b", "h"))
    assert report[f"bit_equal_{new_n}"]


def test_constrain_redistributes_a_dtensor(report):
    """Under ``use_rules(mesh, TP_RULES)`` on a (2, 4) (data, model) mesh,
    ``constrain(x, "batch", "act_ff")`` shards a replicated DTensor's
    rows over "data" and its columns over "model": each rank keeps its
    ``NamedSharding(mesh, P("data", "model"))`` box."""
    placements, boxes_equal = report["constrain"]
    assert placements == ["S(0)", "S(1)"] and boxes_equal


def test_devices_indices_map_matches_jax(report):
    specs = sorted({(shape, names, spec)
                    for shape, names, spec, _ in report["boxes"]})
    arg = json.dumps([[list(s), list(n),
                       [list(a) if isinstance(a, tuple) else a for a in sp]]
                      for s, n, sp in specs])
    proc = subprocess.run([sys.executable, "-c", JAX_BOXES, arg],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    line = [x for x in proc.stdout.splitlines() if x.startswith("BOXES")]
    assert line, proc.stdout + proc.stderr
    jax_boxes = {}
    for shape, names, arr_shape, boxes in json.loads(line[0][5:]):
        jax_boxes[(tuple(shape), tuple(names), tuple(arr_shape))] = {
            int(d): tuple(tuple(b) for b in box) for d, box in boxes.items()}
    assert len(jax_boxes) == len(report["boxes"]) == 8
    for (shape, names, _, arr_shape), mine in report["boxes"].items():
        assert mine == jax_boxes[(shape, names, arr_shape)], (shape, names)
