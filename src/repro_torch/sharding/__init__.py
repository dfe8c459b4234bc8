"""Sharding over a ``torch.distributed`` ``DeviceMesh``: logical-axis
rules (``rules.py``, the twin of ``repro/sharding``) and the process world
and its meshes (``mesh.py``)."""
from .mesh import init_world, make_mesh, make_tp_mesh
from .rules import (FSDP_RULES, SEQ_RULES, TP_RULES, NamedSharding, P,
                    PartitionSpec, Rules, active_rules, constrain, get_rules,
                    placements, spec, use_rules)

__all__ = ["Rules", "TP_RULES", "FSDP_RULES", "SEQ_RULES", "spec",
           "constrain", "use_rules", "active_rules",
           "get_rules", "PartitionSpec", "P", "NamedSharding", "placements",
           "init_world", "make_mesh", "make_tp_mesh"]
