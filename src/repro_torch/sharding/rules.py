"""Logical-axis -> mesh-axis sharding rules, the twin of
``repro/sharding/rules.py`` over a ``torch.distributed`` ``DeviceMesh``.

Every parameter / activation axis carries a *logical name*; a rules table
maps logical names to mesh axes.  ``spec`` resolves a tuple of logical
names into a ``PartitionSpec`` exactly as the reference does: a mesh axis
is used once (first come, first served), axes the mesh lacks are dropped,
and a dimension that a mapping does not divide falls back to the axis's
``fallback`` entry, then to replication.  ``spec`` reads only
``mesh.shape``, a mapping from axis name to size, so a stand-in mesh of
any size resolves specs on one process.

``PartitionSpec`` here is a tuple with trailing ``None``s trimmed, equal
element by element to the reference's.  ``placements`` turns one into
DTensor placements over a ``DeviceMesh``; ``NamedSharding`` gives each
rank's box of an array (``devices_indices_map``), which is what
``core/plan.py``'s ``mesh_part_bounds`` reads.

Rule sets:
  TP_RULES        -- tensor parallelism: heads / ff / experts / vocab over
                     "model", batch over ("pod", "data").
  FSDP_RULES      -- TP + the param embed axis over ("pod", "data").
  SEQ_RULES       -- TP + sequence parallelism on activations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Mesh axes per array dimension (None: not split; a tuple: split over
    several mesh axes, major first); trailing ``None``s are dropped."""

    def __new__(cls, *parts: MeshAxes):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    """Immutable mapping logical axis name -> mesh axes (+ fallbacks)."""

    table: Tuple[Tuple[str, MeshAxes], ...]
    fallbacks: Tuple[Tuple[str, MeshAxes], ...] = ()

    def lookup(self, name: str) -> MeshAxes:
        for k, v in self.table:
            if k == name:
                return v
        return None

    def fallback(self, name: str) -> MeshAxes:
        for k, v in self.fallbacks:
            if k == name:
                return v
        return None

    def with_rule(self, name: str, axes: MeshAxes) -> "Rules":
        table = tuple((k, v) for k, v in self.table if k != name)
        return dataclasses.replace(self, table=table + ((name, axes),))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (its dim names and sizes) or
    of any object with a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and hasattr(mesh, "mesh"):
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _as_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axes_size(shape: Dict[str, int], axes: MeshAxes) -> int:
    return math.prod(shape[a] for a in _as_tuple(axes))


def spec(logical_axes: Sequence[Optional[str]], rules: Rules, mesh=None,
         dims: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec.

    With ``mesh`` and ``dims`` a mapping is taken only where the dimension
    divides evenly; a non-dividing dimension falls back (then replicates).
    A mesh axis is never used twice (first come, first served)."""
    shape = None if mesh is None else mesh_shape(mesh)
    out = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        cand = None if name is None else rules.lookup(name)
        for attempt in (cand, None if name is None else rules.fallback(name),
                        None):
            if attempt is None:
                chosen = None
                break
            ax = _as_tuple(attempt)
            if shape is not None:
                # drop axes the mesh lacks (e.g. "pod" on a single pod)
                ax = tuple(a for a in ax if a in shape)
                if not ax:
                    chosen = None
                    break
            if any(a in used for a in ax):
                continue
            if shape is not None and dims is not None \
                    and dims[i] % _axes_size(shape, ax) != 0:
                continue
            chosen = ax[0] if len(ax) == 1 else ax
            break
        used.update(_as_tuple(chosen))
        out.append(chosen)
    return PartitionSpec(*out)


# --------------------------------------------------------------------------
# specs on a DeviceMesh
# --------------------------------------------------------------------------
def placements(pspec: Sequence[MeshAxes], device_mesh) -> tuple:
    """DTensor placements of ``pspec`` on ``device_mesh``: for each mesh
    dimension ``Shard(d)`` where array dim d is split over it, else
    ``Replicate()``.  A dim split over several mesh axes is not a DTensor
    layout (it shards one dim over two mesh dims) and raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(pspec):
        axes = _as_tuple(axes)
        if len(axes) > 1:
            raise ValueError(f"dim {d} split over {axes}: one mesh axis a "
                             f"dim for a DTensor")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


class NamedSharding:
    """A ``PartitionSpec`` on a mesh: which box of an array each rank
    holds.  ``mesh`` is a ``DeviceMesh`` (or None: one device holding the
    whole array)."""

    def __init__(self, mesh, pspec: Sequence[MeshAxes] = ()):
        self.mesh = mesh
        self.spec = PartitionSpec(*pspec)

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[int, Tuple[slice, ...]]:
        """rank -> its box of an array of ``shape``, one slice a dim.
        Dim d of ``spec`` split over mesh axes (a0, a1, ...) is cut into
        their product of even blocks, a0 major; every split must divide
        the dim, as the reference's shardings demand."""
        shape = tuple(int(s) for s in shape)
        if self.mesh is None:
            return {0: tuple(slice(0, s) for s in shape)}
        names = list(self.mesh.mesh_dim_names)
        ranks = self.mesh.mesh
        sizes = dict(zip(names, ranks.shape))
        out = {}
        for coord in torch.cartesian_prod(
                *[torch.arange(n) for n in ranks.shape]).reshape(
                    -1, ranks.dim()).tolist():
            at = dict(zip(names, coord))
            box = []
            for d, s in enumerate(shape):
                axes = _as_tuple(self.spec[d]) if d < len(self.spec) else ()
                parts, idx = 1, 0
                for a in axes:
                    parts, idx = parts * sizes[a], idx * sizes[a] + at[a]
                if s % parts:
                    raise ValueError(f"dim {d} of {shape} does not split "
                                     f"evenly over {axes} ({parts} parts)")
                step = s // parts
                box.append(slice(idx * step, (idx + 1) * step))
            out[int(ranks[tuple(coord)])] = tuple(box)
        return out


# --------------------------------------------------------------------------
# activation sharding constraints
# --------------------------------------------------------------------------
_ACTIVE: list = []   # stack of (mesh, rules); empty -> constraints are no-ops


class use_rules:
    """Context manager activating (mesh, rules) for ``constrain`` calls."""

    def __init__(self, mesh, rules: Rules):
        self.pair = (mesh, rules)

    def __enter__(self):
        _ACTIVE.append(self.pair)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def active_rules():
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x, *logical_axes: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names: a
    ``DTensor`` is redistributed to the resolved placements on the active
    mesh; a plain tensor, or no active mesh, is left as it is."""
    if not _ACTIVE:
        return x
    mesh, rules = _ACTIVE[-1]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    s = spec(logical_axes, rules, mesh, x.shape)
    return x.redistribute(mesh, placements(s, mesh))


# --------------------------------------------------------------------------
# canonical rule sets
# --------------------------------------------------------------------------
_COMMON = (
    # activations
    ("batch", ("pod", "data")),
    ("seq", None),
    ("act_embed", None),
    ("act_heads", "model"),
    ("act_kv_heads", "model"),
    ("act_ff", "model"),
    ("act_experts", "model"),
    ("act_vocab", "model"),
    ("act_rnn", "model"),
    ("kv_seq", None),
    # params
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("ff", "model"),
    ("experts", "model"),
    ("expert_ff", None),
    ("vocab", "model"),
    ("rnn", "model"),
    ("conv", None),
    ("layers", None),
    ("stack", None),
)

TP_RULES = Rules(table=_COMMON,
                 fallbacks=(("act_kv_heads", None), ("kv_seq", "model")))

FSDP_RULES = Rules(
    table=tuple((k, v) for k, v in _COMMON if k != "embed")
    + (("embed", ("pod", "data")),),
    fallbacks=(("act_kv_heads", None), ("kv_seq", "model")),
)

SEQ_RULES = Rules(
    table=tuple((k, v) for k, v in _COMMON if k != "seq")
    + (("seq", "model"),),
    fallbacks=(("act_kv_heads", None), ("kv_seq", "model")),
)


def get_rules(name: str) -> Rules:
    return {"tp": TP_RULES, "fsdp": FSDP_RULES, "seq": SEQ_RULES}[name]
