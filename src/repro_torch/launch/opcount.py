"""Op counting of one step: FLOPs, bytes, collectives and peak live bytes,
the counterpart of ``repro/launch/hlo.py``.

There is no HLO here.  ``OpCounter`` is a ``TorchDispatchMode``: it sees
every aten op a step runs, on any device (``meta`` included), the
backward and ``torch.utils.checkpoint``'s recompute among them, and the
``c10d`` collectives.  The hand-written kernels (K4, K6, K7) run outside
aten: their wrappers report each call's work to ``kernels.common``'s
``cost_sinks``, launched on the card or traced on ``meta`` alike, and the
counter adds it.

Cost model per op (per device: the process's own step):
  flops:  matrix products, 2 * M * N * K (``mm``, ``addmm``, ``bmm``,
          ``baddbmm``, ``mv``, ``dot``); the kernels' recorded FLOPs
  bytes:  operands + result, except
            views and metadata ops, allocations  -> 0
            gather / index / embedding          -> result + indices
            in-place scatter / index_put_       -> 2x update + indices
            out-of-place scatter                -> result + 2x update
                                                   + indices
            copy_ (into a slice, say)           -> 2x update
          and the kernels' recorded bytes
  collective link-bytes (ring model on k ranks), N the result's bytes:
            all-reduce 2N(k-1)/k; all-gather / reduce-scatter / all-to-all
            N(k-1)/k; send / recv N; broadcast N
  peak live bytes: the storages alive at once, the step's inputs (which
          ``track`` registers, or which the counter meets as operands)
          included; a storage counts from the op that makes it until it
          is freed.
  inputs read (``was_read``, what a compiled step's arguments keep): a
          storage that an op or a kernel (the tensors its wrapper
          reports) takes as an operand before any op overwrites it
          whole; a view reads nothing.

``top_ops`` is the twin of ``top_instructions``, ``roofline_terms`` a
copy of the reference's.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import common

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# c10d op -> (collective kind, index of its output argument: the tensors
# whose bytes are N)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
    "broadcast_": ("broadcast", 0),
}
_RING = {"all-reduce": lambda k: 2 * (k - 1) / k,
         "all-gather": lambda k: (k - 1) / k,
         "reduce-scatter": lambda k: (k - 1) / k,
         "all-to-all": lambda k: (k - 1) / k,
         "collective-permute": lambda k: 1.0,
         "broadcast": lambda k: 1.0}

# matrix products: the argument whose last dim is the contracted K
_MATMUL_K_ARG = {"mm": 0, "bmm": 0, "mv": 0, "addmm": 1, "baddbmm": 1,
                 "addmv": 1, "addbmm": 1}
# ops that move no bytes: allocations and metadata; views are found by
# their schema (an aliased, unwritten result)
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
             "alias", "_local_scalar_dense", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "is_same_size",
             "record_stream", "resize_", "set_"}
_GATHER = {"index", "gather", "index_select", "embedding", "take"}
_SCATTER_INPLACE = {"index_put_", "scatter_", "scatter_add_",
                    "scatter_reduce_", "index_add_", "index_copy_",
                    "masked_scatter_", "_index_put_impl_"}
_SCATTER = {"index_put", "scatter", "scatter_add", "scatter_reduce",
            "index_add", "index_copy", "slice_scatter", "select_scatter",
            "masked_scatter", "embedding_dense_backward"}


# ops that overwrite their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}


def _whole(t: torch.Tensor) -> bool:
    """Whether ``t`` spans its whole storage, densely."""
    return t.is_contiguous() and t.storage_offset() == 0 and \
        t.numel() * t.element_size() == t.untyped_storage().nbytes()


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's distinct elements: a broadcast (stride-0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of a (nested list / tuple) argument, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


_FUNCS: Dict[Any, Tuple[str, str, bool]] = {}


def _info(func) -> Tuple[str, str, bool, bool]:
    """(op name, full name, whether the op moves no bytes, whether it is
    a view) of an aten or c10d op: an allocation, a metadata op or a view
    (its results aliased, not written) moves none."""
    info = _FUNCS.get(func)
    if info is None:
        name = func.overloadpacket.__name__
        rets = func._schema.returns
        view = bool(rets) and all(r.alias_info is not None
                                  and not r.alias_info.is_write
                                  for r in rets)
        info = _FUNCS[func] = (name, str(func), view or name in _NO_BYTES,
                               view)
    return info


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments (2, as
    the reference assumes, when none is found)."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("ProcessGroup"):
            from torch._C._distributed_c10d import ProcessGroup
            return ProcessGroup.unbox(a).size()
    return 2


class OpCounter(TorchDispatchMode):
    """Counts the ops run while it is active (``with OpCounter() as c:``);
    ``c.result()`` gives the totals.  ``track(*trees)`` registers tensors
    alive before the step (parameters, optimizer state, caches), whose
    storages count toward the live bytes until they are freed."""

    def __init__(self):
        super().__init__()
        # reentrant: a storage freed (and its finalizer run) while the
        # lock is held in the same thread takes it again
        self._lock = threading.RLock()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        # (op name, operand shapes) -> [calls, flops, bytes]
        self.by_op: Dict[Tuple, List[float]] = {}
        # kernel name -> {"calls", "flops", "bytes"}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.coll_result = {k: 0.0 for k in COLLECTIVES}
        self.coll_link = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_rows: Dict[Tuple, List[float]] = {}
        self._live: Dict[int, int] = {}
        self._read: set = set()
        self._fresh: set = set()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.start_bytes: Optional[int] = None

    # ---------------------------------------------------------- live bytes
    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    def _see(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live from now until it is freed;
        returns the storage's key."""
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._live:
                return key
            self._live[key] = n = st.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return key

    def _mark_read(self, key: int) -> None:
        if key not in self._fresh:
            self._read.add(key)

    def was_read(self, t: torch.Tensor) -> bool:
        """Whether an op took ``t``'s storage (``t`` or a view of it) as
        an operand before any op overwrote it whole: an input of the step
        that no op reads is one XLA would prune from a compiled step's
        arguments."""
        return t.untyped_storage()._cdata in self._read

    def track(self, *trees) -> "OpCounter":
        for tree in trees:
            for t in _tensors(_flatten(tree), []):
                self._see(t)
        return self

    # ------------------------------------------------------------- kernels
    def _on_kernel(self, name: str, flops: float, nbytes: float,
                   reads: tuple = ()) -> None:
        for t in reads:
            if t is not None:
                self._mark_read(self._see(t))
        with self._lock:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes

    def __enter__(self):
        if self.start_bytes is None:
            self.start_bytes = self.live_bytes
        common.cost_sinks.append(self._on_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        common.cost_sinks.remove(self._on_kernel)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, full, no_bytes, view = _info(func)
        ins = _tensors(list(args) + list(kwargs.values()), [])
        # a view reads nothing; a storage that an op overwrites whole
        # before any op reads it is not an input the step reads (XLA
        # prunes such an argument)
        dst = args[0] if name in _OVERWRITE and _whole(args[0]) else None
        for t in ins:
            key = self._see(t)
            if view:
                continue
            if t is dst and key not in self._read:
                self._fresh.add(key)
            else:
                self._mark_read(key)
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        for t in outs:
            self._see(t)
        flops = _flops(name, args, outs)
        nbytes = 0 if no_bytes else _bytes(name, args, ins, outs)
        if full.startswith("c10d.") and name in _C10D:
            self._collective(name, args)
        key = (full, tuple(tuple(t.shape) for t in ins))
        with self._lock:
            self.ops += 1
            self.flops += flops
            self.bytes += nbytes
            row = self.by_op.setdefault(key, [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out

    def _collective(self, name: str, args) -> None:
        kind, at = _C10D[name]
        n = sum(tensor_bytes(t) for t in _tensors(args[at], []))
        k = max(_group_size(args), 1)
        link = n * _RING[kind](k)
        with self._lock:
            self.coll_result[kind] += n
            self.coll_link[kind] += link
            self.coll_counts[kind] += 1
            row = self.coll_rows.setdefault((f"c10d.{name}", k), [0, 0, 0])
            row[0] += 1
            row[2] += link

    # -------------------------------------------------------------- result
    def result(self) -> Dict[str, Any]:
        """Totals in ``hlo.analyze``'s keys, with the kernels' records,
        the aten-only parts and the live bytes beside them."""
        kflops = sum(k["flops"] for k in self.kernels.values())
        kbytes = sum(k["bytes"] for k in self.kernels.values())
        return {
            "flops": self.flops, "bytes": self.bytes,
            "aten_flops": self.flops - kflops,
            "aten_bytes": self.bytes - kbytes,
            "ops": self.ops,
            "kernels": {n: dict(v) for n, v in sorted(self.kernels.items())},
            "collectives": {
                "result_bytes": dict(self.coll_result),
                "link_bytes": dict(self.coll_link),
                "counts": dict(self.coll_counts),
                "total_result_bytes": sum(self.coll_result.values()),
                "total_link_bytes": sum(self.coll_link.values()),
            },
            "start_bytes": self.start_bytes or 0,
            "peak_bytes": self.peak_bytes,
        }


def _flatten(tree):
    """The leaves of a tree of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return [_flatten(v) for v in tree.values()]
    if isinstance(tree, (list, tuple)):
        return [_flatten(v) for v in tree]
    return tree


def _flops(name: str, args, outs) -> int:
    if name in _MATMUL_K_ARG:
        a = args[_MATMUL_K_ARG[name]]
        return 2 * outs[0].numel() * a.shape[-1]
    if name in ("dot", "vdot"):
        return 2 * args[0].numel()
    return 0


def _bytes(name: str, args, ins, outs) -> int:
    res = sum(tensor_bytes(t) for t in outs)
    if name in _GATHER:
        return res + sum(tensor_bytes(t) for t in ins[1:])
    if name == "copy_":                 # the region written, read and written
        return 2 * tensor_bytes(args[0])
    scatter = name in _SCATTER
    if scatter or name in _SCATTER_INPLACE:
        # the update and the indices; every operand of the embedding's
        # backward is one (it has no destination operand)
        rest = ins if name == "embedding_dense_backward" else ins[1:]
        idx = [t for t in rest if not t.is_floating_point()]
        upd = [t for t in rest if t.is_floating_point()]
        moved = 2 * sum(tensor_bytes(t) for t in upd) \
            + sum(tensor_bytes(t) for t in idx)
        return moved + (res if scatter else 0)
    return res + sum(tensor_bytes(t) for t in ins)


def top_ops(counter: OpCounter, k: int = 12) -> Dict[str, List]:
    """The k biggest contributors per category, as ``(value, op, operand
    shapes)`` rows (the twin of ``top_instructions``); the kernels' records
    stand among the ops under their kernel's name."""
    flops, bytes_ = [], []
    for (op, shapes), (_, f, b) in counter.by_op.items():
        if f:
            flops.append((f, op, str(shapes)[:160]))
        if b:
            bytes_.append((b, op, str(shapes)[:160]))
    for name, rec in counter.kernels.items():
        flops.append((rec["flops"], f"kernel {name}",
                      f"{rec['calls']} calls"))
        bytes_.append((rec["bytes"], f"kernel {name}",
                       f"{rec['calls']} calls"))
    colls = [(link, op, f"k={k_}, {calls} calls")
             for (op, k_), (calls, _, link) in counter.coll_rows.items()]
    return {cat: sorted(rows, key=lambda r: -r[0])[:k]
            for cat, rows in (("flops", flops), ("bytes", bytes_),
                              ("collectives", colls))}


def roofline_terms(analysis: Dict, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> Dict[str, float]:
    t_compute = analysis["flops"] / peak_flops
    t_memory = analysis["bytes"] / hbm_bw
    t_coll = analysis["collectives"]["total_link_bytes"] / ici_bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"flops": analysis["flops"], "bytes": analysis["bytes"],
            "coll_link_bytes": analysis["collectives"]["total_link_bytes"],
            "t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dominant,
            "bound_s": max(t_compute, t_memory, t_coll)}
