"""The cost of every (architecture x shape) cell on one device of the
production mesh: the counterpart of ``repro/launch/dryrun.py`` (which
reports one device of the partitioned program) and of the roofline table
of ``benchmarks/roofline.py``.

Each cell's report has two parts:

* the production mesh (16 x 16, or 2 x 16 x 16 with ``--multipod``): the
  bytes each device holds of the inputs the step reads (the arguments XLA
  keeps of a compiled step), exact, from ``specs.cell_shardings``;
* rank 0 of that mesh, traced: its step (``train_step``, ``prefill`` or
  ``decode_step``) under the cell's rules (``specs.cell_rules``: for
  serving, the KV cache over its sequence where the kv heads do not
  divide "model"), at full width and depth, on the ``meta`` device under
  ``opcount.OpCounter``.  The rank holds its boxes of the parameters
  (``models.shard_params``; a training cell its train state's), of the
  cache (``models.init_cache(mesh=, rules=)``) and its rows of the batch,
  and runs the library's split step (``train.make_train_step(mesh=)``,
  in ``specs.default_microbatches`` microbatches, with FSDP's per-layer
  gathers; ``prefill`` / ``decode_step`` under ``use_rules``) inside a
  one-process world of the mesh's ranks on the ``fake`` backend
  (``fake_world``), whose ("data", "model") ``DeviceMesh`` gives the
  collectives their group sizes: they are traced and counted, not
  reckoned.  "pod" x "data" is one "data" axis there, as every rule
  splits them together.  A process has one default group, so the trace
  runs where no other group lives (this module's ``main``, or a
  subprocess).  It gives the counted FLOPs, bytes, collectives and peak
  live bytes, the roofline terms at ``mesh``'s H100 peaks, and ``fits``
  (the peak within the card's memory: ``mesh.HBM_BYTES``, or under
  ``--measure`` on a card its own ``total_memory``).  Serving weights are
  cast as ``models.cast_params`` casts them (norm scales and the
  recurrent layers' f32 leaves stay f32), where ``input_specs`` casts
  every floating leaf as the reference does.

A cell the library does not split yet (``sharding.tp.check_model_axis``
raises: the encoder-decoder and the frames / patches frontends, the int8
cache of ``--kv-quant``) keeps one device's data-parallel step at
``global_batch // (pod * data)`` sequences, nothing in it split over
"model", with the data-parallel gradient all-reduce reckoned by the ring
model; its artifact's ``split`` is None beside the check's message.

  python -m repro_torch.launch.report --arch yi-6b --shape decode_32k
  python -m repro_torch.launch.report --arch yi-6b          # all shapes
  python -m repro_torch.launch.report --all --both-meshes   # every cell
  ... [--multipod] [--mesh data=16,model=4] [--microbatches N]
      [--rules tp|fsdp|seq] [--kv-quant] [--remat full|none] [--tops N]
      [--out artifacts/report]

``--measure`` also runs the traced step on the card (on the CPU with
``--measure-device cpu``): once under the counter, whose counts it holds
against the ``meta`` trace's, then once timed, with the device's peak
memory beside the report's.  A rank of a mesh with a "model" axis runs
with that axis's other ranks as processes on the one card (gloo over CUDA
tensors), a ("data" 1, "model" m) world: a step that issues no
collective over "data" (serving under rules that keep the parameters
whole over "data"), whose rank 0 then runs what rank 0 of the mesh runs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, ShapeConfig
from ..models import cast_params, decode_step, init_cache, init_params
from ..models import param_split, prefill, shard_params
from ..models.params import tree_paths
from ..models.rwkv6_layer import own_head_leaves_
from ..optim import adamw_init
from ..sharding import spec, tp, use_rules
from ..train import TrainState, make_train_state, make_train_step
from . import opcount, specs
from .mesh import HBM_BW, HBM_BYTES, LINK_BW, PEAK_FLOPS, production_mesh

# the kernels whose records a K4 count reads
K4_KERNELS = ("flash_fwd", "flash_fwd_sm90", "flash_bwd", "flash_bwd_sm90")
# the card's max_memory_allocated over the report's peak that
# ``check_measure`` takes
PEAK_BAND = (0.8, 1.25)


def data_devices(mesh) -> int:
    """The devices a batch is split over: pod x data."""
    return mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)


def device_batch(shape: ShapeConfig, mesh) -> int:
    """Sequences of one device's step."""
    return max(shape.global_batch // data_devices(mesh), 1)


# --------------------------------------------------------------------------
# one device's step
# --------------------------------------------------------------------------
def serving_params(cfg: ModelConfig, device, generator=None):
    """Serving weights on ``device``, drawn from ``generator`` in f32 and
    cast as ``models.cast_params`` casts them, one subtree at a time (a
    smaller peak than the whole f32 draw beside its copy)."""
    params = init_params(cfg, generator, device=device)
    dtype = getattr(torch, cfg.dtype)
    for k in list(params):
        params[k] = cast_params({k: params[k]}, dtype)[k]
    return params


def step_inputs(cfg: ModelConfig, shape: ShapeConfig, batch: int, device,
                generator: Optional[torch.Generator] = None, params=None,
                mesh=None, rules=None):
    """The inputs of one device's step at ``batch`` sequences on
    ``device``: on ``meta`` shapes and dtypes, elsewhere values drawn from
    ``generator``.  train: (state, batch); prefill: (params, batch,
    cache); decode: (params, cache, tokens), the cache filled to its last
    slot.  ``params``: serving weights to use instead of a draw.  With
    ``mesh`` (a ``DeviceMesh``, this process one of its ranks) under
    ``rules``: the rank's boxes of the parameters (drawn whole, then
    cut) and, for training, of the optimizer's moments (the params'
    layout), its box of the cache; ``params`` are then its boxes."""
    device = torch.device(device)
    gen = None if device.type == "meta" else generator

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                             dtype=torch.int32, device=device)

    def extras(out):
        for key, n in (("frames", cfg.num_frames),
                       ("patches", cfg.num_patches)):
            if cfg.frontend == key:
                out[key] = torch.randn((batch, n, cfg.d_model),
                                       generator=gen, device=device)
        return out

    if shape.kind == "train":
        state = make_train_state(cfg, gen, device=device)
        if mesh is not None:
            boxes = shard_params(state.params, cfg, mesh, rules)
            del state
            state = TrainState(params=boxes, opt=adamw_init(boxes),
                               step=torch.zeros((), dtype=torch.int32,
                                                device=device))
        toks = tokens(shape.seq_len)
        return state, extras({"tokens": toks, "labels": toks.clone()})
    if params is None:
        params = serving_params(cfg, device, gen)
        if mesh is not None:
            params = shard_params(params, cfg, mesh, rules)
            if cfg.mixer == "rwkv6" and tp.axis_size(mesh) > 1:
                # RWKV-6's head_dim boxes as the rank's heads, as
                # ``ServeEngine`` keeps them
                own_head_leaves_(params, cfg.rwkv_head_dim, mesh, rules)
    if shape.kind == "prefill":
        cache = init_cache(cfg, batch, specs.prefill_len(cfg, shape),
                           device=device, mesh=mesh, rules=rules)
        return params, extras({"tokens": tokens(shape.seq_len)}), cache
    cache = init_cache(cfg, batch, shape.seq_len, device=device, mesh=mesh,
                       rules=rules)
    cache["idx"].fill_(shape.seq_len - 1)
    return params, cache, tokens(1)


def make_step(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1,
              mesh=None, rules=None):
    """The cell's step, a function of ``step_inputs``' tuple: one
    device's, or with ``mesh`` (a ``DeviceMesh``) the rank's under
    ``rules``."""
    if shape.kind == "train":
        return make_train_step(cfg, microbatches=microbatches, mesh=mesh,
                               rules=rules)

    def serve(*inputs):
        with torch.no_grad(), use_rules(mesh, rules):
            if shape.kind == "prefill":
                return prefill(cfg, *inputs)
            return decode_step(cfg, *inputs)
    return serve


def count_step(cfg: ModelConfig, shape: ShapeConfig, batch: int,
               microbatches: int, inputs=None, mesh=None,
               rules=None) -> opcount.OpCounter:
    """One step at ``batch`` sequences (the rank's on ``mesh`` under
    ``rules``) run under an ``OpCounter`` that tracks its inputs
    (``inputs``, or ``meta`` ones: a trace)."""
    if inputs is None:
        inputs = step_inputs(cfg, shape, batch, "meta", mesh=mesh,
                             rules=rules)
    step = make_step(cfg, shape, microbatches, mesh, rules)
    counter = opcount.OpCounter().track(inputs)
    with counter:
        step(*inputs)
    return counter


# --------------------------------------------------------------------------
# rank 0 of the mesh
# --------------------------------------------------------------------------
def rank_layout(mesh) -> Dict[str, int]:
    """The ("data", "model") sizes of ``mesh``'s ranks: "pod" x "data" as
    one "data" axis (every rule splits them together, "pod" major)."""
    s = mesh.shape
    return {"data": s.get("pod", 1) * s.get("data", 1),
            "model": s.get("model", 1)}


def unsplit_reason(cfg: ModelConfig, mesh, rules) -> Optional[str]:
    """None where the library splits ``cfg`` over ``mesh`` under
    ``rules``, else ``check_model_axis``'s message."""
    lay = rank_layout(mesh)
    try:
        tp.check_model_axis(cfg, lay["model"], rules, lay["data"])
    except ValueError as e:
        return str(e)
    return None


def rank_rows(shape: ShapeConfig, mesh, rules) -> int:
    """Rows of the global batch one device holds: the batch's spec on
    ``mesh`` (the whole batch where the data devices do not divide it,
    as the reference's spec replicates it)."""
    sizes = mesh.shape
    parts = 1
    for axes in spec(("batch", None), rules, mesh,
                     (shape.global_batch, shape.seq_len)):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            parts *= sizes[a]
    return shape.global_batch // parts


def fake_store():
    """The store of torch's ``fake`` process-group backend, which importing
    its module registers.  That module lies in torch's private testing
    package: a torch without it raises here, naming its version."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"torch {torch.__version__} has no 'fake' process-group backend "
            f"(torch.testing._internal.distributed.fake_pg.FakeStore), on "
            f"which the report traces a rank of the mesh: {e}") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(layout: Dict[str, int]):
    """A world of ``data * model`` ranks in this one process, its rank 0,
    on the ``fake`` backend (collectives that move nothing, on any
    device, ``meta`` included); yields its ("data", "model")
    ``DeviceMesh``.  A process holds one default group: raises where one
    lives already."""
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        raise RuntimeError("a rank of the mesh is traced where no other "
                           "process group lives: run it in a process of "
                           "its own")
    n = layout["data"] * layout["model"]
    dist.init_process_group("fake", store=fake_store(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(
            layout["data"], layout["model"]),
            mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def kv_seq_split(tree) -> bool:
    """Whether a tree holds a KV cache split over its slots
    (``attention.KVSeqShard``)."""
    from ..models.attention import KVSeqShard

    if isinstance(tree, KVSeqShard):
        return True
    if isinstance(tree, dict):
        tree = list(tree.values())
    return isinstance(tree, (list, tuple)) and any(
        kv_seq_split(t) for t in tree)


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaves(tree, path=()) -> Dict[str, Any]:
    """{"/"-joined path: leaf} of a tree of dicts, NamedTuples, lists and
    tuples; None subtrees vanish."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = (zip(tree._fields, tree) if hasattr(tree, "_fields")
                 else enumerate(tree))
    else:
        return {"/".join(path): tree}
    out = {}
    for k, v in items:
        out.update(leaves(v, path + (str(k),)))
    return out


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   rules=None, used=None) -> Dict[str, int]:
    """Bytes of the cell's inputs (``specs.input_specs``): in all, and on
    each device of ``mesh`` (each leaf's bytes over the devices its spec in
    ``specs.cell_shardings`` splits it across).  With ``used`` (a set of
    leaf paths) only those leaves count."""
    total = per_device = 0
    sizes = mesh.shape
    shardings = leaves(specs.cell_shardings(cfg, shape, mesh, rules))
    for path, t in leaves(specs.input_specs(cfg, shape)).items():
        if used is not None and path not in used:
            continue
        parts = 1
        for axes in shardings[path].spec:
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                parts *= sizes[a]
        total += _nbytes(t)
        per_device += _nbytes(t) // parts
    return {"total": total, "per_device": per_device}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N D for training, 2 N D for serving, N the active parameters and
    D the tokens (``dryrun.py:93-103``)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * n_active * shape.global_batch * shape.seq_len
    return 2 * n_active * shape.global_batch


def dp_allreduce(cfg: ModelConfig, k: int) -> Dict[str, float]:
    """The data-parallel step's all-reduces over ``k`` ranks
    (``train/step.py``'s ``_grads``): every gradient leaf (f32), the
    token count and the loss, by the ring model."""
    params = leaves(init_params(cfg, None, device="meta")).values()
    n = 4 * sum(t.numel() for t in params) + 8
    return {"ranks": k, "calls": len(params) + 2, "result_bytes": float(n),
            "link_bytes": 2 * n * (k - 1) / k}


def report_cell(cfg: ModelConfig, shape: ShapeConfig, *,
                multi_pod: bool = False, microbatches: int = 0,
                rules=None, kv_quant: bool = False,
                remat: Optional[str] = None,
                mesh_shape: Optional[Dict[str, int]] = None,
                tops: int = 0, hbm_bytes: float = HBM_BYTES
                ) -> Dict[str, Any]:
    """One cell's artifact (module docstring); ``microbatches`` 0 takes
    ``specs.default_microbatches``, ``mesh_shape`` replaces the production
    mesh (a {"data": 1, "model": 1} mesh is one device's step),
    ``hbm_bytes`` is the card's memory ``fits`` is held to."""
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    mesh = production_mesh(multi_pod, mesh_shape)
    rules = rules or specs.cell_rules(cfg, shape, mesh)
    if microbatches == 0:
        microbatches = specs.default_microbatches(cfg, shape, mesh)
    unsplit = unsplit_reason(cfg, mesh, rules)
    layout = rank_layout(mesh)
    t0 = time.monotonic()
    if unsplit is None and mesh.size > 1:
        batch = rank_rows(shape, mesh, rules)
        with fake_world(layout) as dmesh:
            inputs = step_inputs(cfg, shape, batch, "meta", mesh=dmesh,
                                 rules=rules)
            counter = count_step(cfg, shape, batch, microbatches, inputs,
                                 dmesh, rules)
    else:
        batch = device_batch(shape, mesh)
        inputs = step_inputs(cfg, shape, batch, "meta")
        counter = count_step(cfg, shape, batch, microbatches, inputs)
    t_trace = time.monotonic() - t0
    analysis = counter.result()
    # the inputs the step reads: what a compiled step's arguments keep
    used = {p for p, t in leaves(inputs).items() if counter.was_read(t)}
    args = argument_bytes(cfg, shape, mesh, rules, used)
    all_args = argument_bytes(cfg, shape, mesh, rules)
    k = data_devices(mesh)
    coll = analysis["collectives"]
    if unsplit is not None and shape.kind == "train" and k > 1:
        dp = dp_allreduce(cfg, k)
        coll["result_bytes"]["all-reduce"] += dp["result_bytes"]
        coll["link_bytes"]["all-reduce"] += dp["link_bytes"]
        coll["total_result_bytes"] += dp["result_bytes"]
        coll["total_link_bytes"] += dp["link_bytes"]
        coll["reckoned"] = {"data_parallel_all_reduce": dp}
    terms = opcount.roofline_terms(analysis, PEAK_FLOPS, HBM_BW, LINK_BW)
    mflops = model_flops(cfg, shape)
    # the step's share of the model's work: the devices' share of it
    # (``dryrun.py:104``), or, for one device's data-parallel step, its
    # sequences' (a batch smaller than the devices leaves each device a
    # whole sequence)
    per_device = (mflops / mesh.size if unsplit is None
                  else mflops * batch / shape.global_batch)
    peak = analysis["peak_bytes"]
    art = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(mesh.shape), "chips": mesh.size,
        "microbatches": microbatches, "device_batch": batch,
        "split": None if unsplit else {"rank": 0, "ranks": layout,
                                       "kv_seq": kv_seq_split(inputs)},
        "unsplit": unsplit,
        "trace_s": round(t_trace, 2),
        "serving_params": ("cast as models.cast_params: norm scales and "
                           "the recurrent f32 leaves kept in f32"
                           if shape.kind != "train" else None),
        "memory": {
            "argument_bytes": args["per_device"],
            "argument_bytes_total": args["total"],
            "all_inputs_bytes": all_args["per_device"],
            "unread_inputs": sorted(set(leaves(inputs)) - used),
            "input_bytes": analysis["start_bytes"],
            "peak_bytes_per_device": peak,
            "device_bytes": hbm_bytes,
            "fits": peak <= hbm_bytes,
        },
        "cost": {"flops": terms["flops"], "bytes": terms["bytes"],
                 "aten_flops": analysis["aten_flops"],
                 "aten_bytes": analysis["aten_bytes"],
                 "ops": analysis["ops"], "kernels": analysis["kernels"]},
        "collectives": coll,
        "roofline": {
            "t_compute": terms["t_compute"],
            "t_memory": terms["t_memory"],
            "t_collective": terms["t_collective"],
            "dominant": terms["dominant"],
            "bound_s": terms["bound_s"],
            "model_flops": mflops,
            "model_flops_per_device": per_device,
            "useful_flop_ratio": (per_device / terms["flops"]
                                  if terms["flops"] else 0.0),
            "roofline_fraction": ((per_device / PEAK_FLOPS)
                                  / terms["bound_s"]
                                  if terms["bound_s"] > 0 else 0.0),
        },
        "params": {"total": cfg.param_count(),
                   "active": cfg.active_param_count()},
    }
    if tops:
        art["tops"] = opcount.top_ops(counter, tops)
    return art


# --------------------------------------------------------------------------
# the report held against a run
# --------------------------------------------------------------------------
def k4_records(kernels: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """K4's records among a count's ``kernels``."""
    return {n: v for n, v in kernels.items() if n in K4_KERNELS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_counted(step, inputs, device: torch.device, timed_runs: int,
                 keep=None):
    """The step once under the counter, then ``timed_runs`` times without
    it: (count, K4 launches in the counted run, median ms of the timed
    runs, the peak of ``max_memory_allocated`` over them on CUDA, else
    None, ``keep`` of the counted run's output, taken before the output
    is let go).  With no timed run, the counted run's ms and peak (a step
    whose time the counter's per-op work does not move)."""
    from ..kernels.flash_attention import kernel as fa

    _sync(device)
    if device.type == "cuda" and not timed_runs:
        torch.cuda.reset_peak_memory_stats(device)
    before = fa.launches + fa.bwd_launches
    counter = opcount.OpCounter().track(inputs)
    t0 = time.perf_counter()
    with counter:
        out = step(*inputs)
    _sync(device)
    ms = [] if timed_runs else [(time.perf_counter() - t0) * 1e3]
    kept = None if keep is None else keep(out)
    del out
    launches = fa.launches + fa.bwd_launches - before
    run = counter.result()
    del counter
    peak = None
    if device.type == "cuda" and timed_runs:
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(timed_runs):
        _sync(device)
        t0 = time.perf_counter()
        step(*inputs)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    return run, launches, sorted(ms)[len(ms) // 2], peak, kept


def _measured(cfg, shape, batch, microbatches, device, run, launches, ms,
              peak, meta) -> Dict[str, Any]:
    """A run's numbers beside its ``meta`` trace's (an ``OpCounter``
    result, or a report's counts in its keys)."""
    bound_s = opcount.roofline_terms(meta, PEAK_FLOPS, HBM_BW,
                                     LINK_BW)["bound_s"]
    return {
        "arch": cfg.name, "shape": shape.name, "layers": cfg.num_layers,
        "device": str(device), "sequences": batch,
        "microbatches": microbatches,
        "flops": run["flops"], "bytes": run["bytes"],
        "meta_flops": meta["flops"], "meta_bytes": meta["bytes"],
        "kernels": run["kernels"], "meta_kernels": meta["kernels"],
        "collectives": _coll(run["collectives"]),
        "meta_collectives": _coll(meta["collectives"]),
        "k4_launches": launches,
        "report_peak_bytes": meta["peak_bytes"],
        "run_counted_peak_bytes": run["peak_bytes"],
        "max_memory_allocated": peak,
        "peak_ratio": None if peak is None else peak / meta["peak_bytes"],
        "ms": ms, "bound_s": bound_s,
    }


def _coll(c: Dict[str, Any]) -> Dict[str, Any]:
    """A count's collectives: calls and result bytes of each kind."""
    return {"counts": dict(c["counts"]),
            "result_bytes": dict(c["result_bytes"])}


def measure_cell(cfg: ModelConfig, shape: ShapeConfig, batch: int,
                 microbatches: int, device="cuda", seed: int = 0,
                 timed_runs: int = 1, params=None) -> Dict[str, Any]:
    """Run one device's step of the cell on ``device`` and hold it
    against the ``meta`` trace of the same step: the step once under the
    counter (its FLOPs, bytes and kernel records beside the trace's), then
    ``timed_runs`` times without it (median ms; on CUDA the peak of
    ``max_memory_allocated`` after ``reset_peak_memory_stats``, the step's
    inputs allocated).  ``launches`` is the K4 wrappers' count over the
    counted run.  ``params``: serving weights on ``device`` to use
    instead of a draw."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = step_inputs(cfg, shape, batch, device, generator=gen,
                         params=params)
    step = make_step(cfg, shape, microbatches)
    run, launches, ms, peak, _ = _run_counted(step, inputs, device,
                                              timed_runs)
    meta = count_step(cfg, shape, batch, microbatches).result()
    return _measured(cfg, shape, batch, microbatches, device, run,
                     launches, ms, peak, meta)


def measurable(cfg: ModelConfig, shape: ShapeConfig, art, rules) -> None:
    """Raise ``ValueError`` unless rank 0 of ``art``'s mesh runs on one
    card as rank 0 of a ("data" 1, "model" m) world: a split cell whose
    step issues no collective over "data" (serving under rules that keep
    every parameter whole over "data")."""
    split = art["split"]
    if split is None:
        raise ValueError(f"{cfg.name} x {shape.name} is not split: "
                         f"{art['unsplit']}")
    ranks = split["ranks"]
    if ranks["data"] == 1:
        return
    lay = production_mesh(False, ranks)
    if shape.kind == "train" or any(
            "data" in axes for _, axes in tree_paths(
                param_split(cfg, lay, rules))):
        raise ValueError(
            f"{cfg.name} x {shape.name}: its step talks over the mesh's "
            f"{ranks['data']} data ranks, which one card does not run")


def measure_rank(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                 batch: int, microbatches: int, device, seed: int = 0,
                 timed_runs: int = 1, inputs=None) -> Dict[str, Any]:
    """This rank's step on ``mesh`` (a ("data" 1, "model" m) world's
    ``DeviceMesh``, every rank calling it) on ``device``: its inputs drawn
    from ``seed`` (``step_inputs(mesh=)``: every rank draws the whole
    parameters, one rank at a time, and keeps its boxes), then the step
    under the counter and timed as ``measure_cell``'s.  ``inputs``: the
    rank's to use instead.  Returns the run's numbers (no trace:
    ``hold_to_report`` adds the report's) and a serving step's logits
    (the rank's vocabulary columns), on the CPU."""
    device = torch.device(device)
    for r in range(dist.get_world_size() if inputs is None else 0):
        if r == dist.get_rank():
            gen = torch.Generator(device=device).manual_seed(seed)
            inputs = step_inputs(cfg, shape, batch, device, generator=gen,
                                 mesh=mesh, rules=rules)
            _sync(device)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    step = make_step(cfg, shape, microbatches, mesh, rules)
    run, launches, ms, peak, logits = _run_counted(
        step, inputs, device, timed_runs,
        None if shape.kind == "train" else lambda o: o[0].float().cpu())
    return {"run": run, "launches": launches, "ms": ms, "peak": peak,
            "device": str(device), "sequences": batch,
            "microbatches": microbatches, "logits": logits}


def hold_to_report(cfg: ModelConfig, shape: ShapeConfig, rank: Dict,
                   art: Dict[str, Any]) -> Dict[str, Any]:
    """``measure_rank``'s numbers of rank 0 beside ``art``'s trace of rank
    0 of the mesh, as ``measure_cell``'s (``check_measure`` holds them)."""
    trace = {"flops": art["cost"]["flops"], "bytes": art["cost"]["bytes"],
             "kernels": art["cost"]["kernels"],
             "collectives": art["collectives"],
             "peak_bytes": art["memory"]["peak_bytes_per_device"]}
    return _measured(cfg, shape, rank["sequences"], rank["microbatches"],
                     rank["device"], rank["run"], rank["launches"],
                     rank["ms"], rank["peak"], trace)


def _measure_world(rank, world, store, out, cfg, shape, rules, batch,
                   microbatches, device_type, seed, timed_runs):
    from ..sharding import init_world, make_tp_mesh

    init_world(rank, world, "cuda:gloo" if device_type == "cuda"
               else "gloo", store)
    try:
        device = torch.device("cpu") if device_type != "cuda" else \
            torch.device("cuda", torch.cuda.current_device())
        res = measure_rank(cfg, shape, make_tp_mesh(1, world), rules, batch,
                           microbatches, device, seed, timed_runs)
        if rank == 0:
            torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def measure_split(cfg: ModelConfig, shape: ShapeConfig, art: Dict[str, Any],
                  rules, device="cuda", seed: int = 0,
                  timed_runs: int = 1) -> Dict[str, Any]:
    """Rank 0 of ``art``'s mesh run on ``device`` beside the "model"
    axis's other ranks, as processes of a ("data" 1, "model" m) world over
    gloo (``measurable``), and held to ``art``'s trace: ``measure_cell``'s
    numbers, the collectives too."""
    import tempfile

    import torch.multiprocessing as mp

    measurable(cfg, shape, art, rules)
    world = art["split"]["ranks"]["model"]
    with tempfile.TemporaryDirectory(prefix="report-measure-") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.start_processes(
            _measure_world, args=(world, os.path.join(tmp, "store"), out,
                                  cfg, shape, rules, art["device_batch"],
                                  art["microbatches"],
                                  torch.device(device).type, seed,
                                  timed_runs),
            nprocs=world, join=True, start_method="spawn")
        rank0 = torch.load(out, weights_only=False)
    return hold_to_report(cfg, shape, rank0, art)


def check_measure(m: Dict[str, Any]) -> None:
    """Raise unless the run and the ``meta`` trace count the same FLOPs,
    bytes, collectives (calls and bytes of each kind) and kernel records
    (K4's, K6's, K7's), K4's launches equal its
    records' calls, and the device's peak lies within ``PEAK_BAND`` of
    the report's.  Only a
    run on the card is held to the trace: on the CPU the kernels run their
    plain versions, whose aten ops the counter counts in place of the
    kernels' records."""
    what = f"{m['arch']} x {m['shape']}"
    if not m["device"].startswith("cuda"):
        return
    if (m["flops"], m["bytes"]) != (m["meta_flops"], m["meta_bytes"]):
        raise AssertionError(
            f"{what}: the run counts {m['flops']} FLOPs, {m['bytes']} bytes; "
            f"the meta trace {m['meta_flops']}, {m['meta_bytes']}")
    if m["kernels"] != m["meta_kernels"]:
        raise AssertionError(f"{what}: kernel records {m['kernels']} on "
                             f"the run, {m['meta_kernels']} on meta")
    if m["collectives"] != m["meta_collectives"]:
        raise AssertionError(f"{what}: collectives {m['collectives']} on "
                             f"the run, {m['meta_collectives']} on meta")
    calls = sum(int(v["calls"]) for v in k4_records(m["kernels"]).values())
    if calls != m["k4_launches"]:
        raise AssertionError(f"{what}: {calls} K4 records, "
                             f"{m['k4_launches']} launches")
    ratio = m["peak_ratio"]
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(
            f"{what}: max_memory_allocated {m['max_memory_allocated']} is "
            f"{ratio:.3f}x the report's peak {m['report_peak_bytes']}")


def measure(cfg: ModelConfig, shape: ShapeConfig, art: Dict[str, Any],
            rules=None, kv_quant: bool = False, remat: Optional[str] = None,
            device="cuda") -> Dict[str, Any]:
    """``art``'s traced step run on ``device`` (``report_cell``'s
    ``rules``, ``kv_quant`` and ``remat``): a rank of a mesh of more than
    one device with its "model" ranks beside it (``measure_split``),
    else one device's step (``measure_cell``)."""
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    if art["split"] is None or art["chips"] == 1:
        return measure_cell(cfg, shape, art["device_batch"],
                            art["microbatches"], device)
    rules = rules or specs.cell_rules(cfg, shape,
                                      production_mesh(False, art["mesh"]))
    return measure_split(cfg, shape, art, rules, device)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def _gb(x: float) -> str:
    return f"{x / 1e9:.2f}"


def table_row(art: Dict[str, Any]) -> str:
    r, m = art["roofline"], art["memory"]
    mesh = "x".join(str(v) for v in art["mesh"].values())
    split = art["split"]
    how = "no" if split is None else (
        "kv_seq" if split["kv_seq"] else "yes")
    return (f"| {art['arch']} | {art['shape']} | {mesh} | {how} | "
            f"{art['device_batch']} / {art['microbatches']} | "
            f"{art['cost']['flops']:.4g} | {art['cost']['bytes']:.4g} | "
            f"{art['collectives']['total_link_bytes']:.4g} | "
            f"{_gb(m['argument_bytes'])} | "
            f"{_gb(m['peak_bytes_per_device'])} | "
            f"{'yes' if m['fits'] else 'no'} | {r['dominant']} | "
            f"{r['bound_s'] * 1e3:.4g} | {r['useful_flop_ratio']:.3g} | "
            f"{r['roofline_fraction']:.3g} |")


TABLE_HEAD = ("| arch | shape | mesh | split | seqs / microbatches | FLOPs | "
              "bytes | link bytes | args GB/dev (mesh) | peak GB/dev | fits "
              "| dominant | bound ms | useful | roofline |\n"
              "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
              "---|")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="axis=size,... in place of the production mesh, "
                         "e.g. data=16,model=4")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = specs.default_microbatches")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--remat", default=None, help="full | none")
    ap.add_argument("--tops", type=int, default=0,
                    help="print the N biggest ops per category")
    ap.add_argument("--out", default="artifacts/report")
    ap.add_argument("--measure", action="store_true",
                    help="run the one-H100 step too and hold it against "
                         "the report")
    ap.add_argument("--measure-device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS, get_config, get_shape, shapes_for
    from ..sharding import get_rules

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    hbm = HBM_BYTES
    if args.measure and torch.device(args.measure_device).type == "cuda":
        hbm = torch.cuda.get_device_properties(
            torch.device(args.measure_device)).total_memory
    meshes = [False, True] if args.both_meshes else [args.multipod]
    mesh_shape = None
    if args.mesh:
        mesh_shape = {k: int(v) for k, v in
                      (kv.split("=") for kv in args.mesh.split(","))}
        meshes = [False]
    rules = get_rules(args.rules) if args.rules else None
    rows, failures = [], []
    for arch in archs:
        cfg = get_config(arch)
        names = [args.shape] if args.shape else \
            [s.name for s in shapes_for(cfg)]
        for shape_name in names:
            shape = get_shape(shape_name)
            for mp in meshes:
                where = ("x".join(str(v) for v in mesh_shape.values())
                         if mesh_shape else "2x16x16" if mp else "16x16")
                label = f"{arch} x {shape_name} x {where}"
                try:
                    art = report_cell(cfg, shape, multi_pod=mp,
                                      microbatches=args.microbatches,
                                      rules=rules, kv_quant=args.kv_quant,
                                      remat=args.remat, mesh_shape=mesh_shape,
                                      tops=args.tops, hbm_bytes=hbm)
                    if args.measure:
                        art["measured"] = m = measure(
                            cfg, shape, art, rules, args.kv_quant,
                            args.remat, args.measure_device)
                        check_measure(m)
                    os.makedirs(args.out, exist_ok=True)
                    tag = (f"mesh-{where}" if mesh_shape
                           else "multipod" if mp else "pod")
                    fn = os.path.join(args.out,
                                      f"{arch}__{shape_name}__{tag}.json")
                    with open(fn, "w") as f:
                        json.dump(art, f, indent=1)
                    rows.append(table_row(art))
                    print(f"[OK] {label}: trace {art['trace_s']} s", flush=True)
                    for cat, top in art.get("tops", {}).items():
                        print(f"  --- top {cat} ---")
                        for v, op, where in top:
                            print(f"   {v:.3e}  {op[:40]:40s} {where[:100]}")
                except Exception as e:  # noqa: BLE001
                    failures.append((label, repr(e)))
                    traceback.print_exc()
                    print(f"[FAIL] {label}: {e}", flush=True)
    print(TABLE_HEAD)
    print("\n".join(rows))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(f"  {label}: {err}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
