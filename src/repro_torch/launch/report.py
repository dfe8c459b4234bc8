"""The cost of every (architecture x shape) cell on one H100: the
counterpart of ``repro/launch/dryrun.py`` and of the roofline table of
``benchmarks/roofline.py``.

Each cell's report has two parts:

* the production mesh (16 x 16, or 2 x 16 x 16 with ``--multipod``): the
  bytes each device holds of the inputs the step reads (the arguments XLA
  keeps of a compiled step), exact, from ``specs.cell_shardings``;
* one H100: one device's step (``train_step``, ``prefill`` or
  ``decode_step``) at ``global_batch // (pod * data)`` sequences, in
  ``specs.default_microbatches`` microbatches, at full width and depth,
  traced on the ``meta`` device under ``opcount.OpCounter``.  The trace
  is of the data-parallel step: nothing in it is split over "model"
  (the port's "model" axis, ``sharding/tp.py``, is not traced here yet).
  It gives the counted FLOPs, bytes and peak live bytes, the roofline
  terms at ``mesh``'s H100 peaks, and ``fits`` (the peak within the
  card's memory: ``mesh.HBM_BYTES``, or under ``--measure`` on a card
  its own ``total_memory``).  Serving weights are cast as ``models.cast_params`` casts
  them (norm scales and the recurrent layers' f32 leaves stay f32),
  where ``input_specs`` casts every floating leaf as the reference does.
  A training cell adds the data-parallel gradient all-reduce over the
  pod x data devices, reckoned by the ring model (not traced: one device
  runs no collective).

  python -m repro_torch.launch.report --arch yi-6b --shape decode_32k
  python -m repro_torch.launch.report --arch yi-6b          # all shapes
  python -m repro_torch.launch.report --all --both-meshes   # every cell
  ... [--multipod] [--microbatches N] [--rules tp|fsdp|seq] [--kv-quant]
      [--remat full|none] [--tops N] [--out artifacts/report]

``--measure`` also runs the cell's one-H100 step on the card (on the CPU
with ``--measure-device cpu``): once under the counter, whose counts it
holds against the ``meta`` trace's, then once timed, with the device's
peak memory beside the report's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import cast_params, decode_step, init_cache, init_params
from ..models import prefill
from ..train import make_train_state, make_train_step
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
                generator: Optional[torch.Generator] = None, params=None):
    """The inputs of one device's step at ``batch`` sequences on
    ``device``: on ``meta`` shapes and dtypes, elsewhere values drawn from
    ``generator``.  train: (state, batch); prefill: (params, batch,
    cache); decode: (params, cache, tokens), the cache filled to its last
    slot.  ``params``: serving weights to use instead of a draw."""
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
        toks = tokens(shape.seq_len)
        return state, extras({"tokens": toks, "labels": toks.clone()})
    if params is None:
        params = serving_params(cfg, device, gen)
    if shape.kind == "prefill":
        cache = init_cache(cfg, batch, specs.prefill_len(cfg, shape),
                           device=device)
        return params, extras({"tokens": tokens(shape.seq_len)}), cache
    cache = init_cache(cfg, batch, shape.seq_len, device=device)
    cache["idx"].fill_(shape.seq_len - 1)
    return params, cache, tokens(1)


def make_step(cfg: ModelConfig, shape: ShapeConfig, microbatches: int = 1):
    """The cell's step, a function of ``step_inputs``' tuple."""
    if shape.kind == "train":
        return make_train_step(cfg, microbatches=microbatches)

    def serve(*inputs):
        with torch.no_grad():
            if shape.kind == "prefill":
                return prefill(cfg, *inputs)
            return decode_step(cfg, *inputs)
    return serve


def count_step(cfg: ModelConfig, shape: ShapeConfig, batch: int,
               microbatches: int, inputs=None) -> opcount.OpCounter:
    """One step at ``batch`` sequences run under an ``OpCounter`` that
    tracks its inputs (``inputs``, or ``meta`` ones: a trace)."""
    if inputs is None:
        inputs = step_inputs(cfg, shape, batch, "meta")
    step = make_step(cfg, shape, microbatches)
    counter = opcount.OpCounter().track(inputs)
    with counter:
        step(*inputs)
    return counter


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
    (``train/step.py``'s ``_dp_grads``): every gradient leaf (f32), the
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
    batch = device_batch(shape, mesh)
    inputs = step_inputs(cfg, shape, batch, "meta")
    t0 = time.monotonic()
    counter = count_step(cfg, shape, batch, microbatches, inputs=inputs)
    t_trace = time.monotonic() - t0
    analysis = counter.result()
    # the inputs the step reads: what a compiled step's arguments keep
    used = {p for p, t in leaves(inputs).items() if counter.was_read(t)}
    args = argument_bytes(cfg, shape, mesh, rules, used)
    all_args = argument_bytes(cfg, shape, mesh, rules)
    k = data_devices(mesh)
    coll = analysis["collectives"]
    if shape.kind == "train" and k > 1:
        dp = dp_allreduce(cfg, k)
        coll["result_bytes"]["all-reduce"] += dp["result_bytes"]
        coll["link_bytes"]["all-reduce"] += dp["link_bytes"]
        coll["total_result_bytes"] += dp["result_bytes"]
        coll["total_link_bytes"] += dp["link_bytes"]
        coll["reckoned"] = {"data_parallel_all_reduce": dp}
    terms = opcount.roofline_terms(analysis, PEAK_FLOPS, HBM_BW, LINK_BW)
    mflops = model_flops(cfg, shape)
    # the step's share of the model's work: its sequences' (a batch
    # smaller than the devices leaves each device a whole sequence)
    per_device = mflops * batch / shape.global_batch
    peak = analysis["peak_bytes"]
    art = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(mesh.shape), "chips": mesh.size,
        "microbatches": microbatches, "device_batch": batch,
        "trace_s": round(t_trace, 2),
        "serving_params": ("cast as models.cast_params: norm scales and "
                           "the recurrent f32 leaves kept in f32"
                           if shape.kind != "train" else None),
        "memory": {
            "argument_bytes": args["per_device"],
            "argument_bytes_total": args["total"],
            "all_inputs_bytes": all_args["per_device"],
            "unread_inputs": sorted(set(leaves(inputs)) - used),
            "one_h100_input_bytes": analysis["start_bytes"],
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
    from ..kernels.flash_attention import kernel as fa

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = step_inputs(cfg, shape, batch, device, generator=gen,
                         params=params)
    step = make_step(cfg, shape, microbatches)
    _sync(device)
    before = fa.launches + fa.bwd_launches
    counter = opcount.OpCounter().track(inputs)
    with counter:
        step(*inputs)
    _sync(device)
    launches = fa.launches + fa.bwd_launches - before
    run = counter.result()
    del counter
    meta = count_step(cfg, shape, batch, microbatches).result()

    ms, peak = [], None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(timed_runs):
        _sync(device)
        t0 = time.perf_counter()
        step(*inputs)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    bound_s = opcount.roofline_terms(meta, PEAK_FLOPS, HBM_BW,
                                     LINK_BW)["bound_s"]
    return {
        "arch": cfg.name, "shape": shape.name, "layers": cfg.num_layers,
        "device": str(device), "sequences": batch,
        "microbatches": microbatches,
        "flops": run["flops"], "bytes": run["bytes"],
        "meta_flops": meta["flops"], "meta_bytes": meta["bytes"],
        "kernels": run["kernels"], "meta_kernels": meta["kernels"],
        "k4_launches": launches,
        "report_peak_bytes": meta["peak_bytes"],
        "run_counted_peak_bytes": run["peak_bytes"],
        "max_memory_allocated": peak,
        "peak_ratio": None if peak is None else peak / meta["peak_bytes"],
        "ms": sorted(ms)[len(ms) // 2], "bound_s": bound_s,
    }


def check_measure(m: Dict[str, Any]) -> None:
    """Raise unless the run and the ``meta`` trace count the same FLOPs,
    bytes and kernel records (K4's, K6's, K7's), K4's launches equal its
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
    calls = sum(int(v["calls"]) for v in k4_records(m["kernels"]).values())
    if calls != m["k4_launches"]:
        raise AssertionError(f"{what}: {calls} K4 records, "
                             f"{m['k4_launches']} launches")
    ratio = m["peak_ratio"]
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(
            f"{what}: max_memory_allocated {m['max_memory_allocated']} is "
            f"{ratio:.3f}x the report's peak {m['report_peak_bytes']}")


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def _gb(x: float) -> str:
    return f"{x / 1e9:.2f}"


def table_row(art: Dict[str, Any]) -> str:
    r, m = art["roofline"], art["memory"]
    mesh = "x".join(str(v) for v in art["mesh"].values())
    return (f"| {art['arch']} | {art['shape']} | {mesh} | "
            f"{art['device_batch']} / {art['microbatches']} | "
            f"{art['cost']['flops']:.4g} | {art['cost']['bytes']:.4g} | "
            f"{_gb(m['argument_bytes'])} | "
            f"{_gb(m['peak_bytes_per_device'])} | "
            f"{'yes' if m['fits'] else 'no'} | {r['dominant']} | "
            f"{r['bound_s'] * 1e3:.4g} | {r['useful_flop_ratio']:.3g} | "
            f"{r['roofline_fraction']:.3g} |")


TABLE_HEAD = ("| arch | shape | mesh | seqs / microbatches | FLOPs | bytes | "
              "args GB/dev (mesh) | peak GB (1 H100) | fits | dominant | "
              "bound ms | useful | roofline |\n"
              "|---|---|---|---|---|---|---|---|---|---|---|---|---|")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
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
    rules = get_rules(args.rules) if args.rules else None
    rows, failures = [], []
    for arch in archs:
        cfg = get_config(arch)
        names = [args.shape] if args.shape else \
            [s.name for s in shapes_for(cfg)]
        for shape_name in names:
            shape = get_shape(shape_name)
            for mp in meshes:
                label = (f"{arch} x {shape_name} x "
                         f"{'2x16x16' if mp else '16x16'}")
                try:
                    art = report_cell(cfg, shape, multi_pod=mp,
                                      microbatches=args.microbatches,
                                      rules=rules, kv_quant=args.kv_quant,
                                      remat=args.remat, tops=args.tops,
                                      hbm_bytes=hbm)
                    if args.measure:
                        art["measured"] = m = measure_cell(
                            cfg, shape, art["device_batch"],
                            art["microbatches"], args.measure_device)
                        check_measure(m)
                    os.makedirs(args.out, exist_ok=True)
                    fn = os.path.join(args.out, f"{arch}__{shape_name}__"
                                      f"{'multipod' if mp else 'pod'}.json")
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
