#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit from ``nvidia-smi``; no
   CUDA card means exit 1 with no result;
2. build: every kernel of the serving path compiled with ``nvcc`` for
   ``sm_90a`` from the sources in this checkout, all at once;
3. kernels against their plain PyTorch versions on the card: the
   flash-attention forward over the reference's sweep plus the serving
   path's shape, f32 (atol 3e-5) and bf16 (atol 3e-2), lse atol 1e-4 on
   rows with an allowed key, and exact zeros on rows with none;
4. the main path: yi-6b at full width (32 layers, bf16, random weights
   from a seeded generator) serves 4 requests of 512 prompt tokens and 32
   new tokens through ``ServeEngine.generate``, committing its KV cache to
   an in-process iCheck cluster.  The kernel launch counts are set to 0 just
   before and read just after: one flash-attention launch per layer.  The
   restored cache must equal a second prefill's bit for bit, and decoding
   from it must give the live run's tokens.  A 2-layer cut of the same
   model in f32 is held against the plain CPU path on a short prompt;
5. numbers: prefill and decode times, tokens/s, commit and restore wall
   seconds, peak device memory, a ``torch.profiler`` window over one
   prefill and over 8 decode steps (device busy time, idle share, top
   kernels and host ops), and the ``kernels`` line (kernel, plain and SDPA
   times at the path's shape, and the bound).

The last line is ``{"ok": true, "device": {...}}``.  f32 matmuls run in full
f32 (``allow_tf32`` is False).  Times are CUDA-event times of warm calls
unless named wall times; the inputs of a kernel timing fit in L2.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the sweep of tests/test_kernels_attention.py; (b, hq, hkv, t, s, d,
# causal, window)
SWEEP = [
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 1, 100, 100, 32, True, None),
    (1, 4, 4, 64, 64, 128, False, None),
    (2, 4, 2, 96, 96, 32, True, 32),
    (1, 2, 1, 1, 160, 64, True, None),
    (1, 2, 2, 72, 200, 32, True, None),
]
BATCH, PROMPT, GEN = 4, 512, 32
ATOL = {"float32": 3e-5, "bfloat16": 3e-2}
LSE_ATOL = 1e-4
# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0))


def profile_window(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the summed
    time of the kernels the card ran (its busy time), the idle share, the
    kernels by device time and the host ops by self CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=_device_us, reverse=True)
    host = sorted((e for e in events if e.device_type != DeviceType.CUDA),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
        "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0
        else "not measured",
        "kernels": [[e.key[:70], _device_us(e) / 1e3, e.count]
                    for e in kernels[:top]],
        "host_ops": [[e.key[:70], e.self_cpu_time_total / 1e3, e.count]
                     for e in host[:top]],
    }


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------
def build_kernels():
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    builders = {"flash_fwd": fa_kernel.build}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {n: pool.submit(b) for n, b in builders.items()}
        for f in futures.values():
            f.result()
    log(f"build: {len(builders)} kernel(s) in "
        f"{time.monotonic() - t0:.2f} s wall")
    for name in builders:
        log(f"  {name}: nvcc {common.build_seconds.get(name, 0.0):.2f} s")
        for line in common.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def _inputs(seed, b, hq, hkv, t, s, d, dtype, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to(device, getattr(torch, dtype))
        for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))


def check_attention_case(case, dtype, device) -> float:
    """Kernel against plain on one case; returns the max abs error of the
    output over rows with an allowed key."""
    import torch

    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, dtype, device)
    out, lse = attention(q, k, v, causal=causal, window=window,
                         return_lse=True)
    ref, rlse = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    live = allowed_mask(t, s, causal, window, s - t, device).any(dim=1)
    err = (out.float() - ref.float())[:, :, live].abs().max().item()
    lerr = (lse - rlse)[:, :, live].abs().max().item()
    if not (err <= ATOL[dtype] and lerr <= LSE_ATOL):
        raise AssertionError(f"flash_fwd {case} {dtype}: max abs err {err} "
                             f"(atol {ATOL[dtype]}), lse err {lerr} "
                             f"(atol {LSE_ATOL})")
    return err


def check_kernels(path_case, device) -> float:
    """Every case of the sweep and the path's shape, both dtypes; returns
    the max abs error at the path's shape in bf16."""
    import torch

    from repro_torch.kernels.flash_attention import attention

    path_err = None
    for case in SWEEP + [path_case]:
        for dtype in ("float32", "bfloat16"):
            err = check_attention_case(case, dtype, device)
            log(f"  flash_fwd {case} {dtype}: max abs err {err:.3e}")
            if case == path_case and dtype == "bfloat16":
                path_err = err
    # T > S: the first T - S query rows see no key and must be exact zeros
    q, k, v = _inputs(3, 2, 4, 2, 96, 40, 128, "bfloat16", device)
    out, lse = attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    if not (torch.all(out[:, :, :56] == 0)
            and torch.all(torch.isneginf(lse[:, :, :56]))):
        raise AssertionError("rows without an allowed key are not zero")
    log("  flash_fwd T=96 > S=40: rows without an allowed key are zeros")
    return path_err


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------
def serve_main_path(cfg, params, device, batch_size=BATCH, prompt=PROMPT,
                    gen=GEN, n_layers_launch=None):
    """Serve one batch with iCheck checkpointing and check the restore.
    Returns a dict of counts and wall times."""
    import numpy as np
    import torch

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.core.snapshot import snapshot_pytree
    from repro_torch.serve import ServeEngine, serve_max_len

    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (batch_size, prompt))
             .astype(np.int32)}
    max_len = serve_max_len(cfg, prompt, gen)
    engine = ServeEngine(cfg, params, max_len=max_len, device=device)
    res = {"kv_cache_bytes": 2 * cfg.num_layers * batch_size
           * cfg.num_kv_heads * max_len * cfg.resolved_head_dim
           * torch.finfo(getattr(torch, cfg.dtype)).bits // 8}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)

        fa_kernel.launches = 0
        sync()
        t0 = time.monotonic()
        out = engine.generate(batch, gen_len=gen, checkpoint_client=client)
        sync()
        res["generate_s"] = time.monotonic() - t0
        res["launches"] = {"flash_fwd": fa_kernel.launches}
        if n_layers_launch is not None and \
                fa_kernel.launches != n_layers_launch:
            raise AssertionError(f"flash_fwd launched {fa_kernel.launches} "
                                 f"times in prefill, want {n_layers_launch}")
        if out.shape != (batch_size, gen) or out.min() < 0 or \
                out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad tokens {out.shape} "
                                 f"[{out.min()}, {out.max()}]")
        t0 = time.monotonic()
        engine.last_commit.wait(timeout=600)
        res["commit_wait_s"] = time.monotonic() - t0

        t0 = time.monotonic()
        restored = engine.restore_serving_state(client, batch_size)
        sync()
        res["restore_s"] = time.monotonic() - t0

        sync()
        t0 = time.monotonic()
        logits, fresh = engine.prefill(batch)
        sync()
        res["prefill_ms"] = (time.monotonic() - t0) * 1e3
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        kv_r, kv_f = restored["stack"]["b0"]["self"], fresh["stack"]["b0"][
            "self"]
        for name, got, want in (("k", kv_r.k, kv_f.k), ("v", kv_r.v, kv_f.v),
                                ("idx", restored["idx"], fresh["idx"])):
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"restored {name} differs from a "
                                     f"second prefill")

        sync()
        t0 = time.monotonic()
        cont = engine.decode_greedy(restored, out[:, :1], gen - 1)
        res["decode_ms_per_token"] = (time.monotonic() - t0) * 1e3 / (gen - 1)
        if not np.array_equal(cont, out[:, 1:]):
            raise AssertionError("decode from the restored cache diverged")

        # a second commit of a cache of the same size, timed end to end:
        # snapshot (D2H), register, commit, wait until it lands in L1
        t0 = time.monotonic()
        snap = snapshot_pytree(fresh, step=1)
        client.add_adapt_snapshot(snap)
        client.commit(1, {n: r.parts for n, r in snap.regions.items()}
                      ).wait(timeout=600)
        res["commit_s"] = time.monotonic() - t0
        if device.type == "cuda":
            # where the time goes, with the cluster's threads alive as in
            # the timed run: one prefill, then 8 decode steps
            res["profile_prefill"] = profile_window(
                lambda: engine.prefill(batch))
            _, cache = engine.prefill(batch)
            res["profile_decode_8"] = profile_window(
                lambda: engine.decode_greedy(cache, out[:, :1], 8))
        client.finalize()
    # decode again once the cluster's threads have stopped
    _, cache = engine.prefill(batch)
    sync()
    t0 = time.monotonic()
    engine.decode_greedy(cache, out[:, :1], gen - 1)
    res["decode_ms_per_token_no_cluster"] = \
        (time.monotonic() - t0) * 1e3 / (gen - 1)
    res["tokens"] = out
    return res


def check_against_plain(cfg, params, device):
    """A 2-layer cut of the model in f32: the card's prefill logits (the
    kernel) against the plain CPU path's, on a short prompt."""
    import numpy as np
    import torch

    from repro_torch.models import init_cache, prefill

    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    cut = {k: v for k, v in params.items() if k != "stack"}
    cut["stack"] = {"b0": _map(lambda t: t[:2], params["stack"]["b0"])}
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    logits = {}
    for dev in (device, torch.device("cpu")):
        p = _map(lambda t: t.to(dev), cut)
        cache = init_cache(small, 2, 64, device=dev)
        with torch.no_grad():
            lg, _ = prefill(small, p, {"tokens": torch.from_numpy(toks)
                                       .to(dev)}, cache)
        logits[dev.type] = lg.float().cpu()
    err = (logits[device.type] - logits["cpu"]).abs().max().item()
    if not err <= 1e-3:
        raise AssertionError(f"2-layer f32 logits: card vs plain CPU max abs "
                             f"err {err} (atol 1e-3)")
    return err


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# phase 5: kernel numbers at the path's shape
# --------------------------------------------------------------------------
def attention_numbers(path_case, device):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = path_case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    scale = d ** -0.5
    ms = cuda_ms(lambda: flash_attention_cuda(
        q, k, v, causal=causal, window=window, scale=scale))
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=causal,
                                             window=window), iters=5)
    # yardstick only, never called by the port; at T = S its top-left
    # causal alignment equals the reference's bottom-right one
    try:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
    except TypeError:        # a torch without enable_gqa
        g = hq // hkv
        ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=causal))
    pairs = int(allowed_mask(t, s, causal, window, s - t).sum())
    flops = 4 * b * hq * d * pairs             # Q.K^T and P.V, 2 per MAC
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + b * hq * t * 4                       # out bf16, lse f32
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("yi-6b")
    path_case = (BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT, PROMPT,
                 cfg.resolved_head_dim, True, cfg.window)

    log("phase 2: build")
    build_kernels()
    torch.cuda.synchronize()

    log("phase 3: kernels against their plain versions")
    path_err = check_kernels(path_case, device)
    torch.cuda.synchronize()

    log(f"phase 4: main path, {cfg.name} {cfg.num_layers} layers "
        f"d_model {cfg.d_model} {cfg.dtype}, {BATCH} x {PROMPT} prompt "
        f"tokens, {GEN} new tokens")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize()
    log(f"  params: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
        f"f32 in {time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = serve_main_path(cfg, params, device,
                          n_layers_launch=cfg.num_layers)
    torch.cuda.synchronize()
    log(f"  launches in the main path: {res['launches']}")
    log(f"  KV cache {res['kv_cache_bytes']} bytes; restored cache equals a "
        f"second prefill bit for bit; {GEN - 1} decode steps from it give "
        f"the live tokens")
    plain_err = check_against_plain(cfg, params, device)
    log(f"  2-layer f32 cut: card vs plain CPU logits max abs err "
        f"{plain_err:.3e}")
    torch.cuda.synchronize()

    log("phase 5: numbers")
    num = attention_numbers(path_case, device)
    torch.cuda.synchronize()
    serve = {
        "card": card,
        "prefill_ms": res["prefill_ms"],
        "decode_ms_per_token": res["decode_ms_per_token"],
        "decode_ms_per_token_no_cluster":
            res["decode_ms_per_token_no_cluster"],
        "output_tokens_per_s": BATCH * GEN / res["generate_s"],
        "generate_wall_s": res["generate_s"],
        "commit_wall_s": res["commit_s"],
        "restore_wall_s": res["restore_s"],
        "kv_cache_bytes": res["kv_cache_bytes"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "attention_flops": num["flops"], "attention_bytes": num["bytes"],
    }
    log(json.dumps({"serve": serve}))
    for name in ("profile_prefill", "profile_decode_8"):
        log(json.dumps({name: res[name]}))
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:95",
        "launches": res["launches"]["flash_fwd"],
        "max_abs_err": path_err, "ms": num["ms"],
        "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
        "bound_by": num["bound_by"], "library_ms": num["library_ms"],
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
