#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit from ``nvidia-smi``; no
   CUDA card means exit 1 with no result;
2. build: every kernel library (flash-attention forward and backward, the
   checkpoint codec, the RWKV-6 recurrence, the Reed-Solomon encode)
   compiled with ``nvcc`` for ``sm_90a`` from the sources in this
   checkout, all at once;
3. kernels against their plain PyTorch versions on the card:
   * the flash-attention forward over the reference's sweep plus the
     serving path's shape, f32 (atol 3e-5) and bf16 (atol 3e-2), lse atol
     1e-4 on rows with an allowed key, and exact zeros on rows with none;
   * the flash-attention backward over the same sweep plus the training
     path's shape, from the same (q, k, v, out, lse, do): dq, dk, dv within
     f32 atol 1e-4 + rtol 1e-4, bf16 atol 1e-3 + rtol 2^-7; two runs
     bit-equal;
   * the codec K1-K3 over n in {1, 255, 256, 257, 4096, 100000, the
     training path's largest leaf} x f32/bf16/f16: codes, deltas, scales
     and dequantized values bit-equal (0 mismatches);
   * the RWKV-6 recurrence K6 over the reference's sweep plus the serving
     path's prefill (4, 64, 512, 64) and decode (4, 64, 1, 64) shapes, from
     a carried state, f32 and bf16 r/k/v, against the plain chunked
     version: atol 2e-3 (the reference's kernel tests), plus rtol 2^-7 on
     a bf16 o; log_w below -30 (clamped); [0, T/2) then [T/2, T) equal to
     one shot within atol 1e-5;
4. the serving path: yi-6b at full width (32 layers, bf16, random weights
   from a seeded generator) serves 4 requests of 512 prompt tokens and 32
   new tokens through ``ServeEngine.generate``, committing its KV cache to
   an in-process iCheck cluster.  The kernel launch counts are set to 0 just
   before and read just after: one flash-attention launch per layer.  The
   restored cache must equal a second prefill's bit for bit, and decoding
   from it must give the live run's tokens.  A 2-layer cut of the same
   model in f32 is held against the plain CPU path on a short prompt; then
   the serving numbers, and the weights are freed;
4b. the same serving path for rwkv6-7b at full width (32 layers, d_model
   4096, 64 heads of 64, d_ff 14336, vocab 65536, bf16, 7,551,455,232
   params): K6 must run 32 times in prefill and 32 x 31 times in the
   decode steps of ``generate``; the committed recurrent state (136,314,884
   bytes whatever the prompt's length) is restored bit-equal to a second
   prefill's, and decoding from it gives the live tokens; a 2-layer f32 cut
   against the plain CPU path; then the weights are freed;
4c. the Reed-Solomon encode K5, bit for bit against the numpy host codec
   (``rs.rs_encode_np``): k in {1, 2, 4, 8} x m in {1, 2} x unaligned
   strides, and k = 4, m = 2 over the RWKV state's bytes split as
   ``rs.split_rows`` splits them (stride 34,078,721).  No serving or
   training path runs K5 (the copied service encodes on the host), so its
   launches are this check's;
5. the training path: ``ElasticTrainer`` trains qwen2.5-3b at full width
   (36 layers, d_model 2048, bf16 compute, f32 master weights, full remat)
   on 4096-token sequences, global batch 1 (cut from 256), 6 steps with a
   q8-delta commit every 2 (keyframe, delta, delta) encoded on the card, 2
   more steps as the uninterrupted reference; a fresh trainer restarts from
   the agents, step and data state restored and every float leaf equal to
   its committed codes (which lie within absmax/127 * 0.51 per block of
   the state at commit), and trains 2 steps.  Counts are set to 0 before
   and read after the 6 steps and their commits;
6. a second training phase at full width cut to 8 layers: int8 gradient
   compression (K1 + K3 in every step) and a 1 -> 2 logical-rank resize
   with ``overlap_resize``;
7. numbers: the serving lines (yi-6b, rwkv6-7b), step ms, tokens/s,
   ``mfu``, commit and restart wall seconds,
   bytes on the wire, peak device memory, host RSS, a ``torch.profiler``
   window over one training step, and the ``kernels`` line (each kernel's
   launches on the path named in ``launches_path``, its time, its plain
   version's, the bound, a library yardstick where one
   PyTorch call computes the same function).

The last line is ``{"ok": true, "device": {...}}``.  f32 matmuls run in full
f32 (``allow_tf32`` is False).  Times are CUDA-event times of warm calls
unless named wall times.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the training path's state nearly fills the card: let the allocator grow
# segments instead of fragmenting (read when torch first touches the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

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
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2 ** -7)}
# the training path: qwen2.5-3b, one 4096-token sequence a step
TRAIN_SEQ, TRAIN_STEPS, COMMIT_EVERY, CUT_LAYERS = 4096, 6, 2, 8
CODEC_NS = [1, 255, 256, 257, 4096, 100_000]
# the sweep of tests/test_kernels_rwkv6.py plus the serving path's prefill
# and decode shapes; (b, h, t, d)
RWKV_SWEEP = [(2, 3, 130, 64), (1, 2, 64, 32), (1, 1, 7, 16)]
RWKV_TOL = {"float32": (2e-3, 0.0), "bfloat16": (2e-3, 2 ** -7)}
RS_STRIDES = [1, 15, 33, 4097, 100_003]
CODEC_DTYPES = ("float32", "bfloat16", "float16")
# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores


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
    from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
    from repro_torch.kernels.ckpt_codec import rs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv_kernel

    builders = {"flash_fwd": fa_kernel.build, "flash_bwd": fa_kernel.build_bwd,
                "ckpt_codec": codec_kernel.build, "rwkv6": rwkv_kernel.build,
                "rs": rs_kernel.build}
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
def _check_launches(got: dict, want, what: str) -> None:
    """Each kernel named in ``want`` launched exactly that many times."""
    for name, n in (want or {}).items():
        if got[name] != n:
            raise AssertionError(f"{name} launched {got[name]} times in "
                                 f"{what}, want {n}")


def serve_main_path(cfg, params, device, batch_size=BATCH, prompt=PROMPT,
                    gen=GEN, want=None):
    """Serve one batch with iCheck checkpointing and check the restore.
    ``want`` maps "generate", "prefill" and "decode" (the gen - 1 steps
    from the restored state) to the launches each must count, by kernel.
    Returns a dict of counts and wall times."""
    import numpy as np
    import torch

    from repro_torch.core import ICheckClient, ICheckCluster
    from repro_torch.core.snapshot import _flatten, _leaf_name, snapshot_pytree
    from repro_torch.serve import ServeEngine, serve_max_len

    want = want or {}
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (batch_size, prompt))
             .astype(np.int32)}
    max_len = serve_max_len(cfg, prompt, gen)
    engine = ServeEngine(cfg, params, max_len=max_len, device=device)
    res = {}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)

        reset_counts()
        sync()
        t0 = time.monotonic()
        out = engine.generate(batch, gen_len=gen, checkpoint_client=client)
        sync()
        res["generate_s"] = time.monotonic() - t0
        res["launches"] = read_counts()
        _check_launches(res["launches"], want.get("generate"), "generate")
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

        reset_counts()
        sync()
        t0 = time.monotonic()
        logits, fresh = engine.prefill(batch)
        sync()
        res["prefill_ms"] = (time.monotonic() - t0) * 1e3
        _check_launches(read_counts(), want.get("prefill"), "prefill")
        if not torch.isfinite(logits).all():
            raise AssertionError("prefill logits are not finite")
        got_leaves, want_leaves = list(_flatten(restored)), list(
            _flatten(fresh))
        if [p for p, _ in got_leaves] != [p for p, _ in want_leaves]:
            raise AssertionError("restored state has other leaves than a "
                                 "second prefill's")
        for (path, got), (_, exp) in zip(got_leaves, want_leaves):
            if got.dtype != exp.dtype or not torch.equal(got, exp):
                raise AssertionError(f"restored {_leaf_name(path)} differs "
                                     f"from a second prefill")
        res["state_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in want_leaves)
        res["state_leaves"] = {_leaf_name(p): list(t.shape)
                               for p, t in want_leaves}

        reset_counts()
        sync()
        t0 = time.monotonic()
        cont = engine.decode_greedy(restored, out[:, :1], gen - 1)
        res["decode_ms_per_token"] = (time.monotonic() - t0) * 1e3 / (gen - 1)
        _check_launches(read_counts(), want.get("decode"), "decode")
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
        # the committed bytes, region after region, for K5's check
        res["state_payload"] = np.concatenate(
            [r.parts[0].reshape(-1).view(np.uint8)
             for r in snap.regions.values()])
        del snap
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


# --------------------------------------------------------------------------
# phase 3b: the backward and codec kernels against their plain versions
# --------------------------------------------------------------------------
def check_bwd_case(case, dtype, device, determinism=False) -> float:
    """Backward kernel against the plain backward from the same (q, k, v,
    out, lse, do); returns the max abs error over dq, dk, dv."""
    import torch

    from repro_torch.kernels.flash_attention import attention_bwd_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, dtype, device)
    dout = _inputs(8, b, hq, hkv, t, s, d, dtype, device)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    want = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    atol, rtol = BWD_TOL[dtype]
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        err = max(err, diff.max().item())
        if not bool((diff <= atol + rtol * w.float().abs()).all()):
            raise AssertionError(f"flash_bwd {case} {dtype} {name}: max abs "
                                 f"err {diff.max().item()} (atol {atol}, "
                                 f"rtol {rtol})")
    if determinism:
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_bwd {case} {dtype}: two runs differ")
    return err


def check_bwd(path_case, device) -> float:
    """The sweep and the training path's shape, both dtypes; returns the
    max abs error at the path's shape in bf16."""
    path_err = None
    for case in SWEEP + [path_case]:
        for dtype in ("float32", "bfloat16"):
            err = check_bwd_case(case, dtype, device,
                                 determinism=case == path_case)
            log(f"  flash_bwd {case} {dtype}: max abs err {err:.3e}")
            if case == path_case and dtype == "bfloat16":
                path_err = err
    log("  flash_bwd: two runs at the path's shape are bit-equal")
    return path_err


def _codec_input(n, dtype, device, seed):
    import numpy as np
    import torch

    if n <= 1 << 20:
        x = np.random.default_rng(seed + n).standard_normal(n) \
            .astype(np.float32) * 3
        return torch.from_numpy(x).to(device, getattr(torch, dtype))
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, generator=g, device=device) \
        .mul_(0.02).to(getattr(torch, dtype))


def check_codec(ns, device) -> int:
    """K1-K3 against their plain versions; returns the total number of
    mismatching codes, deltas, scales and values (must be 0)."""
    import torch

    from repro_torch.kernels.ckpt_codec import kernel as K
    from repro_torch.kernels.ckpt_codec import ref as R
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    total = 0
    for n in ns:
        for dtype in CODEC_DTYPES:
            x = _codec_input(n, dtype, device, 0)
            b0 = _to_blocks(x)[0]
            q, s = K.quantize_cuda(b0)
            rq, rs = R.quantize_ref(b0)
            bad = int((q != rq).sum()) + int((s != rs).sum())
            del b0, x, rs
            x1 = _codec_input(n, dtype, device, 1)
            b1 = _to_blocks(x1)[0]
            del x1
            d, s1, q1 = K.quantize_delta_cuda(b1, q)
            rd, rs1, rq1 = R.quantize_delta_ref(b1, rq)
            del b1, rq
            bad += int((d != rd).sum()) + int((s1 != rs1).sum()) \
                + int((q1 != rq1).sum())
            del d, rd, rs1, rq1, q
            for out_dtype in (torch.float32, getattr(torch, dtype)):
                y = K.dequantize_cuda(q1, s1, out_dtype)
                ry = R.dequantize_ref(q1, s1, out_dtype)
                bad += int((y != ry).sum())
                del y, ry
            torch.cuda.synchronize()
            del q1, s1
            log(f"  codec n={n} {dtype}: {bad} mismatches (codes, deltas, "
                f"scales, values)")
            total += bad
    if total:
        raise AssertionError(f"codec kernels: {total} mismatches")
    return total


# --------------------------------------------------------------------------
# phase 3 / 4b / 4c: K6 against its plain version, RWKV-6 serving, K5
# --------------------------------------------------------------------------
def _rwkv_inputs(seed, case, dtype, device, decay_scale=1.0):
    """r/k/v (dtype), log_w, u, s0 (f32) for one (b, h, t, d) case, made
    with numpy from ``seed`` as tests/test_kernels_rwkv6.py makes them."""
    import numpy as np
    import torch

    b, h, t, d = case
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    r, k, v = (f((b, h, t, d), 0.5).to(getattr(torch, dtype))
               for _ in range(3))
    lw = -torch.exp(f((b, h, t, d), 1.0)) * decay_scale
    return r, k, v, lw, f((h, d), 0.5), f((b, h, d, d), 0.1)


def _rwkv_err(got, want, dtype, what) -> float:
    import torch

    atol, rtol = RWKV_TOL[dtype]
    err = 0.0
    for name, g, w in (("o", *[x[0].float() for x in (got, want)]),
                       ("sT", got[1], want[1])):
        diff = (g - w).abs()
        err = max(err, diff.max().item())
        tol = atol + (rtol if name == "o" else 0.0) * w.abs()
        if not bool(torch.all(diff <= tol)):
            raise AssertionError(f"rwkv6 {what} {name}: max abs err "
                                 f"{diff.max().item()} (atol {atol}, rtol "
                                 f"{rtol if name == 'o' else 0})")
    return err


def check_rwkv6(path_cases, device) -> float:
    """K6 against its plain chunked version on the card: the sweep and the
    path's shapes from a carried state (T = 1 at decode), both dtypes,
    extreme decay, and a state continuation; returns the max abs error at
    the prefill shape in bf16."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda

    path_err = None
    for case in RWKV_SWEEP + list(path_cases.values()):
        for dtype in ("float32", "bfloat16"):
            inputs = _rwkv_inputs(3, case, dtype, device)
            got = rwkv6_cuda(*inputs)
            again = rwkv6_cuda(*inputs)
            want = rwkv6_chunked(*inputs)
            torch.cuda.synchronize()
            err = _rwkv_err(got, want, dtype, f"{case} {dtype}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"rwkv6 {case} {dtype}: two runs differ")
            log(f"  rwkv6 {case} {dtype}: max abs err {err:.3e}")
            if case == path_cases["prefill"] and dtype == "bfloat16":
                path_err = err
    for scale in (10.0, 100.0):
        inputs = _rwkv_inputs(4, (1, 2, 96, 32), "float32", device, scale)
        if not bool((inputs[3] < -30).any()):
            raise AssertionError("the extreme-decay case has no log_w < -30")
        got = rwkv6_cuda(*inputs)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()):
            raise AssertionError(f"rwkv6 decay x{scale}: not finite")
        err = _rwkv_err(got, rwkv6_chunked(*inputs, chunk=32), "float32",
                        f"decay x{scale}")
        log(f"  rwkv6 (1, 2, 96, 32) log_w x{scale} (below -30, clamped): "
            f"max abs err {err:.3e}")
    r, k, v, lw, u, s0 = _rwkv_inputs(5, path_cases["prefill"], "float32",
                                      device)
    o, s = rwkv6_cuda(r, k, v, lw, u, s0)
    h = r.shape[2] // 2
    o1, s1 = rwkv6_cuda(*(x[:, :, :h].contiguous() for x in (r, k, v, lw)),
                        u, s0)
    o2, s2 = rwkv6_cuda(*(x[:, :, h:].contiguous() for x in (r, k, v, lw)),
                        u, s1)
    err = max((torch.cat([o1, o2], 2) - o).abs().max().item(),
              (s2 - s).abs().max().item())
    if not err <= 1e-5:
        raise AssertionError(f"rwkv6 continuation: max abs err {err}")
    log(f"  rwkv6 [0, T/2) then [T/2, T) vs one shot at "
        f"{path_cases['prefill']}: max abs err {err:.3e} (atol 1e-5)")
    return path_err


def rwkv6_numbers(case, device) -> dict:
    """K6 at one of the path's shapes (bf16 r/k/v): its time, its plain
    version's, and its bound: each input read once and each output written
    once, or 5 f32 operations per state element per token (the decay's
    multiply-add, k v's product, r S's multiply-add) at the f32 rate."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda

    b, h, t, d = case
    inputs = _rwkv_inputs(3, case, "bfloat16", device)
    ms = cuda_ms(lambda: rwkv6_cuda(*inputs))
    plain_ms = cuda_ms(lambda: rwkv6_chunked(*inputs), iters=3, warmup=1)
    nbytes = b * h * t * d * (3 * 2 + 4 + 2) + h * d * 4 \
        + 2 * b * h * d * d * 4
    flops = 5 * b * h * t * d * d
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def serve_rwkv6_phase(rcfg, device, card) -> dict:
    """rwkv6-7b at full width through ``serve_main_path``: K6's launches
    asserted (32 a prefill, 32 x 31 in the decode steps), the 2-layer f32
    cut against the plain CPU path, K6's numbers; prints the
    ``serve_rwkv6`` line and the profile windows, frees the weights.
    Returns the launches, numbers and the committed state's bytes."""
    import torch

    from repro_torch.models import count_params, init_params

    n_params = count_params(rcfg)
    if n_params != 7_551_455_232:
        raise AssertionError(f"{rcfg.name}: {n_params} params")
    n = rcfg.num_layers
    t0 = time.monotonic()
    params = init_params(rcfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize()
    log(f"  params: {n_params} f32 in {time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = serve_main_path(rcfg, params, device, want={
        "generate": {"rwkv6": n + n * (GEN - 1), "flash_fwd": 0},
        "prefill": {"rwkv6": n},
        "decode": {"rwkv6": n * (GEN - 1)}})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the main path: {res['launches']}")
    log(f"  recurrent state {res['state_bytes']} bytes "
        f"{json.dumps(res['state_leaves'])}; restored state equals a second "
        f"prefill bit for bit; {GEN - 1} decode steps from it give the live "
        f"tokens")
    plain_err = check_against_plain(rcfg, params, device)
    log(f"  2-layer f32 cut: card vs plain CPU logits max abs err "
        f"{plain_err:.3e}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rh = rcfg.d_model // rcfg.rwkv_head_dim
    numbers = {name: rwkv6_numbers((BATCH, rh, t, rcfg.rwkv_head_dim),
                                   device)
               for name, t in (("prefill", PROMPT), ("decode", 1))}
    serve = {
        "card": card, "params": n_params,
        "prefill_ms": res["prefill_ms"],
        "decode_ms_per_token": res["decode_ms_per_token"],
        "decode_ms_per_token_no_cluster":
            res["decode_ms_per_token_no_cluster"],
        "output_tokens_per_s": BATCH * GEN / res["generate_s"],
        "generate_wall_s": res["generate_s"],
        "commit_wall_s": res["commit_s"],
        "commit_wait_s": res["commit_wait_s"],
        "restore_wall_s": res["restore_s"],
        "state_bytes": res["state_bytes"],
        "max_memory_allocated": peak,
        "plain_cut_max_abs_err": plain_err,
        "rwkv6_prefill_shape": numbers["prefill"],
        "rwkv6_decode_shape": numbers["decode"],
    }
    log(json.dumps({"serve_rwkv6": serve}))
    for name in ("profile_prefill", "profile_decode_8"):
        log(json.dumps({f"rwkv6_{name}": res[name]}))
    return {"launches": res["launches"], "numbers": numbers,
            "state_payload": res["state_payload"]}


def check_rs(device, payload) -> dict:
    """K5 bit for bit against ``rs.rs_encode_np``: k in {1, 2, 4, 8}, m in
    {1, 2}, unaligned strides, then k = 4, m = 2 over ``payload`` split as
    ``rs.split_rows`` splits it.  Counts are set to 0 before and read
    after; then K5's numbers on the payload."""
    import numpy as np
    import torch

    from repro_torch.kernels.ckpt_codec import (rs_encode, rs_encode_np,
                                                split_rows)
    from repro_torch.kernels.ckpt_codec.rs_kernel import (rs_encode_cuda,
                                                          rs_encode_ref)

    bad = 0
    reset_counts()
    for k in (1, 2, 4, 8):
        for m in (1, 2):
            for n in RS_STRIDES:
                data = np.random.default_rng(10 * k + n).integers(
                    0, 256, (k, n), dtype=np.uint8)
                got = rs_encode(torch.from_numpy(data).to(device), m=m)
                bad += int((got.cpu().numpy() != rs_encode_np(data, m))
                           .sum())
    log(f"  rs_encode k in (1, 2, 4, 8) x m in (1, 2) x strides "
        f"{RS_STRIDES}: {bad} mismatching bytes")
    rows = split_rows(payload.tobytes(), 4)
    dev = torch.from_numpy(rows).to(device)
    got = rs_encode(dev, m=2)
    state_bad = int((got.cpu().numpy() != rs_encode_np(rows, 2)).sum())
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"  rs_encode k=4 m=2 over the {payload.size}-byte RWKV state "
        f"(stride {rows.shape[1]}): {state_bad} mismatching bytes")
    bad += state_bad
    if bad:
        raise AssertionError(f"rs_encode: {bad} bytes differ from the host "
                             f"codec")
    nbytes = (rows.shape[0] + 2) * rows.shape[1]
    numbers = {"k": 4, "m": 2, "stride": int(rows.shape[1]),
               "ms": cuda_ms(lambda: rs_encode_cuda(dev, 2)),
               "plain_ms": cuda_ms(lambda: rs_encode_ref(dev, 2), iters=2,
                                   warmup=1),
               "library_ms": None,
               "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
               "bound_by": "bytes", "bytes": nbytes}
    return {"launches": launches, "mismatches": bad, "numbers": numbers}


# --------------------------------------------------------------------------
# phase 5/6: the training path
# --------------------------------------------------------------------------
def reset_counts() -> None:
    from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
    from repro_torch.kernels.ckpt_codec import rs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv_kernel

    fa_kernel.launches = 0
    fa_kernel.bwd_launches = 0
    for name in codec_kernel.launches:
        codec_kernel.launches[name] = 0
    rwkv_kernel.launches = 0
    rs_kernel.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
    from repro_torch.kernels.ckpt_codec import rs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv_kernel

    return {"flash_fwd": fa_kernel.launches,
            "flash_bwd": fa_kernel.bwd_launches, **codec_kernel.launches,
            "rwkv6": rwkv_kernel.launches, "rs_encode": rs_kernel.launches}


def _float_leaves(tree):
    from repro_torch.core.snapshot import _flatten, _leaf_name

    return [(_leaf_name(path), t) for path, t in _flatten(tree)
            if t.is_floating_point()]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def committed_codes(trainer) -> dict:
    """Each float leaf's chain head: (device codes, host scales)."""
    out = {}
    for name, _ in _float_leaves(trainer.state):
        st = trainer.client.delta_chain_lookup(name, 1).parts[0]
        out[name] = (st.codes_dev, st.scales)
    return out


def check_commit_bound(trainer, codes, device, rows=1 << 20) -> float:
    """Every float leaf within absmax/127 * 0.51 per block of its committed
    codes; returns the worst error / bound ratio."""
    import torch

    from repro_torch.kernels.ckpt_codec import dequantize
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    worst = 0.0
    with torch.no_grad():
        for name, leaf in _float_leaves(trainer.state):
            q, scales = codes[name]
            scales = torch.from_numpy(scales).to(device)
            blocks = _to_blocks(leaf)[0]
            for i in range(0, blocks.shape[0], rows):
                x = blocks[i:i + rows].float()
                y = dequantize(q[i:i + rows], scales[i:i + rows], x.shape)
                bound = x.abs().amax(1) / 127 * 0.51 + 1e-12
                ratio = ((y - x).abs().amax(1) / bound).max().item()
                worst = max(worst, ratio)
                if ratio > 1:
                    raise AssertionError(f"{name}: committed codes off by "
                                         f"{ratio:.3f} of the bound")
    return worst


def check_restored(trainer, codes, device, rows=1 << 20) -> None:
    """Every restored float leaf equals its committed codes dequantized,
    bit for bit."""
    import torch

    from repro_torch.kernels.ckpt_codec import dequantize
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    with torch.no_grad():
        for name, leaf in _float_leaves(trainer.state):
            q, scales = codes[name]
            scales = torch.from_numpy(scales).to(device)
            blocks = _to_blocks(leaf)[0]
            for i in range(0, blocks.shape[0], rows):
                y = dequantize(q[i:i + rows], scales[i:i + rows],
                               blocks[i:i + rows].shape, leaf.dtype)
                if not torch.equal(y, blocks[i:i + rows]):
                    raise AssertionError(f"{name}: restored values differ "
                                         f"from the committed codes")


def host_rss() -> dict:
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return {"rss_bytes": pages * os.sysconf("SC_PAGE_SIZE"),
            "max_rss_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


def train_main_path(cfg, device, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                    commit_every=COMMIT_EVERY, node_memory=48 << 30,
                    profile=False) -> dict:
    """ElasticTrainer with q8-delta commits, then a restart from the agents.
    Returns counts, losses, wall times and commit records."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ICheckCluster
    from repro_torch.core import events as E
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import ElasticTrainer

    shape = ShapeConfig("train_4k_1", "train", seq, 1)
    res = {"commits": [], "step_ms": []}
    pfs = tempfile.mkdtemp(prefix="chip-smoke-pfs-")
    res["pfs_free_bytes"] = shutil.disk_usage(pfs).free
    log(f"  PFS {pfs}: {res['pfs_free_bytes']} bytes free")
    kw = dict(app_id="train", seed=0, opt_cfg=AdamWConfig(), commit_every=0,
              probe_every=0, total_steps=100, codec="q8-delta",
              device=device)
    try:
        with ICheckCluster(n_icheck_nodes=2, n_spare_nodes=0,
                           node_memory=node_memory, keep_l1=1,
                           pfs_root=pfs, adaptive_interval=False) as cluster:
            records = []
            cluster.bus.subscribe(
                lambda ev: records.append(dict(ev.payload)),
                events=(E.CKPT_DELTA_COMMITTED,))
            t0 = time.monotonic()
            t1 = ElasticTrainer(cfg, shape, cluster, **kw)
            _sync(device)
            res["init_s"] = time.monotonic() - t0
            reset_counts()
            for i in range(1, steps + 1):
                t0 = time.monotonic()
                t1.run(1)
                _sync(device)
                res["step_ms"].append((time.monotonic() - t0) * 1e3)
                log(f"  step {i}: {res['step_ms'][-1]:.1f} ms, loss "
                    f"{t1.metrics_log[-1]['loss']:.4f}")
                if i % commit_every == 0:
                    t0 = time.monotonic()
                    t1.commit(blocking=True)
                    wall = time.monotonic() - t0
                    rec = dict(records[-1], wall_s=wall, step=i,
                               **host_rss())
                    res["commits"].append(rec)
                    log(f"  commit at step {i}: {json.dumps(rec)}")
            _sync(device)
            res["launches"] = read_counts()
            res["losses"] = [m["loss"] for m in t1.metrics_log]
            codes = committed_codes(t1)
            res["commit_bound_ratio"] = check_commit_bound(t1, codes, device)
            res["committed_step"] = int(t1.state.step)
            if device.type == "cuda":
                res["encode_ms"] = cuda_ms(lambda: _encode_all(t1, codes),
                                           iters=1, warmup=1)
            # the uninterrupted reference: 2 more steps, the first counted
            reset_counts()
            t1.run(1)
            _sync(device)
            res["launches_per_step"] = read_counts()
            if profile:
                res["profile_step"] = profile_window(lambda: t1.run(1))
            else:
                t1.run(1)
            res["reference_losses"] = [m["loss"]
                                       for m in t1.metrics_log[-2:]]
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated() \
                if device.type == "cuda" else 0
            # a "crash": the trainer is dropped without finalize, and with
            # it goes its state on the card
            t1_ref = weakref.ref(t1)
            del t1
            gc.collect()
            if t1_ref() is not None:
                raise AssertionError("the dropped trainer is still alive")
            if device.type == "cuda":
                torch.cuda.empty_cache()
            # the drains finish, and L1 keeps only the newest checkpoint
            cluster.controller.wait_for_drains(timeout=600)
            res["pre_restart_rss"] = host_rss()
            log(f"  before the restart: {json.dumps(res['pre_restart_rss'])}")

            t0 = time.monotonic()
            t2 = ElasticTrainer(cfg, shape, cluster, **kw)
            _sync(device)
            res["restart_s"] = time.monotonic() - t0
            res["restart_rss"] = host_rss()
            if not t2.restarted or int(t2.state.step) != \
                    res["committed_step"] or \
                    t2.data.state.step != res["committed_step"]:
                raise AssertionError(
                    f"restart: restarted={t2.restarted} step "
                    f"{int(t2.state.step)} data {t2.data.state.step}, want "
                    f"{res['committed_step']}")
            log(f"  restart in {res['restart_s']:.1f} s: "
                f"{json.dumps(res['restart_rss'])}")
            check_restored(t2, codes, device)
            del codes
            t2.run(2)
            res["restart_losses"] = [m["loss"] for m in t2.metrics_log]
            if not np.all(np.isfinite(res["restart_losses"])):
                raise AssertionError(f"losses after the restart: "
                                     f"{res['restart_losses']}")
            # a clean exit: the app's chain state (codes on the card) goes
            t2.finalize()
            t2.state = None
            del t2
    finally:
        shutil.rmtree(pfs, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        res["allocated_after"] = torch.cuda.memory_allocated()
    return res


def _encode_all(trainer, codes) -> None:
    """One delta encode of every float leaf (K2), outputs discarded."""
    from repro_torch.kernels.ckpt_codec import quantize_delta

    for name, leaf in _float_leaves(trainer.state):
        quantize_delta(leaf, codes[name][0])


def train_cut_phase(cfg, device, seq=TRAIN_SEQ, node_memory=48 << 30
                    ) -> dict:
    """Gradient compression (K1 + K3 every step) and a 1 -> 2 logical-rank
    resize with overlap_resize; returns counts, losses and the resize."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ICheckCluster
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import ElasticTrainer

    shape = ShapeConfig("train_4k_1", "train", seq, 1)
    pfs = tempfile.mkdtemp(prefix="chip-smoke-pfs-")
    res = {}
    try:
        with ICheckCluster(n_icheck_nodes=2, n_spare_nodes=0,
                           node_memory=node_memory, keep_l1=1,
                           pfs_root=pfs, adaptive_interval=False) as cluster:
            t = ElasticTrainer(cfg, shape, cluster, app_id="train-cut",
                               seed=1, opt_cfg=AdamWConfig(
                                   compress_grads=True),
                               commit_every=2, probe_every=0,
                               total_steps=100, codec="q8-delta",
                               overlap_resize=True, device=device)
            reset_counts()
            t0 = time.monotonic()
            t.run(2)
            cluster.rm.schedule_resize("train-cut", 2)
            for _ in range(6):
                t.run(1)
                if t.resizes:
                    break
            _sync(device)
            res["wall_s"] = time.monotonic() - t0
            res["launches"] = read_counts()
            res["resizes"] = t.resizes
            res["ranks"] = t.app.ranks
            res["steps_during_resize"] = t.steps_during_resize
            res["losses"] = [m["loss"] for m in t.metrics_log]
            t.run(1)
            res["losses_after_resize"] = [m["loss"]
                                          for m in t.metrics_log[-1:]]
            t.finalize()
            del t
    finally:
        shutil.rmtree(pfs, ignore_errors=True)
    if res["resizes"] != 1 or res["ranks"] != 2:
        raise AssertionError(f"resize: {res['resizes']} resizes, "
                             f"{res['ranks']} ranks")
    if not np.all(np.isfinite(res["losses"] + res["losses_after_resize"])):
        raise AssertionError(f"cut phase losses: {res['losses']}")
    if device.type == "cuda" and not (res["launches"]["quantize"]
                                      and res["launches"]["dequantize"]):
        raise AssertionError(f"cut phase did not run K1 and K3: "
                             f"{res['launches']}")
    gc.collect()
    return res


# --------------------------------------------------------------------------
# phase 7: kernel numbers at the training path's shapes
# --------------------------------------------------------------------------
def bwd_numbers(path_case, device) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref)
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import allowed_mask

    b, hq, hkv, t, s, d, causal, window = path_case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    dout = _inputs(8, b, hq, hkv, t, s, d, "bfloat16", device)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                  **kw), iters=5)
    plain_ms = cuda_ms(lambda: attention_bwd_ref(q, k, v, out, lse, dout,
                                                 **kw), iters=2, warmup=1)
    # yardstick only, never called by the port: SDPA's backward (at T = S
    # its top-left causal alignment equals the reference's bottom-right)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=True)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dout, retain_graph=True), iters=5)
    pairs = int(allowed_mask(t, s, causal, window, s - t).sum())
    flops = 10 * b * hq * d * pairs     # five products, 2 FLOP per MAC
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
              + 2 * out.numel()) * 2 + dout.numel() * 2 + 2 * lse.numel() * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


def fwd_train_numbers(path_case, device) -> dict:
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    b, hq, hkv, t, s, d, causal, window = path_case
    q, k, v = _inputs(7, b, hq, hkv, t, s, d, "bfloat16", device)
    return {"ms": cuda_ms(lambda: flash_attention_cuda(
        q, k, v, causal=causal, window=window, scale=d ** -0.5), iters=5)}


def codec_numbers(n, device) -> dict:
    """K1-K3 at the path's largest leaf (f32), beside their plain versions
    and their byte bounds; no single PyTorch call computes them."""
    from repro_torch.kernels.ckpt_codec import kernel as K
    from repro_torch.kernels.ckpt_codec import ref as R
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    x = _to_blocks(_codec_input(n, "float32", device, 0))[0]
    q, s = K.quantize_cuda(x)
    nb = x.shape[0]
    out = {}
    for name, fn, plain, nbytes in (
            ("quantize", lambda: K.quantize_cuda(x),
             lambda: R.quantize_ref(x), 4 * n + n + 4 * nb),
            ("quantize_delta", lambda: K.quantize_delta_cuda(x, q),
             lambda: R.quantize_delta_ref(x, q), 4 * n + 3 * n + 4 * nb),
            ("dequantize", lambda: K.dequantize_cuda(q, s),
             lambda: R.dequantize_ref(q, s), n + 4 * nb + 4 * n)):
        out[name] = {"ms": cuda_ms(fn, iters=5),
                     "plain_ms": cuda_ms(plain, iters=2, warmup=1),
                     "library_ms": None,
                     "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3,
                     "bound_by": "bytes", "bytes": nbytes}
    return out


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
    from repro_torch.models import count_params, init_params

    cfg = get_config("yi-6b")
    rcfg = get_config("rwkv6-7b")
    tcfg = get_config("qwen2.5-3b")
    rh = rcfg.d_model // rcfg.rwkv_head_dim
    rwkv_cases = {"prefill": (BATCH, rh, PROMPT, rcfg.rwkv_head_dim),
                  "decode": (BATCH, rh, 1, rcfg.rwkv_head_dim)}
    path_case = (BATCH, cfg.num_heads, cfg.num_kv_heads, PROMPT, PROMPT,
                 cfg.resolved_head_dim, True, cfg.window)
    train_case = (1, tcfg.num_heads, tcfg.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
                  tcfg.resolved_head_dim, True, tcfg.window)
    w_gu = tcfg.num_layers * 2 * tcfg.d_model * tcfg.d_ff
    t_start = time.monotonic()

    log("phase 2: build")
    build_kernels()
    torch.cuda.synchronize()

    log("phase 3: kernels against their plain versions")
    path_err = check_kernels(path_case, device)
    bwd_err = check_bwd(train_case, device)
    codec_bad = check_codec(CODEC_NS + [w_gu], device)
    rwkv_err = check_rwkv6(rwkv_cases, device)
    torch.cuda.empty_cache()
    log(f"  phase 3 done at {time.monotonic() - t_start:.1f} s")

    log(f"phase 4: serving, {cfg.name} {cfg.num_layers} layers "
        f"d_model {cfg.d_model} {cfg.dtype}, {BATCH} x {PROMPT} prompt "
        f"tokens, {GEN} new tokens")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    torch.cuda.synchronize()
    log(f"  params: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
        f"f32 in {time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    res = serve_main_path(cfg, params, device, want={
        "generate": {"flash_fwd": cfg.num_layers},
        "prefill": {"flash_fwd": cfg.num_layers}})
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    del res["state_payload"]
    log(f"  launches in the main path: {res['launches']}")
    log(f"  KV cache {res['state_bytes']} bytes; restored cache equals a "
        f"second prefill bit for bit; {GEN - 1} decode steps from it give "
        f"the live tokens")
    plain_err = check_against_plain(cfg, params, device)
    log(f"  2-layer f32 cut: card vs plain CPU logits max abs err "
        f"{plain_err:.3e}")
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
        "state_bytes": res["state_bytes"],
        "max_memory_allocated": serve_peak,
        "attention_flops": num["flops"], "attention_bytes": num["bytes"],
    }
    log(json.dumps({"serve": serve}))
    for name in ("profile_prefill", "profile_decode_8"):
        log(json.dumps({name: res[name]}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4 done at {time.monotonic() - t_start:.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log(f"phase 4b: serving, {rcfg.name} {rcfg.num_layers} layers d_model "
        f"{rcfg.d_model} {rcfg.dtype}, {BATCH} x {PROMPT} prompt tokens, "
        f"{GEN} new tokens")
    rw = serve_rwkv6_phase(rcfg, device, card)
    log(f"  phase 4b done at {time.monotonic() - t_start:.1f} s; weights "
        f"freed, {torch.cuda.memory_allocated()} bytes allocated")

    log("phase 4c: Reed-Solomon encode against the host codec")
    rs = check_rs(device, rw.pop("state_payload"))
    log(json.dumps({"rs_encode_state": rs["numbers"]}))
    log(f"  phase 4c done at {time.monotonic() - t_start:.1f} s")

    n_params = count_params(tcfg)
    log(f"phase 5: training, {tcfg.name} {tcfg.num_layers} layers d_model "
        f"{tcfg.d_model} {tcfg.dtype} compute, {n_params} params, "
        f"{TRAIN_SEQ} tokens a step, q8-delta commit every {COMMIT_EVERY} "
        f"steps")
    torch.cuda.reset_peak_memory_stats()
    tr = train_main_path(tcfg, device, profile=True)
    frames = [(c["key_frames"], c["delta_frames"]) for c in tr["commits"]]
    ratios = [c["raw_bytes"] / c["encoded_bytes"] for c in tr["commits"]]
    if tr["launches"]["flash_fwd"] != 2 * tcfg.num_layers * TRAIN_STEPS or \
            tr["launches"]["flash_bwd"] != tcfg.num_layers * TRAIN_STEPS:
        raise AssertionError(f"training launches {tr['launches']}")
    if not (tr["launches"]["quantize"] and tr["launches"]["quantize_delta"]):
        raise AssertionError(f"commits did not run K1 and K2: "
                             f"{tr['launches']}")
    if not any(d for _, d in frames) or not frames[0][0] or \
            min(ratios) <= 3:
        raise AssertionError(f"commit frames {frames}, ratios {ratios}")
    step_ms = sorted(tr["step_ms"][1:])[len(tr["step_ms"][1:]) // 2]
    tokens_per_s = TRAIN_SEQ / (step_ms / 1e3)
    train = {
        "card": card, "params": n_params, "seq": TRAIN_SEQ, "batch": 1,
        "step_ms_median": step_ms, "step_ms": tr["step_ms"],
        "tokens_per_s": tokens_per_s,
        "mfu": 6 * n_params * TRAIN_SEQ / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "init_s": tr["init_s"],
        "commit_wall_s": [c["wall_s"] for c in tr["commits"]],
        "commit_encode_s": [c["encode_s"] for c in tr["commits"]],
        "device_encode_ms": tr["encode_ms"],
        "wire_bytes": [c["encoded_bytes"] for c in tr["commits"]],
        "raw_bytes": [c["raw_bytes"] for c in tr["commits"]],
        "compression_ratio": ratios, "frames_key_delta": frames,
        "commit_bound_ratio": tr["commit_bound_ratio"],
        "restart_wall_s": tr["restart_s"],
        "losses": tr["losses"], "reference_losses": tr["reference_losses"],
        "restart_losses": tr["restart_losses"],
        "launches": tr["launches"],
        "launches_per_step": tr["launches_per_step"],
        "max_memory_allocated": tr["max_memory_allocated"],
        "host": host_rss(), "restart_host": tr["restart_rss"],
        "pre_restart_host": tr["pre_restart_rss"],
        "pfs_free_bytes": tr["pfs_free_bytes"],
    }
    log(card)
    log(json.dumps({"train": train}))
    log(json.dumps({"profile_train_step": tr["profile_step"]}))
    log(f"  phase 5 done at {time.monotonic() - t_start:.1f} s; "
        f"{tr['allocated_after']} bytes still allocated")

    cut_cfg = dataclasses.replace(tcfg, num_layers=CUT_LAYERS)
    log(f"phase 6: {tcfg.name} cut to {CUT_LAYERS} layers, compressed "
        f"gradients, 1 -> 2 rank resize with overlap")
    cut = train_cut_phase(cut_cfg, device)
    log(json.dumps({"train_cut": cut}))
    log(f"  phase 6 done at {time.monotonic() - t_start:.1f} s")

    log("phase 7: numbers")
    bwd = bwd_numbers(train_case, device)
    fwd_train = fwd_train_numbers(train_case, device)
    codec = codec_numbers(w_gu, device)
    torch.cuda.synchronize()
    log(json.dumps({"flash_fwd_train_shape": fwd_train,
                    "flash_bwd_train_shape": bwd, "codec_w_gu": codec}))
    # ``launches`` is the count from the run of the path named by
    # ``launches_path``; ``launches_by_path`` gives every path's count
    paths = {"serve": res["launches"], "serve_rwkv6": rw["launches"],
             "train": tr["launches"], "train_cut": cut["launches"],
             "rs_encode_check": rs["launches"]}

    def counts(name, path):
        return {"launches": paths[path][name], "launches_path": path,
                "launches_by_path": {p: c[name] for p, c in paths.items()
                                     if name in c}}

    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:95",
        **counts("flash_fwd", "serve"),
        "max_abs_err": path_err, "ms": num["ms"],
        "plain_ms": num["plain_ms"], "bound_ms": num["bound_ms"],
        "bound_by": num["bound_by"], "library_ms": num["library_ms"],
    }, {
        "name": "flash_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/ops.py:94",
        **counts("flash_bwd", "train"),
        "max_abs_err": bwd_err, "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
    }]
    for name, line in (("quantize", 54), ("quantize_delta", 74),
                       ("dequantize", 98)):
        c = codec[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/ckpt_codec/csrc/codec.cu",
            "replaces": f"src/repro/kernels/ckpt_codec/kernel.py:{line}",
            # K3 runs only where gradients are compressed: the cut phase
            **counts(name, "train_cut" if name == "dequantize" else "train"),
            "max_abs_err": float(codec_bad), "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    rn = rw["numbers"]["prefill"]
    kernels.append({
        "name": "rwkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:86",
        **counts("rwkv6", "serve_rwkv6"),
        "max_abs_err": rwkv_err, "ms": rn["ms"], "plain_ms": rn["plain_ms"],
        "bound_ms": rn["bound_ms"], "bound_by": rn["bound_by"],
        "library_ms": None,
        "decode_shape": rw["numbers"]["decode"]})
    rsn = rs["numbers"]
    kernels.append({
        "name": "rs_encode", "route": "cuda",
        "source": "src/repro_torch/kernels/ckpt_codec/csrc/rs.cu",
        "replaces": "src/repro/kernels/ckpt_codec/rs_kernel.py:87",
        # no serving or training path runs K5: its launches are its check's
        **counts("rs_encode", "rs_encode_check"),
        "max_abs_err": float(rs["mismatches"]), "ms": rsn["ms"],
        "plain_ms": rsn["plain_ms"], "bound_ms": rsn["bound_ms"],
        "bound_by": rsn["bound_by"], "library_ms": None})
    log(f"  total {time.monotonic() - t_start:.1f} s")
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
