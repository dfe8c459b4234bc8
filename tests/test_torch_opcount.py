"""The op counter (``repro_torch.launch.opcount``), the counterpart of
the reference's HLO analysis, twins of ``tests/test_hlo_analysis.py``:
matmul FLOPs exact (and equal to the reference's count of the same jitted
product), loops counted once an iteration, the bytes of an elementwise
pass, ``top_ops``, and the all-reduces of a gloo world of 2 by the ring
model.  Each kernel's record on ``meta`` tensors (K4 forward and
backward, K6 and K7 forward and backward, both routes) equals the count
its bound in ``PERF.md`` uses, written out here at a small shape; the
``meta`` route is taken only by ``meta`` tensors.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.hlo import analyze  # noqa: E402
from repro_torch.kernels.flash_attention import attention  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops  # noqa: E402
from repro_torch.launch.opcount import (OpCounter,  # noqa: E402
                                        roofline_terms, top_ops)

import torch_dp_workers as workers  # noqa: E402

META = torch.device("meta")


def count(fn, *args):
    """Run ``fn(*args)`` under an ``OpCounter`` tracking ``args``; returns
    (fn's result, the counter)."""
    with OpCounter().track(args) as counter:
        out = fn(*args)
    return out, counter


def _jax_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_matmul_flops(device):
    a = torch.ones(256, 256, device=device)
    _, c = count(lambda x, y: x @ y, a, a)
    assert c.result()["flops"] == 2 * 256 ** 3
    assert c.result()["flops"] == _jax_flops(lambda x, y: x @ y,
                                             (256, 256), (256, 256))


def test_loop_multiplies_flops():
    a = torch.ones(128, 128, device=META)

    def f(x, b):
        for _ in range(10):
            x = torch.tanh(x @ b)
        return x

    _, c = count(f, a, a)
    assert c.result()["flops"] == 10 * 2 * 128 ** 3

    def g(x, b):
        return jax.lax.scan(lambda y, _: (jnp.tanh(y @ b), None), x, None,
                            length=10)[0]
    assert c.result()["flops"] == _jax_flops(g, (128, 128), (128, 128))


def test_nested_loops_multiply():
    a = torch.ones(64, 64, device=META)

    def f(x, b):
        for _ in range(3):
            for _ in range(4):
                x = x @ b
            x = torch.tanh(x)
        return x

    _, c = count(f, a, a)
    assert c.result()["flops"] == 12 * 2 * 64 ** 3
    assert c.result()["ops"] == 15


def test_bytes_of_an_elementwise_pass():
    x = torch.ones(1 << 20)
    _, c = count(lambda x: x * 2 + 1, x)
    # two passes (mul, add), each a read and a write of 4 MiB
    assert c.result()["bytes"] == 4 * 4 * (1 << 20)
    # views and allocations move nothing; a copy into a slice moves twice
    # the update
    y = torch.empty(64, 1024, device=META)
    _, c = count(lambda y: y[:8].copy_(torch.empty(8, 1024, device=META)),
                 y)
    assert c.result()["bytes"] == 2 * 8 * 1024 * 4
    # a gather moves its result and its indices
    table = torch.empty(1000, 64, device=META)
    ids = torch.zeros(4, 16, dtype=torch.long, device=META)
    _, c = count(lambda t, i: torch.nn.functional.embedding(i, t), table,
                 ids)
    assert c.result()["bytes"] == 4 * 16 * 64 * 4 + 4 * 16 * 8


def test_peak_live_bytes():
    a = torch.empty(1024, 1024, device=META)         # 4 MiB

    def f(a):
        b = a * 2                                    # +4 MiB
        c = b + 1                                    # +4 MiB
        del b                                        # -4 MiB
        return c.sum()
    _, c = count(f, a)
    r = c.result()
    assert r["start_bytes"] == 4 << 20
    assert r["peak_bytes"] == 12 << 20


def test_tops_and_roofline():
    a = torch.ones(128, 128, device=META)
    _, c = count(lambda a, b: torch.tanh(a @ b) @ b, a, a)
    tops = top_ops(c, 3)
    assert len(tops["flops"]) >= 1 and tops["flops"][0][0] > 0
    assert tops["flops"][0][1] == "aten.mm.default"
    # the two products share a row: same op, same operand shapes
    assert tops["bytes"] == [
        (2 * 3 * 128 * 128 * 4, "aten.mm.default", str(((128, 128),) * 2)),
        (2 * 128 * 128 * 4, "aten.tanh.default", str(((128, 128),)))]
    assert tops["collectives"] == []
    r = c.result()
    terms = roofline_terms(r, 1e12, 1e12, 1e9)
    assert terms["t_compute"] == r["flops"] / 1e12
    assert terms["dominant"] in ("compute", "memory")


def test_collectives_of_a_gloo_world(tmp_path):
    n = 1000
    coll = workers.spawn_world(workers.counted_collectives, 2, tmp_path, n)
    # ring model on k = 2 ranks: an all-reduce moves 2 N (k-1)/k = N over
    # a link, an all-gather of N result bytes N (k-1)/k = N / 2
    assert coll["counts"]["all-reduce"] == 2
    assert coll["result_bytes"]["all-reduce"] == 2 * 4 * n
    assert coll["link_bytes"]["all-reduce"] == 2 * 4 * n
    assert coll["counts"]["all-gather"] == 1
    assert coll["link_bytes"]["all-gather"] == 2 * 4 * n / 2
    assert coll["total_link_bytes"] == 3 * 4 * n


# --------------------------------------------------------------------------
# the kernels' records on meta tensors
# --------------------------------------------------------------------------
def _pairs(t, s, causal, window):
    """Allowed (query, key) pairs, counted pair by pair."""
    return sum(1 for i in range(t) for j in range(s)
               if (not causal or j <= s - t + i)
               and (window is None or j > s - t + i - window))


@pytest.mark.parametrize("causal,window,t,s", [(True, None, 48, 48),
                                               (True, 16, 40, 64),
                                               (False, None, 24, 80)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_records(causal, window, t, s, dtype):
    b, hq, hkv, d = 2, 4, 2, 64
    es = torch.tensor([], dtype=dtype).element_size()
    q = torch.empty(b, hq, t, d, dtype=dtype, device=META,
                    requires_grad=True)
    k, v = (torch.empty(b, hkv, s, d, dtype=dtype, device=META,
                        requires_grad=True) for _ in range(2))
    with OpCounter() as c:
        out = attention(q, k, v, causal=causal, window=window)
        out.backward(torch.empty_like(out))
    assert out.shape == q.shape and out.dtype == dtype
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    pairs = _pairs(t, s, causal, window)
    sm90 = "_sm90" if dtype == torch.bfloat16 else ""
    rec = c.result()["kernels"]
    assert rec[f"flash_fwd{sm90}"] == {
        "calls": 1, "flops": 4 * b * hq * d * pairs,
        "bytes": (2 * b * hq * t * d + 2 * b * hkv * s * d) * es
        + b * hq * t * 4}
    assert rec[f"flash_bwd{sm90}"] == {
        "calls": 1, "flops": 10 * b * hq * d * pairs,
        "bytes": (2 * b * hq * t * d + 2 * 2 * b * hkv * s * d
                  + 2 * b * hq * t * d) * es + b * hq * t * d * es
        + 2 * b * hq * t * 4}


@pytest.mark.parametrize("t", [8, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv6_records(t, dtype):
    b, h, d = 2, 3, 32
    es = torch.tensor([], dtype=dtype).element_size()
    r, k, v = (torch.empty(b, h, t, d, dtype=dtype, device=META,
                           requires_grad=True) for _ in range(3))
    lw = torch.empty(b, h, t, d, device=META, requires_grad=True)
    u = torch.empty(h, d, device=META, requires_grad=True)
    with OpCounter() as c:
        o, s_t = rwkv6_ops.rwkv6(r, k, v, lw, u)
        o.float().sum().backward()
    assert o.shape == (b, h, t, d) and o.dtype == dtype
    assert s_t.shape == (b, h, d, d) and s_t.dtype == torch.float32
    chunked = dtype == torch.bfloat16 and t >= rwkv6_ops.SM90_MIN_T
    n = b * h * t * d
    fwd_bytes = n * (3 * es + 4 + es) + h * d * 4 + 2 * b * h * d * d * 4
    bwd_bytes = n * (4 * es + 4 + 3 * es + 4) + 2 * h * d * 4 \
        + 3 * b * h * d * d * 4
    nc = math.ceil(t / 64)
    want = ({"rwkv6_sm90": (8 * 64 * d * d * nc * b * h, fwd_bytes),
             "rwkv6_bwd_sm90": (b * h * nc * (12 * 64 * d * d
                                              + 5 * 64 * 64 * d),
                                bwd_bytes)}
            if chunked else
            {"rwkv6": (5 * b * h * t * d * d, fwd_bytes),
             "rwkv6_bwd": (12 * b * h * t * d * d, bwd_bytes)})
    rec = c.result()["kernels"]
    assert rec == {name: {"calls": 1, "flops": f, "bytes": nb}
                   for name, (f, nb) in want.items()}


@pytest.mark.parametrize("t", [16, 400])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rglru_records(t, dtype):
    b, d = 2, 256
    es = torch.tensor([], dtype=dtype).element_size()
    la = torch.empty(b, t, d, device=META, requires_grad=True)
    g = torch.empty(b, t, d, dtype=dtype, device=META, requires_grad=True)
    with OpCounter() as c:
        h, h_last = rglru_ops.rglru(la, g)
        h.float().sum().backward()
    assert h.shape == g.shape and h.dtype == dtype
    assert h_last.shape == (b, d) and h_last.dtype == torch.float32
    fwd = rglru_ops.route(t, d, dtype)
    bwd = rglru_ops.route_bwd(t, d, dtype)
    assert fwd == ("rglru_sm90" if t >= rglru_ops.SM90_MIN_T else "rglru")
    rec = c.result()["kernels"]
    assert rec == {
        fwd: {"calls": 1, "flops": 3 * b * t * d,
              "bytes": b * t * d * (4 + es + es) + 2 * b * d * 4},
        bwd: {"calls": 1, "flops": 4 * b * t * d,
              "bytes": b * t * d * (4 + es + es + es + 4) + 3 * b * d * 4}}


def test_meta_route_only_for_meta_tensors():
    q = torch.zeros(1, 2, 8, 32)
    with OpCounter() as c:
        out = attention(q, q, q)                 # CPU: the plain version
    assert c.result()["kernels"] == {} and c.result()["flops"] > 0
    assert out.device.type == "cpu"
    with pytest.raises(ValueError):              # mixed devices raise
        attention(q.to("meta"), q, q)
    with pytest.raises(ValueError):
        rwkv6_ops.rwkv6(*(torch.zeros(1, 1, 4, 16, device=META),) * 4,
                        torch.zeros(1, 16))
    with pytest.raises(ValueError):
        rglru_ops.rglru(torch.zeros(1, 4, 8, device=META),
                        torch.zeros(1, 4, 8))
