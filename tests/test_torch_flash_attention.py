"""The port's flash-attention forward held against the JAX reference.

The same inputs, made with numpy from a seed, go through the JAX oracle
(``attention_ref``), the Pallas kernel in interpret mode, and the port's
``attention`` on the CPU (its plain version).  Tolerances: f32 atol 3e-5
and bf16 atol 3e-2 on the output (the reference suite's own), lse atol
1e-5 against ``flash_attention_pallas(interpret=True, return_lse=True)``.
Rows with no allowed key are excluded from every comparison: the reference
has no consistent answer there (it depends on its tile size); a separate
case checks that the port gives zeros and lse = -inf.

Head dim 256 with a sliding window (recurrentgemma-9b's attention
layers), head dim 160 (pixtral-12b's) and non-causal calls whose query
and key lengths differ (cross-attention) take the forward's tolerances.

Gradients: dq/dk/dv against ``jax.grad`` of the reference's XLA backward,
f32 atol 5e-4, over the sweep, at head dim 256 and at the cross-attention
shapes.

f32 matmuls run in full precision: ``torch.backends.cuda.matmul.allow_tf32``
is set False.  The kernel against its plain version on the card is in
``test_torch_kernels_cuda.py``, which imports no jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs files in parallel worker processes: few intra-op threads
# keep this file from crowding the others off the cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention as jax_attention  # noqa: E402
from repro.kernels.flash_attention import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro_torch.kernels.common import on_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import attention, attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import allowed_mask  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

# the sweep of tests/test_kernels_attention.py
SWEEP = [
    # b, hq, hkv, t, s, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 1, 100, 100, 32, True, None),      # MQA, unaligned T
    (1, 4, 4, 64, 64, 128, False, None),      # MHA, bidirectional
    (2, 4, 2, 96, 96, 32, True, 32),          # sliding window
    (1, 2, 1, 1, 160, 64, True, None),        # decode-like (T=1)
    (1, 2, 2, 72, 200, 32, True, None),       # cross-length causal
]
ATOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _mk(seed, b, hq, hkv, t, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _live_rows(t, s, causal, window):
    """(t,) bool: rows that have at least one allowed key."""
    return allowed_mask(t, s, causal, window, s - t).any(dim=1).numpy()


def _port(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_forward_matches_jax(case, dtype):
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _mk(7, b, hq, hkv, t, s, d)
    out, lse = attention(_port(q, dtype), _port(k, dtype), _port(v, dtype),
                         causal=causal, window=window, return_lse=True)
    assert out.dtype == getattr(torch, dtype)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, t)
    jq, jk, jv = (_jax(x, dtype) for x in (q, k, v))
    live = _live_rows(t, s, causal, window)
    got = out.float().numpy()[:, :, live]
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    interp = jax_attention(jq, jk, jv, causal=causal, window=window,
                           impl="interpret")
    for want in (ref, interp):
        np.testing.assert_allclose(
            got, np.asarray(want, np.float32)[:, :, live], atol=ATOL[dtype])
    _, jlse = flash_attention_pallas(jq, jk, jv, causal=causal,
                                     window=window, interpret=True,
                                     return_lse=True)
    np.testing.assert_allclose(lse.numpy()[:, :, live],
                               np.asarray(jlse)[:, :, live], atol=1e-5)


# recurrentgemma's attention layers: MQA at head dim 256 under a sliding
# window, cut to a few heads and tokens; the window hides keys in each
D256 = [
    (1, 4, 1, 48, 48, 256, True, 16),
    (2, 2, 1, 40, 40, 256, True, 8),
    (1, 2, 1, 1, 40, 256, True, 16),          # decode-like (T=1)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", D256)
def test_forward_matches_jax_at_head_dim_256(case, dtype):
    test_forward_matches_jax(case, dtype)


# the shapes this slice adds, cut to a few heads and tokens: pixtral-12b's
# head dim 160 (GQA, causal; with a window; T < S), and cross-attention's
# non-causal calls whose query and key lengths differ, more queries than
# keys and fewer
NEW_SHAPES = [
    (1, 4, 2, 48, 48, 160, True, None),
    (1, 2, 1, 40, 40, 160, True, 16),
    (1, 2, 2, 24, 56, 160, True, None),
    (2, 4, 4, 72, 24, 64, False, None),
    (1, 4, 2, 20, 64, 64, False, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", NEW_SHAPES)
def test_forward_matches_jax_at_head_dim_160_and_cross(case, dtype):
    test_forward_matches_jax(case, dtype)


@pytest.mark.parametrize("case", NEW_SHAPES[3:])
def test_grads_match_jax_cross(case):
    """As ``test_grads_match_jax``, at the non-causal T != S calls of the
    encoder-decoder's cross-attention, which it trains through."""
    _check_grads(case)


def test_rows_without_allowed_key_are_zero():
    """T > S, causal: the offset S - T is -8, so query rows 0..7 sit
    before every key and have no allowed key.  The port gives zeros and lse = -inf there
    and agrees with the reference on the other rows."""
    b, hq, hkv, t, s, d = 1, 2, 1, 16, 8, 8
    q, k, v = _mk(3, b, hq, hkv, t, s, d)
    out, lse = attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, return_lse=True)
    live = _live_rows(t, s, True, None)
    assert not live[:8].any() and live[8:].all()
    assert torch.all(out[:, :, :8] == 0)
    assert torch.all(torch.isneginf(lse[:, :, :8]))
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True)
    np.testing.assert_allclose(out.numpy()[:, :, 8:],
                               np.asarray(ref)[:, :, 8:], atol=3e-5)


def test_port_ref_matches_jax_ref_scale():
    """An explicit softmax scale reaches the scores the same way."""
    q, k, v = _mk(5, 1, 4, 2, 32, 32, 32)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, scale=0.3)[0]
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_forward_only():
    """The op is no longer forward-only: an input that requires a gradient
    gets one, and ``lse`` is not differentiable."""
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 1, 2, 1, 8, 8, 32))
    out, lse = attention(q.requires_grad_(), k, v, return_lse=True)
    assert out.requires_grad and not lse.requires_grad
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


@pytest.mark.parametrize("case", SWEEP)
def test_grads_match_jax(case):
    """dq, dk, dv of the port's ``attention`` (its plain backward on the
    CPU) against ``jax.grad`` of the reference's ``attention(impl="xla")``
    (the blockwise XLA backward), f32, atol 5e-4.  dq rows with no allowed
    key are left out (no consistent answer in the reference); their
    upstream gradient is zero, so they add nothing to dk and dv on either
    side."""
    _check_grads(case)


@pytest.mark.parametrize("case", D256)
def test_grads_match_jax_at_head_dim_256(case):
    """As ``test_grads_match_jax``, at recurrentgemma-9b's head dim 256:
    MQA, causal, a window shorter than T (the backward its training path
    runs, ``_xla_flash_bwd`` in the reference), f32, atol 5e-4."""
    _check_grads(case)


def _check_grads(case):
    import jax

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _mk(11, b, hq, hkv, t, s, d)
    live = _live_rows(t, s, causal, window)
    do = np.random.default_rng(12).standard_normal(q.shape) \
        .astype(np.float32) * live[None, None, :, None]

    def jf(jq, jk, jv):
        o = jax_attention(jq, jk, jv, causal=causal, window=window,
                          impl="xla")
        return jnp.sum(o * jnp.asarray(do))

    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention(tq, tk, tv, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    for name, got, want in (("dq", tq.grad, jgrads[0]),
                            ("dk", tk.grad, jgrads[1]),
                            ("dv", tv.grad, jgrads[2])):
        got, want = got.numpy(), np.asarray(want)
        if name == "dq":
            got, want = got[:, :, live], want[:, :, live]
        np.testing.assert_allclose(got, want, atol=5e-4, err_msg=name)


def test_dispatch_follows_input_device():
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 1, 2, 1, 8, 8, 32))
    assert on_cuda(q, k, v) is False
    with pytest.raises(ValueError):
        on_cuda(q, k.to("meta"))


@pytest.mark.parametrize("b,hq,hkv,s,d,want", [
    (1, 16, 1, 4096, 256, 4),     # recurrentgemma-9b's training shape
    (1, 16, 1, 300, 256, 1),      # too few key tiles to share a block
    (1, 16, 2, 4096, 256, 4),
    (4, 16, 1, 512, 256, 2),
    (1, 16, 16, 4096, 256, 1),    # no group to sum
    (1, 16, 1, 4096, 128, 1)])    # below 256: a part per query head
def test_bwd_heads_per_part(b, hq, hkv, s, d, want):
    """The bf16 backward's dk/dv blocks at head dim 256 sum the most query
    heads of a KV head's group that still leave a block for each of an
    H100's 132 SMs."""
    from repro_torch.kernels.flash_attention.kernel import heads_per_part

    assert heads_per_part(b, hq, hkv, s, d, 132) == want


# a fault in the last rows of one gradient: (gradient, rows counted from
# the end, factor); None is the right answer
FAULTS = [None, ("dv", 64, 0.0), ("dk", 40, 1.03), ("dq", 64, 0.0),
          ("dv", 8, 1.1)]


@pytest.mark.parametrize("fault", FAULTS)
def test_bf16_grad_check_finds_a_wrong_tail(fault):
    """The card's bf16 backward check (``torch_flash_checks``) on a causal
    T = S = 512: the last keys' gradients are a few hundredths of the
    first keys', so a small fault there hides under the max abs error
    (dk x 1.03, dv x 1.1); the error norm over each tile of rows must
    still find it, and a zeroed tile.  The plain backward on
    the bf16 inputs stands in for both the kernel and SDPA."""
    from torch_flash_checks import check_bf16_grads

    from repro_torch.kernels.flash_attention import attention_bwd_ref

    b, hq, hkv, t, d = 1, 4, 2, 512, 32
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _mk(21, b, hq, hkv, t, t, d))
    do = torch.from_numpy(_mk(22, b, hq, hkv, t, t, d)[0]).bfloat16()
    out, lse = attention_ref(q, k, v, causal=True)
    kw = dict(causal=True, window=None, scale=d ** -0.5)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                             lse, do.float(), **kw)
    lib = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    got = [g.clone() for g in lib]
    if fault is None:
        res = check_bf16_grads("plain", got, want, lib)
        assert all(r["worst_tile_ratio"] <= 1 for r in res.values())
        return
    name, rows, factor = fault
    g = got[("dq", "dk", "dv").index(name)]
    g[:, :, -rows:] *= factor
    with pytest.raises(AssertionError, match=f"faulty {name}: "):
        check_bf16_grads("faulty", got, want, lib)
