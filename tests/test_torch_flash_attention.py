"""The port's flash-attention forward held against the JAX reference.

The same inputs, made with numpy from a seed, go through the JAX oracle
(``attention_ref``), the Pallas kernel in interpret mode, and the port's
``attention`` on the CPU (its plain version).  Tolerances: f32 atol 3e-5
and bf16 atol 3e-2 on the output (the reference suite's own), lse atol
1e-5 against ``flash_attention_pallas(interpret=True, return_lse=True)``.
Rows with no allowed key are excluded from every comparison: the reference
has no consistent answer there (it depends on its tile size); a separate
case checks that the port gives zeros and lse = -inf.

f32 matmuls run in full precision: ``torch.backends.cuda.matmul.allow_tf32``
is set False.  The kernel against its plain version on the card is in
``test_torch_kernels_cuda.py``, which imports no jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 1, 2, 1, 8, 8, 32))
    with pytest.raises(NotImplementedError):
        attention(q.requires_grad_(), k, v)


def test_dispatch_follows_input_device():
    q, k, v = (torch.from_numpy(x) for x in _mk(1, 1, 2, 1, 8, 8, 32))
    assert on_cuda(q, k, v) is False
    with pytest.raises(ValueError):
        on_cuda(q, k.to("meta"))
