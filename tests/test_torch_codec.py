"""The port's checkpoint codec ops (K1-K3, their plain versions on the CPU)
held against the host codec and the JAX reference.

The same inputs, made with numpy from a seed, go through the port's
``quantize`` / ``quantize_delta`` / ``dequantize`` and:

* ``blocks.quantize_np`` / ``dequantize_np`` (the wire codec of the
  service): codes, scales and dequantized values bit for bit;
* JAX's ``quantize(impl="xla")`` with ROADMAP's tolerance: codes differ by
  at most 1 on fewer than 1e-3 of the values (XLA may turn x / scale into
  x * (1 / scale)), scales to rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ckpt_codec import quantize as jax_quantize  # noqa: E402
from repro_torch.kernels.ckpt_codec import (BLOCK, dequantize,  # noqa: E402
                                            dequantize_np, quantize,
                                            quantize_delta, quantize_np,
                                            to_blocks_np,
                                            undelta_dequantize)
from repro_torch.kernels.ckpt_codec.ops import _to_blocks  # noqa: E402

NS = [1, 255, 256, 257, 4096, 100_000]
DTYPES = ["float32", "float16", "bfloat16"]


def _x(n, dtype, seed=0, mul=1.0):
    rng = np.random.default_rng(seed + n)
    x = (rng.standard_normal(n) * mul).astype(np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _blocks_bound(x: torch.Tensor) -> np.ndarray:
    """Per-block bound absmax/127 * 0.51 of the roundtrip error."""
    blocks = _to_blocks(x.float())[0].numpy()
    return np.abs(blocks).max(axis=1) / 127 * 0.51


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_quantize_matches_host_codec_bit_for_bit(n, dtype):
    x = _x(n, dtype, mul=3.0)
    q, s = quantize(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (-(-n // BLOCK), BLOCK) and s.shape == (q.shape[0], 1)
    hq, hs = quantize_np(to_blocks_np(x.float().numpy())[0])
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(s.numpy(), hs)
    y = dequantize(q, s, (n,), torch.float32)
    np.testing.assert_array_equal(y.numpy(),
                                  dequantize_np(hq, hs, n, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_quantize_matches_jax_xla(n, dtype):
    x = _x(n, dtype, seed=1)
    q, s = quantize(x)
    jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    jq, js = jax_quantize(jx, impl="xla")
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_delta_roundtrip_and_bound(n, dtype):
    x0 = _x(n, dtype, seed=2)
    x1 = (x0.float() + _x(n, "float32", seed=3) * 0.01).to(x0.dtype)
    q0, _ = quantize(x0)
    d, s1, q1 = quantize_delta(x1, q0)
    np.testing.assert_array_equal(torch.bitwise_xor(d, q0).numpy(),
                                  q1.numpy())
    hq1, hs1 = quantize_np(to_blocks_np(x1.float().numpy())[0])
    np.testing.assert_array_equal(q1.numpy(), hq1)
    np.testing.assert_array_equal(s1.numpy(), hs1)
    y = undelta_dequantize(d, q0, s1, (n,), x1.dtype)
    assert y.dtype == x1.dtype and y.shape == (n,)
    err = _to_blocks((y.float() - x1.float()).abs())[0].numpy().max(axis=1)
    # the cast back to f16/bf16 adds at most half an ulp of the value
    slack = {"float32": 0.0, "float16": 2 ** -11,
             "bfloat16": 2 ** -8}[dtype]
    absmax = _to_blocks(x1.float().abs())[0].numpy().max(axis=1)
    assert np.all(err <= _blocks_bound(x1) + slack * absmax + 1e-7)


def test_zero_block_scale_is_one():
    q, s = quantize(torch.zeros(BLOCK))
    assert torch.all(q == 0) and torch.all(s == 1.0)


def test_identical_input_gives_zero_delta():
    x = _x(5000, "float32", seed=4)
    q, _ = quantize(x)
    d, _, q2 = quantize_delta(x, q)
    assert torch.all(d == 0) and torch.equal(q2, q)


@pytest.mark.parametrize("shape", [(17,), (33, 65), (4, 5, 6)])
def test_roundtrip_error_bound_per_block(shape):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)
                         .astype(np.float32) * 10)
    q, s = quantize(x)
    y = dequantize(q, s, shape)
    assert y.shape == x.shape
    err = _to_blocks((y - x).abs())[0].numpy().max(axis=1)
    assert np.all(err <= _blocks_bound(x) + 1e-7)


def test_aligned_contiguous_leaf_is_a_view():
    x = torch.randn(4, 2 * BLOCK)
    blocks, n = _to_blocks(x)
    assert n == x.numel() and blocks.data_ptr() == x.data_ptr()
