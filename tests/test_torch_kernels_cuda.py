"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Imports no jax, so it runs on a machine with a CUDA card and no jax:

  python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Every test skips without a card.  Tolerances: f32 atol 3e-5, bf16 atol
3e-2 on the output, lse atol 1e-4, on rows with an allowed key;
``allow_tf32`` is False so the plain version's f32 matmuls are full f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import attention, attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import allowed_mask  # noqa: E402

pytestmark = pytest.mark.cuda
torch.backends.cuda.matmul.allow_tf32 = False

# the sweep of tests/test_kernels_attention.py, plus yi-6b's prefill shape
SWEEP = [
    # b, hq, hkv, t, s, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 1, 100, 100, 32, True, None),
    (1, 4, 4, 64, 64, 128, False, None),
    (2, 4, 2, 96, 96, 32, True, 32),
    (1, 2, 1, 1, 160, 64, True, None),
    (1, 2, 2, 72, 200, 32, True, None),
    (4, 32, 4, 512, 512, 128, True, None),
]
ATOL = {"float32": 3e-5, "bfloat16": 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _mk(card, seed, b, hq, hkv, t, s, d, dtype):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to(card, getattr(torch, dtype))
        for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_kernel_matches_plain(card, case, dtype):
    from repro_torch.kernels.flash_attention import kernel

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _mk(card, 7, b, hq, hkv, t, s, d, dtype)
    n0 = kernel.launches
    out, lse = attention(q, k, v, causal=causal, window=window,
                         return_lse=True)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    ref, rlse = attention_ref(q, k, v, causal=causal, window=window)
    live = allowed_mask(t, s, causal, window, s - t, card).any(dim=1)
    torch.testing.assert_close(out.float()[:, :, live],
                               ref.float()[:, :, live],
                               atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse[:, :, live], rlse[:, :, live],
                               atol=1e-4, rtol=0)


def test_rows_without_allowed_key_are_zero(card):
    q, k, v = _mk(card, 3, 1, 2, 1, 16, 8, 64, "float32")
    out, lse = attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.all(out[:, :, :8] == 0)
    assert torch.all(torch.isneginf(lse[:, :, :8]))
    ref, _ = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out[:, :, 8:], ref[:, :, 8:], atol=3e-5,
                               rtol=0)


def test_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    q, k, v = _mk(card, 1, 1, 2, 1, 8, 8, 16, "float32")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, k, v, causal=True, window=None, scale=0.25)
    q, k, v = _mk(card, 1, 1, 2, 1, 8, 8, 32, "float32")
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), k.half(), v.half(), causal=True,
                             window=None, scale=0.25)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), k, v, causal=True,
                             window=None, scale=0.25)
