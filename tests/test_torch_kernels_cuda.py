"""The port's Hopper kernels against their plain PyTorch versions, on the
card.  Imports no jax, so it runs on a machine with a CUDA card and no jax:

  python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Every test skips without a card.  Tolerances:

* flash-attention forward: f32 atol 3e-5, bf16 atol 3e-2 on the output
  and its error norm at most 2^-7 of the plain output's, lse atol 1e-4,
  on rows with an allowed key;
* flash-attention backward, from the same (q, k, v, out, lse, do): f32
  atol 1e-4 + rtol 1e-4 (f32 sums in another order); bf16 dq, dk, dv each
  within twice SDPA's error of the plain backward run on f32 copies of the
  inputs, in max abs and in the error norm over each tile of 64 rows (the
  tensor-core kernels round P and dS to bf16 for their products, as SDPA
  does; ``torch_flash_checks.py``); two runs are bit-equal (no atomics);
* bf16 runs on the sm90 (wgmma + TMA) libraries and f32 on the FMA ones,
  with the same tolerances, at every head dim, ragged T and S at the new
  tile sizes, a window edge that crosses a tile, GQA groups 1 to 16 and
  rows with no allowed key; a misaligned bf16 input raises;
* codec K1-K3: bit-equal to the plain version and to the numpy host codec,
  K3 also at row counts around its 16-row trips;
* RWKV-6 (K6) against its plain chunked version: f32 atol 2e-3 (the
  reference's kernel tests), bf16 r/k/v the same plus rtol 2^-7 on o (one
  bf16 rounding of an f32 value apart), for the sequential kernel and
  the chunked tensor-core one (which takes bf16 prefill: ragged chunks
  and sub-chunks, extreme decay, zero and carried states); two runs
  bit-equal; the carried state continues a run within atol 1e-5 where
  the split falls on a chunk boundary of both runs, within the tolerance
  above where it does not;
* Reed-Solomon encode (K5): bit-equal to the numpy host codec;
* RG-LRU scan (K7), both kernels (loads in registers, ``rglru.cu``, and by
  TMA, ``rglru_sm90.cu``) against their plain chunked version: h_final
  and an f32 h within atol 2e-4 (the reference's kernel tests), a bf16 h
  within atol 2e-4 + rtol 2^-7 (one bf16 rounding of an f32 value apart);
  the TMA kernel bit-equal to the register kernel at every shape and ring
  depth (the same f32 steps); two runs bit-equal; [0, T/2) then [T/2, T)
  and one-token steps equal to one shot; ``ops.rglru`` routes by length;
* the flash-attention forward at head dim 160 (pixtral-12b, its serving
  shape (4, 32, 8, 768, 768) among them) in f32 and bf16, and the sm90
  cases at 160, with the forward's tolerances; its backward there (GQA,
  causal and not, a window, T != S both ways, and the sm90 cases) with the
  backward's tolerances below, two runs bit-equal; non-causal T != S
  (cross-attention) at D 64 in the forward and backward sweeps;
* the flash-attention forward at head dim 256 (recurrentgemma-9b's MQA
  layers): the forward's tolerances above; its backward there (MQA,
  causal, a window shorter than T): f32 on the FMA kernel within the f32
  backward's tolerance, bf16 on the wgmma kernel within twice SDPA's error
  as at the lower head dims; two runs bit-equal;
* the backward kernels of K6 and K7 against their plain backwards, over
  the sweeps above in f32 and bf16, with and without s0 / h0, with nonzero
  cotangents of the final state (dsT / dh_last); two runs bit-equal;
  ``ops`` takes inputs that require grad on CUDA through them.  RG-LRU:
  atol 2e-4 (the reference's kernel tests) + rtol 1e-5 (lam grows with the
  memory 1 / (1 - a)), a bf16 dg + rtol 2^-7.  K7's backward has two
  kernels, routed as the forward by length and width (at least
  ``SM90_BWD_MIN_T`` tokens whose rows TMA can read to the TMA one,
  ``rglru_bwd_sm90.cu``), bit-equal to each other at every shape and ring
  depth and each held to the same tolerances, with dh_last and without.
  RWKV-6: atol 2e-3 (the
  reference's kernel tests) + rtol 1e-5, bf16 dr, dk, dv + rtol 2^-7; at
  decays below -30 (unclamped in the backward, as in the reference) every
  gradient also within |L| 2^-23 of the call's largest, L the largest
  cumulative log-decay over a chunk of the plain version (its exponents'
  f32 resolution).  K6's backward has two kernels, routed as the forward
  (bf16 of at least ``SM90_MIN_T`` tokens to the chunked tensor-core one,
  ``rwkv6_bwd_sm90.cu``), each held to the same tolerances;
* the int8 KV cache (tensor ops, no kernel of its own): ``_q8`` and
  ``_dq`` on the card bit-equal to the CPU's; a tiny int8 prefill (K4)
  and 8 decode steps against the CPU, codes at most one step apart on at
  most 1e-3 of them, logits within the CPU's own int8-against-exact
  difference plus 1e-4 and argmax-equal;
* the op counter (``launch/opcount.py``): one small step (full width, a
  layer or a super-layer, 320 tokens; yi-6b trained, prefilled and
  decoded, rwkv6-7b and recurrentgemma-9b trained) counted on the card
  and traced on ``meta`` gives equal FLOPs, bytes and kernel records
  (K4, K6, K7 forward and backward), and K4's records equal its launches;
* the MoE serving shapes of K4's bf16 forward (qwen3-moe-235b-a22b's GQA
  16:1 at D 64, dbrx-132b's 48/8 at D 128) with the forward's tolerances;
  ``moe_apply`` (tensor ops, no kernel of its own) on the card against
  the same call on the CPU in f32: expert ids and kept assignments
  equal, y and aux within 1e-5 of their largest; two bf16 runs on the
  card bit-equal (dispatch writes unique slots, combine sums a view: no
  atomics).

``allow_tf32`` is False so the plain versions' f32 matmuls are full f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ckpt_codec import (dequantize_np, quantize_np,  # noqa: E402
                                            to_blocks_np)
from repro_torch.kernels.flash_attention import (attention,  # noqa: E402
                                                 attention_bwd_ref,
                                                 attention_ref)
from repro_torch.kernels.flash_attention.ref import allowed_mask  # noqa: E402
from torch_flash_checks import (FWD_REL_BF16, check_bf16_grads,  # noqa: E402
                                fwd_rel_err, sdpa_grads, summary)

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
    # non-causal T != S at D 64, as cross-attention calls it: more queries
    # than keys, and fewer
    (2, 4, 4, 100, 37, 64, False, None),
    (1, 4, 2, 64, 200, 64, False, None),
]
# the forward also at head dim 160 (pixtral-12b): ragged, GQA, a window,
# T < S, no mask, and its serving shape
FWD_SWEEP = SWEEP + [
    (1, 4, 2, 100, 130, 160, True, None),
    (2, 4, 1, 96, 96, 160, True, 32),
    (1, 2, 2, 72, 200, 160, False, None),
    (4, 32, 8, 768, 768, 160, True, None),
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
@pytest.mark.parametrize("case", FWD_SWEEP)
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
    if dtype == "bfloat16":
        assert fwd_rel_err(out, ref, live) <= FWD_REL_BF16


# K4 at the local shapes of a two-way "model" split (sharding/tp.py):
# yi-6b's prefill (16 of 32 heads, 2 of 4 KV heads) and qwen2.5-3b's
# training shape (8 of 16, 1 of 2)
TP_CASES = [(4, 16, 2, 512, 512, 128, True, None),
            (1, 8, 1, 4096, 4096, 128, True, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TP_CASES)
def test_kernel_matches_plain_at_model_split_shapes(card, case, dtype):
    test_kernel_matches_plain(card, case, dtype)


def test_bwd_kernel_at_model_split_training_shape(card):
    got, run = _check_bwd(card, TP_CASES[1], "bfloat16")
    for g, g2 in zip(got, run()):
        assert torch.equal(g, g2)


# K4 at recurrentgemma-9b's attention on a rank of a two-way "model"
# split: 8 of its 16 query heads over its one kv head, gathered whole
# (D 256, window 2048), at its prefill and at its training shape
TP_D256_CASES = [(4, 8, 1, 512, 512, 256, True, 2048),
                 (1, 8, 1, 4096, 4096, 256, True, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TP_D256_CASES)
def test_kernel_matches_plain_at_recurrent_model_split_shapes(card, case,
                                                              dtype):
    test_kernel_matches_plain(card, case, dtype)


def test_bwd_kernel_at_recurrent_model_split_training_shape(card):
    got, run = _check_bwd(card, TP_D256_CASES[1], "bfloat16")
    for g, g2 in zip(got, run()):
        assert torch.equal(g, g2)


# K4 at the MoE models' prefill on a rank of a two-way "model" split
# (their experts over "model" too): dbrx-132b's 24 of 48 query heads over
# 4 of 8 kv heads at D 128, qwen3-moe-235b-a22b's 32 of 64 over 2 of 4 at
# D 64
TP_MOE_CASES = [(4, 24, 4, 512, 512, 128, True, None),
                (4, 32, 2, 512, 512, 64, True, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TP_MOE_CASES)
def test_kernel_matches_plain_at_moe_model_split_shapes(card, case, dtype):
    test_kernel_matches_plain(card, case, dtype)


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


# recurrentgemma-9b's attention: 16 query heads of 256 over one KV head,
# causal, window 2048; its prefill shape, and a window that hides keys
D256_CASES = [
    (1, 4, 1, 300, 300, 256, True, 128),
    (4, 16, 1, 512, 512, 256, True, 2048),
    (1, 16, 1, 2560, 2560, 256, True, 2048),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", D256_CASES)
def test_kernel_matches_plain_at_head_dim_256(card, case, dtype):
    test_kernel_matches_plain(card, case, dtype)


# recurrentgemma-9b's backward: MQA, causal, windows shorter than T, ragged
# T and S at the tiles of 64 keys and 32-key ring tiles, T < S
D256_BWD_CASES = [
    (1, 4, 1, 300, 300, 256, True, 128),
    (2, 8, 1, 200, 333, 256, True, 100),
    (1, 16, 1, 1100, 1100, 256, True, 1024),
]


@pytest.mark.parametrize("case", D256_BWD_CASES)
def test_bwd_kernel_at_head_dim_256(card, libraries, case):
    """f32 through ``flash_bwd.cu`` against the plain backward; bf16
    through ``flash_bwd_sm90.cu`` (wgmma) within twice SDPA's error of the
    plain backward on f32 copies, as at the lower head dims; two runs of
    each bit-equal."""
    for dtype in ("float32", "bfloat16"):
        got, run = _check_bwd(card, case, dtype)
        for g, g2 in zip(got, run()):
            assert torch.equal(g, g2)
    assert libraries == ["flash_bwd"] * 2 + ["flash_bwd_sm90"] * 2


BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4)}


def _check_bwd(card, case, dtype, seed=7):
    """The backward kernel on one case against the plain backward; returns
    its (dq, dk, dv) and the inputs' call so a test can run it again."""
    from repro_torch.kernels.flash_attention import kernel

    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _mk(card, seed, b, hq, hkv, t, s, d, dtype)
    dout = _mk(card, seed + 1, b, hq, hkv, t, s, d, dtype)[0]
    out, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)
    n0 = kernel.bwd_launches

    def run():
        return kernel.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)

    got = run()
    torch.cuda.synchronize()
    assert kernel.bwd_launches == n0 + 1
    if dtype == "float32":
        want = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype],
                                       msg=lambda m, name=name: f"{name}: {m}")
        return got, run
    want = attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                             lse, dout.float(), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
    res = check_bf16_grads(str(case), got, want,
                           sdpa_grads(q, k, v, dout, causal, window))
    print(f"{case}: {summary(res)}")
    return got, run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_bwd_kernel_matches_plain(card, case, dtype):
    got, run = _check_bwd(card, case, dtype)
    again = run()
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


def test_bwd_rows_without_allowed_key_give_zero_grads(card):
    q, k, v = _mk(card, 3, 1, 2, 1, 16, 8, 64, "float32")
    for x in (q, k, v):
        x.requires_grad_()
    out = attention(q, k, v, causal=True)
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert torch.all(q.grad[:, :, :8] == 0)
    assert torch.isfinite(k.grad).all() and torch.isfinite(v.grad).all()


def test_autograd_goes_through_both_kernels(card):
    from repro_torch.kernels.flash_attention import kernel

    q, k, v = _mk(card, 5, 1, 4, 2, 128, 128, 64, "bfloat16")
    for x in (q, k, v):
        x.requires_grad_()
    f0, b0 = kernel.launches, kernel.bwd_launches
    attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert (kernel.launches - f0, kernel.bwd_launches - b0) == (1, 1)
    assert q.grad.dtype == torch.bfloat16 and k.grad.shape == k.shape


# --------------------------------------------------------------------------
# K4 in bf16: the sm90 kernels (wgmma fed by TMA)
# --------------------------------------------------------------------------
# (b, hq, hkv, t, s, causal, window) at each head dim: T = 1 under S > T,
# T and S ragged at the tiles of 64 and 128 rows, a window whose edge
# crosses a tile, GQA groups 1, 2, 8 and 16, T > S (the first T - S rows
# see no key), and no mask
SM90_CASES = [
    (1, 4, 4, 1, 160, True, None),
    (1, 4, 2, 127, 127, True, None),
    (2, 8, 1, 129, 200, True, None),
    (1, 16, 1, 200, 333, True, 100),
    (1, 4, 2, 96, 40, True, None),
    (1, 2, 2, 200, 200, False, None),
]


@pytest.fixture
def libraries(monkeypatch):
    """The names of the kernel libraries each call of the wrappers ran."""
    from repro_torch.kernels.flash_attention import kernel

    called = []
    real = kernel._call

    def spy(name, *args):
        called.append(name)
        return real(name, *args)

    monkeypatch.setattr(kernel, "_call", spy)
    return called


@pytest.mark.parametrize("case", SM90_CASES)
@pytest.mark.parametrize("d", [32, 64, 128, 160, 256])
def test_sm90_fwd_matches_plain(card, libraries, d, case):
    b, hq, hkv, t, s, causal, window = case
    test_kernel_matches_plain(card, (b, hq, hkv, t, s, d, causal, window),
                              "bfloat16")
    assert libraries == ["flash_fwd_sm90"]
    q, k, v = _mk(card, 7, b, hq, hkv, t, s, d, "bfloat16")
    out, lse = attention(q, k, v, causal=causal, window=window,
                         return_lse=True)
    dead = ~allowed_mask(t, s, causal, window, s - t, card).any(dim=1)
    assert torch.all(out[:, :, dead] == 0)
    assert torch.all(torch.isneginf(lse[:, :, dead]))


@pytest.mark.parametrize("case", SM90_CASES)
@pytest.mark.parametrize("d", [32, 64, 128, 160, 256])
def test_sm90_bwd_matches_plain(card, libraries, d, case):
    b, hq, hkv, t, s, causal, window = case
    (dq, _, _), _ = _check_bwd(card, (b, hq, hkv, t, s, d, causal, window),
                               "bfloat16")
    assert libraries == ["flash_bwd_sm90"]
    dead = ~allowed_mask(t, s, causal, window, s - t, card).any(dim=1)
    assert torch.all(dq[:, :, dead] == 0)


# pixtral-12b's backward at head dim 160: GQA 2:1 and 4:1 with T < S
# ragged at the 64-key blocks, a window, non-causal T < S and T > S (as
# cross-attention calls it), MHA, and a longer causal GQA run
D160_BWD_CASES = [
    (1, 4, 2, 100, 130, 160, True, None),
    (2, 4, 1, 96, 96, 160, True, 32),
    (1, 2, 2, 72, 200, 160, False, None),
    (2, 4, 4, 100, 37, 160, False, None),
    (1, 8, 2, 520, 520, 160, True, None),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", D160_BWD_CASES)
def test_bwd_kernel_at_head_dim_160(card, libraries, case, dtype):
    """f32 through ``flash_bwd.cu`` against the plain backward within the
    f32 tolerance; bf16 through ``flash_bwd_sm90.cu``'s query-split dk/dv
    kernel within twice SDPA's error of the plain backward on f32 copies;
    two runs of each bit-equal."""
    got, run = _check_bwd(card, case, dtype)
    for g, g2 in zip(got, run()):
        assert torch.equal(g, g2)
    lib = "flash_bwd_sm90" if dtype == "bfloat16" else "flash_bwd"
    assert libraries == [lib] * 2


def test_sm90_bwd_runs_are_bit_equal(card, libraries):
    got, run = _check_bwd(card, (2, 8, 2, 384, 384, 64, True, None),
                          "bfloat16", seed=11)
    for g, g2 in zip(got, run()):
        assert torch.equal(g, g2)
    assert libraries == ["flash_bwd_sm90"] * 2


def test_f32_stays_on_the_fma_kernels(card, libraries):
    q, k, v = _mk(card, 5, 1, 4, 2, 64, 64, 64, "float32")
    for x in (q, k, v):
        x.requires_grad_()
    attention(q, k, v).sum().backward()
    torch.cuda.synchronize()
    assert libraries == ["flash_fwd", "flash_bwd"]


def test_sm90_rejects_a_misaligned_input(card):
    """TMA needs 16-byte aligned bases; the wrapper raises, never copies."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    q, k, v = _mk(card, 1, 1, 2, 1, 64, 64, 64, "bfloat16")
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    q_odd = buf[1:].view(q.shape)
    q_odd.copy_(q)
    assert q_odd.is_contiguous() and q_odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(q_odd, k, v, causal=True, window=None,
                             scale=0.125)
    lse = torch.zeros((1, 2, 64), device=card)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_cuda(q_odd, k, v, q, lse, q, causal=True,
                                 window=None, scale=0.125)


CODEC_NS = [1, 255, 256, 257, 4096, 100_000]
CODEC_DTYPES = ["float32", "bfloat16", "float16"]


@pytest.mark.parametrize("dtype", CODEC_DTYPES)
@pytest.mark.parametrize("n", CODEC_NS)
def test_codec_kernels_match_plain_bit_for_bit(card, n, dtype):
    from repro_torch.kernels.ckpt_codec import (dequantize, kernel, quantize,
                                                quantize_delta, ref)
    from repro_torch.kernels.ckpt_codec.ops import _to_blocks

    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 3) \
        .to(card, getattr(torch, dtype))
    x1 = x + torch.from_numpy(rng.standard_normal(n).astype(np.float32)
                              * 0.01).to(card, x.dtype)
    blocks = _to_blocks(x)[0]
    n0 = dict(kernel.launches)
    q, s = quantize(x)
    d, s1, q1 = quantize_delta(x1, q)
    y = dequantize(q1, s1, (n,), x.dtype)
    torch.cuda.synchronize()
    assert {k: kernel.launches[k] - n0[k] for k in n0} == \
        {"quantize": 1, "quantize_delta": 1, "dequantize": 1}
    rq, rs = ref.quantize_ref(blocks)
    rd, rs1, rq1 = ref.quantize_delta_ref(_to_blocks(x1)[0], rq)
    for got, want in ((q, rq), (s, rs), (d, rd), (s1, rs1), (q1, rq1)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(y, ref.dequantize_ref(rq1, rs1, x.dtype)
                       .reshape(-1)[:n])
    hq, hs = quantize_np(to_blocks_np(x.float().cpu().numpy())[0])
    np.testing.assert_array_equal(q.cpu().numpy(), hq)
    np.testing.assert_array_equal(s.cpu().numpy(), hs)
    want_y = dequantize_np(q1.cpu().numpy(), s1.cpu().numpy(), n, np.float32)
    np.testing.assert_array_equal(y.float().cpu().numpy(),
                                  torch.from_numpy(want_y).to(x.dtype)
                                  .float().numpy())
    assert torch.equal(torch.bitwise_xor(d, q), q1)


def test_codec_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.ckpt_codec import kernel

    x = torch.zeros((4, 256), device=card)
    with pytest.raises(ValueError, match="dtype"):
        kernel.quantize_cuda(x.double())
    with pytest.raises(ValueError, match="256"):
        kernel.quantize_cuda(torch.zeros((4, 128), device=card))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.quantize_cuda(x.cpu())
    with pytest.raises(ValueError, match="prev_q"):
        kernel.quantize_delta_cuda(x, torch.zeros((4, 256), device=card))


# --------------------------------------------------------------------------
# K6: the RWKV-6 recurrence, against its plain chunked version
# --------------------------------------------------------------------------
# the sweep of tests/test_kernels_rwkv6.py, plus rwkv6-7b's prefill and
# decode shapes; (b, h, t, d)
RWKV_SWEEP = [(2, 3, 130, 64), (1, 2, 64, 32), (1, 1, 7, 16),
              (4, 64, 512, 64), (4, 64, 1, 64)]
# f32: atol 2e-3 (the reference's kernel tests); bf16 r/k/v: the same plus
# rtol 2^-7 on o (both round one f32 value to bf16)
RWKV_TOL = {"float32": (2e-3, 0.0), "bfloat16": (2e-3, 2 ** -7)}


def _rwkv_inputs(card, seed, b, h, t, d, dtype, decay_scale=1.0):
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(card)

    r, k, v = (f((b, h, t, d), 0.5).to(getattr(torch, dtype))
               for _ in range(3))
    lw = -torch.exp(f((b, h, t, d), 1.0)) * decay_scale
    return r, k, v, lw, f((h, d), 0.5), f((b, h, d, d), 0.1)


def _rwkv_check(got, want, dtype):
    atol, rtol = RWKV_TOL[dtype]
    assert got[0].dtype == want[0].dtype and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(got[1], want[1], atol=atol, rtol=0)


def _rwkv_counts():
    from repro_torch.kernels.rwkv6 import kernel

    return kernel.launches, kernel.sm90_launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RWKV_SWEEP)
def test_rwkv6_kernel_matches_plain(card, case, dtype):
    from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_chunked

    inputs = _rwkv_inputs(card, 3, *case, dtype)
    n0 = sum(_rwkv_counts())
    got = rwkv6(*inputs)
    torch.cuda.synchronize()
    assert sum(_rwkv_counts()) == n0 + 1
    _rwkv_check(got, rwkv6_chunked(*inputs), dtype)
    again = rwkv6(*inputs)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
def test_rwkv6_kernel_extreme_decay(card, decay_scale):
    """log_w far below -30 is clamped as the plain version clamps it."""
    from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_chunked

    inputs = _rwkv_inputs(card, 4, 1, 2, 96, 32, "float32", decay_scale)
    assert (inputs[3] < -30).any()
    got = rwkv6(*inputs)
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    _rwkv_check(got, rwkv6_chunked(*inputs, chunk=32), "float32")


def test_rwkv6_kernel_state_continuation(card):
    """[0, T/2) then [T/2, T) from the carried state == one shot, and T = 1
    steps from the carried state continue it."""
    from repro_torch.kernels.rwkv6 import rwkv6

    r, k, v, lw, u, s0 = _rwkv_inputs(card, 5, 2, 4, 64, 64, "float32")
    o, s = rwkv6(r, k, v, lw, u, s0)
    o1, s1 = rwkv6(r[:, :, :32], k[:, :, :32], v[:, :, :32], lw[:, :, :32],
                   u, s0)
    o2, s2 = rwkv6(r[:, :, 32:], k[:, :, 32:], v[:, :, 32:], lw[:, :, 32:],
                   u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 2), o, atol=1e-5, rtol=0)
    torch.testing.assert_close(s2, s, atol=1e-5, rtol=0)
    st, outs = s1, []
    for t in range(32, 64):
        ot, st = rwkv6(r[:, :, t:t + 1], k[:, :, t:t + 1], v[:, :, t:t + 1],
                       lw[:, :, t:t + 1], u, st)
        outs.append(ot)
    torch.testing.assert_close(torch.cat(outs, 2), o2, atol=1e-5, rtol=0)
    torch.testing.assert_close(st, s, atol=1e-5, rtol=0)


def _rwkv_bwd_inputs(card, seed, b, h, t, d, dtype, decay_scale=1.0):
    """The forward's inputs and the cotangents (do, dsT) of (o, sT)."""
    rng = np.random.default_rng(seed + 100)
    inputs = _rwkv_inputs(card, seed, b, h, t, d, dtype, decay_scale)
    do = torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(
        np.float32)).to(card, getattr(torch, dtype))
    dsT = torch.from_numpy(rng.standard_normal((b, h, d, d)).astype(
        np.float32)).to(card)
    return inputs, do, dsT


def _rwkv_bwd_check(got, want, dtype, extra_atol=0.0):
    atol, rtol = RWKV_TOL[dtype]
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"), got,
                          want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rt = rtol if name in ("dr", "dk", "dv") else 0.0
        torch.testing.assert_close(
            g.float(), w.float(), atol=atol + extra_atol, rtol=rt + 1e-5,
            msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RWKV_SWEEP)
def test_rwkv6_bwd_kernel_matches_plain(card, case, dtype, with_s0):
    from repro_torch.kernels.rwkv6 import kernel
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(card, 3, *case, dtype)
    s0 = s0 if with_s0 else None
    n0 = kernel.bwd_launches
    got = kernel.rwkv6_bwd_cuda(r, k, v, lw, u, s0, do, dsT)
    torch.cuda.synchronize()
    assert kernel.bwd_launches == n0 + 1
    _rwkv_bwd_check(got, rwkv6_bwd_ref(r, k, v, lw, u, s0, do, dsT), dtype)
    again = kernel.rwkv6_bwd_cuda(r, k, v, lw, u, s0, do, dsT)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
def test_rwkv6_bwd_kernel_extreme_decay(card, decay_scale):
    """log_w far below -30: the backward takes it unclamped, as the
    reference's and the plain one do."""
    from repro_torch.kernels.rwkv6.kernel import rwkv6_bwd_cuda
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(
        card, 4, 1, 2, 96, 32, "float32", decay_scale)
    assert (lw < -30).any()
    got = rwkv6_bwd_cuda(r, k, v, lw, u, s0, do, dsT)
    want = rwkv6_bwd_ref(r, k, v, lw, u, s0, do, dsT)
    assert all(torch.isfinite(g).all() for g in got)
    lwp = torch.nn.functional.pad(lw, (0, 0, 0, 32)).reshape(1, 2, 2, 64, 32)
    L = lwp.cumsum(3).abs().max().item()
    top = max(w.abs().max().item() for w in want)
    _rwkv_bwd_check(got, want, "float32", L * 2.0 ** -23 * top)


def _rwkv_bwd_counts():
    from repro_torch.kernels.rwkv6 import kernel

    return kernel.bwd_launches, kernel.bwd_sm90_launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [7, 64, 130])
def test_rwkv6_autograd_goes_through_the_backward_kernel(card, t, dtype):
    """``ops.rwkv6`` on inputs that require grad: the forward kernel once,
    a backward kernel once (the chunked one for bf16 of at least
    SM90_MIN_T tokens, else the sequential one), never autograd over the
    plain version; the gradients are that kernel's."""
    from repro_torch.kernels.rwkv6 import kernel, rwkv6
    from repro_torch.kernels.rwkv6.ops import SM90_MIN_T

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(card, 6, 1, 2, t, 64,
                                                     dtype)
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
    n0 = (sum(_rwkv_counts()), _rwkv_bwd_counts())
    o, sT = rwkv6(*leaves)
    grads = torch.autograd.grad((o, sT), leaves, (do, dsT))
    torch.cuda.synchronize()
    chunked = dtype == "bfloat16" and t >= SM90_MIN_T
    seq, sm90 = (a - b for a, b in zip(_rwkv_bwd_counts(), n0[1]))
    assert (sum(_rwkv_counts()) - n0[0], seq, sm90) == \
        ((1, 0, 1) if chunked else (1, 1, 0))
    run = kernel.rwkv6_bwd_sm90_cuda if chunked else kernel.rwkv6_bwd_cuda
    for g, w in zip(grads, run(r, k, v, lw, u, s0, do, dsT)):
        assert torch.equal(g, w)


# the chunked backward: the sweep's cases of at least 32 tokens, ragged T
# and rwkv6-7b's training width over 512 tokens; (b, h, t, d)
RWKV_BWD_SM90_CASES = [(2, 3, 130, 64), (1, 2, 64, 32), (1, 2, 100, 32),
                       (2, 2, 40, 16), (1, 16, 512, 64)]


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("case", RWKV_BWD_SM90_CASES)
def test_rwkv6_bwd_sm90_matches_plain(card, case, with_s0):
    """The chunked tensor-core backward on bf16 against the plain one, from
    s0 and from none, a nonzero dsT: atol 2e-3 + rtol 1e-5, bf16 dr, dk,
    dv + rtol 2^-7; two runs bit-equal."""
    from repro_torch.kernels.rwkv6 import kernel
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(card, 3, *case,
                                                     "bfloat16")
    s0 = s0 if with_s0 else None
    n0 = _rwkv_bwd_counts()
    got = kernel.rwkv6_bwd_sm90_cuda(r, k, v, lw, u, s0, do, dsT)
    torch.cuda.synchronize()
    assert _rwkv_bwd_counts() == (n0[0], n0[1] + 1)
    _rwkv_bwd_check(got, rwkv6_bwd_ref(r, k, v, lw, u, s0, do, dsT),
                    "bfloat16")
    again = kernel.rwkv6_bwd_sm90_cuda(r, k, v, lw, u, s0, do, dsT)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
def test_rwkv6_bwd_sm90_extreme_decay(card, decay_scale):
    """log_w far below -30, unclamped: finite (products of w underflow to
    0, never overflow) and the plain backward's within the tolerance plus
    |L| 2^-23 of the largest gradient (the plain version's exponents)."""
    from repro_torch.kernels.rwkv6.kernel import rwkv6_bwd_sm90_cuda
    from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(
        card, 4, 1, 2, 96, 32, "bfloat16", decay_scale)
    assert (lw < -30).any()
    got = rwkv6_bwd_sm90_cuda(r, k, v, lw, u, s0, do, dsT)
    want = rwkv6_bwd_ref(r, k, v, lw, u, s0, do, dsT)
    assert all(torch.isfinite(g.float()).all() for g in got)
    lwp = torch.nn.functional.pad(lw, (0, 0, 0, 32)).reshape(1, 2, 2, 64, 32)
    L = lwp.cumsum(3).abs().max().item()
    top = max(w.float().abs().max().item() for w in want)
    _rwkv_bwd_check(got, want, "bfloat16", L * 2.0 ** -23 * top)


@pytest.mark.parametrize("dtype,t,route", [
    ("bfloat16", 31, "sequential"), ("bfloat16", 32, "sm90"),
    ("bfloat16", 130, "sm90"), ("float32", 130, "sequential")])
@pytest.mark.parametrize("misaligned", [False, True])
def test_rwkv6_bwd_routing(card, dtype, t, route, misaligned):
    """The backward of ``ops.rwkv6`` follows the forward's rule; r/k/v at
    an odd storage offset take the same route and give the same
    gradients."""
    from repro_torch.kernels.rwkv6 import rwkv6

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(card, 15, 1, 2, t, 32,
                                                     dtype)
    leaves = [r, k, v, lw, u, s0]
    if misaligned:
        for i in range(3):
            buf = torch.empty(leaves[i].numel() + 1, dtype=leaves[i].dtype,
                              device=card)
            leaves[i] = buf[1:].view(leaves[i].shape)
            leaves[i].copy_((r, k, v)[i])
            assert leaves[i].data_ptr() % 16
    leaves = [x.detach().requires_grad_() for x in leaves]
    n0 = _rwkv_bwd_counts()
    o, sT = rwkv6(*leaves)
    grads = torch.autograd.grad((o, sT), leaves, (do, dsT))
    seq, sm90 = (a - b for a, b in zip(_rwkv_bwd_counts(), n0))
    assert (seq, sm90) == ((0, 1) if route == "sm90" else (1, 0))
    if misaligned:
        plain = [x.detach().clone().requires_grad_()
                 for x in (r, k, v, lw, u, s0)]
        o, sT = rwkv6(*plain)
        want = torch.autograd.grad((o, sT), plain, (do, dsT))
        assert all(torch.equal(x, y) for x, y in zip(grads, want))


def test_rwkv6_bwd_sm90_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rwkv6.kernel import rwkv6_bwd_sm90_cuda

    (r, k, v, lw, u, s0), do, dsT = _rwkv_bwd_inputs(card, 16, 1, 2, 64, 32,
                                                     "bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        rwkv6_bwd_sm90_cuda(r.float(), k.float(), v.float(), lw, u, s0,
                            do.float(), dsT)
    buf = torch.empty(do.numel() + 1, dtype=do.dtype, device=card)
    do_odd = buf[1:].view(do.shape)
    do_odd.copy_(do)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_bwd_sm90_cuda(r, k, v, lw, u, s0, do_odd, dsT)


def test_rwkv6_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rwkv6 import rwkv6
    from repro_torch.kernels.rwkv6.kernel import rwkv6_cuda

    r, k, v, lw, u, s0 = _rwkv_inputs(card, 7, 1, 2, 8, 16, "float32")
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_cuda(*(x[..., :8].contiguous() for x in (r, k, v, lw)),
                   u[:, :8].contiguous(), s0[..., :8, :8].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        rwkv6_cuda(r.half(), k.half(), v.half(), lw, u, s0)
    with pytest.raises(ValueError, match="log_w"):
        rwkv6_cuda(r, k, v, lw.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_cuda(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, lw,
                   u, s0)
    with pytest.raises(ValueError, match="u must be"):
        rwkv6(r, k, v, lw, u[:1], s0)


# rwkv6-7b's prefill and decode shapes on a rank of a two-way "model"
# split: 32 of its 64 heads; (b, h, t, d)
RWKV_TP_CASES = [(4, 32, 512, 64), (4, 32, 1, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RWKV_TP_CASES)
def test_rwkv6_kernel_matches_plain_at_model_split_shapes(card, case, dtype):
    test_rwkv6_kernel_matches_plain(card, case, dtype)


def test_rwkv6_kernels_at_model_split_shapes_route_as_on_one_rank(card):
    """The split prefill's bf16 call takes the chunked kernel, the decode
    step's the sequential one."""
    from repro_torch.kernels.rwkv6 import rwkv6

    for case, sm90 in zip(RWKV_TP_CASES, (1, 0)):
        inputs = _rwkv_inputs(card, 3, *case, "bfloat16")
        n0 = _rwkv_counts()
        rwkv6(*inputs)
        torch.cuda.synchronize()
        n1 = _rwkv_counts()
        assert (n1[0] - n0[0], n1[1] - n0[1]) == (1 - sm90, sm90)


@pytest.mark.parametrize("t", [1, 7, 16, 63, 64, 65, 130, 512])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_rwkv6_sm90_matches_plain(card, d, t):
    """The chunked tensor-core kernel on bf16 r/k/v: ragged chunks (T not
    a multiple of 64) and sub-chunks (not of 16), from a carried and from
    a zero state; two runs bit-equal."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_sm90_cuda

    r, k, v, lw, u, s0 = _rwkv_inputs(card, 11, 2, 3, t, d, "bfloat16")
    for state in (s0, torch.zeros_like(s0)):
        got = rwkv6_sm90_cuda(r, k, v, lw, u, state)
        again = rwkv6_sm90_cuda(r, k, v, lw, u, state)
        torch.cuda.synchronize()
        _rwkv_check(got, rwkv6_chunked(r, k, v, lw, u, state), "bfloat16")
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
@pytest.mark.parametrize("d", [32, 64])
def test_rwkv6_sm90_extreme_decay(card, d, decay_scale):
    """log_w far below -30: finite, clamped as the plain version clamps
    (running products of exp(-30) underflow to 0, never overflow)."""
    from repro_torch.kernels.rwkv6 import rwkv6_chunked
    from repro_torch.kernels.rwkv6.kernel import rwkv6_sm90_cuda

    inputs = _rwkv_inputs(card, 4, 1, 2, 150, d, "bfloat16", decay_scale)
    assert (inputs[3] < -30).any()
    got = rwkv6_sm90_cuda(*inputs)
    assert torch.isfinite(got[0].float()).all()
    assert torch.isfinite(got[1]).all()
    _rwkv_check(got, rwkv6_chunked(*inputs), "bfloat16")


@pytest.mark.parametrize("split", [64, 100])
def test_rwkv6_sm90_state_continuation(card, split):
    """[0, split) then [split, T) from the carried state against one shot:
    within atol 1e-5 at a chunk boundary (the same chunks either way),
    within the bf16 tolerance off it (other chunks)."""
    from repro_torch.kernels.rwkv6 import rwkv6

    r, k, v, lw, u, s0 = _rwkv_inputs(card, 12, 2, 4, 256, 64, "bfloat16")
    o, s = rwkv6(r, k, v, lw, u, s0)
    parts = [(x[:, :, :split], x[:, :, split:]) for x in (r, k, v, lw)]
    o1, s1 = rwkv6(*(a for a, _ in parts), u, s0)
    o2, s2 = rwkv6(*(b for _, b in parts), u, s1)
    got = (torch.cat([o1, o2], 2), s2)
    if split % 64 == 0:
        torch.testing.assert_close(got[0].float(), o.float(), atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(got[1], s, atol=1e-5, rtol=0)
    else:
        _rwkv_check(got, (o, s), "bfloat16")


@pytest.mark.parametrize("dtype,t,route", [
    ("bfloat16", 1, "sequential"), ("bfloat16", 31, "sequential"),
    ("bfloat16", 32, "sm90"), ("bfloat16", 512, "sm90"),
    ("float32", 1, "sequential"), ("float32", 512, "sequential")])
@pytest.mark.parametrize("misaligned", [False, True])
def test_rwkv6_routing(card, dtype, t, route, misaligned):
    """``ops.rwkv6`` sends bf16 with at least SM90_MIN_T tokens to the
    chunked kernel, everything else to the sequential one; contiguous
    r/k/v/log_w at an odd storage offset take the same route and give the
    same result."""
    from repro_torch.kernels.rwkv6 import rwkv6
    from repro_torch.kernels.rwkv6.ops import SM90_MIN_T

    assert (route == "sm90") == (dtype == "bfloat16" and t >= SM90_MIN_T)
    inputs = _rwkv_inputs(card, 13, 1, 2, t, 64, dtype)
    args = list(inputs)
    if misaligned:
        for i in range(4):            # r, k, v, log_w one element in
            buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype,
                              device=card)
            args[i] = buf[1:].view(args[i].shape)
            args[i].copy_(inputs[i])
            assert args[i].is_contiguous() and args[i].data_ptr() % 16
    n0 = _rwkv_counts()
    got = rwkv6(*args)
    seq, sm90 = (a - b for a, b in zip(_rwkv_counts(), n0))
    assert (seq, sm90) == ((0, 1) if route == "sm90" else (1, 0))
    if misaligned:
        want = rwkv6(*inputs)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_rwkv6_sm90_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rwkv6.kernel import rwkv6_sm90_cuda

    r, k, v, lw, u, s0 = _rwkv_inputs(card, 14, 1, 2, 8, 16, "bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        rwkv6_sm90_cuda(r.float(), k.float(), v.float(), lw, u, s0)
    buf = torch.empty(r.numel() + 1, dtype=r.dtype, device=card)
    r_odd = buf[1:].view(r.shape)
    r_odd.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_sm90_cuda(r_odd, k, v, lw, u, s0)


@pytest.mark.parametrize("dtype", CODEC_DTYPES)
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 15, 16, 17, 100_003])
def test_dequantize_kernel_row_counts(card, rows, dtype):
    """K3 takes 16 rows a warp-trip: whole trips, partial ones and one
    row, bit-equal to the host codec in each output dtype."""
    from repro_torch.kernels.ckpt_codec import kernel

    rng = np.random.default_rng(rows)
    q = rng.integers(-127, 128, (rows, 256)).astype(np.int8)
    s = (rng.random((rows, 1)) * 0.1).astype(np.float32)
    got = kernel.dequantize_cuda(torch.from_numpy(q).to(card),
                                 torch.from_numpy(s).to(card),
                                 getattr(torch, dtype))
    want = dequantize_np(q, s, rows * 256, np.float32)
    np.testing.assert_array_equal(
        got.float().reshape(-1).cpu().numpy(),
        torch.from_numpy(want).to(getattr(torch, dtype)).float().numpy())


# --------------------------------------------------------------------------
# K5: the Reed-Solomon encode, bit for bit against the host codec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 15, 16, 33, 513, 4097, 100_003])
def test_rs_encode_kernel_matches_host_codec(card, k, m, n):
    from repro_torch.kernels.ckpt_codec import rs_encode, rs_encode_np
    from repro_torch.kernels.ckpt_codec import rs_kernel

    data = np.random.default_rng(10 * k + n).integers(0, 256, (k, n),
                                                      dtype=np.uint8)
    n0 = rs_kernel.launches
    got = rs_encode(torch.from_numpy(data).to(card), m=m)
    torch.cuda.synchronize()
    assert rs_kernel.launches == n0 + 1
    assert got.dtype == torch.uint8 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.cpu().numpy(), rs_encode_np(data, m))


def test_rs_encode_kernel_on_a_view_at_an_odd_address(card):
    """Rows that start at no 16-byte boundary, and data whose first byte
    does not either."""
    from repro_torch.kernels.ckpt_codec import rs_encode, rs_encode_np

    buf = np.random.default_rng(2).integers(0, 256, 4 * 1001 + 3,
                                            dtype=np.uint8)
    dev = torch.from_numpy(buf).to(card)[3:].view(4, 1001)
    got = rs_encode(dev, m=2)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  rs_encode_np(buf[3:].reshape(4, 1001), 2))


def test_rs_encode_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.ckpt_codec.rs_kernel import rs_encode_cuda

    x = torch.zeros((4, 64), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="m=3"):
        rs_encode_cuda(x, 3)
    with pytest.raises(ValueError, match="uint8"):
        rs_encode_cuda(x.int(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        rs_encode_cuda(x.t(), 1)


# --------------------------------------------------------------------------
# K7: the RG-LRU scan, against its plain chunked version
# --------------------------------------------------------------------------
# the sweep of tests/test_kernels_rglru.py, plus recurrentgemma-9b's
# prefill and decode shapes, its ring sub-phase's prefill and ragged cases
# of the TMA kernel (T not a multiple of its chunk, over several chunks; D
# a multiple of its 32-channel strip and not, and for f32 g a multiple of
# 4 but not of 8, which ends a row halfway into a helper's 8-channel
# store); (b, t, d)
RGLRU_SWEEP = [(2, 100, 256), (1, 64, 128), (1, 5, 512), (3, 33, 96),
               (4, 512, 4096), (4, 1, 4096), (1, 2560, 4096), (3, 100, 96),
               (3, 100, 104), (5, 100, 1000), (1, 300, 104), (1, 320, 100),
               (3, 100, 100)]
RGLRU_TOL = {"float32": (2e-4, 0.0), "bfloat16": (2e-4, 2 ** -7)}


def _rglru_inputs(card, seed, b, t, d, dtype):
    """log_a, g, h0 as tests/test_kernels_rglru.py makes them."""
    rng = np.random.default_rng(seed)
    la = -np.exp(rng.standard_normal((b, t, d))).astype(np.float32)
    g = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return (torch.from_numpy(la).to(card),
            torch.from_numpy(g).to(card, getattr(torch, dtype)),
            torch.from_numpy(h0).to(card))


def _rglru_check(got, want, dtype):
    atol, rtol = RGLRU_TOL[dtype]
    assert got[0].dtype == want[0].dtype and got[1].dtype == torch.float32
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(got[1], want[1], atol=2e-4, rtol=0)


def _rglru_counts():
    from repro_torch.kernels.rglru import kernel

    return kernel.launches, kernel.sm90_launches


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_SWEEP)
def test_rglru_kernel_matches_plain(card, case, dtype, with_h0):
    """Through ``ops.rglru``, which launches one of the two kernels."""
    from repro_torch.kernels.rglru import rglru, rglru_chunked

    la, g, h0 = _rglru_inputs(card, 3, *case, dtype)
    h0 = h0 if with_h0 else None
    n0 = sum(_rglru_counts())
    got = rglru(la, g, h0)
    torch.cuda.synchronize()
    assert sum(_rglru_counts()) == n0 + 1
    _rglru_check(got, rglru_chunked(la, g, h0), dtype)
    again = rglru(la, g, h0)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_SWEEP)
def test_rglru_sm90_kernel_matches_plain_and_register_kernel(
        card, case, dtype, with_h0):
    """The TMA kernel called directly, below ``SM90_MIN_T`` too: within the
    tolerance of the plain version, bit-equal to the register kernel, two
    runs bit-equal; rows TMA cannot read (bf16 g, D not a multiple of 8)
    raise."""
    from repro_torch.kernels.rglru import rglru_chunked
    from repro_torch.kernels.rglru.kernel import (rglru_cuda,
                                                  rglru_sm90_cuda,
                                                  row_multiple)

    la, g, h0 = _rglru_inputs(card, 3, *case, dtype)
    h0 = h0 if with_h0 else None
    n0 = _rglru_counts()
    if case[2] % row_multiple(g.dtype):
        with pytest.raises(ValueError, match="multiple of 8"):
            rglru_sm90_cuda(la, g, h0)
        assert _rglru_counts() == n0
        return
    got = rglru_sm90_cuda(la, g, h0)
    again = rglru_sm90_cuda(la, g, h0)
    torch.cuda.synchronize()
    assert _rglru_counts() == (n0[0], n0[1] + 2)
    _rglru_check(got, rglru_chunked(la, g, h0), dtype)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for x, y in zip(got, rglru_cuda(la, g, h0)))


# recurrentgemma-9b's prefill, decode and training shapes on a rank of a
# two-way "model" split: 2048 of its 4096 channels; (b, t, d)
RGLRU_TP_CASES = [(4, 512, 2048), (4, 1, 2048), (1, 4096, 2048)]


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_TP_CASES)
def test_rglru_kernels_match_plain_at_model_split_shapes(card, case, dtype,
                                                         with_h0):
    test_rglru_kernel_matches_plain(card, case, dtype, with_h0)
    test_rglru_sm90_kernel_matches_plain_and_register_kernel(
        card, case, dtype, with_h0)


@pytest.mark.parametrize("case,stages", [
    ((4, 32, 4096), 1), ((4, 64, 4096), 2), ((4, 96, 4096), 3),
    ((4, 512, 4096), 3), ((1, 128, 4096), 1), ((1, 256, 4096), 2),
    ((1, 2560, 4096), 3), ((5, 100, 1000), 3)])
def test_rglru_sm90_ring_depths(card, case, stages):
    """``plan``'s ring of one, two and three stages (by T), over one pass
    of the ring and many (the barrier phases wrap): bit-equal to the
    register kernel."""
    from repro_torch.kernels.rglru.kernel import (plan, rglru_cuda,
                                                  rglru_sm90_cuda)

    assert plan(*case)[1] == stages
    la, g, h0 = _rglru_inputs(card, 8, *case, "bfloat16")
    got = rglru_sm90_cuda(la, g, h0)
    assert all(torch.equal(x, y) for x, y in zip(got, rglru_cuda(la, g, h0)))


@pytest.mark.parametrize("d", [4096, 100])
@pytest.mark.parametrize("t", [1, 255, 320, 512])
def test_rglru_routing(card, t, d):
    """``ops.rglru`` sends calls of at least SM90_MIN_T tokens whose rows
    TMA can address (D a multiple of 8 for bf16 g) to the TMA kernel,
    everything else to the register kernel; a view at an odd offset takes
    the same route and gives the same result."""
    from repro_torch.kernels.rglru import rglru
    from repro_torch.kernels.rglru.ops import SM90_MIN_T

    sm90 = t >= SM90_MIN_T and d % 8 == 0
    assert sm90 == (t in (320, 512) and d == 4096)
    la, g, h0 = _rglru_inputs(card, 9, 1, t, d, "bfloat16")
    n0 = _rglru_counts()
    got = rglru(la, g, h0)
    n1 = _rglru_counts()
    assert (n1[0] - n0[0], n1[1] - n0[1]) == ((0, 1) if sm90 else (1, 0))
    buf = torch.empty(g.numel() + 1, dtype=g.dtype, device=card)
    g_odd = buf[1:].view(g.shape)
    g_odd.copy_(g)
    assert g_odd.is_contiguous() and g_odd.data_ptr() % 16
    n1 = _rglru_counts()
    odd = rglru(la, g_odd, h0)
    n2 = _rglru_counts()
    assert (n2[0] - n1[0], n2[1] - n1[1]) == ((0, 1) if sm90 else (1, 0))
    assert all(torch.equal(x, y) for x, y in zip(got, odd))


def test_rglru_sm90_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rglru.kernel import rglru_sm90_cuda

    la, g, h0 = _rglru_inputs(card, 10, 1, 64, 104, "bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        rglru_sm90_cuda(la, g.half(), h0)
    buf = torch.empty(g.numel() + 1, dtype=g.dtype, device=card)
    g_odd = buf[1:].view(g.shape)
    g_odd.copy_(g)
    with pytest.raises(ValueError, match="16-byte"):
        rglru_sm90_cuda(la, g_odd, h0)
    la, g, h0 = _rglru_inputs(card, 10, 1, 64, 100, "bfloat16")
    with pytest.raises(ValueError, match="multiple of 8"):
        rglru_sm90_cuda(la, g, h0)
    la, g, h0 = _rglru_inputs(card, 10, 1, 64, 98, "float32")
    with pytest.raises(ValueError, match="multiple of 4"):
        rglru_sm90_cuda(la, g, h0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_kernel_state_continuation(card, dtype):
    """[0, T/2) then [T/2, T) from the carried state, and T = 1 steps from
    it, equal one shot: the kernel takes the same f32 steps."""
    from repro_torch.kernels.rglru import rglru

    la, g, h0 = _rglru_inputs(card, 5, 4, 64, 4096, dtype)
    h, hT = rglru(la, g, h0)
    h1, s1 = rglru(la[:, :32].contiguous(), g[:, :32].contiguous(), h0)
    h2, s2 = rglru(la[:, 32:].contiguous(), g[:, 32:].contiguous(), s1)
    assert torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(s2, hT)
    st, outs = s1, []
    for t in range(32, 64):
        ht, st = rglru(la[:, t:t + 1].contiguous(),
                       g[:, t:t + 1].contiguous(), st)
        outs.append(ht)
    assert torch.equal(torch.cat(outs, 1), h2) and torch.equal(st, hT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_sm90_state_continuation(card, dtype):
    """The serving path's hand-off: a prefill on the TMA kernel, [0, T/2)
    then [T/2, T) on it too, and one-token steps on the register kernel
    from its carried state, all equal to one shot."""
    from repro_torch.kernels.rglru import rglru
    from repro_torch.kernels.rglru.ops import SM90_MIN_T

    t = 2 * SM90_MIN_T
    la, g, h0 = _rglru_inputs(card, 11, 4, t, 4096, dtype)
    n0 = _rglru_counts()
    h, hT = rglru(la, g, h0)
    h1, s1 = rglru(la[:, :t // 2], g[:, :t // 2], h0)
    h2, s2 = rglru(la[:, t // 2:], g[:, t // 2:], s1)
    assert _rglru_counts() == (n0[0], n0[1] + 3)
    assert torch.equal(torch.cat([h1, h2], 1), h) and torch.equal(s2, hT)
    hp, st = rglru(la[:, :t - 8], g[:, :t - 8], h0)
    outs = [hp]
    for i in range(t - 8, t):
        ht, st = rglru(la[:, i:i + 1], g[:, i:i + 1], st)
        outs.append(ht)
    assert _rglru_counts() == (n0[0] + 8, n0[1] + 4)
    assert torch.equal(torch.cat(outs, 1), h) and torch.equal(st, hT)


def _rglru_bwd_inputs(card, seed, b, t, d, dtype):
    """log_a, the forward's h (plain), h0 and the cotangents (dh, dh_last)
    of (h, h_final)."""
    from repro_torch.kernels.rglru import rglru_chunked

    la, g, h0 = _rglru_inputs(card, seed, b, t, d, dtype)
    h = rglru_chunked(la, g, h0)[0].contiguous()
    rng = np.random.default_rng(seed + 100)
    dh = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(card, getattr(torch, dtype))
    dh_last = torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(card)
    return la, g, h, h0, dh, dh_last


def _rglru_bwd_check(got, want, dtype):
    atol, rtol = RGLRU_TOL[dtype]
    for name, x, w in zip(("dlog_a", "dg", "dh0"), got, want):
        if w is None:
            assert x is None, name
            continue
        assert x.dtype == w.dtype and x.shape == w.shape, name
        torch.testing.assert_close(
            x.float(), w.float(), atol=atol,
            rtol=(rtol if name == "dg" else 0.0) + 1e-5,
            msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_SWEEP)
def test_rglru_bwd_kernel_matches_plain(card, case, dtype, with_h0):
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref

    la, _, h, h0, dh, dh_last = _rglru_bwd_inputs(card, 3, *case, dtype)
    h0 = h0 if with_h0 else None
    n0 = kernel.bwd_launches
    got = kernel.rglru_bwd_cuda(la, h, h0, dh, dh_last)
    torch.cuda.synchronize()
    assert kernel.bwd_launches == n0 + 1
    _rglru_bwd_check(got, rglru_bwd_ref(la, h, h0, dh, dh_last), dtype)
    again = kernel.rglru_bwd_cuda(la, h, h0, dh, dh_last)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 100, 512])
def test_rglru_autograd_goes_through_the_backward_kernel(card, t, dtype):
    """``ops.rglru`` on inputs that require grad: one forward kernel
    launch, one backward kernel launch (the TMA one from SM90_BWD_MIN_T
    tokens, else the register one), never autograd over the plain
    version; the gradients are that kernel's from the forward's own h."""
    from repro_torch.kernels.rglru import kernel, rglru
    from repro_torch.kernels.rglru.ops import SM90_BWD_MIN_T

    la, g, _, h0, dh, dh_last = _rglru_bwd_inputs(card, 6, 2, t, 256, dtype)
    leaves = [x.clone().requires_grad_() for x in (la, g, h0)]
    n0 = (sum(_rglru_counts()), _rglru_bwd_counts())
    h, h_last = rglru(*leaves)
    grads = torch.autograd.grad((h, h_last), leaves, (dh, dh_last))
    torch.cuda.synchronize()
    sm90 = t >= SM90_BWD_MIN_T
    reg, tma = (a - b for a, b in zip(_rglru_bwd_counts(), n0[1]))
    assert (sum(_rglru_counts()) - n0[0], reg, tma) == \
        ((1, 0, 1) if sm90 else (1, 1, 0))
    run = kernel.rglru_bwd_sm90_cuda if sm90 else kernel.rglru_bwd_cuda
    want = run(la, h.detach(), h0, dh, dh_last)
    for x, w in zip(grads, want):
        assert torch.equal(x, w)


def _rglru_bwd_counts():
    from repro_torch.kernels.rglru import kernel

    return kernel.bwd_launches, kernel.bwd_sm90_launches


# recurrentgemma-9b's training shape: one 4096-token sequence
RGLRU_TRAIN = (1, 4096, 4096)


@pytest.mark.parametrize("with_dh_last", [True, False])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_SWEEP + [RGLRU_TRAIN])
def test_rglru_bwd_sm90_matches_plain_and_register_kernel(
        card, case, dtype, with_h0, with_dh_last):
    """The TMA backward called directly, below ``SM90_BWD_MIN_T`` too (T
    below one chunk, T not a multiple of it, D a multiple of 8 but not of
    32): within the tolerance of the plain backward, bit-equal to the
    register kernel, two runs bit-equal; rows TMA cannot read (bf16, D not
    a multiple of 8) raise."""
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref

    la, _, h, h0, dh, dh_last = _rglru_bwd_inputs(card, 3, *case, dtype)
    args = (la, h, h0 if with_h0 else None, dh,
            dh_last if with_dh_last else None)
    n0 = _rglru_bwd_counts()
    if case[2] % kernel.row_multiple(h.dtype):
        with pytest.raises(ValueError, match="multiple of 8"):
            kernel.rglru_bwd_sm90_cuda(*args)
        assert _rglru_bwd_counts() == n0
        return
    got = kernel.rglru_bwd_sm90_cuda(*args)
    again = kernel.rglru_bwd_sm90_cuda(*args)
    torch.cuda.synchronize()
    assert _rglru_bwd_counts() == (n0[0], n0[1] + 2)
    _rglru_bwd_check(got, rglru_bwd_ref(*args), dtype)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(got, kernel.rglru_bwd_cuda(*args)):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("case,stages", [
    ((4, 32, 4096), 1), ((4, 64, 4096), 2), ((4, 96, 4096), 3),
    ((4, 512, 4096), 3), ((1, 128, 4096), 1), ((1, 256, 4096), 2),
    ((1, 4096, 4096), 3), ((5, 100, 1000), 3)])
def test_rglru_bwd_sm90_ring_depths(card, case, stages):
    """``plan``'s ring of one, two and three stages (by T), over one pass
    of the ring and many (the barrier phases wrap), walked backwards:
    bit-equal to the register kernel."""
    from repro_torch.kernels.rglru.kernel import (plan, rglru_bwd_cuda,
                                                  rglru_bwd_sm90_cuda)

    assert plan(*case)[1] == stages
    la, _, h, h0, dh, dh_last = _rglru_bwd_inputs(card, 8, *case, "bfloat16")
    got = rglru_bwd_sm90_cuda(la, h, h0, dh, dh_last)
    want = rglru_bwd_cuda(la, h, h0, dh, dh_last)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("d", [4096, 100])
@pytest.mark.parametrize("below", [True, False])
def test_rglru_bwd_routing(card, below, d):
    """``ops.rglru``'s backward sends calls of at least SM90_BWD_MIN_T
    tokens whose rows TMA can address (D a multiple of 8 for bf16 h) to the
    TMA backward, everything else to the register one; a cotangent that
    is a view at an odd offset takes the same route and gives the same
    gradients."""
    from repro_torch.kernels.rglru import rglru
    from repro_torch.kernels.rglru.ops import SM90_BWD_MIN_T

    t = SM90_BWD_MIN_T - 1 if below else SM90_BWD_MIN_T
    sm90 = not below and d == 4096
    la, g, _, h0, dh, dh_last = _rglru_bwd_inputs(card, 9, 1, t, d,
                                                  "bfloat16")
    buf = torch.empty(dh.numel() + 1, dtype=dh.dtype, device=card)
    dh_odd = buf[1:].view(dh.shape)
    dh_odd.copy_(dh)
    assert dh_odd.is_contiguous() and dh_odd.data_ptr() % 16
    grads = []
    for cot in (dh, dh_odd):
        leaves = [x.clone().requires_grad_() for x in (la, g, h0)]
        h, h_last = rglru(*leaves)
        n0 = _rglru_bwd_counts()
        grads.append(torch.autograd.grad((h, h_last), leaves,
                                         (cot, dh_last)))
        n1 = _rglru_bwd_counts()
        assert (n1[0] - n0[0], n1[1] - n0[1]) == ((0, 1) if sm90 else (1, 0))
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_rglru_bwd_sm90_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rglru.kernel import rglru_bwd_sm90_cuda

    la, _, h, h0, dh, dh_last = _rglru_bwd_inputs(card, 10, 1, 64, 104,
                                                  "bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        rglru_bwd_sm90_cuda(la, h.half(), h0, dh.half(), dh_last)
    with pytest.raises(ValueError, match="dh has dtype"):
        rglru_bwd_sm90_cuda(la, h, h0, dh.float(), dh_last)
    with pytest.raises(ValueError, match="dh_last"):
        rglru_bwd_sm90_cuda(la, h, h0, dh, dh_last[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_bwd_sm90_cuda(la, h, h0,
                            dh.transpose(1, 2).contiguous().transpose(1, 2),
                            dh_last)
    for name in ("log_a", "h", "dh"):
        x = {"log_a": la, "h": h, "dh": dh}[name]
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)
        odd = buf[1:].view(x.shape)
        odd.copy_(x)
        args = {"log_a": la, "h": h, "dh": dh, name: odd}
        with pytest.raises(ValueError, match=f"{name} is not 16-byte"):
            rglru_bwd_sm90_cuda(args["log_a"], args["h"], h0, args["dh"],
                                dh_last)
    la, _, h, h0, dh, dh_last = _rglru_bwd_inputs(card, 10, 1, 64, 100,
                                                  "bfloat16")
    with pytest.raises(ValueError, match="multiple of 8"):
        rglru_bwd_sm90_cuda(la, h, h0, dh, dh_last)
    la, _, h, h0, dh, dh_last = _rglru_bwd_inputs(card, 10, 1, 64, 98,
                                                  "float32")
    with pytest.raises(ValueError, match="multiple of 4"):
        rglru_bwd_sm90_cuda(la, h, h0, dh, dh_last)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_bwd_sm90_cuda(la.cpu(), h.cpu(), h0.cpu(), dh.cpu(),
                            dh_last.cpu())


def test_rglru_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.rglru.kernel import rglru_cuda

    la, g, h0 = _rglru_inputs(card, 7, 2, 8, 64, "float32")
    with pytest.raises(ValueError, match="dtype"):
        rglru_cuda(la, g.half(), h0)
    with pytest.raises(ValueError, match="log_a"):
        rglru_cuda(la.bfloat16(), g, h0)
    with pytest.raises(ValueError, match="h0"):
        rglru_cuda(la, g, h0[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_cuda(la, g.transpose(1, 2).contiguous().transpose(1, 2), h0)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_cuda(la.cpu(), g.cpu(), h0.cpu())


# --------------------------------------------------------------------------
# the int8 KV cache: tensor ops, no kernel of its own, on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 32, 544, 128), (2, 4, 33, 256),
                                   (2, 3, 7, 6), (1 << 16, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_on_the_card_bit_equal_to_cpu(card, shape, dtype):
    from repro_torch.models.attention import _dq, _q8

    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.uniform(-8, 8, shape[:-1] + (1,))).astype(np.float32)
    x[..., :min(4, shape[-1])] = 0.0
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = _q8(x)
    gq, gs = _q8(x.to(card))
    assert gq.is_cuda and gs.is_cuda
    assert torch.equal(gq.cpu(), q)
    assert torch.equal(gs.cpu().view(torch.int16), s.view(torch.int16))
    d = _dq(gq, gs)
    assert d.is_cuda
    assert torch.equal(d.cpu().view(torch.int32), _dq(q, s).view(torch.int32))


def test_int8_prefill_and_decode_on_the_card(card):
    """Tiny deepseek-7b widened to head dim 32 (a dim K4 takes), f32, an
    int8 cache: prefill through K4 and 8 greedy decode steps on the card
    against the CPU, both fed the CPU's tokens.  The codes on the card lie
    at most one step from the CPU's (f32 sums in another order can cross
    a rounding edge), on at most 1e-3 of them; the logits within the CPU's
    own int8-against-exact difference (every code rounded by up to half a
    step) plus 1e-4, and argmax-equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models import decode_step, init_cache, init_params, \
        prefill

    exact = dataclasses.replace(get_config("deepseek-7b", tiny=True),
                                d_model=128)
    cfg = dataclasses.replace(exact, kv_quant=True)
    assert cfg.resolved_head_dim == 32
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    steps = 8
    out = {}
    for name, c, dev in (("cpu", cfg, torch.device("cpu")),
                         ("exact", exact, torch.device("cpu")),
                         ("card", cfg, card)):
        p = _to(params, dev)
        cache = init_cache(c, 2, 64 + steps, device=dev)
        n0 = kernel.launches
        with torch.no_grad():
            lg, cache = prefill(c, p, {"tokens": toks.to(dev)}, cache)
            if dev.type == "cuda":
                assert kernel.launches - n0 == c.num_layers
            # a copy: the decode steps below write into the cache
            codes = cache["stack"]["b0"]["self"].k.to("cpu", copy=True)
            logits = [lg.cpu()]
            for i in range(steps):
                nxt = out["cpu"][1][i].argmax(-1)[:, None] if "cpu" in out \
                    else logits[i].argmax(-1)[:, None]
                lg, cache = decode_step(c, p, cache,
                                        nxt.to(torch.int32).to(dev))
                logits.append(lg.cpu())
        out[name] = (codes, logits)
    step = (out["card"][0].int() - out["cpu"][0].int()).abs()
    assert int(step.max()) <= 1
    assert int((step > 0).sum()) <= 1e-3 * step.numel()
    e_q = max((a - b).abs().max().item()
              for a, b in zip(out["cpu"][1], out["exact"][1]))
    err = max((a - b).abs().max().item()
              for a, b in zip(out["card"][1], out["cpu"][1]))
    assert err <= e_q + 1e-4, (err, e_q)
    for a, b in zip(out["card"][1], out["cpu"][1]):
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# K4's bf16 forward at the MoE archs' serving shapes:
# qwen3-moe-235b-a22b (GQA 16:1, D 64) and dbrx-132b (48/8, D 128)
MOE_SERVE_CASES = [(4, 64, 4, 512, 512, 64, True, None),
                   (4, 48, 8, 512, 512, 128, True, None)]


@pytest.mark.parametrize("case", MOE_SERVE_CASES)
def test_kernel_matches_plain_at_moe_serving_shapes(card, case):
    test_kernel_matches_plain(card, case, "bfloat16")


def _moe_inputs(arch, t, seed=0):
    from repro_torch.configs import get_config

    cfg = get_config(arch, tiny=True)
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gu": rng.standard_normal((2, e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((2, t, d)).astype(np.float32))
    kw = dict(num_experts=e, experts_per_token=cfg.experts_per_token,
              capacity_factor=0.5, aux_coef=cfg.router_aux_coef)
    return cfg, p, x, kw


@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-moe-235b-a22b"])
def test_moe_apply_on_card_matches_cpu(card, arch, t):
    from repro_torch.models import moe

    cfg, p, x, kw = _moe_inputs(arch, t)
    cap = moe.capacity(t, cfg.num_experts, cfg.experts_per_token,
                       kw["capacity_factor"])
    out = {}
    for dev in (torch.device("cpu"), card):
        pd = {k: v.to(dev) for k, v in p.items()}
        _, _, ids = moe.route(pd, x.to(dev), cfg.experts_per_token)
        _, keep = moe.dispatch(ids, cap, cfg.num_experts)
        y, aux = moe.moe_apply(pd, x.to(dev), **kw)
        out[dev.type] = [a.cpu() for a in (ids, keep, y, aux)]
    (ids, keep, y, aux), (cids, ckeep, cy, caux) = out["cuda"], out["cpu"]
    assert torch.equal(ids, cids) and torch.equal(keep, ckeep)
    if t > 1:
        assert not bool(ckeep.all())          # capacity 0.5 drops
    assert (y - cy).abs().max().item() <= 1e-5 * cy.abs().max().item()
    assert abs(aux.item() - caux.item()) <= 1e-5 * abs(caux.item())


def test_moe_apply_bf16_runs_are_bit_equal(card):
    from repro_torch.models import moe

    _, p, x, kw = _moe_inputs("qwen3-moe-235b-a22b", 64, seed=1)
    p = {k: v.to(card, torch.bfloat16) for k, v in p.items()}
    x = x.to(card, torch.bfloat16)
    (y1, a1), (y2, a2) = (moe.moe_apply(p, x, **kw) for _ in range(2))
    assert y1.dtype == torch.bfloat16
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


# --------------------------------------------------------------------------
# sharding: a one-card NCCL world
# --------------------------------------------------------------------------
def test_make_mesh_on_one_card_snapshots_as_a_plain_tensor(card, tmp_path):
    """At world size 1 over NCCL, ``make_mesh`` (asked for 4 ranks) gives
    a one-card CUDA mesh, and a tree of DTensors replicated over it
    snapshots to the parts of the same plain tensors: raw bit-equal, q8
    codes equal; ``load_leaf_`` writes the parts back into the local
    shard."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.core.snapshot import load_leaf_, snapshot_pytree
    from repro_torch.sharding import init_world, make_mesh

    init_world(0, 1, "nccl", tmp_path / "store")
    try:
        mesh = make_mesh(4)
        assert mesh.device_type == "cuda" and mesh.size() == 1
        gen = torch.Generator(device=card).manual_seed(0)
        plain = {"w": torch.randn(300, 257, generator=gen, device=card),
                 "h": torch.randn(64, 8, generator=gen, device=card)
                 .to(torch.bfloat16),
                 "step": torch.full((), 7, dtype=torch.int32, device=card)}
        tree = {k: DTensor.from_local(v, mesh, [Replicate()],
                                      run_check=False)
                for k, v in plain.items()}
        for codec in ("raw", "q8"):
            got = snapshot_pytree(tree, codec=codec)
            want = snapshot_pytree(plain, codec=codec)
            assert got.regions.keys() == want.regions.keys()
            for name, r in want.regions.items():
                g = got.regions[name]
                assert g.meta.partition == r.meta.partition
                assert g.parts.keys() == r.parts.keys()
                for p, arr in r.parts.items():
                    np.testing.assert_array_equal(g.parts[p], arr)
                if r.encoded is not None:
                    assert g.encoded.blobs == r.encoded.blobs
        raw = snapshot_pytree(plain)
        kept = {k: v.clone() for k, v in plain.items()}
        for name, leaf in tree.items():
            leaf.to_local().zero_()        # the plain tensor's storage too
            r = raw.regions[name]
            load_leaf_(name, leaf, dataclasses.replace(r.meta), r.parts)
        for name, t in kept.items():
            local = tree[name].to_local()
            assert local.is_cuda and torch.equal(local, t)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the op counter: one step on the card and on meta
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind,layers", [
    ("yi-6b", "train", 1), ("yi-6b", "prefill", 1), ("yi-6b", "decode", 1),
    ("rwkv6-7b", "train", 1), ("recurrentgemma-9b", "train", 3)])
def test_step_counts_on_the_card_equal_the_meta_trace(card, arch, kind,
                                                      layers):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import report

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    shape = ShapeConfig(f"small_{kind}", kind, 320, 2)
    m = report.measure_cell(cfg, shape, batch=2,
                            microbatches=2 if kind == "train" else 1,
                            device=card)
    assert (m["flops"], m["bytes"]) == (m["meta_flops"], m["meta_bytes"])
    assert m["kernels"] == m["meta_kernels"]
    calls = sum(v["calls"] for v in
                report.k4_records(m["kernels"]).values())
    assert calls == m["k4_launches"]
    # decode and RWKV-6 run no flash attention
    assert (calls > 0) == (kind != "decode" and arch != "rwkv6-7b")
    if arch != "yi-6b":
        assert set(m["kernels"]) - set(report.K4_KERNELS)
