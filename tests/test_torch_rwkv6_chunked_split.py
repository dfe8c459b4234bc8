"""The algorithm of the chunked RWKV-6 tensor-core kernel (K6 for bf16
prefill, ``src/repro_torch/kernels/rwkv6/csrc/rwkv6_sm90.cu``), emulated
in plain PyTorch on the CPU and held against the port's plain versions.

The kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``
holds it there).  What it computes differs from ``rwkv6_chunked`` in two
ways that this file keeps tested:

* no exponent of a cumulative decay: running products of w = exp(log_w)
  inside sub-chunks of 16 tokens (and their halves of 8), reference points
  at sub-chunk boundaries across them, so every factor lies in [0, 1];
* every product of an f32 operand on the tensor cores splits it into bf16
  hi + lo: three products for two split operands, two against v (exact in
  bf16).  A single bf16 rounding of the same operands misses the state's
  tolerance (``test_single_pass_bf16_breaks_the_state_tolerance``).

Tolerance: ``RWKV_TOL`` of ``chip_smoke.py`` and the card tests, bf16
r/k/v: atol 2e-3 on the state and on o, plus rtol 2^-7 on o (one bf16
rounding of an f32 value apart).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels.rwkv6 import (LOG_W_MIN, rwkv6_chunked,  # noqa: E402
                                       rwkv6_ref)

C, SUB, HALF = 64, 16, 8
ATOL, RTOL = 2e-3, 2 ** -7


def _split(x, passes):
    """f32 -> (hi, lo), bf16 values held in f32; one pass keeps hi only."""
    hi = x.to(torch.bfloat16).float()
    if passes == 1:
        return hi, torch.zeros_like(hi)
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm(a, b, passes, b_exact=False):
    """a @ b as the kernel's mma.sync products: bf16 operands, f32 sums."""
    ah, al = _split(a, passes)
    if b_exact:
        return ah @ b + al @ b
    bh, bl = _split(b, passes)
    return ah @ bh + ah @ bl + al @ bh


def _prod(xs, like):
    out = torch.ones_like(like)
    for x in xs:
        out = out * x
    return out


def emulate(r, k, v, log_w, u, s0, passes=3):
    """What ``rwkv6_sm90_kernel`` computes, chunk by chunk, for all (b, h)
    at once; ``passes=1`` rounds each f32 operand to bf16 once instead."""
    b, h, t, d = r.shape
    tp = -(-t // C) * C
    pad = (0, 0, 0, tp - t)
    rf, kf, vf = (F.pad(x.float(), pad) for x in (r, k, v))
    w = torch.exp(F.pad(torch.clamp(log_w.float(), min=LOG_W_MIN), pad))
    uf = u.float()
    S = s0.float().clone()
    one = torch.ones(b, h, d)
    outs = []
    for c0 in range(0, tp, C):
        rt, kt, vt, wt = (x[:, :, c0:c0 + C] for x in (rf, kf, vf, w))
        # the walkers: E_i = k_i times the decay after i to token 15 of
        # its sub-chunk on the second half, to token 7 on the first; the
        # halves' decays
        E = torch.empty_like(kt)
        up, lo = [], []
        for a in range(4):
            run = one
            for j in reversed(range(SUB)):
                if j == HALF - 1:
                    up.append(run)
                    run = one
                E[:, :, SUB * a + j] = kt[:, :, SUB * a + j] * run
                run = run * wt[:, :, SUB * a + j]
            lo.append(run)
        W = [lo[a] * up[a] for a in range(4)]
        # Q_t from the sub-chunk's start; q2 from token 8 (rows 8..15)
        Q = torch.empty_like(rt)
        q2 = torch.empty(b, h, 4, HALF, d)
        for a in range(4):
            run = one
            for j in range(SUB):
                if j == HALF:
                    tot_lo = run
                    run = one
                if j >= HALF:
                    q2[:, :, a, j - HALF] = rt[:, :, SUB * a + j] * run
                    Q[:, :, SUB * a + j] = q2[:, :, a, j - HALF] * tot_lo
                else:
                    Q[:, :, SUB * a + j] = rt[:, :, SUB * a + j] * run
                run = run * wt[:, :, SUB * a + j]
        O = torch.zeros(b, h, C, d)
        for q in range(4):
            rows = slice(SUB * q, SUB * q + SUB)
            # inter-chunk: (Q prod_{x < q} W_x) S
            O[:, :, rows] = _mm(Q[:, :, rows] * _prod(W[:q], one)[:, :, None],
                                S, passes)
            A = torch.zeros(b, h, SUB, C)
            # keys of earlier sub-chunks, reference point: q's start
            if q:
                Kp = torch.cat([
                    E[:, :, SUB * a + half * HALF:SUB * a + (half + 1) * HALF]
                    * (_prod(W[a + 1:q], one)
                       * (up[a] if half == 0 else one))[:, :, None]
                    for a in range(q) for half in range(2)], 2)
                A[..., :SUB * q] = _mm(Q[:, :, rows], Kp.transpose(2, 3),
                                       passes)
            # the 8 x 8 block below the diagonal, reference point: token 8
            A[:, :, HALF:, SUB * q:SUB * q + HALF] = _mm(
                q2[:, :, q], E[:, :, SUB * q:SUB * q + HALF].transpose(2, 3),
                passes)
            # pairs inside 8 tokens: running products, and the bonus
            for half in range(2):
                base = SUB * q + HALF * half
                for i in range(HALF):
                    kd = kt[:, :, base + i]
                    for s in range(i + 1, HALF):
                        A[:, :, HALF * half + s, base + i] = (
                            rt[:, :, base + s] * kd).sum(-1)
                        kd = kd * wt[:, :, base + s]
                    A[:, :, HALF * half + i, base + i] = (
                        rt[:, :, base + i] * uf * kt[:, :, base + i]).sum(-1)
            O[:, :, rows] += _mm(A, vt, passes, b_exact=True)
        # the state: exp(L_C) S + Kd^T v, Kd from E with the decay to the
        # chunk's end
        Kd = torch.cat([
            E[:, :, SUB * a + half * HALF:SUB * a + (half + 1) * HALF]
            * (_prod(W[a + 1:], one)
               * (up[a] if half == 0 else one))[:, :, None]
            for a in range(4) for half in range(2)], 2)
        S = _prod(W, one)[..., None] * S \
            + _mm(Kd.transpose(2, 3), vt, passes, b_exact=True)
        outs.append(O)
    return torch.cat(outs, 2)[:, :, :t].to(v.dtype), S


def _inputs(seed, case, decay_scale=1.0):
    """bf16 r/k/v, f32 log_w, u, s0, made as ``chip_smoke._rwkv_inputs``
    makes them."""
    b, h, t, d = case
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    r, k, v = (f((b, h, t, d), 0.5).to(torch.bfloat16) for _ in range(3))
    lw = -torch.exp(f((b, h, t, d), 1.0)) * decay_scale
    return r, k, v, lw, f((h, d), 0.5), f((b, h, d, d), 0.1)


def _state_err(got, want):
    return (got[1] - want[1]).abs().max().item()


def _check(got, want):
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(got[1], want[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("decay_scale", [1.0, 10.0, 100.0])
@pytest.mark.parametrize("case", [(2, 3, 130, 64), (1, 2, 64, 32),
                                  (1, 1, 7, 16), (1, 2, 100, 32)])
def test_split_emulation_matches_plain(case, decay_scale):
    """Sub-chunk reference points, running products and split operands
    against the sequential oracle and the plain chunked version."""
    inputs = _inputs(3, case, decay_scale)
    if decay_scale > 1:
        assert (inputs[3] < LOG_W_MIN).any()
    got = emulate(*inputs)
    assert torch.isfinite(got[0].float()).all()
    assert torch.isfinite(got[1]).all()
    _check(got, rwkv6_chunked(*inputs))
    _check(got, rwkv6_ref(*inputs))


def test_split_emulation_from_a_zero_state():
    inputs = list(_inputs(5, (2, 2, 77, 64)))
    inputs[5] = torch.zeros_like(inputs[5])
    _check(emulate(*inputs), rwkv6_ref(*inputs))


def test_single_pass_bf16_breaks_the_state_tolerance():
    """rwkv6-7b's head width over 512 tokens (16 heads): one bf16 rounding
    of each f32 operand puts the state 3.2e-3 from the plain version's,
    over atol 2e-3; the split keeps it within 1e-4."""
    inputs = _inputs(3, (1, 16, 512, 64))
    want = rwkv6_chunked(*inputs)
    single = _state_err(emulate(*inputs, passes=1), want)
    split = _state_err(emulate(*inputs), want)
    assert single > ATOL, single
    assert split < 1e-4, split
