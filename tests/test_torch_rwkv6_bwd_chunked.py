"""The algorithm of the chunked RWKV-6 backward on the tensor cores (K6's
backward for bf16 r/k/v, ``src/repro_torch/kernels/rwkv6/csrc/
rwkv6_bwd_sm90.cu``), emulated in plain PyTorch on the CPU and held
against ``jax.vjp`` of the reference's chunked form (``repro.kernels.
rwkv6.ops._xla_chunked``, whose vjp is the reference's backward) and
against the port's plain backward ``rwkv6_bwd_ref``.

The kernel runs only on the card (``tests/test_torch_kernels_cuda.py``
holds it there).  What this file keeps tested is its arithmetic:

* three passes: each chunk's own state update and cotangent update
  (products of its tokens, in parallel over chunks); the scans over the
  chunks of S_{n+1} = W_n S_n + U_n and G_n = W_n G_{n+1} + V_n; then
  each chunk's gradients from S_n, S_{n+1} and G_{n+1};
* no exponent of a cumulative decay: running products of w = exp(log_w)
  (unclamped, the reference's answer) inside halves of 8 tokens, the
  forward kernel's reference points at sub-chunk (16 tokens) and half
  boundaries across them, so every decay factor lies in [0, 1];
* dlog_w in the chunked form: a reverse cumulative sum inside the chunk
  of r (dr - bonus) minus k (dk - bonus), plus the chunk-end term
  rowsum(G_{n+1} * S_{n+1});
* every product of an f32 operand split into bf16 hi + lo (three products
  for two split operands, two against an operand exact in bf16: v, do).

Tolerance: the card check's, atol 2e-3 + rtol 1e-5, bf16 dr, dk and dv
also rtol 2^-7 (one bf16 rounding apart); below -30 also |L| 2^-23 of the
call's largest gradient, as ``test_torch_rwkv6_grad.py`` holds the plain
backward (the reference's exponents are f32 differences of cumulative
sums).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models  # noqa: E402,F401
from repro.kernels.rwkv6.ops import _xla_chunked  # noqa: E402
from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref  # noqa: E402
from test_torch_rwkv6_chunked_split import _mm  # noqa: E402

C, SUB, HALF = 64, 16, 8
ATOL, RTOL = 2e-3, 1e-5
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")


def _prod(xs, like):
    out = torch.ones_like(like)
    for x in xs:
        out = out * x
    return out


def _mm_exact_a(a, b, passes):
    """a @ b with ``a`` exact in bf16 (do, v) and ``b`` split."""
    return _mm(b.transpose(-1, -2), a.transpose(-1, -2), passes,
               b_exact=True).transpose(-1, -2)


def _halves(w, forward):
    """Running decays inside each half of 8 tokens, per channel: forward,
    the decay from the half's start to t - 1; backward, from t + 1 to the
    half's end; and each half's whole decay (B, H, C / 8, D)."""
    run = torch.empty_like(w)
    whole = []
    for h0 in range(0, C, HALF):
        acc = torch.ones_like(w[:, :, 0])
        order = range(h0, h0 + HALF) if forward else \
            reversed(range(h0, h0 + HALF))
        for j in order:
            run[:, :, j] = acc
            acc = acc * w[:, :, j]
        whole.append(acc)
    return run, torch.stack(whole, 2)


def _same_half(dA, w, x, for_rows):
    """The pairs inside a half: for_rows (dr) sum_{i < t} dA[t, i] x_i
    prod_{i < m < t} w_m; else (dk) sum_{t > i} dA[t, i] x_t times the
    same decay; walked with running products, as the kernel's last pass."""
    out = torch.zeros_like(x)
    for h0 in range(0, C, HALF):
        for a in range(h0, h0 + HALF):
            run = x[:, :, a]
            if for_rows:        # key a walks the later rows t
                for t in range(a + 1, h0 + HALF):
                    out[:, :, t] += dA[:, :, t, a, None] * run
                    run = run * w[:, :, t]
            else:               # row a walks the earlier keys i
                for i in reversed(range(h0, a)):
                    out[:, :, i] += dA[:, :, a, i, None] * run
                    run = run * w[:, :, i]
    return out


def _chunk_factors(w):
    """The forward kernel's decay factors for one chunk (B, H, C, D):
    pq (from t's half start to t - 1), ek (from t + 1 to its half's end),
    the row factors f (the first half's decay on second-half rows) and hk
    (the second half's decay on first-half keys), and per sub-chunk W."""
    pq, wh = _halves(w, True)
    ek, _ = _halves(w, False)
    lo, up = wh[:, :, 0::2], wh[:, :, 1::2]        # (B, H, 4, D)
    W = lo * up
    one = torch.ones_like(w[:, :, :1])
    f = torch.cat([one.expand(-1, -1, HALF, -1) if (t // HALF) % 2 == 0
                   else lo[:, :, t // SUB, None].expand(-1, -1, 1, -1)
                   .expand(-1, -1, HALF, -1)
                   for t in range(0, C, HALF)], 2)
    hk = torch.cat([up[:, :, t // SUB, None].expand(-1, -1, HALF, -1)
                    if (t // HALF) % 2 == 0
                    else one.expand(-1, -1, HALF, -1)
                    for t in range(0, C, HALF)], 2)
    return pq, ek, f, hk, W


def _intra_A(rt, kt, w, uf, Qr, Kk, f, hk, W, passes):
    """A[t, i] = sum_c r_t k_i prod_{i < m < t} w_m for i < t, and the
    bonus r_t u k_t on the diagonal: the forward kernel's A."""
    b, h = rt.shape[:2]
    A = torch.zeros(b, h, C, C)
    one = torch.ones_like(w[:, :, 0])
    for q in range(4):
        rows = slice(SUB * q, SUB * q + SUB)
        for a in range(q):
            Kh = Kk[:, :, SUB * a:SUB * a + SUB] \
                * hk[:, :, SUB * a:SUB * a + SUB] \
                * _prod(W[:, :, a + 1:q].unbind(2), one)[:, :, None]
            A[:, :, rows, SUB * a:SUB * a + SUB] = _mm(
                Qr[:, :, rows] * f[:, :, rows], Kh.transpose(2, 3), passes)
        hi = slice(SUB * q + HALF, SUB * q + SUB)
        lo = slice(SUB * q, SUB * q + HALF)
        A[:, :, hi, lo] = _mm(Qr[:, :, hi], Kk[:, :, lo].transpose(2, 3),
                              passes)
    for h0 in range(0, C, HALF):
        for i in range(h0, h0 + HALF):
            kd = kt[:, :, i]
            for t in range(i + 1, h0 + HALF):
                A[:, :, t, i] = (rt[:, :, t] * kd).sum(-1)
                kd = kd * w[:, :, t]
            A[:, :, i, i] = (rt[:, :, i] * uf * kt[:, :, i]).sum(-1)
    return A


def emulate_bwd(r, k, v, log_w, u, s0, do, dsT, passes=3):
    """What ``rwkv6_bwd_sm90.cu`` computes for all (b, h) at once:
    ``(dr, dk, dv in r's dtype, dlog_w, du, ds0 f32)``; ``passes=1`` rounds
    each f32 operand of a product to bf16 once instead of splitting it."""
    b, h, t, d = r.shape
    tp = -(-t // C) * C
    nc = tp // C
    pad = (0, 0, 0, tp - t)
    rf, kf, vf, dof = (F.pad(x.float(), pad) for x in (r, k, v, do))
    w = torch.exp(F.pad(log_w.float(), pad))      # unclamped
    uf = u.float()
    one = torch.ones(b, h, d)

    def chunk(x, n):
        return x[:, :, C * n:C * n + C]

    # pass 1: each chunk's decay W_n, U_n = (k e^{L_C - L})^T v and V_n =
    # (r e^{Lx})^T do, from running products over the chunk
    Wn, Un, Vn = [], [], []
    for n in range(nc):
        wt = chunk(w, n)
        pre, suf = torch.empty_like(wt), torch.empty_like(wt)
        acc = one
        for j in range(C):
            pre[:, :, j] = acc
            acc = acc * wt[:, :, j]
        Wn.append(acc)
        acc = one
        for j in reversed(range(C)):
            suf[:, :, j] = acc
            acc = acc * wt[:, :, j]
        Un.append(_mm((chunk(kf, n) * suf).transpose(2, 3), chunk(vf, n),
                      passes, b_exact=True))
        Vn.append(_mm((chunk(rf, n) * pre).transpose(2, 3), chunk(dof, n),
                      passes, b_exact=True))
    # pass 2: the scans over chunks
    S = [torch.zeros(b, h, d, d) if s0 is None else s0.float()]
    for n in range(nc):
        S.append(Wn[n][..., None] * S[n] + Un[n])
    G = [None] * nc
    g = torch.zeros(b, h, d, d) if dsT is None else dsT.float()
    for n in reversed(range(nc)):
        G[n] = g                       # the cotangent of S_{n+1}
        g = Wn[n][..., None] * g + Vn[n]
    ds0 = g
    # pass 3: each chunk's gradients
    outs = {x: [] for x in ("dr", "dk", "dv", "dlw")}
    du = torch.zeros(b, h, d)
    for n in range(nc):
        rt, kt, vt, dot, wt = (chunk(x, n) for x in (rf, kf, vf, dof, w))
        pq, ek, f, hk, W = _chunk_factors(wt)
        Qr, Kk = rt * pq, kt * ek
        dA = dot @ vt.transpose(2, 3)            # exact: bf16 products
        vdo = torch.diagonal(dA, dim1=2, dim2=3)[..., None]
        A = _intra_A(rt, kt, wt, uf, Qr, Kk, f, hk, W, passes)
        XR, XK, dv = (torch.zeros(b, h, C, d) for _ in range(3))
        Gt = G[n].transpose(2, 3)
        for q in range(4):
            rows = slice(SUB * q, SUB * q + SUB)
            hi = slice(SUB * q + HALF, SUB * q + SUB)
            lo = slice(SUB * q, SUB * q + HALF)
            # dr's bracket: rows t of q
            x = _prod(W[:, :, :q].unbind(2), one)[:, :, None] \
                * _mm_exact_a(dot[:, :, rows], S[n].transpose(2, 3), passes)
            if q:
                Kh = torch.cat([
                    Kk[:, :, SUB * a:SUB * a + SUB]
                    * hk[:, :, SUB * a:SUB * a + SUB]
                    * _prod(W[:, :, a + 1:q].unbind(2), one)[:, :, None]
                    for a in range(q)], 2)
                x = x + _mm(dA[:, :, rows, :SUB * q], Kh, passes)
            XR[:, :, rows] = f[:, :, rows] * x
            XR[:, :, hi] += _mm(dA[:, :, hi, lo], Kk[:, :, lo], passes)
            # dk's bracket: keys i of q
            x = _prod(W[:, :, q + 1:].unbind(2), one)[:, :, None] \
                * _mm_exact_a(vt[:, :, rows], Gt, passes)
            if q < 3:
                Qh = torch.cat([
                    Qr[:, :, SUB * p:SUB * p + SUB]
                    * f[:, :, SUB * p:SUB * p + SUB]
                    * _prod(W[:, :, q + 1:p].unbind(2), one)[:, :, None]
                    for p in range(q + 1, 4)], 2)
                x = x + _mm(dA[:, :, SUB * q + SUB:, rows].transpose(2, 3),
                            Qh, passes)
            XK[:, :, rows] = hk[:, :, rows] * x
            XK[:, :, lo] += _mm(dA[:, :, hi, lo].transpose(2, 3),
                                Qr[:, :, hi], passes)
            # dv: keys i of q
            Kd = Kk[:, :, rows] * hk[:, :, rows] \
                * _prod(W[:, :, q + 1:].unbind(2), one)[:, :, None]
            dv[:, :, rows] = _mm(A[:, :, SUB * q:, rows].transpose(2, 3),
                                 dot[:, :, SUB * q:], passes, b_exact=True) \
                + _mm(Kd, G[n], passes)
        # the last pass, per channel: the pairs inside halves, the bonus,
        # dlog_w and du
        sr = pq * XR + _same_half(dA, wt, kt, True)
        sk = ek * XK + _same_half(dA, wt, rt, False)
        R, K = rt * sr, kt * sk
        tail = (G[n] * S[n + 1]).sum(-1)[:, :, None]      # (B, H, 1, D)
        rsum = torch.flip(torch.cumsum(torch.flip(R, [2]), 2), [2]) - R
        ksum = torch.flip(torch.cumsum(torch.flip(K, [2]), 2), [2])
        outs["dlw"].append(tail + rsum - ksum)
        outs["dr"].append(sr + uf[:, None] * kt * vdo)
        outs["dk"].append(sk + uf[:, None] * rt * vdo)
        outs["dv"].append(dv)
        du = du + (rt * kt * vdo).sum(2)
    dr, dk, dv, dlw = (torch.cat(outs[x], 2)[:, :, :t]
                       for x in ("dr", "dk", "dv", "dlw"))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw,
            du.sum(0), None if s0 is None else ds0)


def _inputs(seed, b, h, t, d, dtype, with_s0=True, decay_scale=1.0):
    """As ``chip_smoke._rwkv_bwd_inputs`` makes them: r/k/v/do in
    ``dtype``, log_w = -exp(N(0, 1)) times ``decay_scale``."""
    rng = np.random.default_rng(seed)

    def f(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    tdt = getattr(torch, dtype)
    r, k, v = (f((b, h, t, d), 0.5).to(tdt) for _ in range(3))
    lw = -torch.exp(f((b, h, t, d), 1.0)) * decay_scale
    u, s0 = f((h, d), 0.5), f((b, h, d, d), 0.1)
    do, dsT = f((b, h, t, d), 1.0).to(tdt), f((b, h, d, d), 0.1)
    return r, k, v, lw, u, s0 if with_s0 else None, do, dsT


def _jax_vjp(r, k, v, lw, u, s0, do, dsT):
    """jax.vjp of the reference's ``_xla_chunked`` at 64-token chunks, f32
    arrays of the same values."""
    args = [jnp.asarray(x.float().numpy()) for x in (r, k, v, lw, u)]
    args.append(jnp.zeros((r.shape[0], r.shape[1], r.shape[3], r.shape[3]),
                          jnp.float32) if s0 is None
                else jnp.asarray(s0.numpy()))
    _, vjp = jax.vjp(lambda *a: _xla_chunked(*a, chunk=C), *args)
    grads = vjp((jnp.asarray(do.float().numpy()), jnp.asarray(dsT.numpy())))
    out = [torch.from_numpy(np.array(g)) for g in grads]
    return out if s0 is not None else out[:5] + [None]


def _ratios(got, want, dtype, extra=0.0):
    """Each gradient's largest error over its bound: atol 2e-3 (+
    ``extra``) + rtol 1e-5, bf16 dr, dk, dv also rtol 2^-7."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert bool(torch.isfinite(g.float()).all()), name
        rtol = RTOL + (2 ** -7 if dtype == "bfloat16"
                       and name in ("dr", "dk", "dv") else 0.0)
        bound = ATOL + extra + rtol * w.float().abs()
        out[name] = ((g.float() - w.float()).abs() / bound).max().item()
    return out


def _check(got, want, dtype, extra=0.0, what=""):
    for name, ratio in _ratios(got, want, dtype, extra).items():
        assert ratio <= 1.0, f"{what} {name}: {ratio} x its bound"


CASES = [(2, 3, 130, 64), (1, 2, 64, 32), (1, 1, 7, 16), (1, 2, 100, 32)]


@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_the_reference_vjp(case, with_s0):
    """The sweep (and a ragged T) from s0 and from none, a nonzero dsT,
    bf16 r/k/v/do: against jax.vjp of ``_xla_chunked`` and the plain
    backward."""
    x = _inputs(sum(case), *case, "bfloat16", with_s0)
    got = emulate_bwd(*x)
    _check(got, _jax_vjp(*x), "bfloat16", what="jax")
    _check(got, rwkv6_bwd_ref(*x), "bfloat16", what="plain")


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
def test_emulation_below_the_clamp(decay_scale):
    """log_w x10 and x100, a share below -30, unclamped: within the
    tolerance plus |L| 2^-23 of the call's largest gradient, L the largest
    cumulative log-decay over a chunk (the reference's exponents are f32
    differences of those sums)."""
    x = _inputs(9, 2, 2, 70, 32, "bfloat16", decay_scale=decay_scale)
    below = (x[3] < -30).float().mean().item()
    assert 0.05 < below < 0.95, below
    want = _jax_vjp(*x)
    lw = F.pad(x[3], (0, 0, 0, 58))
    L = lw.reshape(2, 2, 2, 64, 32).cumsum(3).abs().max().item()
    top = max(g.abs().max().item() for g in want if g is not None)
    got = emulate_bwd(*x)
    _check(got, want, "bfloat16", extra=L * 2 ** -23 * top, what="jax")


def test_emulation_in_f32():
    """f32 r/k/v/do (split on both sides of every product) against the
    plain backward."""
    x = _inputs(4, 1, 2, 100, 64, "float32")
    _check(emulate_bwd(*x), rwkv6_bwd_ref(*x), "float32")


def test_single_pass_bf16_breaks_the_tolerance():
    """rwkv6-7b's head width over 512 tokens (4 heads): one bf16 rounding
    of each f32 operand puts dr, dk, dv, dlog_w and ds0 past the tolerance
    that the split operands hold."""
    x = _inputs(3, 1, 4, 512, 64, "bfloat16")
    want = rwkv6_bwd_ref(*x)
    _check(emulate_bwd(*x), want, "bfloat16")
    single = _ratios(emulate_bwd(*x, passes=1), want, "bfloat16")
    for name in ("dr", "dk", "dv", "dlog_w", "ds0"):
        assert single[name] > 1.0, (name, single)
