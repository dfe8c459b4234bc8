"""Plain PyTorch versions of the RWKV-6 (Finch) time-mix recurrence.

Per head, with state S in R^{Dk x Dv}:

    o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(exp(lw_t)) S_{t-1} + k_t^T v_t

with lw_t <= 0 the data-dependent per-channel log-decay and u the bonus
of the current token.

* ``rwkv6_ref``: the sequential oracle, a loop over time, the twin of
  ``repro/kernels/rwkv6/ref.py:23``.
* ``rwkv6_chunked``: the plain version beside the Hopper kernel (K6), the
  twin of ``repro/kernels/rwkv6/ops.py::_xla_chunked``: chunks of C
  tokens with the exact pairwise intra-chunk decays (every exponent a
  "later minus earlier" difference of cumulative log-decays, so <= 0),
  plus the Pallas kernel's clamp ``log_w >= LOG_W_MIN``
  (``repro/kernels/rwkv6/kernel.py:35,53``), so that it computes what the
  kernel computes.  The CPU path runs it.

Both take r/k/v/log_w (B, H, T, D), u (H, D), s0 (B, H, D, D) or None,
compute in f32 and return ``(o in v.dtype, s_final f32)``.

* ``rwkv6_bwd_ref``: the plain backward beside the Hopper backward
  kernel, the vjp of the chunked form (the reference's ``_rwkv6_bwd``),
  with log_w unclamped as there.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..common import next_multiple

LOG_W_MIN = -30.0     # exp(-30) ~ 1e-13: numerically zero decay


def _zeros_state(r: torch.Tensor) -> torch.Tensor:
    b, h, _, d = r.shape
    return torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)


def rwkv6_ref(r, k, v, log_w, u, s0: Optional[torch.Tensor] = None):
    """The recurrence one token at a time, in f32 (no clamp)."""
    rf, kf, vf, lwf = (x.float() for x in (r, k, v, log_w))
    uf = u.float()
    S = _zeros_state(r) if s0 is None else s0.float()
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]       # (B,H,K,V)
        o = torch.einsum("bhk,bhkv->bhv", rf[:, :, t],
                         S + uf[None, :, :, None] * kv)
        S = torch.exp(lwf[:, :, t])[..., None] * S + kv
        outs.append(o)
    o = torch.stack(outs, dim=2) if outs else torch.zeros_like(vf)
    return o.to(v.dtype), S


def _pad_chunks(r, k, v, log_w, chunk, clamp):
    """f32 r/k/v/log_w padded to whole chunks of C tokens with zeros (k = 0
    and log_w = 0 leave the state exact), log_w clamped at ``LOG_W_MIN``
    when ``clamp``; returns (c, padded tensors)."""
    t = r.shape[2]
    c = min(chunk, next_multiple(max(t, 1), 8))
    pad = (0, 0, 0, next_multiple(max(t, 1), c) - t)
    lw = log_w.float()
    if clamp:
        lw = torch.clamp(lw, min=LOG_W_MIN)
    return c, [F.pad(x.float(), pad) for x in (r, k, v, lw)]


def _chunk(S, rt, kt, vt, lw, uf):
    """One chunk of the chunked form, the reference's ``per_chunk``
    (``repro/kernels/rwkv6/ops.py:39-58``): the state after the chunk and
    the chunk's output, from the state before it; (B, H, C, D) inputs."""
    c = rt.shape[2]
    strict = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=rt.device), diagonal=-1)
    mask = strict[None, None, :, :, None]
    L = torch.cumsum(lw, dim=2)                  # inclusive
    Lx = L - lw                                  # exclusive
    o = torch.einsum("bhcd,bhde->bhce", rt * torch.exp(Lx), S)
    # exact pairwise decays (B, H, C_t, C_i, D), exponents <= 0
    diff = Lx[:, :, :, None, :] - L[:, :, None, :, :]
    E = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    A = torch.einsum("bhtic,bhtc,bhic->bhti", E, rt, kt)
    diag = torch.einsum("bhtd,hd,bhtd->bht", rt, uf, kt)
    o = o + torch.einsum("bhti,bhid->bhtd", A, vt) + diag[..., None] * vt
    Llast = L[:, :, -1:, :]
    kend = kt * torch.exp(Llast - L)
    S = (torch.exp(Llast[:, :, 0, :])[..., None] * S
         + torch.einsum("bhck,bhcv->bhkv", kend, vt))
    return S, o


def rwkv6_chunked(r, k, v, log_w, u, s0: Optional[torch.Tensor] = None,
                  chunk: int = 64):
    """The chunked form, clamped at ``LOG_W_MIN``; T is padded to whole
    chunks with k = 0 and log_w = 0, which leaves the state exact."""
    t = r.shape[2]
    c, (rf, kf, vf, wf) = _pad_chunks(r, k, v, log_w, chunk, clamp=True)
    uf = u.float()
    S = _zeros_state(r) if s0 is None else s0.float()
    outs = []
    for lo in range(0, rf.shape[2], c):
        S, o = _chunk(S, *(x[:, :, lo:lo + c] for x in (rf, kf, vf, wf)), uf)
        outs.append(o)
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(v.dtype), S


def rwkv6_bwd_ref(r, k, v, log_w, u, s0, do, dsT=None, chunk: int = 64):
    """The plain backward, the twin of the reference's ``_rwkv6_bwd``
    (``repro/kernels/rwkv6/ops.py:90-96``): the vjp of the chunked form
    with ``log_w`` as given, not clamped (the reference's backward is the
    vjp of ``_xla_chunked``, which has no clamp; below ``LOG_W_MIN`` its
    decay is e^-30 or less either way, so the forward's clamp moves o by
    less than f32 resolves, and the gradient is the unclamped one).  As
    the reference checkpoints each chunk, the states at chunk boundaries
    are kept and each chunk's vjp recomputes its chunk, last chunk first.

    r/k/v/log_w (B, H, T, D), u (H, D), s0 (B, H, D, D) or None (zeros),
    do (B, H, T, D) the cotangent of o, dsT (B, H, D, D) or None (zeros)
    that of the final state.  Returns ``(dr, dk, dv, dlog_w, du, ds0)`` in
    the inputs' dtypes (ds0 None when s0 is None)."""
    t = r.shape[2]
    c, xs = _pad_chunks(r, k, v, log_w, chunk, clamp=False)
    dof = F.pad(do.float(), (0, 0, 0, xs[0].shape[2] - t))
    uf = u.float()
    S = _zeros_state(r) if s0 is None else s0.float()
    starts = list(range(0, xs[0].shape[2], c))
    states = []
    with torch.no_grad():
        for lo in starts:
            states.append(S)
            S, _ = _chunk(S, *(x[:, :, lo:lo + c] for x in xs), uf)
    G = torch.zeros_like(S) if dsT is None else dsT.float()
    du = torch.zeros_like(uf)
    parts = []
    for lo, S in zip(reversed(starts), reversed(states)):
        with torch.enable_grad():
            leaves = [S.detach().requires_grad_(), uf.detach().requires_grad_()]
            leaves += [x[:, :, lo:lo + c].detach().requires_grad_()
                       for x in xs]
            S_new, o = _chunk(leaves[0], *leaves[2:], leaves[1])
            grads = torch.autograd.grad((S_new, o), leaves,
                                        (G, dof[:, :, lo:lo + c]))
        G, gu = grads[0], grads[1]
        du = du + gu
        parts.append(grads[2:])
    dr, dk, dv, dlw = (torch.cat(g[::-1], dim=2)[:, :, :t]
                       for g in zip(*parts))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dlw.to(log_w.dtype), du.to(u.dtype),
            None if s0 is None else G.to(s0.dtype))
