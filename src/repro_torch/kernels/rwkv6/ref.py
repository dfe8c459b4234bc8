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


def rwkv6_chunked(r, k, v, log_w, u, s0: Optional[torch.Tensor] = None,
                  chunk: int = 64):
    """The chunked form, clamped at ``LOG_W_MIN``; T is padded to whole
    chunks with k = 0 and log_w = 0, which leaves the state exact."""
    b, h, t, d = r.shape
    c = min(chunk, next_multiple(max(t, 1), 8))
    tp = next_multiple(max(t, 1), c)
    pad = (0, 0, 0, tp - t)
    rf, kf, vf = (F.pad(x.float(), pad) for x in (r, k, v))
    wf = F.pad(torch.clamp(log_w.float(), min=LOG_W_MIN), pad)
    uf = u.float()
    S = _zeros_state(r) if s0 is None else s0.float()
    strict = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    mask = strict[None, None, :, :, None]
    outs = []
    for lo in range(0, tp, c):
        rt, kt, vt, lw = (x[:, :, lo:lo + c] for x in (rf, kf, vf, wf))
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
        outs.append(o)
    o = torch.cat(outs, dim=2)[:, :, :t]
    return o.to(v.dtype), S
