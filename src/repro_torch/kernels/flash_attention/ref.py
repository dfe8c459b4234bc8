"""Plain PyTorch version of the flash-attention forward (K4).

The dense form of the reference oracle (``repro/kernels/flash_attention/
ref.py:30-51``), extended to return the log-sum-exp as the kernel does.
Materialises the (T, S) score matrix, so it is the numerical reference and
the CPU path, not a fast path.

A row with no allowed key gives zeros and ``lse = -inf``.  The reference
has no consistent answer there (its result depends on its tile size), so
such rows are excluded from every comparison with it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def allowed_mask(t: int, s: int, causal: bool, window: Optional[int],
                 offset: int, device=None) -> torch.Tensor:
    """(t, s) boolean mask of allowed positions; query row 0 sits at
    absolute position ``offset`` (``S - T``: bottom-right alignment)."""
    qpos = torch.arange(t, device=device)[:, None] + offset
    kpos = torch.arange(s, device=device)[None, :]
    ok = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, T, D), k/v: (B, Hkv, S, D), Hq % Hkv == 0.

    Returns ``(out (B, Hq, T, D) in q.dtype, lse (B, Hq, T) f32)``; the
    softmax runs in f32 with scores scaled in f32.
    """
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = torch.matmul(qf, kf.transpose(-1, -2))
    ok = allowed_mask(t, s, causal, window, s - t, q.device)
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))[..., 0]
    return out.to(q.dtype), lse
