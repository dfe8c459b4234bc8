"""Plain PyTorch versions of the RG-LRU (Griffin / RecurrentGemma)
diagonal recurrence, per channel:

    h_t = exp(log_a_t) * h_{t-1} + g_t        log_a_t <= 0

* ``rglru_ref``: the sequential oracle, a loop over time, the twin of
  ``repro/kernels/rglru/ref.py:17-36``.
* ``rglru_chunked``: the plain version beside the Hopper kernel (K7), the
  twin of the Pallas body ``_rglru_kernel`` (``repro/kernels/rglru/
  kernel.py:29-55``): chunks of C tokens, the inclusive cumsum L of the
  log-decay within a chunk, and the exact pairwise prefix
  ``sum_{i<=t} exp(L_t - L_i) g_i``, every exponent a "later minus
  earlier" difference of a monotone cumsum, so <= 0.  The CPU path runs
  it.

Both take log_a, g (B, T, D) and h0 (B, D) or None (zeros), compute in
f32 and return ``(h in g.dtype, h_final f32)``.  The initial state enters
in f32 (as ``rglru_ref`` and the reference's XLA path ``ops._xla_assoc``
take it), not folded into g's dtype as ``rglru_pallas`` folds it
(ROADMAP §3).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..common import next_multiple


def _h0(g: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    if h0 is None:
        return torch.zeros((g.shape[0], g.shape[2]), dtype=torch.float32,
                           device=g.device)
    return h0.float()


def rglru_ref(log_a, g, h0: Optional[torch.Tensor] = None):
    """The recurrence one token at a time, in f32."""
    la, gf = log_a.float(), g.float()
    h = _h0(g, h0)
    hs = []
    for t in range(g.shape[1]):
        h = torch.exp(la[:, t]) * h + gf[:, t]
        hs.append(h)
    out = torch.stack(hs, dim=1) if hs else torch.zeros_like(gf)
    return out.to(g.dtype), h


def rglru_chunked(log_a, g, h0: Optional[torch.Tensor] = None,
                  chunk: int = 64):
    """The chunked closed form; T is padded to whole chunks with
    log_a = 0 and g = 0, which leaves the carried state exact."""
    b, t, d = g.shape
    c = min(chunk, next_multiple(max(t, 1), 8))
    tp = next_multiple(max(t, 1), c)
    pad = (0, 0, 0, tp - t)
    la = F.pad(log_a.float(), pad)
    gf = F.pad(g.float(), pad)
    h = _h0(g, h0)
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                  device=g.device))[None, :, :, None]
    outs = []
    for lo in range(0, tp, c):
        L = torch.cumsum(la[:, lo:lo + c], dim=1)           # (B, C, D)
        diff = L[:, :, None, :] - L[:, None, :, :]          # (B, Ct, Ci, D)
        E = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)),
                        0.0)
        h_intra = torch.einsum("btid,bid->btd", E, gf[:, lo:lo + c])
        h_seq = torch.exp(L) * h[:, None, :] + h_intra
        outs.append(h_seq)
        h = h_seq[:, -1]
    out = torch.cat(outs, dim=1)[:, :t]
    # the state after the last real token (padding keeps it: a = 1, g = 0)
    return out.to(g.dtype), h
