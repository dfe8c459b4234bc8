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
* ``rglru_bwd_ref``: the plain backward beside the Hopper backward kernel,
  the twin of the reference's analytic reverse scan ``ops._rglru_bwd``
  (``repro/kernels/rglru/ops.py:54-86``).

The forwards take log_a, g (B, T, D) and h0 (B, D) or None (zeros),
compute in f32 and return ``(h in g.dtype, h_final f32)``.  The initial
state enters in f32 (as ``rglru_ref`` and the reference's XLA path
``ops._xla_assoc`` take it), not folded into g's dtype as
``rglru_pallas`` folds it (ROADMAP §3).
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


def rglru_bwd_ref(log_a, h, h0, dh, dh_last=None):
    """The gradients of ``(h, h_final)`` from their cotangents ``dh`` (B,
    T, D) and ``dh_last`` (B, D) or None (zeros), given the forward's
    log_a, its output h (in g's dtype) and h0 (B, D) or None, in f32:

        lam_t = dh_t + a_{t+1} lam_{t+1}     (dh_last added to dh_{T-1})
        dg_t = lam_t,  dlog_a_t = lam_t h_{t-1} a_t,  dh0 = a_0 lam_0

    with h_{t-1} read from the saved h, so rounded to g's dtype as in the
    reference's residuals.  The reverse scan is ``rglru_chunked`` run
    backwards in time: lam is the forward recurrence over the flipped
    tokens with decay a_{t+1} (1 at the last token) and initial state
    dh_last.  Returns ``(dlog_a f32, dg in h.dtype, dh0 f32 or None)``.
    """
    b, t, d = h.shape
    la = log_a.float()
    a_next = torch.cat([la[:, 1:], torch.zeros_like(la[:, :1])], dim=1)
    lam, _ = rglru_chunked(a_next.flip(1), dh.float().flip(1),
                           None if dh_last is None else dh_last.float())
    lam = lam.flip(1)
    h_prev = torch.cat([_h0(h, h0)[:, None], h[:, :-1].float()], dim=1)
    a = torch.exp(la)
    dlog_a = lam * h_prev * a
    dh0 = None if h0 is None else lam[:, 0] * a[:, 0]
    return dlog_a, lam.to(h.dtype), dh0
