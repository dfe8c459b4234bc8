"""Top-k routed Mixture-of-Experts FFN (dbrx-style fine-grained /
qwen3-style many-expert): the twin of ``repro/models/moe.py``.

The reference's sort-free dispatch, ``vmap``ped over batch rows there,
runs here on the whole batch at once (every cumsum and index has a
leading batch dimension):

  1. router top-k -> (B, T, k) expert ids and renormalised weights
     (``route``),
  2. an assignment's position in its expert is the exclusive cumsum of the
     one-hot ids over the row's T*k assignments, token-major; assignments
     at or past the capacity C = max(int(k * T / E * capacity_factor), 1)
     (a floor: the reference's docstring says ceil, its code floors) go
     to a dump slot E*C and are dropped (``dispatch``),
  3. kept tokens are written into an (E, C, D) buffer a row: kept slots
     are unique, so this is a scatter without accumulation, and its
     backward a gather,
  4. each expert's SwiGLU as batched matrix products over the experts,
  5. each assignment's output gathered back, weighted, and a token's k
     contributions (contiguous, token-major) summed over a (T, k, D) view.

Also returns the switch-style load-balancing auxiliary loss.

Expert parallel over a mesh's "model" axis (``sharding/tp.py``) where the
size divides the experts, as the reference's ``act_experts`` and
``experts`` rules split them: the router, the dispatch and the combine
run whole on every model rank; the (B, E, C, D) buffer is sliced to the
rank's experts at the reference's ``act_experts`` site (``tp.scatter``,
whose backward gathers), the expert products run on the rank's
``w_gu`` / ``w_down`` boxes, and their outputs are gathered whole at the
reference's whole ``ye`` site (``tp.gather``, whose backward slices).
Where the size does not divide the experts (dbrx-132b's 16 at 3) both
sites resolve whole and so do the weights.  Decode (one slot an expert)
takes the same path.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..sharding import constrain, tp
from .layers import _dense_init, _normal


def moe_init(generator, d_model: int, num_experts: int, d_ff: int, *,
             lead: Sequence[int] = (), device=None):
    """``router`` (D, E), ``w_gu`` (2, E, D, F) (gate and up stacked) and
    ``w_down`` (E, F, D), with the reference's scales
    (``repro/models/moe.py:28-41``)."""
    return {
        "router": _dense_init(generator, (d_model, num_experts), lead=lead,
                              device=device),
        "w_gu": _normal(generator, (*lead, 2, num_experts, d_model, d_ff),
                        device).mul_(d_model ** -0.5),
        "w_down": _normal(generator, (*lead, num_experts, d_ff, d_model),
                          device).mul_(d_ff ** -0.5),
    }


def moe_axes():
    """Logical axes of ``moe_init``'s leaves."""
    return {"router": ("embed", None),
            "w_gu": ("stack", "experts", "embed", "expert_ff"),
            "w_down": ("experts", "expert_ff", "embed")}


def capacity(t: int, num_experts: int, experts_per_token: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a row of ``t`` tokens, floored as the
    reference floors it (``repro/models/moe.py:69``)."""
    return max(int(experts_per_token * t / num_experts * capacity_factor), 1)


def route(params, x: torch.Tensor, k: int):
    """Router probabilities (B, T, E) in f32, and the top ``k`` of each
    token's: probabilities (B, T, k) and expert ids (B, T, k).  Among
    equal probabilities the lower expert comes first, as with
    ``jax.lax.top_k`` (``torch.topk`` gives no such order): the first k
    of a stable descending sort."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_ids = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    # gathered from ``probs``, so the gradient reaches the router through
    # the selected probabilities
    return probs, torch.gather(probs, -1, top_ids), top_ids


def dispatch(top_ids: torch.Tensor, cap: int, num_experts: int):
    """Each assignment's slot (B, T*k) in its row's (E*C + 1)-slot buffer
    and whether it is kept (B, T*k): the reference's ``_dispatch_row``
    (``repro/models/moe.py:44-60``) on every row at once."""
    b, t, k = top_ids.shape
    flat = top_ids.reshape(b, t * k)                     # token-major
    oh = F.one_hot(flat, num_experts)                    # (B, T*k, E)
    pos = torch.gather(torch.cumsum(oh, dim=1) - oh, 2, flat[..., None])
    pos = pos[..., 0]                                    # position in expert
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos,
                       torch.full_like(flat, num_experts * cap))
    return slot, keep


def moe_apply(params, x: torch.Tensor, *, num_experts: int,
              experts_per_token: int, capacity_factor: float = 1.25,
              aux_coef: float = 0.01):
    """x: (B, T, D) -> (y (B, T, D), aux loss (f32 scalar))."""
    b, t, d = x.shape
    k, e = experts_per_token, num_experts
    cap = capacity(t, e, k, capacity_factor)

    probs, top_p, top_ids = route(params, x, k)
    top_w = (top_p / top_p.sum(-1, keepdim=True)).to(x.dtype)

    # load-balancing aux loss (switch): E * mean_e(frac_routed * mean_prob);
    # ``frac`` counts the routed assignments before any drop and carries no
    # gradient
    frac = F.one_hot(top_ids, e).float().mean(dim=(1, 2))       # (B, E)
    mean_p = probs.mean(dim=1)                                  # (B, E)
    aux = aux_coef * e * torch.mean(torch.sum(frac * mean_p, dim=-1))

    slot, keep = dispatch(top_ids, cap, e)
    rows = torch.arange(b, device=x.device)[:, None]
    # every token k times, token-major; dropped ones zeroed, so the dump
    # slot, which several may hit, only ever receives zeros
    src = (x[:, :, None, :].expand(b, t, k, d).reshape(b, t * k, d)
           * keep[..., None].to(x.dtype))
    xe = x.new_zeros((b, e * cap + 1, d)).index_put((rows, slot), src)
    xe = constrain(xe[:, :-1].reshape(b, e, cap, d), "batch", "act_experts",
                   None, None)
    split = tp.site_split(("batch", "act_experts", None, None), xe.shape)
    if split:
        xe = tp.scatter(xe, 1)                   # the rank's experts
    w_gu = params["w_gu"].to(x.dtype)
    el = xe.shape[1]
    if w_gu.shape[-3] != el:
        raise ValueError(f"w_gu holds {w_gu.shape[-3]} experts, the "
                         f"dispatch buffer {el}")
    # (B, E, C, D) -> (E, B*C, D): one batched product per weight
    xe = xe.transpose(0, 1).reshape(el, b * cap, d)
    h = F.silu(torch.bmm(xe, w_gu[0])) * torch.bmm(xe, w_gu[1])
    h = constrain(h, "act_experts", None, None)
    ye = torch.bmm(h, params["w_down"].to(x.dtype))            # (E, B*C, D)
    ye = ye.reshape(el, b, cap, d).transpose(0, 1)
    if split:
        ye = tp.gather(ye, 1)                    # every expert, whole
    ye = constrain(ye, "batch", None, None, None).reshape(b, e * cap, d)
    flat = torch.cat([ye, ye.new_zeros((b, 1, d))], dim=1)
    wk = (keep * top_w.reshape(b, t * k)).to(x.dtype)
    contrib = flat[rows, slot] * wk[..., None]                  # (B, T*k, D)
    y = contrib.reshape(b, t, k, d).sum(dim=2)
    return constrain(y, "batch", "seq", "act_embed"), aux
