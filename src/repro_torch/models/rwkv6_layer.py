"""RWKV-6 (Finch) block: data-dependent token-shift time-mix over the
recurrence kernel (K6) + squared-ReLU channel-mix.

The twin of ``repro/models/rwkv6_layer.py:22-132``, with the same leaf
names and shapes, so ``convert.params_from_numpy`` carries the
reference's parameters across unchanged.  As in the reference, matrices
and ``mu`` are cast to the activation dtype where they are used, while
``w0`` (added to a product, which promotes to f32), ``u`` (read in f32 by
the kernel) and ``gn_scale`` / ``gn_bias`` (applied in f32 by
``groupnorm_heads``) stay f32.

State carried for decode, per block:
  ``shift_tm`` / ``shift_cm``: (B, d_model) -- previous token's activations
  ``wkv``: (B, H, Dh, Dh) f32 -- the linear-attention state.

Split over a mesh's "model" axis (``TP_RULES``' "rnn", ``sharding/tp.py``)
a rank holds the column box of ``w_rkvg``, ``wB`` and ``w0`` and the row
box of ``wo``: its heads, whole, since the size must divide the heads
(``tp.check_model_axis``).  The recurrence (K6) runs on them at the
rank's width, and its ``wkv`` state holds them; the shift states stay
whole.  ``u``, ``gn_scale`` and ``gn_bias`` split over head_dim, not
heads: ``own_heads`` gathers them and keeps the rank's heads' rows (the
engine once, the training step in each forward).  The channel-mix splits
``wk``'s columns and ``wv``'s rows over d_ff (where the size divides it)
and ``wr``'s columns over d_model, whose output is gathered before it
gates the whole ``kv``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels.rwkv6 import rwkv6 as rwkv6_core
from ..sharding import constrain, tp
from .layers import _dense_init, _normal, groupnorm_heads

LORA_RANK = 32
# leaves the reference uses in f32 whatever the compute dtype
F32_LEAVES = ("w0", "u", "gn_scale", "gn_bias")


class RWKVState(NamedTuple):
    shift_tm: torch.Tensor        # (B, D)
    shift_cm: torch.Tensor        # (B, D)
    wkv: torch.Tensor             # (B, H, Dh, Dh) f32


def _full(lead, shape, value, device) -> torch.Tensor:
    return torch.full((*lead, *shape), value, dtype=torch.float32,
                      device=device)


def timemix_init(generator, d_model: int, head_dim: int, *,
                 lead: Sequence[int] = (), device=None):
    h = d_model // head_dim
    d = d_model

    def dense(shape, scale=None):
        return _dense_init(generator, shape, scale, lead=lead, device=device)

    return {
        # r/k/v/g projections stacked: one contraction
        "w_rkvg": _normal(generator, (*lead, 4, d, d), device).mul_(d ** -0.5),
        "wo": dense((d, d)),
        # data-dependent decay: w = exp(-exp(w0 + (x @ A) @ B))
        "w0": _full(lead, (d,), -4.0, device),
        "wA": dense((d, LORA_RANK)),
        "wB": dense((LORA_RANK, d), scale=0.01),
        # token-shift interpolation factors (static mu + data-dependent lora)
        "mu": _full(lead, (5, d), 0.5, device),            # r, k, v, w, g
        "muA": dense((d, LORA_RANK)),
        "muB": dense((LORA_RANK, 5 * d), scale=0.01),
        "u": _full(lead, (h, head_dim), 0.0, device),       # bonus
        "gn_scale": _full(lead, (h, head_dim), 1.0, device),
        "gn_bias": _full(lead, (h, head_dim), 0.0, device),
    }


def timemix_axes():
    """Logical axes of ``timemix_init``'s leaves."""
    return {"w_rkvg": ("stack", "embed", "rnn"), "wo": ("rnn", "embed"),
            "w0": ("rnn",), "wA": ("embed", None), "wB": (None, "rnn"),
            "mu": ("stack", "embed"), "muA": ("embed", None),
            "muB": (None, None), "u": (None, "rnn"),
            "gn_scale": (None, "rnn"), "gn_bias": (None, "rnn")}


# the leaves the "rnn" axis splits over head_dim
HEAD_LEAVES = ("u", "gn_scale", "gn_bias")


def own_heads(leaf: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``u`` / ``gn_scale`` / ``gn_bias`` (..., H, Dh) as the rank's
    ``heads`` heads, each whole: a head_dim box is gathered and the
    rank's rows are kept (``tp.gather`` then ``tp.scatter``, so the
    gradient sums into each rank's box).  A leaf that is already so is
    returned as it is."""
    if leaf.shape[-1] != head_dim:
        leaf = tp.gather(leaf, -1)
    if leaf.shape[-2] != heads:
        leaf = tp.scatter(leaf, -2)
    return leaf


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D); last: (B, D) previous token (zeros at sequence
    start)."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def timemix_apply(params, x: torch.Tensor, state_tm: torch.Tensor,
                  wkv_state: torch.Tensor, head_dim: int):
    """Returns (out (B, T, D), the last token's x (B, D), the new wkv
    state (B, H, Dh, Dh) f32), H the rank's heads under a "model"
    axis."""
    b, t, d = x.shape
    w = params["w_rkvg"].shape[-1]        # the rank's width of the heads
    split = tp.is_split(w, d)
    h = w // head_dim
    dt = x.dtype
    delta = _token_shift(x, state_tm) - x
    # data-dependent interpolation (RWKV-6 "ddlerp")
    lora = torch.tanh(x @ params["muA"].to(dt))
    lora = (lora @ params["muB"].to(dt)).reshape(b, t, 5, d)
    mix = params["mu"].to(dt)[None, None] + lora
    xr, xk, xv, xw, xg = [x + delta * mix[:, :, i] for i in range(5)]

    xs4 = torch.stack([xr, xk, xv, xg]).reshape(4, b * t, d)
    lw = torch.tanh(xw @ params["wA"].to(dt))
    if split:           # the column-split products' inputs
        xs4, lw = tp.enter(xs4), tp.enter(lw)
    rkvg = torch.matmul(xs4, params["w_rkvg"].to(dt)).reshape(4, b, t, w)
    r, k, v, g = rkvg[0], rkvg[1], rkvg[2], rkvg[3]
    # w0 is f32: the sum promotes to f32, as in the reference
    wlog = params["w0"] + lw @ params["wB"].to(dt)
    log_w = -torch.exp(wlog.float())                     # (B, T, W) <= 0

    def heads(z):
        return z.reshape(b, t, h, head_dim).transpose(1, 2)

    r_ = constrain(heads(r), "batch", "act_rnn", "seq", None)
    u, gn_scale, gn_bias = (own_heads(params[n], h, head_dim)
                            for n in HEAD_LEAVES)
    o, wkv_new = rwkv6_core(r_, heads(k), heads(v), heads(log_w), u,
                            wkv_state)
    o = groupnorm_heads(o.transpose(1, 2), gn_scale, gn_bias)
    o = o.reshape(b, t, w) * F.silu(g)
    out = o @ params["wo"].to(dt)
    out = constrain(tp.reduce(out) if split else out, "batch", "seq",
                    "act_embed")
    return out, x[:, -1, :], wkv_new


def chanmix_init(generator, d_model: int, d_ff: int, *,
                 lead: Sequence[int] = (), device=None):
    def dense(shape):
        return _dense_init(generator, shape, lead=lead, device=device)

    return {"wk": dense((d_model, d_ff)), "wv": dense((d_ff, d_model)),
            "wr": dense((d_model, d_model)),
            "mu": _full(lead, (2, d_model), 0.5, device)}      # k, r


def chanmix_axes():
    """Logical axes of ``chanmix_init``'s leaves."""
    return {"wk": ("embed", "ff"), "wv": ("ff", "embed"),
            "wr": ("embed", "rnn"), "mu": ("stack", "embed")}


def chanmix_apply(params, x: torch.Tensor, state_cm: torch.Tensor,
                  d_ff: Optional[int] = None):
    """Returns (out (B, T, D), the last token's x (B, D)).  ``d_ff``: the
    whole width, which tells ``wk``'s box under a "model" axis."""
    dt = x.dtype
    delta = _token_shift(x, state_cm) - x
    mu = params["mu"].to(dt)
    xk = x + delta * mu[0]
    xr = x + delta * mu[1]
    ff_split = tp.is_split(params["wk"].shape[-1], d_ff)
    r_split = tp.is_split(params["wr"].shape[-1], x.shape[-1])
    k = torch.square(F.relu((tp.enter(xk) if ff_split else xk)
                            @ params["wk"].to(dt)))
    k = constrain(k, "batch", "seq", "act_ff")
    kv = k @ params["wv"].to(dt)
    if ff_split:
        kv = tp.reduce(kv)
    r = torch.sigmoid((tp.enter(xr) if r_split else xr)
                      @ params["wr"].to(dt))
    out = (tp.gather(r) if r_split else r) * kv
    return constrain(out, "batch", "seq", "act_embed"), x[:, -1, :]


def init_state(batch: int, d_model: int, head_dim: int, dtype, *,
               lead: Sequence[int] = (), device=None,
               width: Optional[int] = None) -> RWKVState:
    """Zeros; ``width``: the rank's width of the heads under a "model"
    axis (the state's heads; default d_model)."""
    h = (width or d_model) // head_dim
    return RWKVState(
        shift_tm=torch.zeros((*lead, batch, d_model), dtype=dtype,
                             device=device),
        shift_cm=torch.zeros((*lead, batch, d_model), dtype=dtype,
                             device=device),
        wkv=torch.zeros((*lead, batch, h, head_dim, head_dim),
                        dtype=torch.float32, device=device))


def state_axes() -> RWKVState:
    """Logical axes of ``init_state``'s leaves."""
    return RWKVState(shift_tm=("batch", "act_embed"),
                     shift_cm=("batch", "act_embed"),
                     wkv=("batch", "act_rnn", None, None))
