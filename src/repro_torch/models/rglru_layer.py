"""Griffin / RecurrentGemma recurrent block: causal depthwise conv1d +
RG-LRU over the scan kernel (K7), gated by a GeLU branch.

The twin of ``repro/models/rglru_layer.py:22-87``, with the same leaf
names and shapes, so ``convert.params_from_numpy`` carries the
reference's parameters across unchanged.  As in the reference, the
projections, the convolution and its bias are cast to the activation
dtype where they are used, while the gate matrix ``w_ai`` (an f32 product
of the f32 activations) and ``lam`` (the decay's logit) stay f32: the
gates and the log-decay are computed in f32 whatever the compute dtype.
``g`` is cast to the compute dtype before the scan; ``log_a`` and the
carried ``h`` stay f32.

State carried for decode, per block:
  ``conv``: (B, conv_width - 1, rnn_width) -- past inputs, compute dtype
  ``h``: (B, rnn_width) f32 -- the recurrent state.

Split over a mesh's "model" axis (``TP_RULES``' "rnn", ``sharding/tp.py``)
a rank holds the column box of ``w_ig`` and the rank's channels of the
convolution and ``lam``: the recurrence is per channel, so the conv and
the scan (K7) run at the rank's width, and so does the state.  ``w_ai``
splits over its contraction rows, so ``y @ w_ai`` is a partial sum of
the whole width: it is reduce-scattered to the rank's channels.
``w_out``'s rows are the rank's channels, its product summed over the
model ranks.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..kernels.rglru import rglru as rglru_core
from ..sharding import constrain, tp
from .layers import _dense_init, _normal

RGLRU_C = 8.0  # Griffin's fixed recurrence-sharpness constant
# leaves the reference uses in f32 whatever the compute dtype
F32_LEAVES = ("w_ai", "lam")


class RGLRUState(NamedTuple):
    conv: torch.Tensor      # (B, W-1, rnn_width)
    h: torch.Tensor         # (B, rnn_width) f32


def recurrent_init(generator, d_model: int, rnn_width: int, conv_width: int,
                   *, lead: Sequence[int] = (), device=None):
    # Lambda init so that a^c = sigmoid(lam)^c lands in [0.9, 0.999]
    u = torch.linspace(0.9 ** (1 / RGLRU_C), 0.999 ** (1 / RGLRU_C),
                       rnn_width, dtype=torch.float32, device=device)
    return {
        # in/gate projections stacked, as the reference stacks them
        "w_ig": _normal(generator, (*lead, 2, d_model, rnn_width),
                        device).mul_(d_model ** -0.5),
        "w_out": _dense_init(generator, (rnn_width, d_model), lead=lead,
                             device=device),
        "conv_w": _normal(generator, (*lead, conv_width, rnn_width),
                          device).mul_(conv_width ** -0.5),
        "conv_b": torch.zeros((*lead, rnn_width), dtype=torch.float32,
                              device=device),
        # recurrence/input gates stacked likewise
        "w_ai": _normal(generator, (*lead, 2, rnn_width, rnn_width),
                        device).mul_(rnn_width ** -0.5),
        "lam": torch.log(u / (1 - u)).expand((*lead, rnn_width)).clone(),
    }


def recurrent_axes():
    """Logical axes of ``recurrent_init``'s leaves."""
    return {"w_ig": ("stack", "embed", "rnn"), "w_out": ("rnn", "embed"),
            "conv_w": ("conv", "rnn"), "conv_b": ("rnn",),
            "w_ai": ("stack", "rnn", None), "lam": ("rnn",)}


def _causal_conv(y: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 state: torch.Tensor):
    """Depthwise causal conv in y's dtype. y: (B, T, N); state: (B, W-1, N)
    history.  Returns (out (B, T, N), new history (B, W-1, N))."""
    w = conv_w.shape[0]
    hist = torch.cat([state.to(y.dtype), y], dim=1)
    n = hist.shape[1]
    out = torch.zeros_like(y)
    for i in range(w):
        out = out + hist[:, w - 1 - i: n - i, :] \
            * conv_w[w - 1 - i].to(y.dtype)
    new_state = hist[:, -(w - 1):, :] if w > 1 else state
    return out + conv_b.to(y.dtype), new_state


def recurrent_apply(params, x: torch.Tensor, state: RGLRUState):
    """x: (B, T, d_model) -> (out (B, T, d_model), new state)."""
    dt = x.dtype
    w_ig = params["w_ig"].to(dt)
    w_ai = params["w_ai"].float()
    # the rank's channels of the whole width (w_ai's columns)
    split = tp.is_split(w_ig.shape[-1], w_ai.shape[-1])
    if split:
        x = tp.enter(x)
    y = constrain(x @ w_ig[0], "batch", "seq", "act_rnn")
    gate = F.gelu(x @ w_ig[1], approximate="tanh")   # jax.nn.gelu's form
    y, conv_state = _causal_conv(y, params["conv_w"], params["conv_b"],
                                 state.conv)
    yf = y.float()
    if split:
        # partial sums over the whole width, reduced to the rank's columns
        ai = tp.reduce_scatter(torch.stack([yf @ w_ai[0], yf @ w_ai[1]]))
        r, i = torch.sigmoid(ai[0]), torch.sigmoid(ai[1])
    else:
        r = torch.sigmoid(yf @ w_ai[0])
        i = torch.sigmoid(yf @ w_ai[1])
    log_a = -RGLRU_C * F.softplus(params["lam"].float()) * r  # (B, T, N) <= 0
    a2 = torch.exp(2.0 * log_a)
    g = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * i * yf
    h, h_last = rglru_core(log_a, g.to(dt), state.h)
    h = constrain(h, "batch", "seq", "act_rnn")
    out = (gate * h.to(dt)) @ params["w_out"].to(dt)
    out = constrain(tp.reduce(out) if split else out, "batch", "seq",
                    "act_embed")
    return out, RGLRUState(conv=conv_state.to(state.conv.dtype), h=h_last)


def init_state(batch: int, rnn_width: int, conv_width: int, dtype, *,
               lead: Sequence[int] = (), device=None) -> RGLRUState:
    """Zeros; ``lead`` is prepended (a stack of layers)."""
    return RGLRUState(
        conv=torch.zeros((*lead, batch, conv_width - 1, rnn_width),
                         dtype=dtype, device=device),
        h=torch.zeros((*lead, batch, rnn_width), dtype=torch.float32,
                      device=device))


def state_axes() -> RGLRUState:
    """Logical axes of ``init_state``'s leaves."""
    return RGLRUState(conv=("batch", None, "act_rnn"),
                      h=("batch", "act_rnn"))
