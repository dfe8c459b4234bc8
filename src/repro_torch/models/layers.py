"""Core building blocks: RMSNorm, RWKV-6's per-head group norm, dense
projections, RoPE, gated FFNs, embeddings, the frames / patches frontend
projection.  Plain functions on tensors;
parameters are nested dicts with the reference's names and shapes
(``repro/models/layers.py``).

Initialisers take an explicit ``torch.Generator`` and ``device`` and a
``lead`` shape prepended to every parameter, which is how a stack of
layers is made in one call (the reference ``vmap``s its init over keys).
Beside each ``*_init`` a ``*_axes`` gives the logical axes of its leaves,
leaf for leaf the ``axes`` half of the reference's ``(params, axes)``;
``constrain`` calls stand where the reference's do (no-ops on plain
tensors, ``repro_torch/sharding``).  Under a mesh with a "model" axis the
parameters are a rank's boxes (``models.params.shard_params``) and the
collectives of ``sharding/tp.py`` stand where GSPMD would put them: the
FFN is column- then row-parallel where the size divides d_ff, the
embedding and the LM head split the padded vocab where it divides that;
a leaf it does not divide is whole, and its product runs whole on every
rank.  Each such function takes the whole width (``d_ff``, ``vocab``) to
tell its box from the whole leaf.

As in the reference, every weight is cast to the activation dtype where it
is used (``w.to(x.dtype)``).  A caller may cast the weights once up front
(``ServeEngine`` does): the cast of the same f32 value gives the same bits,
and ``.to`` is then a no-op.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..sharding import constrain, tp


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def _dense_init(generator, shape: Sequence[int], scale: Optional[float] = None,
                *, lead: Sequence[int] = (), device=None) -> torch.Tensor:
    """Normal * fan_in^-0.5, with fan_in the first dim of ``shape`` (the
    per-layer shape, not counting ``lead``)."""
    fan_in = shape[0]
    if scale is None:
        scale = fan_in ** -0.5
    return _normal(generator, (*lead, *shape), device).mul_(scale)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm_init(d: int, *, lead: Sequence[int] = (), device=None):
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=device)}


def rmsnorm_axes():
    return {"scale": ("embed",)}


class _RMSNorm(torch.autograd.Function):
    """The reference's custom backward (``repro/models/layers.py:35-63``):
    it saves x in its own dtype and the f32 ``rsig``, returns dx in x's
    dtype and dscale summed over every row."""

    @staticmethod
    def forward(ctx, x, scale):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        rsig = torch.rsqrt(var + 1e-6)
        ctx.save_for_backward(x, rsig, scale)
        return (xf * rsig * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, rsig, scale = ctx.saved_tensors
        d = x.shape[-1]
        xf = x.float()
        dyf = dy.float() * scale
        inner = torch.sum(dyf * xf, dim=-1, keepdim=True) / d
        dx = rsig * (dyf - xf * (rsig * rsig) * inner)
        dscale = torch.sum((dy.float() * xf * rsig).reshape(-1, d), dim=0)
        return dx.to(x.dtype), dscale


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32; the reference ignores ``eps`` and always uses
    1e-6 (``repro/models/layers.py:66-67``), and so does this."""
    return _RMSNorm.apply(x, params["scale"])


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm of RWKV-6's wkv output
    (``repro/models/layers.py:70-79``).  x: (B, T, H, D), normalised over
    D per head with f32 statistics; scale/bias: (H, D), applied in f32;
    the result is cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE: half-split (not interleaved), frequencies and angles in f32
# --------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T) absolute positions."""
    d = x.shape[-1]
    half = d // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    # the base is filled on the device: a tensor made from the Python
    # scalar would be a host-to-device copy, which waits for the card
    freq = torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=x.device), exponent)
    ang = positions[:, None, :, None].float() * freq        # (B,1,T,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU); gate and up projections stacked as w_gu
# --------------------------------------------------------------------------
def ffn_init(generator, d_model: int, d_ff: int, *,
             lead: Sequence[int] = (), device=None):
    w_gu = _normal(generator, (*lead, 2, d_model, d_ff), device)
    return {"w_gu": w_gu.mul_(d_model ** -0.5),
            "w_down": _dense_init(generator, (d_ff, d_model), lead=lead,
                                  device=device)}


def ffn_axes():
    return {"w_gu": ("stack", "embed", "ff"), "w_down": ("ff", "embed")}


def ffn_apply(params, x: torch.Tensor, kind: str = "swiglu",
              d_ff: Optional[int] = None) -> torch.Tensor:
    """Split over "model" where ``w_gu``'s columns (of ``d_ff``, the
    whole width) are: ``w_down`` by rows, the output summed over the
    model ranks."""
    wgu = params["w_gu"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    split = tp.is_split(wgu.shape[-1], d_ff)
    if split:
        x = tp.enter(x)
    gate, up = x @ wgu[0], x @ wgu[1]
    if kind == "swiglu":
        act = F.silu(gate)
    else:                        # jax.nn.gelu defaults to the tanh form
        act = F.gelu(gate, approximate="tanh")
    h = constrain(act * up, "batch", "seq", "act_ff")
    return tp.reduce(h @ wd) if split else h @ wd


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------
def embed_init(generator, vocab: int, d_model: int, *, device=None):
    return {"table": _normal(generator, (vocab, d_model), device)}


def embed_axes():
    return {"table": ("vocab", "embed")}


def embed_apply(params, tokens: torch.Tensor,
                vocab: Optional[int] = None) -> torch.Tensor:
    """Split over "model" by vocab rows where the table holds fewer than
    the padded vocab's ``vocab``: each rank looks up the tokens its rows
    hold, zeros for the others, and the ranks' rows are summed."""
    table = params["table"]
    tokens = tokens.long()
    if not tp.is_split(table.shape[0], vocab):
        out = F.embedding(tokens, table)
    else:
        local = tokens - tp.vocab_offset(table.shape[0], vocab)
        mine = (local >= 0) & (local < table.shape[0])
        out = F.embedding(torch.where(mine, local, 0), table)
        out = tp.reduce(out * mine[..., None].to(out.dtype))
    return constrain(out, "batch", "seq", "act_embed")


def lm_head_init(generator, d_model: int, vocab: int, *, device=None):
    return {"w": _dense_init(generator, (d_model, vocab), device=device)}


def lm_head_axes():
    return {"w": ("embed", "vocab")}


def lm_head_apply(params, x: torch.Tensor, valid_vocab: int = 0,
                  vocab: Optional[int] = None):
    """valid_vocab > 0: the head is padded; the tail logits are set to
    -1e30 in the logits' dtype so they are inert in softmax / argmax.
    Split over "model" by vocab columns where it holds fewer than the
    padded vocab's ``vocab``, each rank's logits are those of its
    columns, masked by their global index (only the last shard holds the
    padded tail)."""
    w = params["w"]
    if tp.is_split(w.shape[-1], vocab):
        x = tp.enter(x)
    logits = x @ w.to(x.dtype)
    vl = logits.shape[-1]
    lo = tp.vocab_offset(vl, vocab)
    if valid_vocab and valid_vocab < lo + vl:
        ok = torch.arange(lo, lo + vl, device=logits.device) < valid_vocab
        logits = torch.where(ok, logits, logits.new_full((), -1e30))
    return constrain(logits, "batch", "seq", "act_vocab")


# --------------------------------------------------------------------------
# Frontend stubs: audio frames and vision patches arrive as precomputed
# embeddings (B, N, d_in); the frontend is one projection
# (``repro/models/layers.py:159-167``)
# --------------------------------------------------------------------------
def frontend_init(generator, d_in: int, d_model: int, *, device=None):
    return {"proj": _dense_init(generator, (d_in, d_model), device=device)}


def frontend_axes():
    return {"proj": (None, "embed")}


def frontend_apply(params, embeds: torch.Tensor) -> torch.Tensor:
    out = embeds @ params["proj"].to(embeds.dtype)
    return constrain(out, "batch", "seq", "act_embed")
