"""Core building blocks: RMSNorm, dense projections, RoPE, gated FFNs,
embeddings.  Plain functions on tensors; parameters are nested dicts with
the reference's names and shapes (``repro/models/layers.py``).

Initialisers take an explicit ``torch.Generator`` and ``device`` and a
``lead`` shape prepended to every parameter, which is how a stack of
layers is made in one call (the reference ``vmap``s its init over keys).

As in the reference, every weight is cast to the activation dtype where it
is used (``w.to(x.dtype)``).  A caller may cast the weights once up front
(``ServeEngine`` does): the cast of the same f32 value gives the same bits,
and ``.to`` is then a no-op.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32; the reference ignores ``eps`` and always uses
    1e-6 (``repro/models/layers.py:66-67``), and so does this."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6) * params["scale"]
    return y.to(x.dtype)


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


def ffn_apply(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    wgu = params["w_gu"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    gate, up = x @ wgu[0], x @ wgu[1]
    if kind == "swiglu":
        act = F.silu(gate)
    else:                        # jax.nn.gelu defaults to the tanh form
        act = F.gelu(gate, approximate="tanh")
    return (act * up) @ wd


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------
def embed_init(generator, vocab: int, d_model: int, *, device=None):
    return {"table": _normal(generator, (vocab, d_model), device)}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), params["table"])


def lm_head_init(generator, d_model: int, vocab: int, *, device=None):
    return {"w": _dense_init(generator, (d_model, vocab), device=device)}


def lm_head_apply(params, x: torch.Tensor, valid_vocab: int = 0):
    """valid_vocab > 0: the head is padded; the tail logits are set to
    -1e30 in the logits' dtype so they are inert in softmax / argmax."""
    logits = x @ params["w"].to(x.dtype)
    vp = logits.shape[-1]
    if valid_vocab and valid_vocab < vp:
        ok = torch.arange(vp, device=logits.device) < valid_vocab
        logits = torch.where(ok, logits, logits.new_full((), -1e30))
    return logits
