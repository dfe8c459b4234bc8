"""GQA attention block: prefill (flash kernel) + decode over the KV cache.

The twin of ``repro/models/attention.py`` for the non-quantized,
self-attention case.  Prefill attention runs the flash-attention op, which
launches the Hopper kernel on CUDA tensors.  Decode keeps the reference's
plain f32 softmax over the whole cache (``attention.py:222-246``): with one
query per step it is bound by reading the cache, and the reference leaves
it to XLA as this leaves it to ``torch.matmul``.  A sliding-window layer's
cache is a ring of ``min(max_len, window)`` slots (``attention.py:
170-246``): position p lives in slot p % S, and keys are RoPE'd with their
absolute positions at insert, so an overwritten slot needs no re-rotation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..kernels.flash_attention import attention as flash_attention
from .layers import _dense_init, _normal, apply_rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor                        # (B, Hkv, S, D)
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None      # int8 mode scales: a later slice
    vs: Optional[torch.Tensor] = None


def attn_init(generator, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, qkv_bias: bool = False, *,
              lead: Sequence[int] = (), device=None):
    """K and V projections are stacked on a leading axis as ``wkv``."""
    p = {"wq": _dense_init(generator, (d_model, num_heads * head_dim),
                           lead=lead, device=device)}
    p["wkv"] = _normal(generator, (*lead, 2, d_model, num_kv_heads * head_dim),
                       device).mul_(d_model ** -0.5)
    p["wo"] = _dense_init(generator, (num_heads * head_dim, d_model),
                          lead=lead, device=device)
    if qkv_bias:
        p["bq"] = torch.zeros((*lead, num_heads * head_dim),
                              dtype=torch.float32, device=device)
        p["bkv"] = torch.zeros((*lead, 2, num_kv_heads * head_dim),
                               dtype=torch.float32, device=device)
    return p


def _project_kv(params, xkv: torch.Tensor):
    wkv = params["wkv"].to(xkv.dtype)
    k, v = xkv @ wkv[0], xkv @ wkv[1]
    if "bkv" in params:
        bkv = params["bkv"].to(xkv.dtype)
        k, v = k + bkv[0], v + bkv[1]
    return k, v


def _project_qkv(params, x, xkv, num_heads, num_kv_heads, head_dim):
    b, t, _ = x.shape
    s = xkv.shape[1]
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    k, v = _project_kv(params, xkv)
    q = q.reshape(b, t, num_heads, head_dim).transpose(1, 2)
    k = k.reshape(b, s, num_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(b, s, num_kv_heads, head_dim).transpose(1, 2)
    return q, k, v


def attn_apply(params, x: torch.Tensor, *, num_heads: int, num_kv_heads: int,
               head_dim: int, positions: Optional[torch.Tensor] = None,
               causal: bool = True, window: Optional[int] = None,
               rope_theta: float = 10000.0, use_rope: bool = True,
               return_cache: bool = False):
    """Full-sequence self-attention (prefill / scoring).

    Returns ``out`` or ``(out, KVCache)`` when ``return_cache``.
    """
    b, t, _ = x.shape
    q, k, v = _project_qkv(params, x, x, num_heads, num_kv_heads, head_dim)
    if use_rope:
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window)
    o = o.transpose(1, 2).reshape(b, t, num_heads * head_dim)
    out = o @ params["wo"].to(x.dtype)
    if return_cache:
        return out, KVCache(k=k, v=v)
    return out


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def init_kv_cache(batch: int, num_kv_heads: int, max_len: int, head_dim: int,
                  dtype, quant: bool = False, *, lead: Sequence[int] = (),
                  device=None) -> KVCache:
    if quant:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    shape = (*lead, batch, num_kv_heads, max_len, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attn_decode(params, x: torch.Tensor, cache: KVCache, idx: torch.Tensor, *,
                num_heads: int, num_kv_heads: int, head_dim: int,
                rope_theta: float = 10000.0, use_rope: bool = True,
                window: Optional[int] = None,
                scale: Optional[float] = None):
    """One-token self-attention decode over a (not int8) cache.
    x: (B, 1, d_model); idx: 0-d int32 position.

    The new K/V are written into ``cache`` in place at slot ``idx``, or
    ``idx % S`` for a sliding-window layer's ring (the reference returns
    an updated copy; the same tensors come back here).
    """
    b = x.shape[0]
    s = cache.k.shape[2]
    if scale is None:
        scale = head_dim ** -0.5
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(b, 1, num_heads, head_dim).transpose(1, 2)
    pos = idx.to(torch.int32).reshape(1, 1).expand(b, 1)
    if use_rope:
        q = apply_rope(q, pos, rope_theta)
    k_new, v_new = _project_kv(params, x)
    k_new = k_new.reshape(b, 1, num_kv_heads, head_dim).transpose(1, 2)
    v_new = v_new.reshape(b, 1, num_kv_heads, head_dim).transpose(1, 2)
    if use_rope:
        k_new = apply_rope(k_new, pos, rope_theta)
    slot = idx.reshape(1).long()
    if window is not None:
        slot = slot % s
    cache.k.index_copy_(2, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(2, slot, v_new.to(cache.v.dtype))

    g = num_heads // num_kv_heads
    qg = q.reshape(b, num_kv_heads, g, head_dim).float() * scale
    kf, vf = cache.k.float(), cache.v.float()
    scores = torch.matmul(qg, kf.transpose(-1, -2))          # (B,Hkv,G,S)
    kpos = torch.arange(s, device=x.device)
    if window is not None:
        valid = kpos < torch.clamp(idx + 1, max=s)      # slots written
    else:
        valid = kpos <= idx
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.matmul(p, vf)                                   # (B,Hkv,G,D)
    o = o.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    return o @ params["wo"].to(x.dtype), cache
