"""GQA attention block: prefill (flash kernel) + decode over the KV cache.

The twin of ``repro/models/attention.py``: self-attention, causal or not
(an encoder's), and cross-attention over an encoder's output (``xkv``;
no RoPE, never causal, its K/V a static cache that ``cross_kv`` fills at
prefill and decode reads without inserting).
Prefill attention runs the flash-attention op, which launches the Hopper
kernel on CUDA tensors.  Decode keeps the reference's plain f32 softmax
over the whole cache (``attention.py:222-246``): with one query per step
it is bound by reading the cache, and the reference leaves it to XLA as
this leaves it to ``torch.matmul``.  A sliding-window layer's cache is a
ring of ``min(max_len, window)`` slots (``attention.py:170-246``): position
p lives in slot p % S, and keys are RoPE'd with their absolute positions
at insert, so an overwritten slot needs no re-rotation.

The int8 cache (``cfg.kv_quant``) holds int8 codes with one f16 scale per
``_Q8_SCALE_BLOCK`` head dims (``_q8``); decode dequantizes the whole cache
to f32 (``_dq``) before its products, as the reference does.  Quantizing
and dequantizing are elementwise tensor ops, XLA in the reference too.

Under a mesh with a "model" axis each rank holds its heads' columns of
``wq`` / ``wkv`` (and biases) and their rows of ``wo``
(``models.params.shard_params``): the head counts are read from the
shards, so the kernel and the cache see the rank's local heads, and
``o @ wo`` is summed over the model ranks (``sharding/tp.py``).  The
``num_heads`` / ``num_kv_heads`` arguments are the model's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..kernels.flash_attention import attention as flash_attention
from ..sharding import constrain, tp
from .layers import _dense_init, _normal, apply_rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor                        # (B, Hkv, S, D)
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None      # int8 mode: (B, Hkv, S, D/blk)
    vs: Optional[torch.Tensor] = None      # f16 scales (see _q8)


# one f16 scale per head, per position, per ``_Q8_SCALE_BLOCK`` contiguous
# head dims (``repro/models/attention.py:31-40``)
_Q8_SCALE_BLOCK = 4
# 1/127 in f32.  The reference writes ``absmax / 127.0``; it serves under
# ``jax.jit``, where XLA turns that division into a multiply by the f32
# reciprocal, and its eager answer differs in some scales by an ulp
# (ROADMAP.md, section 3).  The served model is the reference here, so the
# port multiplies, and its codes and scales are bit-equal to the jitted
# ``_q8``'s.
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _q8_block(head_dim: int) -> int:
    """Scale-block size for a head dim (the whole head when not
    divisible)."""
    return _Q8_SCALE_BLOCK if head_dim % _Q8_SCALE_BLOCK == 0 else head_dim


def _q8(x: torch.Tensor):
    """Blockwise symmetric int8 quantization along the head dim
    (``repro/models/attention.py:48-59``): x (..., D) -> (codes int8
    (..., D), scales f16 (..., D/blk)).  The codes are rounded (half to
    even, as ``jnp.round``) with the f32 scale, which is stored as f16
    only afterwards; a zero block has scale 1."""
    d = x.shape[-1]
    blk = _q8_block(d)
    xf = x.float().reshape(*x.shape[:-1], d // blk, blk)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * _INV_127,
                        torch.ones_like(absmax))
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes.reshape(x.shape), scale[..., 0].to(torch.float16)


def _dq(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``_q8``'s output back to f32 (codes (..., D), scales (...,
    D/blk))."""
    d, nb = codes.shape[-1], scales.shape[-1]
    xf = codes.float().reshape(*codes.shape[:-1], nb, d // nb)
    return (xf * scales.float()[..., None]).reshape(codes.shape)


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


def attn_axes(qkv_bias: bool = False):
    """Logical axes of ``attn_init``'s leaves."""
    a = {"wq": ("embed", "heads"), "wkv": ("stack", "embed", "kv_heads"),
         "wo": ("heads", "embed")}
    if qkv_bias:
        a["bq"], a["bkv"] = ("heads",), ("stack", "kv_heads")
    return a


def _project_kv(params, xkv: torch.Tensor):
    wkv = params["wkv"].to(xkv.dtype)
    k, v = xkv @ wkv[0], xkv @ wkv[1]
    if "bkv" in params:
        bkv = params["bkv"].to(xkv.dtype)
        k, v = k + bkv[0], v + bkv[1]
    return k, v


def local_heads(params, head_dim: int):
    """(query heads, KV heads) of a rank's shards of ``params``."""
    return (params["wq"].shape[-1] // head_dim,
            params["wkv"].shape[-1] // head_dim)


def _project_qkv(params, x, xkv, head_dim):
    b, t, _ = x.shape
    num_heads, num_kv_heads = local_heads(params, head_dim)
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
               xkv: Optional[torch.Tensor] = None,
               return_cache: bool = False):
    """Full-sequence attention (train / prefill / encoder / cross).

    ``xkv`` (B, S, d_model), for cross-attention, defaults to ``x``
    (self-attention); cross-attention takes no RoPE and no causal mask
    (``repro/models/attention.py:105-134``).  Returns ``out`` or ``(out,
    KVCache)`` when ``return_cache``.
    """
    b, t, _ = x.shape
    self_attn = xkv is None
    x = tp.enter(x)
    xkv = x if xkv is None else xkv
    q, k, v = _project_qkv(params, x, xkv, head_dim)
    if use_rope and self_attn:
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q = constrain(q, "batch", "act_heads", "seq", None)
    k = constrain(k, "batch", "act_kv_heads", "kv_seq", None)
    v = constrain(v, "batch", "act_kv_heads", "kv_seq", None)
    o = flash_attention(q, k, v, causal=causal and self_attn, window=window)
    o = o.transpose(1, 2).reshape(b, t, q.shape[1] * head_dim)
    out = constrain(tp.reduce(o @ params["wo"].to(x.dtype)), "batch", "seq",
                    "act_embed")
    if return_cache:
        return out, KVCache(k=k, v=v)
    return out


def cross_kv(params, enc_out: torch.Tensor, num_kv_heads: int,
             head_dim: int, dtype) -> KVCache:
    """The encoder's output projected into a static cross-attention KV
    cache, (B, Hkv, S, D) in ``dtype``
    (``repro/models/attention.py:137-146``)."""
    b, s, _ = enc_out.shape
    k, v = _project_kv(params, enc_out)
    k = k.reshape(b, s, num_kv_heads, head_dim).transpose(1, 2)
    v = v.reshape(b, s, num_kv_heads, head_dim).transpose(1, 2)
    return KVCache(k=k.to(dtype), v=v.to(dtype))


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def init_kv_cache(batch: int, num_kv_heads: int, max_len: int, head_dim: int,
                  dtype, quant: bool = False, *, lead: Sequence[int] = (),
                  device=None) -> KVCache:
    """A zero cache; with ``quant`` int8 codes and f16 scales of one.  The
    cache is written in place, so its leaves are distinct tensors (the
    reference shares one array between ``k`` and ``v``)."""
    shape = (*lead, batch, num_kv_heads, max_len, head_dim)
    if quant:
        sshape = (*shape[:-1], head_dim // _q8_block(head_dim))
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            ks=torch.ones(sshape, dtype=torch.float16, device=device),
            vs=torch.ones(sshape, dtype=torch.float16, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def cache_axes(quant: bool = False) -> KVCache:
    """Logical axes of ``init_kv_cache``'s leaves."""
    ax = ("batch", "act_kv_heads", "kv_seq", None)
    if quant:
        return KVCache(k=ax, v=ax, ks=ax, vs=ax)
    return KVCache(k=ax, v=ax)


def attn_decode(params, x: torch.Tensor, cache: KVCache, idx: torch.Tensor, *,
                num_heads: int, num_kv_heads: int, head_dim: int,
                rope_theta: float = 10000.0, use_rope: bool = True,
                window: Optional[int] = None, cross: bool = False,
                scale: Optional[float] = None):
    """One-token decode. x: (B, 1, d_model); idx: 0-d int32 position.

    The new K/V (int8 codes and scales for an int8 cache) are written into
    ``cache`` in place at slot ``idx``, or ``idx % S`` for a
    sliding-window layer's ring (the reference returns an updated copy;
    the same tensors come back here).  ``cross=True`` attends over a
    static, prefilled cache (cross-attention) without inserting, every
    slot valid.
    """
    b = x.shape[0]
    s = cache.k.shape[2]
    num_heads, num_kv_heads = local_heads(params, head_dim)
    if scale is None:
        scale = head_dim ** -0.5
    x = tp.enter(x)
    q = x @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(b, 1, num_heads, head_dim).transpose(1, 2)
    pos = idx.to(torch.int32).reshape(1, 1).expand(b, 1)
    if use_rope:
        q = apply_rope(q, pos, rope_theta)
    if not cross:
        k_new, v_new = _project_kv(params, x)
        k_new = k_new.reshape(b, 1, num_kv_heads, head_dim).transpose(1, 2)
        v_new = v_new.reshape(b, 1, num_kv_heads, head_dim).transpose(1, 2)
        if use_rope:
            k_new = apply_rope(k_new, pos, rope_theta)
        slot = idx.reshape(1).long()
        if window is not None:
            slot = slot % s
        if cache.ks is not None:                   # int8 cache
            for buf, sbuf, new in ((cache.k, cache.ks, k_new),
                                   (cache.v, cache.vs, v_new)):
                codes, scales = _q8(new)
                buf.index_copy_(2, slot, codes)
                sbuf.index_copy_(2, slot, scales)
        else:
            cache.k.index_copy_(2, slot, k_new.to(cache.k.dtype))
            cache.v.index_copy_(2, slot, v_new.to(cache.v.dtype))
    if cache.ks is not None:
        kf, vf = _dq(cache.k, cache.ks), _dq(cache.v, cache.vs)
    else:
        kf, vf = cache.k.float(), cache.v.float()

    g = num_heads // num_kv_heads
    qg = q.reshape(b, num_kv_heads, g, head_dim).float() * scale
    scores = torch.matmul(qg, kf.transpose(-1, -2))          # (B,Hkv,G,S)
    if not cross:
        kpos = torch.arange(s, device=x.device)
        if window is not None:
            valid = kpos < torch.clamp(idx + 1, max=s)  # slots written
        else:
            valid = kpos <= idx
        scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.matmul(p, vf)                                   # (B,Hkv,G,D)
    o = o.reshape(b, 1, num_heads * head_dim).to(x.dtype)
    out = tp.reduce(o @ params["wo"].to(x.dtype))
    return constrain(out, "batch", None, "act_embed"), cache
