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

Under a mesh with a "model" axis each rank holds its box of ``wq`` /
``wkv`` (and biases) and of ``wo``'s rows (``models.params.shard_params``),
which may end inside a head: the boxes split the flattened width.  The
q and k / v sites (``act_heads``, ``act_kv_heads``) split the heads only
where the size divides them; elsewhere the projection is gathered whole
(``_layout``, ``sharding/tp.py``).  A rank whose query heads are split
over whole K/V takes the K/V heads of its heads' GQA groups
(``_group_kv``), and a whole ``o`` is sliced to ``wo``'s row box before
the product, which is summed over the model ranks.  So the kernel and
the cache see the rank's heads, or all of them where they are whole; the
cache is whole on every model rank where the kv heads do not split.  The
``num_heads`` / ``num_kv_heads`` arguments are the model's.

Under rules that map ``kv_seq`` to "model" (``launch/specs.cell_rules``
where the kv heads do not divide the axis) a cache of S slots that the
size m divides is split over its slots instead (``KVSeqShard``): rank r
holds slots [r S/m, (r+1) S/m), of a ring too.  Prefill computes as
above and keeps the rank's slots (``transformer._write_prefill_cache``).
Decode (the reference's ``attention.py:1-8``: the softmax statistics and
the PV contraction reduce over the split axis) gathers q's heads whole,
lets the slot's owner alone write it, scores every head over the rank's
slots at their global positions, and combines the ranks' partial
softmaxes: the max over the ranks, then one all-reduce of the sums of
``exp(s - max)`` beside their products with V.  A rank whose slots are
all masked adds zeros.
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


class KVSeqShard(KVCache):
    """A rank's box of a KV cache split over its slots on the "model"
    axis: rank r of m holds slots [r s, (r+1) s) of the m s, s its
    ``k.shape[-2]`` (``transformer.init_cache`` under rules that map
    ``kv_seq`` to "model")."""
    __slots__ = ()


def seq_box(cache: KVCache):
    """(global slots, the rank's first slot) of a ``KVSeqShard`` on the
    active "model" axis; (slots, 0) of a whole cache."""
    s = cache.k.shape[-2]
    ax = tp.model_axis()
    if not isinstance(cache, KVSeqShard) or ax is None:
        return s, 0
    return s * ax.size, s * ax.rank


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


class _Layout(NamedTuple):
    """How a rank holds an attention layer under the active "model" axis:
    ``wq`` / ``wkv``, whether those leaves (and ``wo``'s rows) are column
    boxes; ``q`` / ``kv``, whether the q and k / v sites split the heads
    (``act_heads`` / ``act_kv_heads`` resolved on the model's counts)."""
    wq: bool
    q: bool
    wkv: bool
    kv: bool


def _layout(params, num_heads: int, num_kv_heads: int,
            head_dim: int) -> _Layout:
    wq = tp.is_split(params["wq"].shape[-1], num_heads * head_dim)
    wkv = tp.is_split(params["wkv"].shape[-1], num_kv_heads * head_dim)
    q = wq and tp.site_split(("batch", "act_heads", "seq", None),
                             (1, num_heads, 1, head_dim))
    kv = wkv and tp.site_split(("batch", "act_kv_heads", "kv_seq", None),
                               (1, num_kv_heads, 1, head_dim))
    return _Layout(wq, q, wkv, kv)


def _project_qkv(params, x, xkv, head_dim, lay: _Layout, kv: bool = True):
    """q (B, Hq, T, D) and k / v (B, Hkv, S, D) at their sites' layouts:
    the rank's heads where a site splits them, else all of them (a
    column box gathered).  ``xkv`` None: self-attention over ``x``;
    ``kv=False``: q alone (k / v None)."""
    b, t, _ = x.shape
    xq = tp.enter(x) if lay.wq else x
    if xkv is None:
        src = xq if lay.wkv == lay.wq else (tp.enter(x) if lay.wkv else x)
    else:
        src = tp.enter(xkv) if lay.wkv else xkv
    s = src.shape[1]
    q = xq @ params["wq"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    if lay.wq and not lay.q:
        q = tp.gather(q)
    q = q.reshape(b, t, -1, head_dim).transpose(1, 2)
    if not kv:
        return q, None, None
    k, v = _project_kv(params, src)
    if lay.wkv and not lay.kv:
        k, v = tp.gather(k), tp.gather(v)
    k = k.reshape(b, s, -1, head_dim).transpose(1, 2)
    v = v.reshape(b, s, -1, head_dim).transpose(1, 2)
    return q, k, v


def _group_kv(k: torch.Tensor, v: torch.Tensor, lay: _Layout,
              num_heads: int, num_kv_heads: int):
    """K/V (B, Hkv, S, D) for the rank's query heads: as they are where
    both sites split the heads (the groups align) or neither does; where
    the queries are split over whole K/V, the K/V heads of the rank's
    query heads' GQA groups, a slice where those heads fill whole groups
    or lie in one, else one K/V head per query head (a rank's heads can
    straddle groups unevenly, and the kernel takes one group size).  The
    whole K/V's gradient is summed over the model ranks."""
    if lay.q == lay.kv:
        return k, v
    ax = tp.model_axis()
    hq = num_heads // ax.size
    lo, hi = ax.rank * hq, (ax.rank + 1) * hq
    g = num_heads // num_kv_heads
    k, v = tp.enter(k), tp.enter(v)
    if lo % g == 0 and hq % g == 0:
        return k[:, lo // g:hi // g], v[:, lo // g:hi // g]
    if lo // g == (hi - 1) // g:
        return k[:, lo // g:lo // g + 1], v[:, lo // g:lo // g + 1]
    idx = torch.arange(lo, hi, device=k.device) // g
    return k.index_select(1, idx), v.index_select(1, idx)


def _out_proj(params, o: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """``o @ wo``: summed over the model ranks where ``wo`` holds a row
    box, ``o`` sliced to it first where ``o`` is whole."""
    wo = params["wo"].to(o.dtype)
    if not lay.wq:
        return o @ wo
    if not lay.q:
        o = tp.scatter(o)
    return tp.reduce(o @ wo)


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
    lay = _layout(params, num_heads, num_kv_heads, head_dim)
    q, k, v = _project_qkv(params, x, xkv, head_dim, lay)
    if use_rope and self_attn:
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q = constrain(q, "batch", "act_heads", "seq", None)
    k = constrain(k, "batch", "act_kv_heads", "kv_seq", None)
    v = constrain(v, "batch", "act_kv_heads", "kv_seq", None)
    kg, vg = _group_kv(k, v, lay, num_heads, num_kv_heads)
    o = flash_attention(q, kg, vg, causal=causal and self_attn, window=window)
    o = o.transpose(1, 2).reshape(b, t, q.shape[1] * head_dim)
    out = constrain(_out_proj(params, o, lay), "batch", "seq", "act_embed")
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
    slot valid.  A ``KVSeqShard`` holds the rank's slots of the S
    (module docstring).
    """
    b = x.shape[0]
    s, start = seq_box(cache)
    split = s != cache.k.shape[2]
    lay = _layout(params, num_heads, num_kv_heads, head_dim)
    if scale is None:
        scale = head_dim ** -0.5
    q, k_new, v_new = _project_qkv(params, x, None, head_dim, lay,
                                   kv=not cross)
    pos = idx.to(torch.int32).reshape(1, 1).expand(b, 1)
    if use_rope:
        q = apply_rope(q, pos, rope_theta)
    if not cross:
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
        elif split:
            _write_owned(cache, slot - start, k_new, v_new)
        else:
            cache.k.index_copy_(2, slot, k_new.to(cache.k.dtype))
            cache.v.index_copy_(2, slot, v_new.to(cache.v.dtype))
    if cache.ks is not None:
        kf, vf = _dq(cache.k, cache.ks), _dq(cache.v, cache.vs)
    else:
        kf, vf = cache.k.float(), cache.v.float()
    if split:
        # every head over the rank's slots: q whole, K/V whole already
        # (their heads do not split where the slots do)
        if lay.q:
            q = tp.gather(q, 1)
        lay = lay._replace(q=False)
    else:
        kf, vf = _group_kv(kf, vf, lay, num_heads, num_kv_heads)

    hkv = kf.shape[1]
    qg = q.reshape(b, hkv, q.shape[1] // hkv, head_dim).float() * scale
    scores = torch.matmul(qg, kf.transpose(-1, -2))          # (B,Hkv,G,S)
    if cross:
        o = torch.matmul(torch.softmax(scores, dim=-1), vf)
    else:
        kpos = start + torch.arange(kf.shape[2], device=x.device)
        if window is not None:
            valid = kpos < torch.clamp(idx + 1, max=s)  # slots written
        else:
            valid = kpos <= idx
        scores = torch.where(valid, scores, NEG_INF)
        if split:
            o = _split_softmax_pv(scores, valid, vf)
        else:
            o = torch.matmul(torch.softmax(scores, dim=-1), vf)
    o = o.reshape(b, 1, q.shape[1] * head_dim).to(x.dtype)
    out = _out_proj(params, o, lay)
    return constrain(out, "batch", None, "act_embed"), cache


def _write_owned(cache: KVCache, local: torch.Tensor, k_new, v_new) -> None:
    """Write the new K/V at local slot ``local`` (1,) of a ``KVSeqShard``
    where the rank owns it (0 <= local < its slots); elsewhere the slot
    it would clamp to is written back as it was.  No host sync."""
    n = cache.k.shape[2]
    own = (local >= 0) & (local < n)
    at = local.clamp(0, n - 1)
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        cur = buf.index_select(2, at)
        buf.index_copy_(2, at, torch.where(own, new.to(buf.dtype), cur))


def _split_softmax_pv(scores: torch.Tensor, valid: torch.Tensor,
                      vf: torch.Tensor) -> torch.Tensor:
    """softmax(scores) @ V over slots split across the "model" ranks:
    each rank's masked ``scores`` (B, Hkv, G, s) and ``vf`` (B, Hkv, s,
    D) its slots'.  The max over every rank's slots, then the sums of
    ``exp(scores - max)`` and their products with V, all-reduced in one
    call; a rank without a valid slot adds zeros."""
    m = tp.all_max(scores.amax(dim=-1, keepdim=True))
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    d = vf.shape[-1]
    acc = tp.reduce(torch.cat([torch.matmul(e, vf),
                               e.sum(dim=-1, keepdim=True)], dim=-1))
    return acc[..., :d] / acc[..., d:]
