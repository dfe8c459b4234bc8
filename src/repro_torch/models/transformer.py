"""The LM backbone, the twin of ``repro/models/transformer.py`` on all ten
architectures: decoder-only attention models (``mixer="attention"``) with
a gated FFN or a Mixture-of-Experts FFN (``ffn="moe"``, ``moe.py``), the
encoder-decoder over audio frames (``frontend="frames"``,
seamless-m4t-medium), the decoder over a prefix of vision patches
(``frontend="patches"``, pixtral-12b), RWKV-6 (``mixer="rwkv6"``) and the
RG-LRU hybrid (``mixer="rglru_hybrid"``, Griffin / RecurrentGemma).

* ``init_params(cfg, generator, device)``: a nested dict of f32 tensors
  whose names and shapes equal ``repro.models.init_params``'s params
  (``param_axes(cfg)`` is its axes half, ``abstract_params(cfg)`` both on
  the ``meta`` device); the layer
  stack is stacked on a leading "layers" axis, one super-layer of the
  plan's kinds under ``stack/b0``, ``stack/b1``, ..., and the hybrid's
  leftover layers are ``tail0``, ``tail1``, ... (``stack_plan``).  The
  frames / patches models add ``frontend/proj``; the encoder-decoder adds
  the encoder ``enc/b0`` (non-causal attention layers) and ``enc_norm``,
  and its decoder layers (kind ``"dec"``) cross-attention ``norm_x`` and
  ``xattn`` over the encoder's output.
* ``forward`` / ``loss_fn``: the training and scoring path, each layer
  recomputed in the backward (``torch.utils.checkpoint``) unless the
  config's ``remat_policy`` is ``"none"``, the encoder's layers too; the
  MoE layers' aux losses are summed in f32 and added to the loss.  A
  patch prefix is cut off before the LM head.
* ``init_cache`` / ``prefill`` / ``decode_step``: the serving path.  The
  cache has the reference's layout, ``{"stack": {"b0": ...}, "tails":
  [...], "idx": int32 0-d}``: a ``{"self": KVCache(k, v)}`` of k/v
  (L, B, Hkv, S, D) for an attention layer (S = min(max_len, window), a
  ring, for a sliding-window layer; with ``cfg.kv_quant`` int8 k/v and
  f16 scales ks/vs (L, B, Hkv, S, D/blk), ``attention._q8``), an
  ``RWKVState`` (shift_tm, shift_cm (L, B, D), wkv (L, B, H, Dh, Dh) f32)
  for RWKV-6 and an ``RGLRUState`` (conv (L, B, W-1, N), h (L, B, N) f32)
  for an RG-LRU layer; tail layers have no leading L.  A decoder layer of
  the encoder-decoder holds ``{"self": ..., "cross": ...}``, the cross
  cache ``num_frames`` slots of the encoder's projected K/V, filled at
  prefill and only read in decode.  It is written in place;
  ``cache_axes(cfg)`` gives its logical axes.

A Python loop over the stacked layers takes the place of ``lax.scan``.
The reference's sharding constraints stand where it has them; on plain
tensors they are no-ops.  Under a mesh with a "model" axis
(``use_rules(mesh, rules)``) the params are a rank's boxes
(``params.shard_params``) and the layers call the collectives of
``sharding/tp.py`` between them and the reference's activation layouts;
where the size divides the padded vocab the logits are the rank's vocab
columns and ``loss_fn`` reduces its log-sum-exp and target logits over
them.  ``init_cache(..., mesh=)`` gives every leaf the rank's box of its
``cache_axes`` under the rules: the rank's heads or channels where the
size divides them, else the whole leaf.

Under ``FSDP_RULES`` a leaf with an ``"embed"`` axis is also split over
the mesh's "data" axis (ZeRO-3).  Each layer gathers its own such leaves
first thing (``_gathered``), inside the remat ``checkpoint``, so the
backward gathers them again and reduce-scatters their gradients
(``tp.gather_param``); the embedding, the frontend, the final norms and
the LM head are gathered at their use.  A leaf the layer casts to the
compute dtype is cast before its gather.
"""
from __future__ import annotations

import functools
import types
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding import active_rules, constrain, get_rules, spec, tp
from . import attention as attn
from . import moe as moe_lib
from . import rglru_layer as rglru
from . import rwkv6_layer as rwkv
from .layers import (embed_apply, embed_axes, embed_init, ffn_apply,
                     ffn_axes, ffn_init, frontend_apply, frontend_axes,
                     frontend_init, lm_head_apply, lm_head_axes,
                     lm_head_init, rmsnorm, rmsnorm_axes, rmsnorm_init)
from .params import map_axes

Params = Dict[str, Any]


# ==========================================================================
# layer-stack layout
# ==========================================================================
def stack_plan(cfg: ModelConfig) -> Dict[str, Any]:
    """How layers are grouped (``repro/models/transformer.py:49-68``):
    attention models (dense or MoE) and RWKV-6 stack every layer as one
    super-layer ``b0``; the RG-LRU hybrid stacks one pattern period, e.g.
    (rec, rec, attn), as ``b0, b1, b2`` and runs the leftovers as tail
    layers; the encoder-decoder stacks its decoder layers (kind ``"dec"``)
    as ``b0`` and its ``enc_layers`` encoder layers apart, under ``enc``."""
    if cfg.mixer == "rwkv6":
        return dict(scan_kinds=("rwkv",), scan_len=cfg.num_layers,
                    tail_kinds=(), enc_layers=0)
    if cfg.mixer == "rglru_hybrid":
        period = cfg.pattern or ("rec", "rec", "attn")
        n_scan = cfg.num_layers // len(period)
        n_tail = cfg.num_layers - n_scan * len(period)
        tail = (cfg.tail_layers or ("rec",) * n_tail)[:n_tail]
        return dict(scan_kinds=tuple(period), scan_len=n_scan,
                    tail_kinds=tuple(tail), enc_layers=0)
    if cfg.is_encdec:
        return dict(scan_kinds=("dec",), scan_len=cfg.num_layers,
                    tail_kinds=(), enc_layers=cfg.encoder_layers)
    return dict(scan_kinds=("attn",), scan_len=cfg.num_layers,
                tail_kinds=(), enc_layers=0)


def _layer_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind == "attn" and cfg.mixer == "rglru_hybrid":
        return cfg.window or 2048
    return cfg.window


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies); a NamedTuple
    (``KVCache``, ``RWKVState``) keeps its type, field by field."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(None if t is None else t[i] for t in tree))
    return tree[i]


# ==========================================================================
# per-layer blocks
# ==========================================================================
def _block_init(generator, cfg: ModelConfig, kind: str, *, lead, device):
    if kind == "rec":
        return {
            "norm1": rmsnorm_init(cfg.d_model, lead=lead, device=device),
            "rec": rglru.recurrent_init(generator, cfg.d_model,
                                        cfg.resolved_rnn_width,
                                        cfg.conv1d_width, lead=lead,
                                        device=device),
            "norm2": rmsnorm_init(cfg.d_model, lead=lead, device=device),
            "ffn": ffn_init(generator, cfg.d_model, cfg.d_ff, lead=lead,
                            device=device),
        }
    if kind == "rwkv":
        return {
            "norm1": rmsnorm_init(cfg.d_model, lead=lead, device=device),
            "tm": rwkv.timemix_init(generator, cfg.d_model,
                                    cfg.rwkv_head_dim, lead=lead,
                                    device=device),
            "norm2": rmsnorm_init(cfg.d_model, lead=lead, device=device),
            "cm": rwkv.chanmix_init(generator, cfg.d_model, cfg.d_ff,
                                    lead=lead, device=device),
        }
    hd = cfg.resolved_head_dim

    def attn_init():
        return attn.attn_init(generator, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, hd, qkv_bias=cfg.qkv_bias,
                              lead=lead, device=device)

    p = {"norm1": rmsnorm_init(cfg.d_model, lead=lead, device=device),
         "attn": attn_init()}
    if kind == "dec":
        p["norm_x"] = rmsnorm_init(cfg.d_model, lead=lead, device=device)
        p["xattn"] = attn_init()
    p["norm2"] = rmsnorm_init(cfg.d_model, lead=lead, device=device)
    if cfg.ffn == "moe":
        p["moe"] = moe_lib.moe_init(generator, cfg.d_model, cfg.num_experts,
                                    cfg.resolved_moe_d_ff, lead=lead,
                                    device=device)
    else:
        p["ffn"] = ffn_init(generator, cfg.d_model, cfg.d_ff, lead=lead,
                            device=device)
    return p


def _block_axes(cfg: ModelConfig, kind: str):
    """Logical axes of ``_block_init``'s leaves (one layer, no lead)."""
    if kind == "rec":
        return {"norm1": rmsnorm_axes(), "rec": rglru.recurrent_axes(),
                "norm2": rmsnorm_axes(), "ffn": ffn_axes()}
    if kind == "rwkv":
        return {"norm1": rmsnorm_axes(), "tm": rwkv.timemix_axes(),
                "norm2": rmsnorm_axes(), "cm": rwkv.chanmix_axes()}
    a = {"norm1": rmsnorm_axes(), "attn": attn.attn_axes(cfg.qkv_bias)}
    if kind == "dec":
        a["norm_x"] = rmsnorm_axes()
        a["xattn"] = attn.attn_axes(cfg.qkv_bias)
    a["norm2"] = rmsnorm_axes()
    if cfg.ffn == "moe":
        a["moe"] = moe_lib.moe_axes()
    else:
        a["ffn"] = ffn_axes()
    return a


def _stacked(axes):
    """A layer's axes with the stack's leading ``"layers"`` axis."""
    return map_axes(lambda ax: ("layers",) + tuple(ax), axes)


def _attn_kw(cfg: ModelConfig):
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


# leaves gathered in their own dtype: those used in f32 (``cast_params``
# keeps them) and the embedding table, whose lookup is cast after it
_GATHER_AS_IS = ("scale", "table") + rwkv.F32_LEAVES + rglru.F32_LEAVES


@functools.lru_cache(maxsize=None)
def _data_dims(cfg: ModelConfig, kind: Optional[str], rules, data: int,
               model: int):
    """(dim, whole width) of each leaf of one layer of ``kind`` (None:
    the leaves outside the layers) where the rules split that dim over a
    "data" axis of ``data`` ranks on a ("data", "model") mesh, or None
    where they keep it whole over "data" (a tree of the layer's
    layout)."""
    mesh = types.SimpleNamespace(shape={"data": data, "model": model})
    if kind is None:
        shapes, axes = init_params(cfg, None, "meta"), param_axes(cfg)
        shapes = {k: v for k, v in shapes.items()
                  if k not in ("stack", "enc") and not k.startswith("tail")}
        axes = {k: axes[k] for k in shapes}
    else:
        shapes = _block_init(None, cfg, kind, lead=(), device="meta")
        axes = _block_axes(cfg, kind)

    return map_axes(lambda ax, t: next(
        ((d, t.shape[d]) for d, entry in enumerate(
            spec(ax, rules, mesh, t.shape)) if tp.on_axis(entry, "data")),
        None), axes, shapes)


def _gathered(cfg: ModelConfig, kind: Optional[str], p: Params, dtype):
    """``p`` (a layer's params, or with ``kind`` None the leaves outside
    the layers) with every leaf that is a "data" box of the active mesh
    gathered whole (``tp.gather_param``), cast to ``dtype`` first unless
    the model uses it in its own dtype.  A leaf is a box where the rules
    split its dim over "data" and its width there is less than the
    whole's (as ``tp.is_split`` reads "model"): a caller that keeps the
    leaves whole on a "data" mesh (``ElasticTrainer``) gathers nothing."""
    ax = tp.data_axis()
    if ax is None:
        return p
    mesh, rules = active_rules()
    dims = _data_dims(cfg, kind, rules, ax.size, tp.axis_size(mesh))

    def walk(tree, dims):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, dims[k])
            elif dims[k] is None or v.shape[dims[k][0]] == dims[k][1]:
                out[k] = v
            else:
                out[k] = tp.gather_param(
                    v, dims[k][0], None if k in _GATHER_AS_IS else dtype)
        return out
    return walk(p, dims)


def _top(cfg: ModelConfig, params: Params, key: str, dtype) -> Params:
    """The leaves under ``params[key]`` (outside the layers), gathered
    over "data" where the mesh splits them."""
    return _gathered(cfg, None, {key: params[key]}, dtype)[key]


def _ffn_or_moe(cfg: ModelConfig, p: Params, h):
    """An attention layer's FFN: (y, aux), aux the MoE layer's f32 aux
    loss or None for a gated FFN (``repro/models/transformer.py:114-120``,
    whose zero aux is left out).  MoE's capacity follows h's T, so decode
    runs it with one slot an expert, as the reference does."""
    if cfg.ffn == "moe":
        return moe_lib.moe_apply(
            p["moe"], h, num_experts=cfg.num_experts,
            experts_per_token=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
            aux_coef=cfg.router_aux_coef)
    return ffn_apply(p["ffn"], h, kind=cfg.ffn, d_ff=cfg.d_ff), None


def _rwkv_block(cfg: ModelConfig, p: Params, x, state):
    """One RWKV-6 layer over T >= 1 tokens from ``state`` (None: zeros,
    when scoring), the reference's ``"rwkv"`` kind
    (``repro/models/transformer.py:166-181,245-255``).  The new state is
    written into ``state``'s tensors in place.  Returns (x, state)."""
    st = state if state is not None else rwkv.init_state(
        x.shape[0], cfg.d_model, cfg.rwkv_head_dim, x.dtype,
        device=x.device, width=p["tm"]["w_rkvg"].shape[-1])
    y, shift_tm, wkv = rwkv.timemix_apply(p["tm"], rmsnorm(p["norm1"], x),
                                          st.shift_tm, st.wkv,
                                          cfg.rwkv_head_dim)
    x = x + y
    y, shift_cm = rwkv.chanmix_apply(p["cm"], rmsnorm(p["norm2"], x),
                                     st.shift_cm, d_ff=cfg.d_ff)
    x = x + y
    if state is not None:
        state.shift_tm.copy_(shift_tm)
        state.shift_cm.copy_(shift_cm)
        state.wkv.copy_(wkv)
    return x, state


def _rec_block(cfg: ModelConfig, p: Params, x, state):
    """One RG-LRU layer over T >= 1 tokens from ``state`` (None: zeros,
    when scoring), the reference's ``"rec"`` kind
    (``repro/models/transformer.py:182-190,256-260``).  The new state is
    written into ``state``'s tensors in place.  Returns (x, state)."""
    st = state if state is not None else rglru.init_state(
        x.shape[0], p["rec"]["w_ig"].shape[-1], cfg.conv1d_width, x.dtype,
        device=x.device)
    y, new = rglru.recurrent_apply(p["rec"], rmsnorm(p["norm1"], x), st)
    x = x + y
    x = x + ffn_apply(p["ffn"], rmsnorm(p["norm2"], x), kind=cfg.ffn,
                      d_ff=cfg.d_ff)
    if state is not None:
        state.conv.copy_(new.conv)
        state.h.copy_(new.h)
    return x, state


def _block_apply(cfg: ModelConfig, p: Params, x, *, kind: str, positions,
                 state, enc_out=None, causal: bool = True):
    """Full-sequence application (train / prefill / encoder) of one layer
    of ``kind`` (``repro/models/transformer.py:124-190``).  ``state`` is
    None when scoring; for prefill it is this layer's cache slot, filled
    in place.  ``causal=False`` for an encoder layer; a ``"dec"`` layer
    cross-attends over ``enc_out`` after its self-attention, and at
    prefill fills its cross cache from ``enc_out`` (int8 codes and scales
    for an int8 cache).  Returns (x, aux, state), aux None but for a MoE
    layer."""
    p = _gathered(cfg, kind, p, x.dtype)
    if kind in ("rwkv", "rec"):
        block = _rwkv_block if kind == "rwkv" else _rec_block
        x, state = block(cfg, p, x, state)
        return constrain(x, "batch", "seq", "act_embed"), None, state
    window = _layer_window(cfg, kind)
    h = rmsnorm(p["norm1"], x)
    if state is not None:
        y, kvc = attn.attn_apply(p["attn"], h, positions=positions,
                                 causal=causal, window=window,
                                 return_cache=True, **_attn_kw(cfg))
        state = dict(state, self=_write_prefill_cache(state["self"], kvc,
                                                      window))
    else:
        y = attn.attn_apply(p["attn"], h, positions=positions,
                            causal=causal, window=window, **_attn_kw(cfg))
    x = x + y
    if kind == "dec":
        y = attn.attn_apply(p["xattn"], rmsnorm(p["norm_x"], x), xkv=enc_out,
                            causal=False, use_rope=False, **_attn_kw(cfg))
        x = x + y
        if state is not None:
            _write_cross_cache(state["cross"], attn.cross_kv(
                p["xattn"], enc_out, cfg.num_kv_heads, cfg.resolved_head_dim,
                enc_out.dtype))
    y, aux = _ffn_or_moe(cfg, p, rmsnorm(p["norm2"], x))
    return constrain(x + y, "batch", "seq", "act_embed"), aux, state


def _write_cross_cache(cache: attn.KVCache, kvc: attn.KVCache) -> None:
    """Store the encoder's projected K/V into the cross cache in place,
    as int8 codes and scales for an int8 cache
    (``repro/models/transformer.py:152-162``)."""
    pairs = [(cache.k, kvc.k), (cache.v, kvc.v)]
    if cache.ks is not None:                       # int8 cache
        (kq, ks), (vq, vs) = attn._q8(kvc.k), attn._q8(kvc.v)
        pairs = [(cache.k, kq), (cache.v, vq), (cache.ks, ks),
                 (cache.vs, vs)]
    for buf, val in pairs:
        buf.copy_(val)


def _write_prefill_cache(cache: attn.KVCache, kvc: attn.KVCache, window):
    """Store prefill K/V into the cache in place: slots [0, T), or for a
    sliding-window ring shorter than the prompt the last S positions,
    rotated so that absolute position p lives in slot p % S as decode's
    ring writes expect (the reference's ``_write_prefill_cache``,
    ``repro/models/transformer.py:193-222``).  An int8 cache takes the
    K/V's codes and scales (``attn._q8``), rolled alike."""
    s, t = cache.k.shape[2], kvc.k.shape[2]
    pairs = [(cache.k, kvc.k), (cache.v, kvc.v)]
    if cache.ks is not None:                       # int8 cache
        (kq, ks), (vq, vs) = attn._q8(kvc.k), attn._q8(kvc.v)
        pairs = [(cache.k, kq), (cache.v, vq), (cache.ks, ks),
                 (cache.vs, vs)]
    if t <= s:
        for buf, val in pairs:
            buf[:, :, :t].copy_(val)
        return cache
    if window is None:
        raise ValueError(f"prompt of {t} tokens exceeds the cache's {s} "
                         f"slots")
    shift = (t - s) % s
    for buf, val in pairs:
        buf.copy_(torch.roll(val[:, :, t - s:], shift, dims=2))
    return cache


def _block_decode(cfg: ModelConfig, p: Params, x, idx, *, kind: str,
                  state):
    """One-token decode of one layer. x: (B, 1, D). Returns (x, state)."""
    p = _gathered(cfg, kind, p, x.dtype)
    if kind == "rwkv":
        return _rwkv_block(cfg, p, x, state)
    if kind == "rec":
        return _rec_block(cfg, p, x, state)
    h = rmsnorm(p["norm1"], x)
    y, kvc = attn.attn_decode(p["attn"], h, state["self"], idx,
                              window=_layer_window(cfg, kind),
                              **_attn_kw(cfg))
    x = x + y
    if kind == "dec":
        y, _ = attn.attn_decode(p["xattn"], rmsnorm(p["norm_x"], x),
                                state["cross"], idx, cross=True,
                                use_rope=False, **_attn_kw(cfg))
        x = x + y
    x = x + _ffn_or_moe(cfg, p, rmsnorm(p["norm2"], x))[0]
    return x, dict(state, self=kvc)


# ==========================================================================
# parameter init
# ==========================================================================
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> Params:
    """f32 parameters drawn from ``generator`` on ``device`` (``"meta"``
    allocates nothing).  Names and shapes equal the reference's; the
    values differ, since the two frameworks draw different numbers."""
    plan = stack_plan(cfg)
    params = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                  device=device)}
    if cfg.frontend in ("frames", "patches"):
        params["frontend"] = frontend_init(generator, cfg.d_model,
                                           cfg.d_model, device=device)
    if plan["enc_layers"]:
        params["enc"] = {"b0": _block_init(generator, cfg, "attn",
                                           lead=(plan["enc_layers"],),
                                           device=device)}
        params["enc_norm"] = rmsnorm_init(cfg.d_model, device=device)
    params["stack"] = {f"b{i}": _block_init(generator, cfg, kind,
                                            lead=(plan["scan_len"],),
                                            device=device)
                       for i, kind in enumerate(plan["scan_kinds"])}
    for i, kind in enumerate(plan["tail_kinds"]):
        params[f"tail{i}"] = _block_init(generator, cfg, kind, lead=(),
                                         device=device)
    params["final_norm"] = rmsnorm_init(cfg.d_model, device=device)
    params["lm_head"] = lm_head_init(generator, cfg.d_model,
                                     cfg.padded_vocab, device=device)
    return params


def param_axes(cfg: ModelConfig) -> Params:
    """Logical axes of ``init_params``'s leaves, leaf for leaf the
    reference's axes tree (``repro/models/transformer.py:268-309``): the
    stacked leaves lead with ``"layers"``, the tail layers do not."""
    plan = stack_plan(cfg)
    axes = {"embed": embed_axes()}
    if cfg.frontend in ("frames", "patches"):
        axes["frontend"] = frontend_axes()
    if plan["enc_layers"]:
        axes["enc"] = {"b0": _stacked(_block_axes(cfg, "attn"))}
        axes["enc_norm"] = rmsnorm_axes()
    axes["stack"] = {f"b{i}": _stacked(_block_axes(cfg, kind))
                     for i, kind in enumerate(plan["scan_kinds"])}
    for i, kind in enumerate(plan["tail_kinds"]):
        axes[f"tail{i}"] = _block_axes(cfg, kind)
    axes["final_norm"] = rmsnorm_axes()
    axes["lm_head"] = lm_head_axes()
    return axes


def abstract_params(cfg: ModelConfig):
    """(params on the ``meta`` device, their axes): shapes and dtypes
    with nothing allocated."""
    return init_params(cfg, None, "meta"), param_axes(cfg)


def cast_params(params: Params, dtype) -> Params:
    """Every matrix and bias cast once to the compute ``dtype``; norm
    scales, RWKV-6's ``w0``, ``u``, ``gn_scale`` and ``gn_bias``, and the
    RG-LRU's ``w_ai`` and ``lam`` stay f32, as the reference uses them in
    f32."""
    keep = ("scale",) + rwkv.F32_LEAVES + rglru.F32_LEAVES

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key in keep else tree.to(dtype)
    return walk(params)


# ==========================================================================
# forward (score)
# ==========================================================================
def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _embed_inputs(cfg: ModelConfig, params, batch):
    """The tokens' embeddings, after the projected patches for a patches
    model; positions run over prefix and tokens together.  Returns (x,
    positions, prefix length)."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = embed_apply(_top(cfg, params, "embed", _dtype(cfg)), tokens,
                    vocab=cfg.padded_vocab).to(_dtype(cfg))
    prefix = 0
    if cfg.frontend == "patches":
        pe = frontend_apply(_top(cfg, params, "frontend", _dtype(cfg)),
                            batch["patches"].to(_dtype(cfg)))
        x = torch.cat([pe, x], dim=1)
        prefix = pe.shape[1]
    positions = torch.arange(x.shape[1], device=x.device).expand(
        b, x.shape[1])
    return x, positions, prefix


def _remat(cfg: ModelConfig) -> bool:
    """Recompute each layer in the backward (the reference's ``_remat``,
    ``repro/models/transformer.py:328-341``): any policy but ``"none"``
    keeps only the layer's input.  The reference's ``"dots"`` and
    ``"psum"`` policies name XLA residuals and act here as ``"full"``."""
    return cfg.remat_policy != "none" and torch.is_grad_enabled()


def _layers(cfg: ModelConfig, params, caches=None):
    """(kind, layer params, layer cache or None) for every layer in order:
    the stacked super-layers, then the tail layers."""
    plan = stack_plan(cfg)
    for i in range(plan["scan_len"]):
        for j, kind in enumerate(plan["scan_kinds"]):
            yield (kind, _layer(params["stack"][f"b{j}"], i),
                   None if caches is None
                   else _layer(caches["stack"][f"b{j}"], i))
    for j, kind in enumerate(plan["tail_kinds"]):
        yield (kind, params[f"tail{j}"],
               None if caches is None else caches["tails"][j])


def _run_encoder(cfg: ModelConfig, params, batch):
    """The encoder over the projected frames: non-causal layers with RoPE
    at positions 0..S-1, each recomputed in the backward as the decoder's
    are, then ``enc_norm`` (``repro/models/transformer.py:358-371``)."""
    e = frontend_apply(_top(cfg, params, "frontend", _dtype(cfg)),
                       batch["frames"].to(_dtype(cfg)))
    b, s, _ = e.shape
    epos = torch.arange(s, device=e.device).expand(b, s)
    remat = _remat(cfg)
    for i in range(stack_plan(cfg)["enc_layers"]):
        lp = _layer(params["enc"]["b0"], i)
        if remat:
            e = checkpoint(lambda h, lp=lp: _block_apply(
                cfg, lp, h, kind="attn", positions=epos, state=None,
                causal=False)[0], e, use_reentrant=False,
                preserve_rng_state=False)
        else:
            e = _block_apply(cfg, lp, e, kind="attn", positions=epos,
                             state=None, causal=False)[0]
    return rmsnorm(_top(cfg, params, "enc_norm", e.dtype), e)


def _run_stack(cfg: ModelConfig, params, x, positions, caches=None,
               enc_out=None):
    """Every layer in order, the decoder's cross-attending over
    ``enc_out``.  Returns (x, aux): the MoE layers' aux losses summed in
    f32 in layer order, as the reference's scan sums them (None without a
    MoE layer)."""
    remat = caches is None and _remat(cfg)
    aux = None
    for kind, lp, st in _layers(cfg, params, caches):
        if remat:
            # the layer has no randomness, so no RNG state is kept;
            # enc_out is an input of each layer, so its gradient flows
            # from every layer's cross-attention K/V
            x, aux_i = checkpoint(
                lambda h, e, lp=lp, kind=kind: _block_apply(
                    cfg, lp, h, kind=kind, positions=positions, state=None,
                    enc_out=e)[:2],
                x, enc_out, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux_i, _ = _block_apply(cfg, lp, x, kind=kind,
                                       positions=positions, state=st,
                                       enc_out=enc_out)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
    return x, aux


def _encode(cfg: ModelConfig, params, batch):
    """The encoder's output for an encoder-decoder, else None."""
    return _run_encoder(cfg, params, batch) if cfg.is_encdec else None


def forward(cfg: ModelConfig, params, batch):
    """Training / scoring forward pass. Returns (logits, aux_loss): the MoE
    layers' summed aux loss, an f32 zero for a model without one.  The
    logits are the tokens' only: a patch prefix is cut off before the LM
    head.  Under a "model" axis they are the rank's vocab columns."""
    x, positions, prefix = _embed_inputs(cfg, params, batch)
    x, aux = _run_stack(cfg, params, x, positions,
                        enc_out=_encode(cfg, params, batch))
    x = rmsnorm(_top(cfg, params, "final_norm", x.dtype), x)
    if prefix:
        x = x[:, prefix:, :]
    logits = lm_head_apply(_top(cfg, params, "lm_head", x.dtype), x,
                           valid_vocab=cfg.vocab_size,
                           vocab=cfg.padded_vocab)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux


def loss_fn(cfg: ModelConfig, params, batch, *,
            token_total: Optional[torch.Tensor] = None, ranks: int = 1):
    """Next-token cross-entropy over f32 logits, labels < 0 masked out
    (``repro/models/transformer.py:429-441``). Returns (loss, metrics).

    Under data parallelism each of ``ranks`` ranks scores its slice of the
    global batch and passes ``token_total``, the whole batch's count of
    unmasked targets: its cross-entropy is then its masked sum over that
    count and its aux loss (a mean over sequences) a ``ranks``-th of its
    own, so the ranks' losses and gradients sum to the whole batch's."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    logits = logits[:, :-1, :].float()
    targets = labels[:, 1:].long()
    if not tp.is_split(logits.shape[-1], cfg.padded_vocab):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets.clamp_min(0)[..., None])[..., 0]
    else:
        logz, gold = _vocab_parallel_xent(logits, targets, cfg.padded_vocab)
    mask = (targets >= 0).float()
    count = mask.sum() if token_total is None else token_total
    xent = torch.sum((logz - gold) * mask) / torch.clamp_min(count, 1.0)
    loss = xent + aux / ranks
    return loss, {"xent": xent, "aux": aux}


def _vocab_parallel_xent(logits, targets, vocab: int):
    """(logsumexp, target logit) of vocab-sharded f32 ``logits`` (of the
    padded ``vocab``): the max and the sums of exp and of the target's
    logit (held by one shard) taken over the model ranks."""
    top = tp.all_max(logits.amax(dim=-1))
    logz = top + torch.log(tp.reduce(
        torch.exp(logits - top[..., None]).sum(dim=-1)))
    local = targets - tp.vocab_offset(logits.shape[-1], vocab)
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = tp.reduce(torch.where(mine, gold[..., 0], 0.0))
    return logz, gold


# ==========================================================================
# serving: cache init / prefill / decode
# ==========================================================================
def _kind_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, lead, device):
    """One layer's (or, with ``lead``, a stack's) zero cache of ``kind``
    (``repro/models/transformer.py:462-485``)."""
    def kv_cache(s):
        kv = attn.init_kv_cache(batch, cfg.num_kv_heads, s,
                                cfg.resolved_head_dim, dtype,
                                quant=cfg.kv_quant, lead=lead, device=device)
        if lead and kv.ks is not None:
            # the reference stacks a cache as zeros of each leaf's shape
            # (``repro/models/transformer.py:489-490``), scales included;
            # the slots not yet written are masked in decode, and prefill
            # fills a cross cache whole
            kv.ks.zero_()
            kv.vs.zero_()
        return kv

    if kind == "attn":
        window = _layer_window(cfg, kind)
        return {"self": kv_cache(min(max_len, window) if window
                                 else max_len)}
    if kind == "dec":
        return {"self": kv_cache(max_len), "cross": kv_cache(cfg.num_frames)}
    if kind == "rwkv":
        return rwkv.init_state(batch, cfg.d_model, cfg.rwkv_head_dim, dtype,
                               lead=lead, device=device)
    if kind == "rec":
        return rglru.init_state(batch, cfg.resolved_rnn_width,
                                cfg.conv1d_width, dtype, lead=lead,
                                device=device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda", mesh=None) -> Dict[str, Any]:
    """Decode cache for a batch of ``batch`` sequences: a KV cache of
    ``max_len`` slots (a ring of ``min(max_len, window)`` for a
    sliding-window layer), or a recurrent state, whose size does not
    depend on ``max_len``.  ``mesh``: a mesh whose "model" axis the cache
    is split over, each leaf the rank's box of its ``cache_axes`` under
    the config's rules (``batch`` is the rank's rows already): a rank's
    cache, zeros, as its prefill fills it."""
    size = tp.axis_size(mesh)
    if size > 1:
        rules = get_rules(cfg.rules)
        tp.check_model_axis(cfg, size, rules, tp.axis_size(mesh, "data"))
        whole = init_cache(cfg, batch, max_len, dtype, "meta")
        return map_axes(lambda ax, t: torch.zeros(
            tp.local_shape(ax, t.shape, rules, size), dtype=t.dtype,
            device=device), cache_axes(cfg), whole)
    dtype = dtype or _dtype(cfg)
    plan = stack_plan(cfg)
    lead = (plan["scan_len"],)
    return {
        "stack": {f"b{i}": _kind_cache_init(cfg, kind, batch, max_len, dtype,
                                            lead, device)
                  for i, kind in enumerate(plan["scan_kinds"])},
        "tails": [_kind_cache_init(cfg, kind, batch, max_len, dtype, (),
                                   device)
                  for kind in plan["tail_kinds"]],
        "idx": torch.zeros((), dtype=torch.int32, device=device),
    }


def _kind_cache_axes(kind: str, quant: bool = False):
    if kind == "attn":
        return {"self": attn.cache_axes(quant)}
    if kind == "dec":
        return {"self": attn.cache_axes(quant),
                "cross": attn.cache_axes(quant)}
    if kind == "rwkv":
        return rwkv.state_axes()
    if kind == "rec":
        return rglru.state_axes()
    raise ValueError(kind)


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of ``init_cache``'s leaves
    (``repro/models/transformer.py:500-509``)."""
    plan = stack_plan(cfg)
    return {"stack": {f"b{i}": _stacked(_kind_cache_axes(kind, cfg.kv_quant))
                      for i, kind in enumerate(plan["scan_kinds"])},
            "tails": [_kind_cache_axes(kind, cfg.kv_quant)
                      for kind in plan["tail_kinds"]],
            "idx": ()}


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt (after its patch prefix, over its frames) through
    the model, filling ``cache`` in place.

    Returns (logits_last: (B, vocab), cache with ``idx`` = prefix + T)."""
    x, positions, _ = _embed_inputs(cfg, params, batch)
    x, _ = _run_stack(cfg, params, x, positions, caches=cache,
                      enc_out=_encode(cfg, params, batch))
    x = rmsnorm(_top(cfg, params, "final_norm", x.dtype), x)
    logits = lm_head_apply(_top(cfg, params, "lm_head", x.dtype),
                           x[:, -1:, :], valid_vocab=cfg.vocab_size,
                           vocab=cfg.padded_vocab)[:, 0, :]
    idx = torch.full((), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, dict(cache, idx=idx)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decoding step. tokens: (B, 1) -> (logits (B, vocab), cache),
    the cache written in place and its ``idx`` advanced."""
    x = embed_apply(_top(cfg, params, "embed", _dtype(cfg)), tokens,
                    vocab=cfg.padded_vocab).to(_dtype(cfg))
    idx = cache["idx"]
    for kind, lp, st in _layers(cfg, params, cache):
        x, _ = _block_decode(cfg, lp, x, idx, kind=kind, state=st)
    x = rmsnorm(_top(cfg, params, "final_norm", x.dtype), x)
    logits = lm_head_apply(_top(cfg, params, "lm_head", x.dtype), x,
                           valid_vocab=cfg.vocab_size,
                           vocab=cfg.padded_vocab)[:, 0, :]
    return logits, dict(cache, idx=idx + 1)
