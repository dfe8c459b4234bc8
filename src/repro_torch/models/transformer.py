"""The LM backbone for dense attention models (``mixer="attention"``
without MoE): the twin of ``repro/models/transformer.py`` on that path.

* ``init_params(cfg, generator, device)``: a nested dict of f32 tensors
  whose names and shapes equal ``repro.models.init_params``; the layer
  stack is stacked on a leading "layers" axis under ``stack/b0``.
* ``forward``: the scoring path.
* ``init_cache`` / ``prefill`` / ``decode_step``: the serving path.  The
  cache has the reference's layout, ``{"stack": {"b0": {"self":
  KVCache(k, v)}}, "tails": [], "idx": int32 0-d}`` with k/v of shape
  (L, B, Hkv, S, D), and is written in place.

A Python loop over the stacked layers takes the place of ``lax.scan``;
on one device the reference's sharding constraints are no-ops and are
left out.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import (embed_apply, embed_init, ffn_apply, ffn_init,
                     lm_head_apply, lm_head_init, rmsnorm, rmsnorm_init)

Params = Dict[str, Any]


# ==========================================================================
# layer-stack layout
# ==========================================================================
def stack_plan(cfg: ModelConfig) -> Dict[str, Any]:
    """How layers are grouped: dense attention models stack every layer
    as one super-layer ``b0`` with no tail layers."""
    if (cfg.mixer != "attention" or cfg.ffn == "moe" or cfg.is_encdec
            or cfg.frontend != "token"):
        raise NotImplementedError(
            f"{cfg.name}: the port builds dense token-input attention "
            f"models only (mixer={cfg.mixer}, ffn={cfg.ffn})")
    return dict(scan_kinds=("attn",), scan_len=cfg.num_layers,
                tail_kinds=(), enc_layers=0)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, attn.KVCache):
        return attn.KVCache(*(None if t is None else t[i] for t in tree))
    return tree[i]


# ==========================================================================
# per-layer blocks
# ==========================================================================
def _block_init(generator, cfg: ModelConfig, *, lead, device):
    hd = cfg.resolved_head_dim
    return {
        "norm1": rmsnorm_init(cfg.d_model, lead=lead, device=device),
        "attn": attn.attn_init(generator, cfg.d_model, cfg.num_heads,
                               cfg.num_kv_heads, hd, qkv_bias=cfg.qkv_bias,
                               lead=lead, device=device),
        "norm2": rmsnorm_init(cfg.d_model, lead=lead, device=device),
        "ffn": ffn_init(generator, cfg.d_model, cfg.d_ff, lead=lead,
                        device=device),
    }


def _attn_kw(cfg: ModelConfig):
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)


def _block_apply(cfg: ModelConfig, p: Params, x, *, positions, state):
    """Full-sequence application of one layer.  ``state`` is None when
    scoring; for prefill it is this layer's cache slot, filled in place.
    Returns (x, state)."""
    h = rmsnorm(p["norm1"], x)
    if state is not None:
        y, kvc = attn.attn_apply(p["attn"], h, positions=positions,
                                 window=cfg.window, return_cache=True,
                                 **_attn_kw(cfg))
        state = dict(state, self=_write_prefill_cache(state["self"], kvc))
    else:
        y = attn.attn_apply(p["attn"], h, positions=positions,
                            window=cfg.window, **_attn_kw(cfg))
    x = x + y
    x = x + ffn_apply(p["ffn"], rmsnorm(p["norm2"], x), kind=cfg.ffn)
    return x, state


def _write_prefill_cache(cache: attn.KVCache, kvc: attn.KVCache):
    """Store prefill K/V into slots [0, T) of the cache, in place (the
    reference's ``dynamic_update_slice`` at offset 0)."""
    t = kvc.k.shape[2]
    if t > cache.k.shape[2]:
        raise ValueError(f"prompt of {t} tokens exceeds the cache's "
                         f"{cache.k.shape[2]} slots")
    cache.k[:, :, :t].copy_(kvc.k)
    cache.v[:, :, :t].copy_(kvc.v)
    return cache


def _block_decode(cfg: ModelConfig, p: Params, x, idx, *, state):
    """One-token decode of one layer. x: (B, 1, D). Returns (x, state)."""
    h = rmsnorm(p["norm1"], x)
    y, kvc = attn.attn_decode(p["attn"], h, state["self"], idx,
                              **_attn_kw(cfg))
    x = x + y
    x = x + ffn_apply(p["ffn"], rmsnorm(p["norm2"], x), kind=cfg.ffn)
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
    return {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                            device=device),
        "stack": {"b0": _block_init(generator, cfg, lead=(plan["scan_len"],),
                                    device=device)},
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
        "lm_head": lm_head_init(generator, cfg.d_model, cfg.padded_vocab,
                                device=device),
    }


def cast_params(params: Params, dtype) -> Params:
    """Every matrix and bias cast once to the compute ``dtype``; norm
    scales stay f32, as the reference multiplies by them in f32."""
    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key == "scale" else tree.to(dtype)
    return walk(params)


# ==========================================================================
# forward (score)
# ==========================================================================
def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _embed_inputs(cfg: ModelConfig, params, batch):
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = embed_apply(params["embed"], tokens).to(_dtype(cfg))
    positions = torch.arange(t, device=x.device).expand(b, t)
    return x, positions


def _run_stack(cfg: ModelConfig, params, x, positions, caches=None):
    n = stack_plan(cfg)["scan_len"]
    for i in range(n):
        lp = _layer(params["stack"]["b0"], i)
        st = None if caches is None else _layer(caches["stack"]["b0"], i)
        x, _ = _block_apply(cfg, lp, x, positions=positions, state=st)
    return x


def forward(cfg: ModelConfig, params, batch):
    """Scoring forward pass. Returns (logits, aux_loss = 0)."""
    x, positions = _embed_inputs(cfg, params, batch)
    x = _run_stack(cfg, params, x, positions)
    x = rmsnorm(params["final_norm"], x)
    logits = lm_head_apply(params["lm_head"], x, valid_vocab=cfg.vocab_size)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ==========================================================================
# serving: cache init / prefill / decode
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    """Decode cache for a batch of ``batch`` sequences."""
    if cfg.window is not None:
        raise NotImplementedError("the sliding-window ring-buffer cache is "
                                  "not ported yet")
    dtype = dtype or _dtype(cfg)
    n = stack_plan(cfg)["scan_len"]
    kv = attn.init_kv_cache(batch, cfg.num_kv_heads, max_len,
                            cfg.resolved_head_dim, dtype, quant=cfg.kv_quant,
                            lead=(n,), device=device)
    return {"stack": {"b0": {"self": kv}}, "tails": [],
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt through the model, filling ``cache`` in place.

    Returns (logits_last: (B, vocab), cache with ``idx`` = T)."""
    x, positions = _embed_inputs(cfg, params, batch)
    x = _run_stack(cfg, params, x, positions, caches=cache)
    x = rmsnorm(params["final_norm"], x)
    logits = lm_head_apply(params["lm_head"], x[:, -1:, :],
                           valid_vocab=cfg.vocab_size)[:, 0, :]
    idx = torch.full((), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, dict(cache, idx=idx)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decoding step. tokens: (B, 1) -> (logits (B, vocab), cache),
    the cache written in place and its ``idx`` advanced."""
    x = embed_apply(params["embed"], tokens).to(_dtype(cfg))
    idx = cache["idx"]
    for i in range(stack_plan(cfg)["scan_len"]):
        x, _ = _block_decode(cfg, _layer(params["stack"]["b0"], i), x, idx,
                             state=_layer(cache["stack"]["b0"], i))
    x = rmsnorm(params["final_norm"], x)
    logits = lm_head_apply(params["lm_head"], x,
                           valid_vocab=cfg.vocab_size)[:, 0, :]
    return logits, dict(cache, idx=idx + 1)
