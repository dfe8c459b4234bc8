"""Batched serving engine: prefill + greedy decode over the backbone's
cache API, with iCheck serving-state checkpointing (a preempted inference
node restores its KV cache from the agents instead of re-running prefill).

The twin of ``repro/serve/engine.py``.  Prefill and decode run eagerly on
``device``; the cache is written in place, so a snapshot copies it to the
host (synchronously) before the first decode step writes into it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.snapshot import restore_pytree, snapshot_pytree
from ..models.transformer import (cast_params, decode_step, init_cache,
                                  prefill)


def serve_max_len(cfg: ModelConfig, seq_len: int, gen: int = 0) -> int:
    n = seq_len + gen
    if cfg.frontend == "patches":
        n += cfg.num_patches
    return n


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # the reference casts each weight to the compute dtype where it is
        # used; casting once here gives the same bits and saves the
        # per-step casts
        self.params = cast_params(params, getattr(torch, cfg.dtype))
        self.max_len = max_len
        self.last_commit = None     # CommitHandle of the newest cache commit

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict):
        """Prefill a fresh cache: returns (last-position logits, cache)."""
        tokens = self._tokens(batch["tokens"])
        cache = init_cache(self.cfg, tokens.shape[0], self.max_len,
                           device=self.device)
        return prefill(self.cfg, self.params, {"tokens": tokens}, cache)

    @torch.no_grad()
    def decode_greedy(self, cache, tokens, steps: int) -> np.ndarray:
        """``steps`` greedy decode steps from ``cache`` (written in place),
        fed ``tokens`` (B, 1) first.  Returns the new tokens (B, steps)."""
        tok = self._tokens(tokens).reshape(-1, 1)
        out = []
        for _ in range(steps):
            logits, cache = decode_step(self.cfg, self.params, cache, tok)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
        if not out:
            return np.zeros((tok.shape[0], 0), np.int32)
        return torch.cat(out, dim=1).cpu().numpy()

    def generate(self, batch: Dict, gen_len: int = 16,
                 checkpoint_client=None) -> np.ndarray:
        """Greedy generation. batch: {"tokens": (B, T)} -> (B, gen_len).

        ``checkpoint_client``: optional ICheckClient; if given, the filled
        cache is committed after prefill (serving-state fault tolerance).
        """
        logits, cache = self.prefill(batch)
        if checkpoint_client is not None:
            snap = snapshot_pytree(cache, step=0)
            checkpoint_client.add_adapt_snapshot(snap)
            self.last_commit = checkpoint_client.commit(
                0, {n: r.parts for n, r in snap.regions.items()})
        first = torch.argmax(logits, -1)[:, None].to(torch.int32)
        first = first.cpu().numpy()
        rest = self.decode_greedy(cache, first, gen_len - 1)
        return np.concatenate([first, rest], axis=1)

    def restore_serving_state(self, checkpoint_client, batch_size: int):
        """Rebuild the prefilled cache from the checkpoint service.

        The restart half of serving-state fault tolerance: fetch the
        committed cache from the agents (L1) or the PFS (L2) instead of
        re-running prefill.  Returns the restored cache on ``device``, or
        None when nothing was committed.
        """
        found = checkpoint_client.restart()
        if found is None:
            return None
        meta, regions, _level = found
        template = init_cache(self.cfg, batch_size, self.max_len,
                              device="meta")
        region_meta = {name: meta.regions[name] for name in regions}
        return restore_pytree(template, regions, region_meta,
                              device=self.device)
