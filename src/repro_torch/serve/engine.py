"""Batched serving engine: prefill + greedy decode over the backbone's
cache API, with iCheck serving-state checkpointing (a preempted inference
node restores its KV cache / recurrent state from the agents instead of
re-running prefill).

The twin of ``repro/serve/engine.py``.  Prefill and decode run eagerly on
``device``; the KV cache / recurrent state is written in place, so a
snapshot copies it to the host (synchronously) before the first decode
step writes into it.  An RWKV-6 model's state does not grow with the
prompt, and a sliding-window layer's ring (recurrentgemma-9b's attention
layers) holds at most ``window`` slots: ``max_len`` sizes only a KV cache,
up to the window.  With a ``mesh`` prefill and decode run under
``use_rules(mesh, rules)``, as the reference's do
(``repro/serve/engine.py:26-45``), so the models' ``constrain`` calls see
the mesh; on plain tensors they change nothing.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.snapshot import restore_pytree, snapshot_pytree
from ..models.transformer import (cast_params, decode_step, init_cache,
                                  prefill)
from ..sharding import get_rules, use_rules


# a batch's precomputed embeddings beside its tokens: audio frames (the
# encoder's input) and vision patches (a prefix of the decoder's)
MODALITY_KEYS = ("frames", "patches")


def serve_max_len(cfg: ModelConfig, seq_len: int, gen: int = 0) -> int:
    n = seq_len + gen
    if cfg.frontend == "patches":
        n += cfg.num_patches
    return n


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.rules = get_rules(cfg.rules)
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
        """Prefill a fresh KV cache / recurrent state from ``batch``'s
        tokens and, for a frames / patches model, its ``frames`` /
        ``patches`` embeddings (moved to ``device`` as f32; the model casts
        them to its dtype as the reference does): returns (last-position
        logits, cache)."""
        inputs = {"tokens": self._tokens(batch["tokens"])}
        for key in MODALITY_KEYS:
            if key in batch:
                inputs[key] = torch.as_tensor(np.asarray(batch[key]),
                                              dtype=torch.float32,
                                              device=self.device)
        cache = init_cache(self.cfg, inputs["tokens"].shape[0], self.max_len,
                           device=self.device)
        with use_rules(self.mesh, self.rules):
            return prefill(self.cfg, self.params, inputs, cache)

    @torch.no_grad()
    def decode_greedy(self, cache, tokens, steps: int) -> np.ndarray:
        """``steps`` greedy decode steps from ``cache`` (written in place),
        fed ``tokens`` (B, 1) first.  Returns the new tokens (B, steps)."""
        tok = self._tokens(tokens).reshape(-1, 1)
        out = []
        for _ in range(steps):
            with use_rules(self.mesh, self.rules):
                logits, cache = decode_step(self.cfg, self.params, cache,
                                            tok)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out.append(tok)
        if not out:
            return np.zeros((tok.shape[0], 0), np.int32)
        return torch.cat(out, dim=1).cpu().numpy()

    def generate(self, batch: Dict, gen_len: int = 16,
                 checkpoint_client=None) -> np.ndarray:
        """Greedy generation. batch: {"tokens": (B, T), ...modality} ->
        (B, gen_len).

        ``checkpoint_client``: optional ICheckClient; if given, the filled
        KV cache / recurrent state is committed after prefill
        (serving-state fault tolerance).
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
        """Rebuild the prefilled KV cache / recurrent state from the
        checkpoint service.

        The restart half of serving-state fault tolerance: fetch the
        committed state from the agents (L1) or the PFS (L2) instead of
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
