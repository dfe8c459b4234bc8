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

On a mesh whose axes split the parameters (the "model" axis, tensor and
expert parallelism, and under ``FSDP_RULES`` the "data" axis on the
params' embed rows; ``sharding/tp.py``) every rank of the mesh builds
the engine from the whole parameter tree and keeps its boxes
(``models.shard_params``); each "data" rank serves its rows of the
batch, and the layers gather their "data"-split leaves at their use.
An RWKV-6 model's ``u`` / ``gn_scale`` / ``gn_bias``, split over
head_dim, are turned into the rank's heads once here
(``rwkv6_layer.own_heads``).  Its cache holds its rows and, leaf by
leaf, its box of the reference's layout (``init_cache(mesh=)``): the KV
heads where the size divides them, else the whole K/V on every model
rank; RWKV-6's ``wkv`` heads beside its whole shift states; the RG-LRU's
channels.  The greedy argmax is reduced over the vocab shards where the
vocab splits.  ``generate`` and ``decode_greedy`` return the whole
batch's tokens on every rank.  A commit snapshots the cache as DTensor
views on the mesh (``Shard`` where a leaf splits, ``Replicate`` where it
is whole): one part a distinct box, which the ranks send to rank 0,
where the iCheck client lives.  ``restore_serving_state`` on a mesh
fetches each rank's box through ``redistribute_mesh``, on one rank the
whole cache.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..core import plan as planlib
from ..core.snapshot import (_flatten, _leaf_name, _unflatten,
                             dtensor_sharding, load_leaf_, restore_pytree,
                             snapshot_pytree)
from ..core.types import PartitionDesc, PartitionScheme
from ..models.params import map_axes, param_split, shard_params, tree_paths
from ..models.rwkv6_layer import HEAD_LEAVES, own_heads
from ..models.transformer import (cache_axes, cast_params, decode_step,
                                  init_cache, prefill)
from ..sharding import get_rules, placements, spec, tp, use_rules


# a batch's precomputed embeddings beside its tokens: audio frames (the
# encoder's input) and vision patches (a prefix of the decoder's)
MODALITY_KEYS = ("frames", "patches")


def serve_max_len(cfg: ModelConfig, seq_len: int, gen: int = 0) -> int:
    n = seq_len + gen
    if cfg.frontend == "patches":
        n += cfg.num_patches
    return n


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it is a view (of a whole leaf that the
    engine does not keep)."""
    return t if t._base is None else t.clone()


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.rules = get_rules(cfg.rules)
        self.model_parts = tp.axis_size(mesh)
        split = mesh is not None and any(
            a for _, a in tree_paths(param_split(cfg, mesh, self.rules)))
        # the reference casts each weight to the compute dtype where it is
        # used; casting once here gives the same bits and saves the
        # per-step casts
        dtype = getattr(torch, cfg.dtype)
        if split:
            params = shard_params(params, cfg, mesh, self.rules, copy=False)
        self.params = cast_params(params, dtype)
        if split:
            # the rank's boxes were views: each is cast (or copied) into a
            # tensor of its own, so the engine holds no whole leaf
            self.params = _unflatten(self.params, lambda name, t: _own(t))
            if cfg.mixer == "rwkv6" and self.model_parts > 1:
                self._own_heads()
        self.max_len = max_len
        self.last_commit = None     # CommitHandle of the newest cache commit

    @torch.no_grad()
    def _own_heads(self) -> None:
        """RWKV-6's head_dim boxes as the rank's heads, once."""
        tm = self.params["stack"]["b0"]["tm"]
        heads = tm["w_rkvg"].shape[-1] // self.cfg.rwkv_head_dim
        with use_rules(self.mesh, self.rules):
            for name in HEAD_LEAVES:
                tm[name] = own_heads(tm[name], heads,
                                     self.cfg.rwkv_head_dim)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict):
        """Prefill a fresh KV cache / recurrent state from ``batch``'s
        tokens and, for a frames / patches model, its ``frames`` /
        ``patches`` embeddings (moved to ``device`` as f32; the model casts
        them to its dtype as the reference does): returns (last-position
        logits, cache).  On a mesh both are this rank's: its rows of the
        batch, its vocab columns and KV heads."""
        tokens = self._tokens(batch["tokens"])
        rows = tp.data_rows(tokens.shape[0], self.mesh)
        inputs = {"tokens": tokens[rows]}
        for key in MODALITY_KEYS:
            if key in batch:
                inputs[key] = torch.as_tensor(np.asarray(batch[key]),
                                              dtype=torch.float32,
                                              device=self.device)[rows]
        cache = init_cache(self.cfg, inputs["tokens"].shape[0], self.max_len,
                           device=self.device, mesh=self.mesh)
        with use_rules(self.mesh, self.rules):
            return prefill(self.cfg, self.params, inputs, cache)

    @torch.no_grad()
    def step(self, cache, tokens: torch.Tensor):
        """One decode step from ``cache`` (written in place) fed this
        rank's ``tokens`` (B, 1): (logits, cache), as ``prefill``'s."""
        with use_rules(self.mesh, self.rules):
            return decode_step(self.cfg, self.params, cache, tokens)

    @torch.no_grad()
    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy tokens (B, 1) int32 of ``prefill`` / ``step`` logits,
        the argmax over every vocab shard."""
        with use_rules(self.mesh, self.rules):
            return tp.argmax(logits, self.cfg.padded_vocab)[:, None].to(
                torch.int32)

    def _decode(self, cache, tok: torch.Tensor, steps: int) -> torch.Tensor:
        out = []
        for _ in range(steps):
            logits, cache = self.step(cache, tok)
            tok = self.greedy(logits)
            out.append(tok)
        if not out:
            return tok.new_zeros((tok.shape[0], 0))
        return torch.cat(out, dim=1)

    def _gathered(self, local: torch.Tensor, batch: int) -> np.ndarray:
        """The whole batch's tokens from each data rank's rows."""
        return tp.gather_rows(local, batch, self.mesh).cpu().numpy()

    @torch.no_grad()
    def decode_greedy(self, cache, tokens, steps: int) -> np.ndarray:
        """``steps`` greedy decode steps from ``cache`` (written in place),
        fed ``tokens`` (B, 1) first, the whole batch's.  Returns the new
        tokens (B, steps)."""
        tok = self._tokens(tokens).reshape(-1, 1)
        b = tok.shape[0]
        out = self._decode(cache, tok[tp.data_rows(b, self.mesh)], steps)
        return self._gathered(out, b)

    def generate(self, batch: Dict, gen_len: int = 16,
                 checkpoint_client=None) -> np.ndarray:
        """Greedy generation. batch: {"tokens": (B, T), ...modality} ->
        (B, gen_len).

        ``checkpoint_client``: optional ICheckClient; if given, the filled
        KV cache / recurrent state is committed after prefill
        (serving-state fault tolerance).  On a mesh every rank calls
        ``generate``; the client is rank 0's (the others pass None).
        """
        b = np.shape(batch["tokens"])[0]
        logits, cache = self.prefill(batch)
        if self._root_says(checkpoint_client is not None):
            snap = snapshot_pytree(cache if self.mesh is None
                                   else self._on_mesh(cache, b), step=0)
            if snap is not None:
                checkpoint_client.add_adapt_snapshot(snap)
                self.last_commit = checkpoint_client.commit(
                    0, {n: r.parts for n, r in snap.regions.items()})
        first = self.greedy(logits)
        rest = self._decode(cache, first, gen_len - 1)
        return self._gathered(torch.cat([first, rest], dim=1), b)

    # ------------------------------------------------------------------
    # the cache on the mesh
    # ------------------------------------------------------------------
    def _root_says(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank of the mesh (one broadcast an
        axis, rank 0 first)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        for name in self.mesh.mesh_dim_names:
            group = self.mesh.get_group(name)
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return bool(t.item())

    def _on_mesh(self, cache, batch: int):
        """``cache`` (this rank's, of a global batch of ``batch``) as
        DTensor views on the mesh, each leaf placed as the reference
        shards it (``cache_axes`` under the rules: batch over "data",
        heads or channels over "model" where the size divides them,
        ``Replicate`` where it does not)."""
        from torch.distributed.tensor import DTensor

        whole = init_cache(self.cfg, batch, self.max_len, device="meta")
        return map_axes(lambda ax, w, t: DTensor.from_local(
            t, self.mesh, placements(spec(ax, self.rules, self.mesh,
                                          w.shape), self.mesh),
            run_check=False), cache_axes(self.cfg), whole, cache)

    def restore_serving_state(self, checkpoint_client, batch_size: int):
        """Rebuild the prefilled KV cache / recurrent state from the
        checkpoint service.

        The restart half of serving-state fault tolerance: fetch the
        committed state from the agents (L1) or the PFS (L2) instead of
        re-running prefill.  Returns the restored cache on ``device``, or
        None when nothing was committed.  On a mesh every rank calls it
        (the client is rank 0's) and gets its own box of each leaf, which
        rank 0 fetches through ``redistribute_mesh`` (the client must hold
        the regions: the one that committed, or one that restarted).
        """
        if self.mesh is not None:
            return self._restore_on_mesh(checkpoint_client, batch_size)
        found = checkpoint_client.restart()
        if found is None:
            return None
        meta, regions, _level = found
        template = init_cache(self.cfg, batch_size, self.max_len,
                              device="meta")
        region_meta = {name: meta.regions[name] for name in regions}
        return restore_pytree(template, regions, region_meta,
                              device=self.device)

    def _restore_on_mesh(self, client, batch_size: int):
        found = None
        if dist.get_rank() == 0:
            found = client.controller.latest_restartable(client.app_id)
        if not self._root_says(found is not None):
            return None
        rows = tp.data_rows(batch_size, self.mesh)
        cache = init_cache(self.cfg, rows.stop - rows.start, self.max_len,
                           device=self.device, mesh=self.mesh)
        for path, leaf in _flatten(self._on_mesh(cache, batch_size)):
            name = _leaf_name(path)
            meta = parts = None
            if found is not None:
                boxes = planlib.mesh_part_bounds(leaf.shape,
                                                 dtensor_sharding(leaf))
                parts = client.redistribute_mesh(
                    name, boxes, ckpt_id=found[0].ckpt_id)
                meta = dataclasses.replace(
                    client.regions[name],
                    partition=PartitionDesc(scheme=PartitionScheme.MESH,
                                            num_parts=len(boxes),
                                            bounds=tuple(boxes)))
            load_leaf_(name, leaf, meta, parts)
        return cache
