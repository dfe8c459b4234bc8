"""Deterministic, shardable, checkpointable synthetic data pipeline.

Batches are a pure function of (seed, step) via a counter-based Philox
generator, so the pipeline state is a *single integer*: it checkpoints as an
iCheck region (``icheck_add_adapt("data_state", ...)``), restarts exactly,
and is embarrassingly redistributable across resizes -- every host can
regenerate its slice of any step's global batch from (seed, step, host_id).

The synthetic "language" has learnable structure (a fixed random Markov
chain over the vocab) so that a training run shows a genuinely decreasing
loss, not noise-fitting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def as_array(self) -> np.ndarray:
        return np.asarray([self.seed, self.step], dtype=np.int64)

    @staticmethod
    def from_array(a) -> "DataState":
        a = np.asarray(a).reshape(-1)
        return DataState(seed=int(a[0]), step=int(a[1]))


class SyntheticLMData:
    """Markov-chain token stream + modality stubs (frames / patches)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 order_vocab: int = 512):
        self.cfg = cfg
        self.shape = shape
        self.state = DataState(seed=seed, step=0)
        self.effective_vocab = min(cfg.vocab_size, order_vocab)
        self._reseed(seed)

    def _reseed(self, seed: int) -> None:
        # fixed transition structure, derived from the seed (not steps)
        root = np.random.Generator(np.random.Philox(key=[seed, 0]))
        self._shift = root.integers(1, self.effective_vocab,
                                    size=(8,), dtype=np.int64)

    # --------------------------------------------------------------- batches
    def _rng(self, step: int, lane: int = 0) -> np.random.Generator:
        # counter-based: one Philox key per (seed, lane), step in the key
        return np.random.Generator(np.random.Philox(
            key=[(self.state.seed << 16) ^ lane, step + 1]))

    def batch_at(self, step: int, batch_size: Optional[int] = None,
                 hosts: int = 1, host_id: int = 0) -> Dict[str, np.ndarray]:
        """The (deterministic) global batch of ``step``; hosts>1 slices it."""
        cfg, shape = self.cfg, self.shape
        b = batch_size or shape.global_batch
        assert b % hosts == 0, (b, hosts)
        lo = (b // hosts) * host_id
        hi = lo + b // hosts
        rng = self._rng(step)
        v = self.effective_vocab
        t = shape.seq_len
        start = rng.integers(0, v, size=(b, 1), dtype=np.int64)
        ks = rng.integers(0, len(self._shift), size=(b, t - 1))
        steps = self._shift[ks]                       # Markov-ish increments
        toks = (start + np.concatenate(
            [np.zeros((b, 1), np.int64), np.cumsum(steps, axis=1)],
            axis=1)) % v
        batch = {"tokens": toks[lo:hi].astype(np.int32),
                 "labels": toks[lo:hi].astype(np.int32)}
        if cfg.frontend == "frames":
            batch["frames"] = rng.standard_normal(
                (b, cfg.num_frames, cfg.d_model))[lo:hi].astype(np.float32)
        if cfg.frontend == "patches":
            batch["patches"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model))[lo:hi].astype(np.float32)
        return batch

    def next_batch(self, batch_size: Optional[int] = None, hosts: int = 1,
                   host_id: int = 0) -> Dict[str, np.ndarray]:
        out = self.batch_at(self.state.step, batch_size, hosts, host_id)
        self.state.step += 1
        return out

    # ------------------------------------------------------------ checkpoint
    def state_array(self) -> np.ndarray:
        return self.state.as_array()

    def restore(self, arr) -> None:
        self.state = DataState.from_array(arr)
        self._reseed(self.state.seed)
