"""Backwards-compat shim: checkpoint storage moved to ``repro.core.tiers``.

The old two-level layout (L1 ``MemoryStore`` → L2 ``PFSStore``) is now the
pluggable :class:`~repro.core.tiers.StorageTier` pipeline — see
``tiers.py`` and ARCHITECTURE.md.  The historical names remain importable:

    MemoryStore  -> tiers.MemoryTier      (L1)
    PFSStore     -> tiers.PFSTier         (L2)
"""
from __future__ import annotations

from .tiers import (LocalDiskTier, MemoryTier, PFSTier,  # noqa: F401
                    RemoteObjectTier, StorageTier, TierPipeline, crc32,
                    decode_payload, encode_payload, resolve_codec)

MemoryStore = MemoryTier
PFSStore = PFSTier

__all__ = [
    "MemoryStore", "PFSStore", "MemoryTier", "PFSTier", "LocalDiskTier",
    "RemoteObjectTier", "StorageTier", "TierPipeline", "crc32",
    "encode_payload", "decode_payload", "resolve_codec",
]
