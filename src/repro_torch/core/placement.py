"""Placement engine: affinity key -> shard.

A copy of the part of ``repro.core.placement`` that session routing uses:
Cascade's ``hash(affinity_key) % n_shards`` policy (deterministic within a
group, pseudo-random across groups) plus per-label pins, which re-home a
whole group when its row dies or is rebalanced.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

from .affinity import AffinityFunction, Descriptor, affinity_key_for


def stable_hash(s: str) -> int:
    """Deterministic across processes (unlike python's hash())."""
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(),
                          "big")


class PlacementPolicy:
    def place(self, label: str, shards: Sequence[str]) -> str:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


class HashPlacement(PlacementPolicy):
    """hash(label) % n — Cascade's default mapping."""

    def place(self, label: str, shards: Sequence[str]) -> str:
        return shards[stable_hash(label) % len(shards)]

    def name(self) -> str:
        return "hash"


@dataclasses.dataclass
class PlacementDecision:
    shard: str
    label: str
    grouped: bool           # True if an affinity key drove the decision


class PlacementEngine:
    """Unified placement for data objects AND compute tasks (paper §3.3).

    ``affinity_fn=None`` (or a fn returning None) degrades to the baseline
    random (key-hash) placement the paper compares against.
    """

    def __init__(self, shards: Sequence[str],
                 affinity_fn: Optional[AffinityFunction] = None,
                 policy: Optional[PlacementPolicy] = None):
        self.shards: List[str] = list(shards)
        self.affinity_fn = affinity_fn
        self.policy = policy or HashPlacement()
        self.pins: Dict[str, str] = {}    # label -> shard (migration)
        # label -> home memo; invalidated per label on pin/unpin
        self._home_cache: Dict[str, str] = {}

    def place(self, desc: Descriptor) -> PlacementDecision:
        label = affinity_key_for(self.affinity_fn, desc)
        shard = self.home_of(label)
        return PlacementDecision(shard=shard, label=label,
                                 grouped=(label != desc.key))

    def home_of(self, label: str) -> str:
        shard = self._home_cache.get(label)
        if shard is not None:
            return shard
        pinned = self.pins.get(label)
        if pinned is not None and pinned in self.shards:
            shard = pinned
        else:
            shard = self.policy.place(label, self.shards)
        self._home_cache[label] = shard
        return shard

    def pin(self, label: str, shard: str) -> None:
        """Override a group's home."""
        if shard not in self.shards:
            raise KeyError(f"unknown shard {shard!r}")
        self.pins[label] = shard
        self._home_cache.pop(label, None)

    def unpin(self, label: str) -> None:
        self.pins.pop(label, None)
        self._home_cache.pop(label, None)
