"""The affinity-grouping pieces the serving engine runs on (copies)."""
from .affinity import (AffinityFunction, AffinityKey, CallableAffinity,
                       Descriptor, affinity_key_for)
from .consistency import EpochFence, GroupSequencer
from .placement import (HashPlacement, PlacementDecision, PlacementEngine,
                        PlacementPolicy, stable_hash)

__all__ = [
    "AffinityFunction", "AffinityKey", "CallableAffinity", "Descriptor",
    "affinity_key_for", "EpochFence", "GroupSequencer", "HashPlacement",
    "PlacementDecision", "PlacementEngine", "PlacementPolicy", "stable_hash",
]
