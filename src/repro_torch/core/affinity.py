"""The paper's §3.3 affinity function: descriptor -> affinity key.

A copy of the part of ``repro.core.affinity`` that session routing uses.
A descriptor carries metadata about a data object or a task; the affinity
function maps it to an opaque label, and everything that shares a label
is collocated by the placement engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

AffinityKey = str


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """Metadata about a data object or a computational task."""
    key: str                                  # unique name (path-style)
    kind: str = "object"                      # "object" | "task"
    size: int = 0                             # bytes (objects)
    meta: Tuple[Tuple[str, Any], ...] = ()    # free-form metadata

    def get(self, name: str, default=None):
        for k, v in self.meta:
            if k == name:
                return v
        return default

    @staticmethod
    def of(key: str, kind: str = "object", size: int = 0, **meta):
        return Descriptor(key=key, kind=kind, size=size,
                          meta=tuple(sorted(meta.items())))


class AffinityFunction:
    """Base class: maps a descriptor to an affinity key (or None).

    ``key_pure`` declares that the label depends ONLY on ``desc.key``;
    it is opt-in, because a stale memoized label silently misplaces work.
    """

    key_pure = False

    def __call__(self, desc: Descriptor) -> Optional[AffinityKey]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class CallableAffinity(AffinityFunction):
    """Arbitrary developer logic (e.g. keyed on a runtime classification)."""

    key_pure = False          # arbitrary logic may read size/meta

    def __init__(self, fn: Callable[[Descriptor], Optional[AffinityKey]],
                 name: str = "callable"):
        self._fn = fn
        self._name = name

    def __call__(self, desc: Descriptor) -> Optional[AffinityKey]:
        return self._fn(desc)

    def describe(self) -> str:
        return f"callable:{self._name}"


def affinity_key_for(fn: Optional[AffinityFunction],
                     desc: Descriptor) -> AffinityKey:
    """The effective placement label: affinity key if grouped, else raw key."""
    if fn is not None:
        k = fn(desc)
        if k is not None:
            return k
    return desc.key
