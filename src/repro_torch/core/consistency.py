"""Per-affinity-group ordering and split-brain fencing (paper §3.4).

A copy of ``GroupSequencer`` and ``EpochFence`` from
``repro.core.consistency``: the serving engine commits every turn through
them, so a replayed or retried turn can neither apply its effects twice
nor commit ahead of an earlier turn of its group.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple


class GroupSequencer:
    """FIFO execution order within each affinity group.

    ``admit(label, item)`` enqueues; ``ready(label)`` yields the next item
    only when the previous one for that group was ``complete``d.  Different
    labels never block each other.  Memory is bounded by the labels with
    work currently in flight: a drained label's queue is pruned.
    """

    def __init__(self):
        self._queues: Dict[str, Deque[Any]] = {}
        self._busy: set = set()
        self.max_queue_len: int = 0

    def admit(self, label: str, item: Any) -> None:
        q = self._queues.get(label)
        if q is None:
            q = self._queues[label] = deque()
        q.append(item)
        self.max_queue_len = max(self.max_queue_len, len(q))

    def ready(self, label: str) -> Optional[Any]:
        if label in self._busy:
            return None
        q = self._queues.get(label)
        if not q:
            return None
        item = q.popleft()
        if not q:
            del self._queues[label]     # prune: bounded by in-flight labels
        self._busy.add(label)
        return item

    def complete(self, label: str) -> None:
        self._busy.discard(label)

    def pending(self, label: str) -> int:
        return (len(self._queues.get(label, ()))
                + (1 if label in self._busy else 0))

    def n_labels(self) -> int:
        """Labels currently holding any state (the memory bound)."""
        return len(self._queues.keys() | self._busy)

    def drain_ready(self) -> List[Tuple[str, Any]]:
        out = []
        for label in list(self._queues):
            item = self.ready(label)
            if item is not None:
                out.append((label, item))
        return out


class EpochFence:
    """Per-label monotonic epochs: the split-brain guard for repair and
    commit paths.

    Every authoritative action on a label first ``advance``s its epoch and
    carries the token it got back; an actor still holding an older token
    fails ``check`` and must drop its action, which is counted in
    ``rejected``.  An unknown label passes ``check`` at token 0.
    """

    def __init__(self):
        self._epochs: Dict[str, int] = {}
        self.rejected = 0          # stale-token actions fenced off

    def current(self, label: str) -> int:
        return self._epochs.get(label, 0)

    def advance(self, label: str) -> int:
        e = self._epochs.get(label, 0) + 1
        self._epochs[label] = e
        return e

    def check(self, label: str, epoch: int) -> bool:
        """True iff ``epoch`` is still the label's newest token."""
        if epoch == self._epochs.get(label, 0):
            return True
        self.rejected += 1
        return False

    def n_labels(self) -> int:
        return len(self._epochs)
