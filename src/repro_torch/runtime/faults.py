"""Retry budgets and failure records for serving-row outages.

Copies of ``RetryPolicy`` and ``FailureEvent`` from
``repro.runtime.faults``: the serving engine prices turn retries with the
first and fills the serving counters of the second.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry/timeout/backoff budget.

    ``max_attempts`` counts every attempt including the first; backoff
    before re-attempt ``k`` (1-based) is
    ``min(backoff * multiplier**(k-1), max_backoff)``.  ``timeout`` is the
    deadline-aware give-up: no re-attempt is scheduled past it.
    """
    max_attempts: int = 3
    backoff: float = 0.01
    multiplier: float = 2.0
    max_backoff: float = 1.0
    timeout: Optional[float] = None

    def backoff_of(self, attempt: int) -> float:
        """Backoff before re-attempt ``attempt`` (1-based)."""
        return min(self.backoff * self.multiplier ** (attempt - 1),
                   self.max_backoff)


@dataclasses.dataclass
class FailureEvent:
    """One scheduled down/up cycle, with per-event outcome counters.

    The serving counters (``turns_failed``, ``sessions_displaced``,
    ``groups_rerouted``) are filled by the engine for ``kind="row"``.
    """
    node: str
    t_down: float
    t_up: float
    kind: str = "node"
    domain: str = ""
    failed_over: int = 0
    stalled: int = 0
    retries: int = 0
    retry_failovers: int = 0
    retries_exhausted: int = 0
    turns_failed: int = 0
    sessions_displaced: int = 0
    groups_rerouted: int = 0
