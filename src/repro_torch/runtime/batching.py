"""The batching cost model that prices a serving row's decode steps.

A copy of ``repro.runtime.batching.BatchCostModel``.  One batched
invocation costs far less than ``n`` sequential ones, because weights
stream through the compute units once; the affine curve

    batch_seconds(unit, n) = unit * (fixed + marginal * n) / (fixed + marginal)

is normalized so a batch of one costs exactly ``unit``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BatchCostModel:
    """Affine amortized batch cost, normalized to ``unit`` at n=1.

    ``fixed``    — weight-streaming/launch share of a unit invocation;
    ``marginal`` — per-item share;
    ``max_batch`` — the largest batch the hardware shape admits; cost
    grows linearly (no further amortization) past it.
    """
    fixed: float = 0.65
    marginal: float = 0.35
    max_batch: int = 16

    def __post_init__(self):
        if not (self.fixed >= 0 and self.marginal > 0):
            raise ValueError((self.fixed, self.marginal))
        if self.max_batch < 1:
            raise ValueError(self.max_batch)

    def batch_seconds(self, unit_seconds: float, n: int) -> float:
        """Total service time of a batch of ``n`` unit tasks."""
        if n <= 0:
            return 0.0
        if n == 1:
            return unit_seconds
        norm = self.fixed + self.marginal
        full, rem = divmod(n, self.max_batch)
        t = full * unit_seconds * \
            (self.fixed + self.marginal * self.max_batch) / norm
        if rem:
            t += unit_seconds * (self.fixed + self.marginal * rem) / norm
        return t

    def step_seconds(self, unit_seconds: float, n: int) -> float:
        """Per-participant amortized time of one batched step.

        ``n <= 1`` (including an idle row) prices a full unit step.
        """
        n = max(n, 1)
        return self.batch_seconds(unit_seconds, n) / n

    def largest_within(self, unit_seconds: float, budget: float,
                       wait_per_member: float = 0.0) -> int:
        """Largest ``n <= max_batch`` whose formation wait plus amortized
        service fits ``budget``; at least 1."""
        n = 1
        for k in range(2, self.max_batch + 1):
            if (k - 1) * wait_per_member + \
                    self.batch_seconds(unit_seconds, k) > budget:
                break
            n = k
        return n

    def speedup(self, n: int) -> float:
        """Throughput gain of a batch of ``n`` over ``n`` sequential runs."""
        if n <= 1:
            return 1.0
        return n / self.batch_seconds(1.0, n)

    def drain_rate(self, unit_seconds: float, n: int) -> float:
        """Items/second one lane drains running back-to-back batches of
        ``n``."""
        if unit_seconds <= 0.0:
            return float("inf")
        return max(n, 1) / self.batch_seconds(unit_seconds, max(n, 1))
