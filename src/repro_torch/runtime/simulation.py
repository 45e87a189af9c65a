"""Network and hardware profiles that price the serving engine's virtual
clock.

Copies of ``NetProfile``, ``CLUSTER_NET``, ``HardwareProfile`` and
``UNIFORM`` from ``repro.runtime.simulation``.  They price transfers and
tier speeds in virtual seconds; they say nothing of the device the port
runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from .batching import BatchCostModel


@dataclasses.dataclass(frozen=True)
class NetProfile:
    bandwidth: float          # bytes/s
    rtt: float                # seconds per transfer
    store_latency: float = 0.0   # extra per remote storage op (cloud)

    def transfer_time(self, nbytes: int) -> float:
        return self.rtt + self.store_latency + nbytes / self.bandwidth


# paper §4.4: 100 Gbps RDMA backbone, PTP-synced cluster
CLUSTER_NET = NetProfile(bandwidth=12.5e9, rtt=10e-6)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """A backend tier's hardware shape: per-resource service rates, lane
    counts, and the tier's own batch-amortization curve (``None`` fields
    defer to the engine-shared :class:`BatchCostModel`)."""
    name: str = "uniform"
    speed: Mapping[str, float] = dataclasses.field(default_factory=dict)
    resources: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"gpu": 1, "cpu": 2, "nic": 2})
    batch_fixed: Optional[float] = None      # None -> shared cost model
    batch_marginal: Optional[float] = None
    max_batch: Optional[int] = None

    def speed_of(self, resource: str) -> float:
        return self.speed.get(resource, 1.0)

    @property
    def nominal_speed(self) -> float:
        """Scalar throughput weight (capacity-aware placement ranking)."""
        return max(self.speed.values(), default=1.0)

    def cost_model(self) -> Optional[BatchCostModel]:
        """The tier's own batching economics, or None for the shared one."""
        if self.batch_fixed is None:
            return None
        return BatchCostModel(fixed=self.batch_fixed,
                              marginal=self.batch_marginal
                              if self.batch_marginal is not None else
                              1.0 - self.batch_fixed,
                              max_batch=self.max_batch or 16)


#: The homogeneous default profile.
UNIFORM = HardwareProfile()
