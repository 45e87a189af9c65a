"""Cost models, retry budgets and profiles the serving engine prices with
(copies)."""
from .batching import BatchCostModel
from .faults import FailureEvent, RetryPolicy
from .simulation import CLUSTER_NET, UNIFORM, HardwareProfile, NetProfile

__all__ = ["BatchCostModel", "FailureEvent", "RetryPolicy", "CLUSTER_NET",
           "UNIFORM", "HardwareProfile", "NetProfile"]
