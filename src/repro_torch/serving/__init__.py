from .engine import Row, ServingEngine, TurnMetrics
from .sessions import Session, SessionRouter
from .adapters import AdapterStore, LoRAAdapter, apply_adapter, make_adapter
from . import kv_cache

__all__ = ["Row", "ServingEngine", "TurnMetrics", "Session", "SessionRouter",
           "AdapterStore", "LoRAAdapter", "apply_adapter", "make_adapter",
           "kv_cache"]
