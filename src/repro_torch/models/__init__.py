"""The port's model zoo: the dense, SSM (mamba2) and hybrid
(recurrentgemma) families so far."""
from .common import ModelConfig, resolve_device
from .model import Model

__all__ = ["Model", "ModelConfig", "resolve_device"]
