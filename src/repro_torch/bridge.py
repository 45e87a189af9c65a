"""Moves the JAX package's weights and caches into the port and back,
through numpy.

``params_into`` takes ``Model.init``'s params as a tree of numpy arrays
(``{"embed": {...}, "layers": {"mixer": {...}, "mlp": {...}}}`` with a
leading layer axis on every leaf under ``layers``; an SSM layer has a
mixer and no MLP) and copies them into a port ``Model``.
``cache_to_torch`` and ``cache_to_numpy`` convert the slotted decode
cache.  bf16 arrays arrive as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses, so they cross as a ``uint16`` view.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models import Model


def to_torch(arr: np.ndarray, device: Any = "cpu") -> torch.Tensor:
    arr = np.array(arr)            # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _copy(dst: Mapping[str, torch.Tensor], src: Mapping[str, Any],
          index=None) -> None:
    if set(dst) != set(src):
        raise KeyError(f"parameter names differ: {sorted(dst)} vs "
                       f"{sorted(src)}")
    for name, p in dst.items():
        a = np.asarray(src[name])
        a = a if index is None else a[index]
        t = to_torch(a)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(t.to(p.dtype))


@torch.no_grad()
def params_into(model: Model, params: Mapping[str, Any]) -> Model:
    """Copy JAX ``Model.init`` params (numpy leaves) into ``model``."""
    _copy(model.embed, params["embed"])
    stacked = params["layers"]
    for i, blk in enumerate(model.layers):
        if set(blk.specs) != set(stacked):
            raise KeyError(f"layer subtrees differ: {sorted(blk.specs)} vs "
                           f"{sorted(stacked)}")
        for name in blk.specs:
            _copy(getattr(blk, name), stacked[name], i)
    return model


def cache_to_torch(cache: Mapping[str, Any],
                   device: Any = "cpu") -> Dict[str, torch.Tensor]:
    return {name: to_torch(a, device) for name, a in cache.items()}


def cache_to_numpy(cache: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: to_numpy(t) for name, t in cache.items()}
