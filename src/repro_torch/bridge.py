"""Moves the JAX package's weights and caches into the port and back,
through numpy.

``params_into`` takes ``Model.init``'s params as a tree of numpy arrays
(``{"embed": {...}, "layers": {"mixer": {...}, "mlp": {...}}}`` with a
leading layer axis on every leaf under ``layers``; an SSM layer has a
mixer and no MLP; the hybrid's ``{"groups": {"b<i>": ...}, "tail":
{"t<i>": ...}}`` with a leading group axis under ``groups`` only) and
copies them into a port ``Model``.  ``cache_to_torch`` and
``cache_to_numpy`` convert the decode cache: JAX's nested hybrid tree
becomes the port's flat keys named by path (``"groups/b0/h"``) and back.
bf16 arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses, so they cross as a ``uint16`` view.
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


def _subtree(tree: Mapping[str, Any], path: str) -> Mapping[str, Any]:
    for part in path.split("/"):
        tree = tree[part]
    return tree


@torch.no_grad()
def params_into(model: Model, params: Mapping[str, Any]) -> Model:
    """Copy JAX ``Model.init`` params (numpy leaves) into ``model``."""
    _copy(model.embed, params["embed"])
    for i, blk in enumerate(model.layers):
        path, index = model.tree_path(i)
        src = _subtree(params, path)
        if set(blk.specs) != set(src):
            raise KeyError(f"layer {i} subtrees differ: {sorted(blk.specs)} "
                           f"vs {sorted(src)}")
        for name in blk.specs:
            _copy(getattr(blk, name), src[name], index)
    return model


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for name, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{name}/")
        else:
            yield prefix + name, v


def cache_to_torch(cache: Mapping[str, Any],
                   device: Any = "cpu") -> Dict[str, torch.Tensor]:
    """A JAX decode cache (flat, or the hybrid's nested tree) as the
    port's flat dict of tensors."""
    return {name: to_torch(a, device) for name, a in _flatten(cache)}


def cache_to_numpy(cache: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's cache as JAX's tree of numpy arrays: keys named by a
    path (``"groups/b0/h"``) nest again."""
    out: Dict[str, Any] = {}
    for name, t in cache.items():
        *parents, leaf = name.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = to_numpy(t)
    return out
