"""Plain PyTorch versions of the port's kernels.

These are the semantics, copied from ``repro.kernels.ref``: each CUDA
kernel in this package must match the function here.  The wrappers run
them for tensors that lie on the CPU; on the card they serve only as the
yardstick the kernels are held against.

Shape conventions: B batch, H query heads, K kv heads, D head dim.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


def decode_attention(
    q: torch.Tensor,           # (B, H, D)
    k_cache: torch.Tensor,     # (B, Smax, K, D)
    v_cache: torch.Tensor,     # (B, Smax, K, Dv)
    lengths: torch.Tensor,     # (B,) int32 — valid cache entries per row
    *,
    softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """One query token per row against a slotted cache. Returns (B,H,Dv).

    A row with no valid position (``lengths <= 0``, or a window that holds
    no cache entry) softmaxes over its fully masked logits, as the
    reference does, and so averages every cache entry.
    """
    B, H, D = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    g = H // K
    scale = scale if scale is not None else D ** -0.5

    qf = (q.float() * scale).reshape(B, K, g, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.float())
    logits = _softcap(logits, softcap)
    pos = torch.arange(Smax, device=q.device)[None]         # (1,Smax)
    lengths = lengths.to(q.device)
    mask = pos < lengths[:, None]
    if window and window > 0:
        mask &= pos >= (lengths[:, None] - window)
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.float())
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)
