"""Plain PyTorch versions of the port's kernels.

These are the semantics, copied from ``repro.kernels.ref``: each CUDA
kernel in this package must match the function here.  The wrappers run
them for tensors that lie on the CPU; on the card they serve only as the
yardstick the kernels are held against.

Shape conventions: B batch, S query seq, T key seq, H query heads, K kv
heads, D head dim.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


# ---------------------------------------------------------------------------
# Multi-head attention (train / prefill): causal, local-window, bidirectional
# ---------------------------------------------------------------------------

def mha(
    q: torch.Tensor,           # (B, S, H, D)
    k: torch.Tensor,           # (B, T, K, D)
    v: torch.Tensor,           # (B, T, K, Dv)
    *,
    causal: bool = True,
    window: int = 0,           # >0: local attention (last `window` keys)
    softcap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,         # absolute position of q[0] (chunked prefill)
    q_chunk: int = 0,          # >0: process queries in blocks of this size
    unroll: bool = False,
) -> torch.Tensor:
    """Attention of S queries over T keys, GQA by grouping (H = g*K), in
    fp32.  Returns (B, S, H, Dv) in q's dtype.

    A query row with no valid key (``q_offset + i >= T + window - 1``, or a
    causal row before every key) softmaxes over its fully masked logits,
    as the reference does, and so averages every value.
    """
    del unroll   # in the reference it only shapes JAX's HLO
    S = q.shape[1]
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q_chunk and 0 < q_chunk < S and S % q_chunk == 0:
        return torch.cat([_mha_core(q[:, i:i + q_chunk], k, v, q_offset + i,
                                    **kw)
                          for i in range(0, S, q_chunk)], dim=1)
    return _mha_core(q, k, v, q_offset, **kw)


def _mha_core(q, k, v, q_offset, *, causal, window, softcap, scale):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"{H} query heads do not group over {K} kv heads")
    g = H // K
    scale = scale if scale is not None else D ** -0.5

    qf = (q.float() * scale).reshape(B, S, K, g, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float())  # (B,K,g,S,T)
    logits = _softcap(logits, softcap)

    qpos = torch.arange(S, device=q.device)[:, None] + q_offset   # (S,1)
    kpos = torch.arange(T, device=q.device)[None, :]              # (1,T)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention: one query token against a (possibly partial) KV cache
# ---------------------------------------------------------------------------

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
