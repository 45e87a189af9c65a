"""Plain PyTorch versions of the port's kernels.

These are the semantics, copied from ``repro.kernels.ref``: each CUDA
kernel in this package must match the function here.  The wrappers run
them for tensors that lie on the CPU; on the card they serve only as the
yardstick the kernels are held against.

Shape conventions: B batch, S query seq, T key seq, H query heads, K kv
heads, D head dim; for the SSD scan P head dim, G groups, N state dim;
for the RG-LRU W width.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) — chunked algorithm
# ---------------------------------------------------------------------------

def ssd(
    x: torch.Tensor,           # (B, S, H, P)
    dt: torch.Tensor,          # (B, S, H)  — already softplus'd, > 0
    A: torch.Tensor,           # (H,)       — negative
    Bm: torch.Tensor,          # (B, S, G, N)
    Cm: torch.Tensor,          # (B, S, G, N)
    D: Optional[torch.Tensor] = None,   # (H,) skip connection
    *,
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    unroll: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).

    Chunks of L = min(chunk, S) steps, in fp32; head h reads group
    h // (H/G).  A ragged S is padded with dt=0 steps, which are exact
    no-ops (decay exp(0) = 1, zero input)."""
    del unroll   # in the reference it only shapes JAX's HLO
    Bsz, S_in, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    hpg = H // G
    L = min(chunk, S_in)
    if S_in % L:
        pad = L - S_in % L

        def z(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        x, dt, Bm, Cm = z(x), z(dt), z(Bm), z(Cm)
    S = x.shape[1]
    nc = S // L

    xf = x.float()
    dtf = dt.float()
    Af = A.float()
    # expand groups to heads once
    Bh = Bm.float()
    Ch = Cm.float()
    if G != H:
        Bh = Bh.repeat_interleave(hpg, dim=2)
        Ch = Ch.repeat_interleave(hpg, dim=2)

    xc = xf.reshape(Bsz, nc, L, H, P)
    dtc = dtf.reshape(Bsz, nc, L, H)
    Bc = Bh.reshape(Bsz, nc, L, H, N)
    Cc = Ch.reshape(Bsz, nc, L, H, N)

    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        xi, dti, Bi, Ci = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dti * Af[None, None, :]                        # (B,L,H) <= 0
        cum = torch.cumsum(dA, dim=1)                       # inclusive
        # intra-chunk: decay(i,j) = exp(cum_i - cum_j), j <= i
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])
        decay = torch.where(tri[None, :, :, None], decay, 0.0)
        cb = torch.einsum("bihn,bjhn->bijh", Ci, Bi)        # (B,i,j,H)
        w = cb * decay * dti[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xi)
        # inter-chunk contribution: C_i . exp(cum_i) h_prev
        y_inter = torch.einsum("bihn,bih,bhpn->bihp", Ci, torch.exp(cum), h)
        # chunk-final state update
        last = cum[:, -1:, :]                               # (B,1,H)
        sdecay = torch.exp(last - cum) * dti                # (B,L,H)
        states = torch.einsum("blh,blhn,blhp->bhpn", sdecay, Bi, xi)
        h = h * torch.exp(last[:, 0])[:, :, None, None] + states
        ys.append(y_intra + y_inter)

    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    return y[:, :S_in].to(x.dtype), h


def ssd_decode(
    x: torch.Tensor,           # (B, H, P)
    dt: torch.Tensor,          # (B, H)
    A: torch.Tensor,           # (H,)
    Bm: torch.Tensor,          # (B, G, N)
    Cm: torch.Tensor,          # (B, G, N)
    D: Optional[torch.Tensor],
    state: torch.Tensor,       # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step. Returns (y (B,H,P), new_state fp32)."""
    B, H, P = x.shape
    G = Bm.shape[1]
    hpg = H // G
    xf, dtf = x.float(), dt.float()
    Bh = Bm.repeat_interleave(hpg, dim=1).float()           # (B,H,N)
    Ch = Cm.repeat_interleave(hpg, dim=1).float()
    dA = torch.exp(dtf * A.float()[None])                   # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dtf, Bh, xf)
    new_state = state.float() * dA[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    if D is not None:
        y = y + xf * D.float()[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence (Griffin / recurrentgemma)
# ---------------------------------------------------------------------------

def rglru(
    a: torch.Tensor,           # (B, S, W) — per-step decay in (0,1)
    b: torch.Tensor,           # (B, S, W) — per-step input term
    h0: Optional[torch.Tensor] = None,   # (B, W)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t in fp32, h0 folded into the first input
    term.  Returns (h (B,S,W) in a's dtype, h_final (B,W) fp32).

    The reference runs an associative scan; this is the same scan by
    doubling (log2 S passes, each step combined with the one d before
    it).  No running product is divided out: a_t reaches ~1e-30 and a
    product over 2,048 steps underflows to 0, which the combine takes
    as it is."""
    af = a.float()
    bf = b.float()
    if h0 is not None:
        bf = bf.clone()
        bf[:, 0] += af[:, 0] * h0.float()
    S = af.shape[1]
    d = 1
    while d < S:
        # (a1, b1) earlier, (a2, b2) later -> (a1*a2, a2*b1 + b2)
        bf = torch.cat([bf[:, :d], af[:, d:] * bf[:, :-d] + bf[:, d:]], 1)
        af = torch.cat([af[:, :d], af[:, :-d] * af[:, d:]], 1)
        d *= 2
    return bf.to(a.dtype), bf[:, -1]


def rglru_decode(a: torch.Tensor, b: torch.Tensor,
                 h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: a, b, h all (B, W).  Returns (h in a's dtype, h fp32)."""
    hf = a.float() * h.float() + b.float()
    return hf.to(a.dtype), hf
