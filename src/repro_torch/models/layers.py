"""Shared building blocks: norms, rope, embeddings, GQA attention (full
sequence and decode), MLPs.  The counterparts of ``repro.models.layers``
for the dense family.

Each block's parameters are a mapping of name -> tensor with the JAX
package's shapes, so weights bridge across unchanged; the ``*_param_spec``
functions give those shapes and initializers.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from .common import (ModelConfig, Params, TensorSpec, ones_init, scaled_init,
                     zeros_init)

#: name -> (shape, initializer, initializer keywords)
ParamSpec = Dict[str, Tuple[Tuple[int, ...], object, dict]]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp`` promotes."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., H, D) with positions (..., S) or (...,)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_param_spec(cfg: ModelConfig) -> ParamSpec:
    spec = {"tok_embed": ((cfg.vocab_size, cfg.d_model), scaled_init,
                          {"fan_in": cfg.d_model})}
    if not cfg.tie_embeddings:
        spec["unembed"] = ((cfg.d_model, cfg.vocab_size), scaled_init,
                           {"fan_in": cfg.d_model})
    spec["final_norm"] = ((cfg.d_model,), ones_init, {})
    return spec


def embed(params: Params, cfg: ModelConfig,
          tokens: torch.Tensor) -> torch.Tensor:
    return params["tok_embed"][tokens].to(cfg.compute_dtype)


def unembed(params: Params, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = _mm(x, params["tok_embed"].t())
    else:
        logits = _mm(x, params["unembed"])
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits.float()


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def attention_param_spec(cfg: ModelConfig) -> ParamSpec:
    d, H, K, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    spec = {
        "ln": ((d,), ones_init, {}),
        "wq": ((d, H, Dh), scaled_init, {"fan_in": d}),
        "wk": ((d, K, Dh), scaled_init, {"fan_in": d}),
        "wv": ((d, K, Dh), scaled_init, {"fan_in": d}),
        "wo": ((H, Dh, d), scaled_init, {"fan_in": H * Dh}),
    }
    if cfg.qkv_bias:
        spec["bq"] = ((H, Dh), zeros_init, {})
        spec["bk"] = ((K, Dh), zeros_init, {})
        spec["bv"] = ((K, Dh), zeros_init, {})
    return spec


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    cd = cfg.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _attention_seq(p: Params, cfg: ModelConfig, x: torch.Tensor,
                   causal: bool, window: int):
    """The block over a whole sequence x (B, S, d): returns its output and
    the rotated keys and values (B, S, K, Dh).  The reference's
    ``shard_attn_q`` is a sharding constraint, the identity on one card,
    so it has no counterpart here."""
    B, S, _ = x.shape
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h)
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = ops.mha(q, k, v, causal=causal, window=window,
                q_chunk=cfg.attn_chunk, unroll=cfg.unroll_inner)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.compute_dtype))
    return x + out, k, v


def attention_train(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    window: int = 0,
                    causal: Optional[bool] = None) -> torch.Tensor:
    """x: (B, S, d).  Causal unless the config or ``causal`` says not."""
    causal = cfg.is_causal if causal is None else causal
    return _attention_seq(p, cfg, x, causal, window)[0]


def attention_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      window: int = 0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d), causal.  Returns the block's output and the cache
    ``{"k", "v"}`` of shape (B, S, K, Dh) in the compute dtype."""
    x, k, v = _attention_seq(p, cfg, x, True, window)
    return x, {"k": k, "v": v}


def attention_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], lengths: torch.Tensor,
                     window: int = 0,
                     commit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, d) one token per row; cache k/v: (B, Smax, K, Dh).

    Writes this token's K/V into the cache IN PLACE at ``lengths`` and
    returns the block's output.  Unlike the JAX version, which returns a
    new cache that the engine then merges over every slot, only the
    written positions change: rows outside the bool mask ``commit`` get
    their old entries back after attention (``None`` keeps every row's
    write).  A row at ``lengths >= Smax`` writes nothing, as a JAX scatter
    out of range is dropped; its attention reads all Smax entries.
    """
    B, _ = x.shape
    h = rmsnorm(p["ln"], x[:, None, :], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h)                       # (B,1,H,Dh)/(B,1,K,Dh)
    q = rope(q, lengths[:, None], cfg.rope_theta)[:, 0]      # (B,H,Dh)
    k = rope(k, lengths[:, None], cfg.rope_theta)[:, 0]      # (B,K,Dh)
    v = v[:, 0]
    kc, vc = cache["k"], cache["v"]
    Smax = kc.shape[1]
    bidx = torch.arange(B, device=x.device)
    pos = lengths.clamp(max=Smax - 1)
    in_range = (lengths < Smax)[:, None, None]
    old_k, old_v = kc[bidx, pos], vc[bidx, pos]   # gathers: copies
    new_k = torch.where(in_range, k.to(kc.dtype), old_k)
    new_v = torch.where(in_range, v.to(vc.dtype), old_v)
    kc[bidx, pos] = new_k
    vc[bidx, pos] = new_v
    o = ops.decode_attention(q, kc, vc, lengths + 1, window=window)
    if commit is not None:
        keep = commit[:, None, None]
        kc[bidx, pos] = torch.where(keep, new_k, old_k)
        vc[bidx, pos] = torch.where(keep, new_v, old_v)
    out = torch.einsum("bhk,hkd->bd", o, p["wo"].to(cfg.compute_dtype))
    return x + out


def attention_cache_spec(cfg: ModelConfig, batch: int, max_seq: int,
                         window: int = 0) -> Dict[str, TensorSpec]:
    K, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    seq = min(max_seq, window) if window else max_seq
    shp = (batch, seq, K, Dh)
    return {"k": TensorSpec(shp, cfg.compute_dtype),
            "v": TensorSpec(shp, cfg.compute_dtype)}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_param_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> ParamSpec:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    spec = {"ln": ((d,), ones_init, {})}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        spec["wi_gate"] = ((d, f), scaled_init, {"fan_in": d})
        spec["wi_up"] = ((d, f), scaled_init, {"fan_in": d})
    else:
        spec["wi"] = ((d, f), scaled_init, {"fan_in": d})
    spec["wo_mlp"] = ((f, d), scaled_init, {"fan_in": f})
    return spec


def mlp_core(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """MLP without the residual/norm.  GeLU is the tanh form, which is
    ``jax.nn.gelu``'s default."""
    cd = cfg.compute_dtype
    if cfg.mlp_variant == "swiglu":
        g = F.silu(h @ p["wi_gate"].to(cd)) * (h @ p["wi_up"].to(cd))
    elif cfg.mlp_variant == "geglu":
        g = (F.gelu(h @ p["wi_gate"].to(cd), approximate="tanh")
             * (h @ p["wi_up"].to(cd)))
    elif cfg.mlp_variant == "relu2":
        g = torch.square(F.relu(h @ p["wi"].to(cd)))
    else:  # gelu
        g = F.gelu(h @ p["wi"].to(cd), approximate="tanh")
    return g @ p["wo_mlp"].to(cd)


def mlp_block(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(p["ln"], x, cfg.norm_eps)
    return x + mlp_core(p, cfg, h)
