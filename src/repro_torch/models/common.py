"""Common model-building utilities: the config, initializers, the device.

``ModelConfig`` is a copy of ``repro.models.common.ModelConfig`` with torch
dtypes in place of the JAX ones.  The initializers draw from an explicit
``torch.Generator``; they give other numbers than ``jax.random`` from the
same seed, so tests that compare with the JAX package bridge its weights
(``repro_torch.bridge``) instead of re-drawing them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a card and without an explicit ``device`` this
    raises instead of carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

Family = str  # "dense" | "moe" | "hybrid" | "ssm" | "encoder" | "vlm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    # --- MLP ---
    mlp_variant: str = "swiglu"        # swiglu | relu2 | gelu | geglu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- rope / norm ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                  # per-expert hidden dim
    moe_capacity_factor: float = 1.25
    moe_chunk: int = 4096              # token-chunk for dispatch memory bound
    # --- MLA (deepseek-v2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- hybrid (recurrentgemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","attn")
    lru_width: int = 0
    conv_width: int = 4
    attn_window: int = 0               # 0 -> global attention
    # --- ssm (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    # --- modality frontend stubs ---
    frontend: str = "none"             # none | audio | vision
    frontend_dim: int = 0              # feature dim supplied by the stub
    n_patches: int = 0                 # vlm: patches per request
    # --- dtypes ---
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # --- training ---
    remat: str = "layer"               # none | layer | dots
    opt_state_dtype: Any = torch.float32  # bf16 for >=100B archs
    opt_factored: bool = False         # Adafactor-style 2nd moment (llama4)
    # --- lowering controls of the reference's dry-run cost extraction ---
    scan_layers: bool = True           # False: python-unrolled layer stack
    unroll_inner: bool = False         # True: unroll inner chunk loops
    attn_chunk: int = 0                # >0: q-block-chunked attention
    # --- perf knobs of the reference's sharded layouts ---
    attn_seq_shard: bool = False       # shard q-seq over 'model'
    onehot_loss: bool = False          # einsum-onehot cross entropy
    moe_hoist_gather: bool = True      # force expert FSDP gather pre-loop
    seq_parallel_residual: bool = False  # Megatron-SP residual stream
    # --- misc ---
    logit_softcap: float = 0.0
    is_causal: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model flops)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                if self.mla:
                    qdim = nh * (self.qk_nope_dim + self.qk_rope_dim)
                    attn = d * (self.q_lora_rank or qdim)
                    if self.q_lora_rank:
                        attn += self.q_lora_rank * qdim
                    attn += d * (self.kv_lora_rank + self.qk_rope_dim)
                    attn += self.kv_lora_rank * nh * (self.qk_nope_dim
                                                      + self.v_head_dim)
                    attn += nh * self.v_head_dim * d
                else:
                    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                total += attn
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * self.conv_width + 3 * w + w * d
            elif kind == "ssd":
                di = self.ssm_expand * d
                nheads = di // self.ssm_head_dim
                total += d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state
                              + nheads)
                total += self.conv_width * (di + 2 * self.ssm_ngroups
                                            * self.ssm_state)
                total += 2 * nheads + di * d
            if kind in ("attn", "rglru"):   # blocks followed by an MLP
                if not (self.n_experts and kind == "attn"
                        and self.family == "moe"):
                    total += self.mlp_params(f)
            if self.family == "moe" and kind == "attn":
                total += self.n_experts * self.mlp_params(self.moe_d_ff)
                total += self.n_shared_experts * self.mlp_params(
                    self.moe_d_ff if self.name.startswith("deepseek")
                    else self.d_ff)
                total += d * self.n_experts  # router
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed-to experts)."""
        if self.family != "moe":
            return self.param_count()
        dense = self.param_count()
        all_expert = self.n_layers * self.n_experts * self.mlp_params(
            self.moe_d_ff)
        active_expert = self.n_layers * self.moe_top_k * self.mlp_params(
            self.moe_d_ff)
        return dense - all_expert + active_expert

    def mlp_params(self, f: int) -> int:
        d = self.d_model
        if self.mlp_variant in ("swiglu", "geglu"):
            return 3 * d * f
        return 2 * d * f

    def block_kind(self, layer_idx: int) -> str:
        if self.block_pattern:
            return self.block_pattern[layer_idx % len(self.block_pattern)]
        if self.family == "ssm":
            return "ssd"
        return "attn"


# ---------------------------------------------------------------------------
# Initializers (all take (generator, shape, dtype, device))
# ---------------------------------------------------------------------------

def scaled_init(gen: torch.Generator, shape, dtype, device=None,
                fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal with std 1/sqrt(fan_in), drawn on the generator's device."""
    fan_in = fan_in or shape[0]
    std = 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * std).to(device=device, dtype=dtype)


def zeros_init(gen: torch.Generator, shape, dtype, device=None
               ) -> torch.Tensor:
    del gen
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(gen: torch.Generator, shape, dtype, device=None
              ) -> torch.Tensor:
    del gen
    return torch.ones(shape, dtype=dtype, device=device)


Params = Dict[str, torch.Tensor]


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that is not allocated yet."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize
