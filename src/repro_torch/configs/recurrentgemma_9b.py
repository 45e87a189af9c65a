"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427]

Pattern (rglru, rglru, attn) cycled over 38 layers => 26 recurrent + 12
local-attention (window 2048, MQA kv=1) layers.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    mlp_variant="geglu",
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    conv_width=4,
    attn_window=2048,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=5,                       # 1 full group + 2 tail layers
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    mlp_variant="geglu",
    tie_embeddings=True,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=64,
    conv_width=4,
    attn_window=8,
)
