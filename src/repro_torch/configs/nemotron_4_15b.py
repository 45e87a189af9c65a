"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    mlp_variant="relu2",
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    mlp_variant="relu2",
)
