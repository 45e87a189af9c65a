"""mamba2-780m [ssm] — SSD (state-space duality), attn-free. [arXiv:2405.21060]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,              # unused (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_ngroups=1,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    head_dim=1,
    ssm_state=16,
    ssm_head_dim=8,
    ssm_expand=2,
    ssm_chunk=8,
    ssm_ngroups=1,
)
