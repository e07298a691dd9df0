"""Mamba2-780m [arXiv:2405.21060]: SSD (state-space duality), attention-free."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)
