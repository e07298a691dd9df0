"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block
(applied every 6 mamba layers, weights shared across applications)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_block_every=6,
)
