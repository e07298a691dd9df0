"""h2o-danube3-4b [arXiv:2401.16818]: llama+mistral mix, sliding-window attn."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab=32_000,
    head_dim=120,
    sliding_window=4096,
)
