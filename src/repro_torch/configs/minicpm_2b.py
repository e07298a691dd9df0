"""MiniCPM-2B [arXiv:2404.06395]: llama-like arch, WSD schedule (optimizer)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122_753,
    tie_embeddings=True,
)
