"""OLMo-1B [arXiv:2402.00838]: non-parametric LayerNorm."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50_304,
    norm="nonparametric_ln",
    tie_embeddings=True,
)
