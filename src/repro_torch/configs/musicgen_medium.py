"""MusicGen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens.

Backbone only per assignment: the EnCodec frontend is a stub —
input_specs() feeds precomputed frame embeddings (input_mode="embeddings").
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    input_mode="embeddings",
)
