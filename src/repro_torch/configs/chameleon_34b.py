"""Chameleon-34B [arXiv:2405.09818]: early-fusion; VQ image tokens share the
65536 vocab.  Backbone only: the VQ tokenizer frontend is a stub —
input_specs() feeds precomputed patch embeddings (input_mode="embeddings").
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab=65_536,
    input_mode="embeddings",
)
