"""Llama-3 405B [arXiv:2407.21783]: GQA kv=8, 128k vocab."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53_248,
    vocab=128_256,
    rope_theta=500_000.0,
    # decode_32k at global_batch=128 carries a 2.2 TB KV cache (with the
    # 2x GQA-TP head replication); f8 storage is what fits it on a single
    # 256-chip pod next to the 810 GB bf16 params (EXPERIMENTS.md Sec Perf)
    kv_dtype="float8_e4m3fn",
)
