"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [hf:moonshotai/Moonlight-16B-A3B].

DeepSeek-V3-style MoE: 64 routed experts top-6 + 2 shared experts,
expert d_ff 1408, first layer dense (d_ff 11264), GQA kv=16.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    dense_ff=11_264,
)
