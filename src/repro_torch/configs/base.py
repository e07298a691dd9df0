"""Model/shape configuration dataclasses + the architecture registry.

One config module per assigned architecture lives next to this file; each
exports ``CONFIG``.  ``get_config(arch)`` resolves by name and
``reduced(cfg)`` derives the CPU-smoke variant (same family, tiny sizes).
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    dense_ff: int = 0  # d_ff of the leading dense layers (moonshot)
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (Zamba2) ---
    shared_block_every: int = 0  # shared attn+MLP block applied every k layers
    # --- attention ---
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | nonparametric_ln
    tie_embeddings: bool = False
    # --- modality frontend ---
    input_mode: str = "tokens"  # tokens | embeddings (audio/vlm stub)
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_dtype: str = ""  # decode KV-cache storage dtype ("" = dtype);
    # "float8_e4m3fn" halves the cache (llama3-405b decode_32k only fits a
    # single pod with it — see EXPERIMENTS.md Sec Perf)

    @property
    def kv_dtype_(self) -> str:
        return self.kv_dtype or self.dtype

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def full_attention(self) -> bool:
        """True when long_500k decode would need a quadratic-size cache."""
        if self.family in ("ssm",):
            return False
        if self.family == "hybrid":
            return False  # constant SSM state + a few shared-attn caches
        return self.sliding_window == 0

    @property
    def attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return (self.n_layers + self.shared_block_every - 1) // max(
                self.shared_block_every, 1
            )
        return self.n_layers


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCHS = [
    "moonshot_v1_16b_a3b",
    "olmoe_1b_7b",
    "llama3_405b",
    "olmo_1b",
    "minicpm_2b",
    "h2o_danube_3_4b",
    "musicgen_medium",
    "chameleon_34b",
    "mamba2_780m",
    "zamba2_1p2b",
    "wlsh_index",  # the paper's technique as a dry-run "arch"
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS} | {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3-405b": "llama3_405b",
    "olmo-1b": "olmo_1b",
    "minicpm-2b": "minicpm_2b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "musicgen-medium": "musicgen_medium",
    "chameleon-34b": "chameleon_34b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-1.2b": "zamba2_1p2b",
}


def get_config(arch: str) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """CPU-smoke variant: same family/topology, tiny sizes."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab=256,
        head_dim=16,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        first_dense_layers=min(cfg.first_dense_layers, 1),
        dense_ff=128 if cfg.dense_ff else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        shared_block_every=min(cfg.shared_block_every, 2),
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
    )
