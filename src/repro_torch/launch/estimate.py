"""MODEL_FLOPS estimates (the roofline numerator; the port of the JAX
package's ``launch/estimate.py``, the same arithmetic).

Convention (per the roofline spec): 6*N*D for training (2 fwd + 4 bwd per
param-token), 2*N*D for inference, with N = *active* non-embedding params
(MoE: router + top_k/n_experts of routed experts + shared experts) plus the
LM-head matmul term.  Attention's quadratic term is deliberately excluded —
a low useful-fraction on long-sequence cells then correctly exposes
attention/remat overhead rather than hiding it.
"""

from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models import build_model
from ..models.params import count_params

__all__ = ["active_params", "model_flops"]


def active_params(cfg: ModelConfig) -> tuple[int, int]:
    """(N_active, N_total), excluding embed/unembed."""
    defs = build_model(cfg, mesh=None).defs()
    total = 0
    active = 0
    for key, sub in defs.items():
        if key == "embed":
            continue
        n = count_params(sub)
        total += n
        if key == "blocks" and cfg.n_experts:
            moe = sub.get("moe", {})
            n_moe_experts = sum(
                count_params(moe[k]) for k in ("wg", "wu", "wd") if k in moe
            )
            frac = cfg.top_k / cfg.n_experts
            n_active = n - n_moe_experts + int(n_moe_experts * frac)
            active += n_active
        else:
            active += n
    return active, total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global useful FLOPs for one step of this (arch, shape) cell."""
    if cfg.family == "index":
        # wlsh: build = hash-encode matmul; query = two scoring passes of
        # per-query distance matmuls (pass 2 recomputes, engine docstring).
        # The freq-level compare work is integer ops, not FLOPs.
        n, d, beta = cfg.vocab, cfg.d_model, cfg.d_ff
        if shape.kind == "train":
            return 2.0 * n * d * beta
        q = 64  # IndexConfig.q_batch
        return 2.0 * 2.0 * q * n * d
    n_act, _ = active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        factor = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        factor = 2.0
    head = factor * tokens * cfg.d_model * cfg.vocab
    return factor * n_act * tokens + head
