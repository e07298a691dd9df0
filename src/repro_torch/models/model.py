"""Model factory + per-(arch, shape) input specs and seeded batches."""

from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.platform import resolve_device
from .params import torch_dtype
from .transformer import Model, RunFlags

__all__ = ["build_model", "default_flags", "input_specs", "make_batch"]


def build_model(cfg: ModelConfig, mesh=None,
                flags: RunFlags | None = None) -> Model:
    """The model of ``cfg``; ``mesh`` (a ``DeviceMesh`` with the reference's
    axis names) puts its steps on DTensor parameters."""
    if flags is None:
        flags = default_flags(cfg)
    return Model(cfg, mesh=mesh, flags=flags)


def _best_group(n: int) -> int:
    """Divisor of n closest to sqrt(n): balances boundary count (n/g)
    against live recompute window (g) under nested remat."""
    target = max(1, math.isqrt(n))
    divisors = [d for d in range(1, n + 1) if n % d == 0]
    return min(divisors, key=lambda d: abs(d - target))


def default_flags(cfg: ModelConfig) -> RunFlags:
    """The flags ``build_model`` uses when given none: layers rematerialized
    in nested groups for very wide stacks (llama3-405b, chameleon-34b), whose
    saved layer boundaries at full width would fill the device."""
    groups = 1
    n_scan = cfg.n_layers - cfg.first_dense_layers
    if cfg.d_model >= 8192 and n_scan > 8:
        groups = _best_group(n_scan)
    return RunFlags(layer_groups=groups)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins for every model input of this step kind.

    * train/prefill: token ids (or stub frontend embeddings for audio/vlm)
      + labels for train.
    * decode: one new token per sequence + scalar position; the KV/SSM
      cache is part of the step state, shaped for ``shape.seq_len``.
    """
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        out = {}
        if cfg.input_mode == "embeddings":
            out["embeddings"] = meta((B, S, cfg.d_model),
                                     torch_dtype(cfg.dtype))
        else:
            out["tokens"] = meta((B, S), torch.int32)
        if shape.kind == "train":
            out["labels"] = meta((B, S), torch.int32)
        return out
    return {"tokens": meta((B,), torch.int32),
            "position": meta((), torch.int32)}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               device="cuda") -> dict:
    """A random batch matching ``input_specs``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if not s.dtype.is_floating_point:
            if s.shape == ():
                out[name] = torch.tensor(shape.seq_len // 2, dtype=s.dtype,
                                         device=dev)
            else:
                out[name] = torch.randint(0, cfg.vocab, s.shape,
                                          generator=gen, dtype=s.dtype,
                                          device=dev)
        else:
            out[name] = torch.randn(s.shape, generator=gen, device=dev).to(
                s.dtype)
    return out
