"""Serving loop: batched autoregressive generation over the decode step.

``make_serve_step`` is one token against a full cache; ``generate``
drives it host-side with greedy, temperature or top-k sampling.  Prompt
ingestion reuses the decode step token by token (exact, cache-filling);
``Model.prefill`` is the full-sequence forward.

Ties follow the JAX package: greedy takes the first maximal index (as
``jnp.argmax``), top-k keeps the lower index among equal logits (as
``lax.top_k``).  Draws come from a ``torch.Generator`` seeded with
``SamplerConfig.seed`` on the decode device (Gumbel-max, the way
``jax.random.categorical`` draws), so a seed fixes a run on one device
but the tokens are not JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.platform import resolve_device

__all__ = ["SamplerConfig", "make_serve_step", "generate"]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Host-side sampling knobs for the generation loop."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = full softmax
    seed: int = 0


def make_serve_step(model):
    """(params, cache, tokens (B,), position) -> (logits, cache); the cache
    is updated in place."""
    @torch.no_grad()
    def step(params, cache, tokens, position: int):
        return model.decode_step(params, cache, tokens, position)

    return step


def _categorical(logits, generator):
    """One draw per row: argmax(logits + Gumbel noise)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _sample(logits, generator, cfg: SamplerConfig):
    logits = logits.float()
    if cfg.temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k:
        # a stable descending sort keeps the lower index among equal logits
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        draw = _categorical(vals[:, :cfg.top_k], generator)
        return idx[:, :cfg.top_k].gather(1, draw[:, None])[:, 0].to(
            torch.int32)
    return _categorical(logits, generator).to(torch.int32)


def generate(
    model,
    params,
    prompts: np.ndarray,  # (B, P) int32 prompt tokens
    max_new_tokens: int,
    cache_len: int,
    sampler: SamplerConfig = SamplerConfig(),
    device="cuda",
):
    """Returns (B, max_new_tokens) sampled tokens.  ``params`` live on
    ``device``; the cache and the tokens are made there."""
    dev = resolve_device(device)
    B, P = prompts.shape
    serve_step = make_serve_step(model)
    cache = model.init_cache(B, cache_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(sampler.seed)
    prompts_t = torch.from_numpy(np.ascontiguousarray(prompts,
                                                      np.int32)).to(dev)

    logits = None
    for pos in range(P):
        logits, cache = serve_step(params, cache, prompts_t[:, pos], pos)
    out = torch.empty((B, max_new_tokens), dtype=torch.int32, device=dev)
    tok = _sample(logits, gen, sampler)
    for i in range(max_new_tokens):
        out[:, i] = tok
        logits, cache = serve_step(params, cache, tok, P + i)
        tok = _sample(logits, gen, sampler)
    return out.cpu().numpy()
