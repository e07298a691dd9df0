"""Mixture-of-Experts layer: top-k routing with sort-based dispatch, on
one device (the JAX package's mesh-free ``_moe_block_global``).

One global stable argsort over all (token, k) assignments, dispatch into
an (E, C, d) buffer through int32 slot ids (no (T*K, d) gather), expert
compute as batched products, and a float32 scatter-add combine.  Shared
experts (DeepSeek/Moonlight style) are plain MLPs added to the routed
output.

Integer routing follows the reference exactly: top-k breaks ties toward
the lower expert index (a stable descending sort, as ``lax.top_k``), the
argsort by expert is stable, and slots past the capacity go to the
dropped slot ``E*C``.  The combine adds with ``index_add_``: a token
receives ``top_k`` products, and for ``top_k <= 2`` the sum does not
depend on their order; with ``top_k > 2`` on CUDA the order of the
atomic adds (and so the last bits) may vary between runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import mlp, mlp_defs
from .params import pdef

__all__ = ["moe_defs", "moe_block", "capacity"]


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8 for tiling


def moe_defs(cfg: ModelConfig):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    out = {
        "router": pdef((d, e), ("fsdp", None), init="scaled"),
        "wg": pdef((e, d, ff), ("experts", "fsdp", None), init="scaled"),
        "wu": pdef((e, d, ff), ("experts", "fsdp", None), init="scaled"),
        "wd": pdef((e, ff, d), ("experts", None, "fsdp"), init="scaled"),
    }
    if cfg.n_shared_experts:
        out["shared"] = mlp_defs(cfg, ff=cfg.d_ff * cfg.n_shared_experts)
    return out


def _route(xt, router, cfg: ModelConfig):
    """Top-k routing: (exp_sorted, tok_sorted, gate_sorted, pos_in_e), the
    (T*K,) assignments sorted by expert, capacity-free."""
    T = xt.shape[0]
    K = cfg.top_k
    dev = xt.device
    logits = (xt @ router).float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate = torch.softmax(vals[:, :K], dim=-1)  # (T, K)
    sel = idx[:, :K]
    tok_ids = torch.arange(T, dtype=torch.int32,
                           device=dev).repeat_interleave(K)
    exp_ids = sel.reshape(-1).to(torch.int32)  # (T*K,)
    gates = gate.reshape(-1)
    order = torch.argsort(exp_ids, stable=True)
    exp_sorted = exp_ids[order]
    tok_sorted = tok_ids[order]
    gate_sorted = gates[order]
    counts = torch.bincount(exp_ids, minlength=cfg.n_experts)  # (E,)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    pos_in_e = (torch.arange(T * K, dtype=torch.int32, device=dev)
                - starts[exp_sorted.long()])
    return exp_sorted, tok_sorted, gate_sorted, pos_in_e


def _moe_block_global(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    dt = x.dtype
    dev = x.device
    T = B * S
    xt = x.reshape(T, d)
    E = cfg.n_experts
    C = capacity(T, cfg)

    exp_sorted, tok_sorted, gate_sorted, pos_in_e = _route(
        xt, params["router"].to(dt), cfg
    )
    keep = pos_in_e < C
    slot = torch.where(keep, exp_sorted * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C)).long()

    # --- dispatch via slot-id indirection (no (T*K, d) intermediate) -------
    xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=dt, device=dev)])
    tok_in_slot = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    tok_in_slot[slot] = tok_sorted.long()  # only the dropped slot repeats
    tok_in_slot = tok_in_slot[:-1]
    buf = xt_pad[tok_in_slot].reshape(E, C, d)

    # --- expert compute -----------------------------------------------------
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, params["wg"].to(dt))) * (
        torch.einsum("ecd,edf->ecf", buf, params["wu"].to(dt)))
    out_buf = torch.einsum("ecf,efd->ecd", h, params["wd"].to(dt))

    # --- combine: scatter-add from slot-major -------------------------------
    gate_in_slot = torch.zeros(E * C + 1, dtype=torch.float32, device=dev)
    gate_in_slot[slot] = torch.where(keep, gate_sorted,
                                     torch.zeros_like(gate_sorted))
    gate_in_slot = gate_in_slot[:-1]
    flat = out_buf.reshape(E * C, d).float()
    y = torch.zeros((T + 1, d), dtype=torch.float32, device=dev).index_add_(
        0, tok_in_slot, flat * gate_in_slot[:, None])[:-1]
    wsum = torch.zeros(T + 1, dtype=torch.float32, device=dev).index_add_(
        0, tok_in_slot, gate_in_slot)[:-1]
    y = y / torch.clamp_min(wsum, 1e-9)[:, None]
    return y.to(dt).reshape(B, S, d)


def moe_block(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d).  The JAX package's expert-parallel
    ``shard_map`` path (on a mesh) is not ported yet."""
    y = _moe_block_global(params, x, cfg)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y
