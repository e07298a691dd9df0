"""Mixture-of-Experts layer: top-k routing with sort-based dispatch (the
port of the JAX package's ``models/moe.py``).

Two implementations sharing the same routing math:

* ``_moe_block_global`` — the mesh-free path: one global stable argsort
  over all (token, k) assignments, dispatch into an (E, C, d) buffer
  through int32 slot ids (no (T*K, d) gather), expert compute as batched
  products, and a float32 scatter-add combine.  On a mesh (the fallback
  when the experts do not divide the "model" axis) it runs replicated on
  every device inside ``local_map``: the routing's sorts, scatters and
  gathers of integer slot ids are per-device work, not DTensor ops.

* ``_moe_block_ep`` — the expert-parallel path on a mesh, ``local_map``
  (the reference's ``shard_map``) over the mesh.  Tokens stay local to
  their ("pod","data") shard, experts are sliced over "model".  Dispatch is
  local integer work: assignments are argsorted by expert id per shard,
  each shard keeps only the slots of its E/mp local experts, and the only
  collective is one all-reduce of the (T_loc, d) combined output (and of
  the gate sums) over "model" a layer.  Dropping is per data shard
  (capacity C = ceil(T_loc * top_k / E * capacity_factor)), so a mesh
  run drops other tokens than a one-device run of the same batch.

Shared experts (DeepSeek/Moonlight style) are plain MLPs added to the
routed output.

Integer routing follows the reference exactly: top-k breaks ties toward
the lower expert index (a stable descending sort, as ``lax.top_k``), the
argsort by expert is stable, and slots past the capacity go to the
dropped slot ``E*C``.  The combine adds with ``index_add_``: a token
receives ``top_k`` products, and for ``top_k <= 2`` the sum does not
depend on their order; with ``top_k > 2`` on CUDA the order of the
atomic adds (and so the last bits) may vary between runs.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import (mesh_axes, partial_over, psum, shard,
                                    shard_map_nocheck)
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
    # bincount as a scatter-add of ones (the same integers; meta tensors,
    # which the dry-run traces, have no bincount)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                         device=dev).scatter_add_(
        0, exp_ids.long(), torch.ones_like(exp_ids, dtype=torch.int64))
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    pos_in_e = (torch.arange(T * K, dtype=torch.int32, device=dev)
                - starts[exp_sorted.long()])
    return exp_sorted, tok_sorted, gate_sorted, pos_in_e


def _moe_block_global(params, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, d) -> (B, S, d)."""
    if mesh is not None:
        rep = (None, None, None)
        names = ("router", "wg", "wu", "wd")
        fn = shard_map_nocheck(
            lambda x, *w: _moe_block_global(dict(zip(names, w)), x, cfg),
            mesh, in_specs=(rep, (None, None), rep, rep, rep),
            out_specs=rep)
        y = fn(x, *(params[k] for k in names))
        return shard(y, mesh, "batch", "seq", None)
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


# ---------------------------------------------------------------------------
# EP path (a mesh)
# ---------------------------------------------------------------------------


def _ep_body(x_loc, router, wg, wu, wd, *, cfg: ModelConfig, e_loc: int,
             mesh, mp: str):
    Bl, Sl, d = x_loc.shape
    dt = x_loc.dtype
    dev = x_loc.device
    T = Bl * Sl
    xt = x_loc.reshape(T, d)
    C = capacity(T, cfg)

    exp_sorted, tok_sorted, gate_sorted, pos_in_e = _route(
        xt, router.to(dt), cfg
    )
    e0 = mesh.get_local_rank(mp) * e_loc
    local = (exp_sorted >= e0) & (exp_sorted < e0 + e_loc) & (pos_in_e < C)
    slot = torch.where(local, (exp_sorted - e0) * C + pos_in_e,
                       torch.full_like(pos_in_e, e_loc * C)).long()

    # dispatch: slot-id indirection, only this shard's experts materialize
    xt_pad = torch.cat([xt, torch.zeros((1, d), dtype=dt, device=dev)])
    tok_in_slot = torch.full((e_loc * C + 1,), T, dtype=torch.int64,
                             device=dev)
    tok_in_slot[slot] = tok_sorted.long()
    tok_in_slot = tok_in_slot[:-1]
    buf = xt_pad[tok_in_slot].reshape(e_loc, C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(dt))) * (
        torch.einsum("ecd,edf->ecf", buf, wu.to(dt)))
    out_buf = torch.einsum("ecf,efd->ecd", h, wd.to(dt))

    gate_in_slot = torch.zeros(e_loc * C + 1, dtype=torch.float32,
                               device=dev)
    gate_in_slot[slot] = torch.where(local, gate_sorted,
                                     torch.zeros_like(gate_sorted))
    gate_in_slot = gate_in_slot[:-1]
    flat = out_buf.reshape(e_loc * C, d).float()
    y = torch.zeros((T + 1, d), dtype=torch.float32, device=dev).index_add_(
        0, tok_in_slot, flat * gate_in_slot[:, None])[:-1]
    wsum = torch.zeros(T + 1, dtype=torch.float32, device=dev).index_add_(
        0, tok_in_slot, gate_in_slot)[:-1]
    # one collective per layer: combine expert slices over the model axis
    y = psum(y, mesh, mp)
    wsum = psum(wsum, mesh, mp)
    y = y / torch.clamp_min(wsum, 1e-9)[:, None]
    return y.to(dt).reshape(Bl, Sl, d)


def _moe_block_ep(params, x, cfg: ModelConfig, mesh):
    B, S, d = x.shape
    E = cfg.n_experts
    axes = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    mp = "model"
    dp_size = math.prod(axes[a] for a in dp)
    mp_size = axes[mp]
    if E % mp_size != 0:
        return _moe_block_global(params, x, cfg, mesh)
    e_loc = E // mp_size
    # tokens shard over the data axes when divisible; tiny decode batches
    # fall back to replicated routing (the expert compute stays sliced)
    split = B % dp_size == 0
    tok_spec = (dp, None, None) if split else (None, None, None)
    w_spec = (mp, None, None)  # wg / wu / wd: experts sliced over "model"
    # gradients: each model shard holds the part of its local experts,
    # each data shard that of its tokens (see shard_map_nocheck)
    summed = (mp, *dp) if split else (mp,)
    body = functools.partial(_ep_body, cfg=cfg, e_loc=e_loc, mesh=mesh,
                             mp=mp)
    fn = shard_map_nocheck(
        body, mesh,
        in_specs=(tok_spec, (None, None), w_spec, w_spec, w_spec),
        out_specs=tok_spec,
        in_grad_specs=(partial_over(mesh, tok_spec, (mp,)),
                       partial_over(mesh, (None, None), summed),
                       *[partial_over(mesh, w_spec, summed[1:])] * 3),
    )
    y = fn(x, params["router"], params["wg"], params["wu"], params["wd"])
    return shard(y, mesh, "batch", "seq", None)


def moe_block(params, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, d) -> (B, S, d); the EP ``local_map`` on a mesh, the
    global path off it."""
    if mesh is None:
        y = _moe_block_global(params, x, cfg)
    else:
        y = _moe_block_ep(params, x, cfg, mesh)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x, mesh)
    return y
