"""Decoder stacks for every assigned family (the port of the JAX package's
``models/transformer.py``), on one device or on a ``DeviceMesh``:

  * per-family blocks: dense (GQA/SWA + SwiGLU), MoE (with leading dense
    layers), Mamba2 (SSD), and the Zamba2-style hybrid (Mamba2 backbone +
    one *shared* attention+MLP block applied every k layers through a
    concat-projection, weights reused);
  * a Python loop over the stacked layer dimension where the reference
    scans (``lax.scan`` / ``lax.cond`` become ``for`` / ``if``), each layer
    (or nested group of layers) rematerialized under autograd as the
    reference's ``jax.checkpoint`` does;
  * the training loss (``Model.loss``: the chunked cross-entropy);
  * decode steps with KV/SSM caches updated in place (the torch analogue
    of the reference's donated cache; a ring buffer for SWA).

On a mesh the parameters are ``DTensor``s (``models.params.distribute``)
and the residual stream is constrained at the reference's points
(``_boundary``: batch over the data axes, sequence over "model", the
Megatron-SP layout).  The forward runs under ``implicit_replication``: the
tensors a step makes itself (positions, masks, the blockwise attention's
running maxima) are plain tensors, taken as replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (grad_in_layout, implicit_replication,
                                    mesh_axes, shard)
from . import layers as L
from .moe import moe_block, moe_defs
from .params import pdef, stack_defs, torch_dtype, tree_map
from .ssm import mamba2_block, mamba2_decode_step, ssm_defs, ssm_state_shape

__all__ = ["Model", "RunFlags"]


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Run flags.

    While autograd records, every layer is rematerialized (only its input
    is kept for the backward pass, the reference's ``remat="full"``, the
    only setting its launchers use).  ``layer_groups`` > 1 nests it: each
    group of ``n_scan / layer_groups`` layers is one more checkpoint, so
    only group boundaries stay alive between the passes.
    ``causal_block_skip`` skips the kv blocks above the diagonal in
    ``blockwise_attention``.  The reference's ``seq_shard_boundary`` (on
    by default, and no caller turns it off) is the port's only layout:
    on a mesh the residual stream between layers is sharded over "model"
    along the sequence (``Model._boundary``).  Its ``analysis_unroll``
    unrolls scans for XLA's cost analysis; the port's loops are Python
    loops, already unrolled."""

    layer_groups: int = 1
    causal_block_skip: bool = False


def _remat(fn):
    """``fn`` under activation checkpointing while autograd records
    (``jax.checkpoint`` with ``nothing_saveable``); ``fn`` itself
    otherwise."""
    if not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _block_defs(cfg: ModelConfig):
    fam = cfg.family
    if fam in ("dense", "audio", "vlm"):
        return {
            "ln1": L.norm_defs(cfg),
            "attn": L.attn_defs(cfg),
            "ln2": L.norm_defs(cfg),
            "mlp": L.mlp_defs(cfg),
        }
    if fam == "moe":
        return {
            "ln1": L.norm_defs(cfg),
            "attn": L.attn_defs(cfg),
            "ln2": L.norm_defs(cfg),
            "moe": moe_defs(cfg),
        }
    if fam in ("ssm", "hybrid"):
        return {"ln1": L.norm_defs(cfg), "ssm": ssm_defs(cfg)}
    raise ValueError(fam)


def _kv_repeat(cfg: ModelConfig, mesh) -> int:
    """KV-cache head replication factor for decode TP.

    When n_kv_heads doesn't divide the "model" axis, the logical-axis rules
    fall back to replicating the cache over it — 16x the footprint at
    mesh (16,16).  Storing each kv head ``rep`` times (smallest rep with
    kvh*rep divisible by the axis, rep dividing the GQA group) costs rep x
    memory but shards the head dim, a net (axis/rep)x win.  MHA configs
    (G == 1, e.g. musicgen/minicpm) can't replicate — they fall back to
    sequence-sharded caches (launch/dryrun.py decode rules).
    """
    if mesh is None:
        return 1
    axes = mesh_axes(mesh)
    if "model" not in axes:
        return 1
    kvh = cfg.n_kv_heads
    if not kvh or cfg.family == "ssm":
        return 1
    mp = axes["model"]
    if kvh % mp == 0:
        return 1
    G = cfg.n_heads // kvh
    for rep in range(2, G + 1):
        if G % rep == 0 and (kvh * rep) % mp == 0:
            return rep
    return 1


def _shared_block_defs(cfg: ModelConfig):
    return {
        "proj": pdef((2 * cfg.d_model, cfg.d_model), ("fsdp", None),
                     init="scaled"),
        "ln1": L.norm_defs(cfg),
        "attn": L.attn_defs(cfg),
        "ln2": L.norm_defs(cfg),
        "mlp": L.mlp_defs(cfg),
    }


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree (views, no copies).

    One ``unbind`` a leaf: under autograd its backward stacks the layers'
    gradients once, where indexing each layer would add a zero tensor the
    size of the whole stacked leaf per layer.  On a mesh each layer's
    gradient is brought to its layout before that stack
    (``grad_in_layout``), so the stack never holds every layer's
    unreduced, gathered-size gradient."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda p, i=i: grad_in_layout(p[i]), parts)
            for i in range(n)]


class Model:
    """Built once per (config, mesh, flags); exposes defs + step functions.

    Parameters are nested dicts of tensors keyed as the JAX package's
    tree (``init_params(model.defs(), ...)``, or a JAX tree carried across;
    on a mesh, ``DTensor``s).  The KV cache stores ``n_kv_heads * kv_rep``
    heads (``_kv_repeat``: 1 without a mesh).
    """

    def __init__(self, cfg: ModelConfig, mesh=None,
                 flags: RunFlags = RunFlags()):
        self.cfg = cfg
        self.mesh = mesh
        self.flags = flags
        self.n_scan = cfg.n_layers - cfg.first_dense_layers
        g = flags.layer_groups
        if g > 1 and self.n_scan % g != 0:
            g = 1
        self.groups = g
        self.kv_rep = _kv_repeat(cfg, mesh)

    def replicating(self):
        """The context a step on this model runs in: on a mesh, plain
        tensors meet ``DTensor``s as replicated ones (forward and backward:
        the rematerialized layers rerun the forward in the backward pass)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return implicit_replication()

    # ------------------------------------------------------------------ defs

    def defs(self):
        cfg = self.cfg
        out: dict[str, Any] = {"embed": L.embed_defs(cfg)}
        out["blocks"] = stack_defs(_block_defs(cfg), self.n_scan)
        if cfg.first_dense_layers:
            dense_cfg = dataclasses.replace(cfg, d_ff=cfg.dense_ff)
            out["first"] = stack_defs(
                {
                    "ln1": L.norm_defs(cfg),
                    "attn": L.attn_defs(cfg),
                    "ln2": L.norm_defs(cfg),
                    "mlp": L.mlp_defs(dense_cfg),
                },
                cfg.first_dense_layers,
            )
        if cfg.family == "hybrid":
            out["shared"] = _shared_block_defs(cfg)
        out["final_norm"] = L.norm_defs(cfg)
        return out

    # ------------------------------------------------------------ fwd blocks

    def _boundary(self, x):
        """The residual stream between layers: batch over the data axes,
        sequence over "model" (Megatron-SP)."""
        return shard(x, self.mesh, "batch", "act_seq", None)

    def _dense_block(self, p, x, positions):
        cfg = self.cfg
        x = x + L.attention(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg,
                            self.mesh, positions,
                            causal_block_skip=self.flags.causal_block_skip)
        x = x + L.mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg), self.mesh)
        return self._boundary(x)

    def _moe_layer(self, p, x, positions):
        cfg = self.cfg
        x = x + L.attention(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg,
                            self.mesh, positions,
                            causal_block_skip=self.flags.causal_block_skip)
        x = x + moe_block(p["moe"], L.apply_norm(p["ln2"], x, cfg), cfg,
                          self.mesh)
        return self._boundary(x)

    def _ssm_layer(self, p, x):
        h, _ = mamba2_block(p["ssm"], L.apply_norm(p["ln1"], x, self.cfg),
                            self.cfg, self.mesh)
        return self._boundary(x + h)

    def _shared_block(self, p, x, x0, positions):
        cat = L.seq_whole(torch.cat([x, x0], dim=-1), self.mesh)
        h = cat @ p["proj"].to(x.dtype)
        return self._boundary(x + self._dense_block(p, h, positions))

    # ------------------------------------------------------------- forward

    def hidden_states(self, params, batch):
        """Full-sequence forward -> final hidden states (B, S, d)."""
        with self.replicating():
            return self._hidden_states(params, batch)

    def _hidden_states(self, params, batch):
        cfg = self.cfg
        if cfg.input_mode == "embeddings":
            x = batch["embeddings"].to(torch_dtype(cfg.dtype))
            x = shard(x, self.mesh, "batch", "seq", None)
        else:
            x = L.embed(params["embed"], batch["tokens"], cfg, self.mesh)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x = self._boundary(x)
        x0 = x

        if cfg.first_dense_layers:
            for p in _layers(params["first"], cfg.first_dense_layers):
                x = self._dense_block(p, x, positions)

        fam = cfg.family
        every = cfg.shared_block_every

        def layer_fn(x, p, i: int):
            if fam in ("dense", "audio", "vlm"):
                return self._dense_block(p, x, positions)
            if fam == "moe":
                return self._moe_layer(p, x, positions)
            x = self._ssm_layer(p, x)  # ssm, hybrid
            if fam == "hybrid" and (i + 1) % every == 0:
                x = self._shared_block(params["shared"], x, x0, positions)
            return x

        layer_fn = _remat(layer_fn)
        layers = _layers(params["blocks"], self.n_scan)
        per = self.n_scan // self.groups

        def group_fn(x, g: int):
            for i in range(g * per, (g + 1) * per):
                x = layer_fn(x, layers[i], i)
            return x

        if self.groups > 1:
            group_fn = _remat(group_fn)
        for g in range(self.groups):
            x = group_fn(x, g)
        return L.apply_norm(params["final_norm"], x, cfg)

    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch["labels"]``."""
        with self.replicating():
            x = self._hidden_states(params, batch)
            return L.chunked_ce_loss(params["embed"], x, batch["labels"],
                                     self.cfg, self.mesh)

    def prefill(self, params, batch):
        """Forward + final-position logits."""
        with self.replicating():
            x = self._hidden_states(params, batch)
            W = L.unembed_matrix(params["embed"], self.cfg).to(x.dtype)
            return shard(x[:, -1, :] @ W, self.mesh, "batch", "vocab")

    # ------------------------------------------------------------- decode

    def cache_shapes(self, batch: int, cache_len: int):
        """Meta-device tensors of the decode cache's leaves."""
        cfg = self.cfg
        fam = cfg.family
        dt = torch_dtype(cfg.dtype)
        kdt = torch_dtype(cfg.kv_dtype_)
        kvh, dh = cfg.n_kv_heads * self.kv_rep, cfg.head_dim_

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        out = {}
        if fam in ("dense", "audio", "vlm", "moe"):
            eff = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                   else cache_len)
            out["k"] = meta((cfg.n_layers, batch, eff, kvh, dh), kdt)
            out["v"] = meta((cfg.n_layers, batch, eff, kvh, dh), kdt)
        if fam in ("ssm", "hybrid"):
            st = ssm_state_shape(cfg, batch)
            out["ssm"] = meta((self.n_scan, *st["ssm"]), torch.float32)
            out["conv"] = meta((self.n_scan, *st["conv"]), dt)
        if fam == "hybrid":
            n_inv = cfg.n_layers // cfg.shared_block_every
            out["k"] = meta((n_inv, batch, cache_len, kvh, dh), kdt)
            out["v"] = meta((n_inv, batch, cache_len, kvh, dh), kdt)
        return out

    def init_cache(self, batch: int, cache_len: int, device):
        """A zeroed decode cache on ``device``."""
        return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
                for name, s in self.cache_shapes(batch, cache_len).items()}

    def _cache_slot(self, position: int) -> int:
        if self.cfg.sliding_window:
            return position % self.cfg.sliding_window
        return position

    def decode_step(self, params, cache, tokens, position: int):
        """One-token decode: tokens (B,), position -> (logits, cache).

        ``cache`` is updated in place and returned.
        """
        with self.replicating():
            return self._decode_step(params, cache, tokens, position)

    def _decode_step(self, params, cache, tokens, position: int):
        cfg = self.cfg
        fam = cfg.family
        dt = torch_dtype(cfg.dtype)
        x = L.embed(params["embed"], tokens, cfg, self.mesh)
        x0 = x
        slot = self._cache_slot(position)

        if fam in ("dense", "audio", "vlm", "moe"):
            nf = cfg.first_dense_layers
            if nf:
                for i, p in enumerate(_layers(params["first"], nf)):
                    x = self._decode_attn_layer(p, x, cache, i, position,
                                                slot)
            for i, p in enumerate(_layers(params["blocks"], self.n_scan)):
                x = self._decode_attn_layer(p, x, cache, nf + i, position,
                                            slot)
        else:  # ssm, hybrid
            inv = 0
            for i, p in enumerate(_layers(params["blocks"], self.n_scan)):
                xn = L.apply_norm(p["ln1"], x, cfg)
                y, st = mamba2_decode_step(
                    p["ssm"], xn, cfg,
                    {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                    self.mesh)
                cache["ssm"][i] = st["ssm"]
                cache["conv"][i] = st["conv"]
                x = x + y
                if fam == "hybrid" and (i + 1) % cfg.shared_block_every == 0:
                    p_s = params["shared"]
                    h = torch.cat([x, x0], dim=-1) @ p_s["proj"].to(dt)
                    h = self._decode_attn_layer(p_s, h, cache, inv,
                                                position, slot)
                    x = x + h
                    inv += 1

        x = L.apply_norm(params["final_norm"], x, cfg)
        W = L.unembed_matrix(params["embed"], cfg).to(dt)
        return shard(x @ W, self.mesh, "batch", "vocab"), cache

    def _decode_attn_layer(self, p, x, cache, li: int, position: int,
                           slot: int):
        """Attention against cache layer ``li`` (written at ``slot``) and
        the layer's MLP or MoE; x (B, d)."""
        cfg = self.cfg
        y, _, _ = L.decode_attention(
            p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, self.mesh,
            cache["k"][li], cache["v"][li], position, slot)
        x = x + y
        xn = L.apply_norm(p["ln2"], x, cfg)[:, None, :]
        if "moe" in p:
            return x + moe_block(p["moe"], xn, cfg, self.mesh)[:, 0]
        return x + L.mlp(p["mlp"], xn, self.mesh)[:, 0]
