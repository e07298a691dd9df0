"""Transformer building blocks: norms, rotary, GQA attention (blockwise
online-softmax for prefill, cache attention for decode), SwiGLU MLP,
embeddings and the chunked cross-entropy loss.

The port's counterpart of the JAX package's ``models/layers.py``: plain
torch functions on tensors.  On a mesh the forwards take
``torch.distributed.tensor`` parameters and annotate activations at the
reference's points with logical-axis sharding constraints (``shard``, a
DTensor redistribute; a no-op without a mesh), so the weights follow
Megatron column/row parallelism and the batch data parallelism; the
attention, the embedding and the cross-entropy run under ``local_map``.
Where the reference asks XLA for a float32 product of bfloat16 operands
(``preferred_element_type=float32``) the operands are widened to float32
first, which is what that product is; ``torch.einsum`` on bfloat16 would
round its result to bfloat16.  No library attention is used: the
blockwise online softmax is the reference's own, so both packages sum in
the same order.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import (mesh_axes, partial_over, pmax, psum,
                                    shard, shard_map_nocheck, spec)
from .params import pdef, torch_dtype

NEG_INF = -1.0e30

__all__ = [
    "NEG_INF",
    "norm_defs",
    "apply_norm",
    "rope",
    "attn_defs",
    "blockwise_attention",
    "attention",
    "decode_attention",
    "mlp_defs",
    "mlp",
    "embed_defs",
    "embed",
    "unembed_matrix",
    "chunked_ce_loss",
]


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------


def norm_defs(cfg: ModelConfig):
    if cfg.norm == "nonparametric_ln":
        return {}
    return {"scale": pdef((cfg.d_model,), (None,), init="ones")}


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    """Statistics in f32, the (B,S,d)-sized products in x.dtype."""
    xf = x.float()
    if cfg.norm == "nonparametric_ln":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)  # jnp.var: population
        inv = torch.rsqrt(var + eps)
        return (x - mu.to(x.dtype)) * inv.to(x.dtype)
    ms = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)


# ----------------------------------------------------------------------------
# rotary
# ----------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: (..., S).  Angles in f32, the
    rotation itself in x.dtype."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig):
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "wq": pdef((d, h * dh), ("fsdp", "heads"), init="scaled"),
        "wk": pdef((d, kvh * dh), ("fsdp", "kv_heads"), init="scaled"),
        "wv": pdef((d, kvh * dh), ("fsdp", "kv_heads"), init="scaled"),
        "wo": pdef((h * dh, d), ("heads", "fsdp"), init="scaled"),
    }


def seq_whole(x, mesh):
    """The (B, S, d) residual stream with its sequence whole on each device
    (the Megatron-SP all-gather in front of a column-parallel product): the
    product's (B*S, d) view then flattens a batch-sharded dim only, which
    every DTensor version shards; the stream arrives sequence-sharded over
    "model" between layers."""
    return shard(x, mesh, "batch", "seq", None)


def _heads(y, mesh, name: str, n: int, shape):
    """A projection (batch, ..., n * dh) reshaped to ``shape`` (its last
    dim split into n heads).  On a mesh whose "model" axis shards the
    projection but not n heads (24 heads on 16 devices), the last dim is
    gathered first: a view cannot split a dim unevenly."""
    if mesh is not None and spec(mesh, (name,), (n,))[0] is None:
        y = shard(y, mesh, "batch", *(None,) * (y.ndim - 1))
    return y.reshape(shape)


def _qkv(params, x, cfg: ModelConfig, mesh, positions):
    x = seq_whole(x, mesh)
    B, S, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = x.dtype
    q = _heads(x @ params["wq"].to(dt), mesh, "heads", h, (B, S, h, dh))
    k = _heads(x @ params["wk"].to(dt), mesh, "kv_heads", kvh,
               (B, S, kvh, dh))
    v = _heads(x @ params["wv"].to(dt), mesh, "kv_heads", kvh,
               (B, S, kvh, dh))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = shard(q, mesh, "batch", "seq", "heads", None)
    k = shard(k, mesh, "batch", "seq", "kv_heads", None)
    v = shard(v, mesh, "batch", "seq", "kv_heads", None)
    return q, k, v


def _kv_block(carry, q_rows, qpos, kj, vj, kp, scale, window: int):
    """One online-softmax step of q rows against one kv block.

    carry (m, l, acc): (B,n,bq,KVH,G), same, (B,n,bq,KVH,G,dh) f32;
    q_rows (B,n,bq,KVH,G,dh); kj / vj (B,bk,KVH,dh); qpos (n,bq), kp (bk,).
    """
    m, l, acc = carry
    s = torch.einsum("bnqkgd,bpkd->bnqkgp", q_rows.float(),
                     kj.float()) * scale
    qp = qpos[None, :, :, None, None, None]
    kq = kp[None, None, None, None, None, :]
    mask = qp >= kq
    if window:
        mask &= (qp - kq) < window
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    # the reference rounds p to the value dtype before the PV product
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bnqkgp,bpkd->bnqkgd", p.to(vj.dtype).float(), vj.float())
    return m_new, l_new, acc_new


def blockwise_attention(
    q, k, v, cfg: ModelConfig, q_offset: int = 0,
    block_q: int = 512, block_kv: int = 512,
    causal_block_skip: bool = False,
):
    """Online-softmax causal (optionally sliding-window) attention.

    q (B,S,H,dh), k/v (B,Sk,KVH,dh) -> (B,S,H,dh).  Memory O(S*block): the
    (S, Sk) score matrix is never materialized.  ``causal_block_skip``
    skips the kv blocks that lie wholly above a q block's diagonal instead
    of masking them, as the reference does (it assumes square blocks).
    """
    B, S, H, dh = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    bq = min(block_q, S)
    bk = min(block_kv, Sk)
    nq, nk = S // bq, Sk // bk
    scale = 1.0 / math.sqrt(dh)
    window = cfg.sliding_window
    dev = q.device

    qb = q.reshape(B, nq, bq, KVH, G, dh)
    kb = k.reshape(B, nk, bk, KVH, dh)
    vb = v.reshape(B, nk, bk, KVH, dh)
    qpos = q_offset + torch.arange(S, device=dev).reshape(nq, bq)
    kpos = torch.arange(Sk, device=dev).reshape(nk, bk)

    def init(n):
        return (torch.full((B, n, bq, KVH, G), NEG_INF, device=dev),
                torch.zeros((B, n, bq, KVH, G), device=dev),
                torch.zeros((B, n, bq, KVH, G, dh), device=dev))

    if causal_block_skip and q_offset == 0 and S == Sk:
        outs = []
        for i in range(nq):
            lo = 0 if not window else max(0, i - (window + bq) // bk)
            carry = init(1)
            for j in range(lo, i + 1):
                carry = _kv_block(carry, qb[:, i:i + 1], qpos[i:i + 1],
                                  kb[:, j], vb[:, j], kpos[j], scale, window)
            _, li, ai = carry
            outs.append(ai / torch.clamp_min(li[..., None], 1e-30))
        out = torch.cat(outs, dim=1)
    else:
        carry = init(nq)
        for j in range(nk):
            carry = _kv_block(carry, qb, qpos, kb[:, j], vb[:, j], kpos[j],
                              scale, window)
        _, l, acc = carry
        out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, S, H, dh).to(q.dtype)


def _kv_slice(q, k, v, *, attend, mesh, group: int):
    """One device's attention when its q heads are a slice of the heads
    and k, v hold every kv head: the kv heads its q heads read (q head i
    reads kv head i // group), then the plain attention."""
    h = q.shape[2]
    m = mesh.get_local_rank("model")
    lo, hi = m * h // group, ((m + 1) * h - 1) // group + 1
    return attend(q, k[:, :, lo:hi], v[:, :, lo:hi])


def _attend_on(mesh, q, k, v, cfg: ModelConfig, attend):
    """``attend`` under ``local_map``: each device's (batch, heads) block
    attends where it lies (no collective; DTensor's einsum views would
    have to flatten a head-sharded dim).  Where the kv heads do not divide
    "model" but the q heads do (GQA: 8 kv heads on 16 devices), k and v
    are whole on each device and each takes the kv heads of its q heads
    (their gradients then add up over "model"); where the q heads' slices
    do not align with the kv groups, q is gathered too."""
    from torch.distributed.tensor import Partial, Shard

    qp, kp = list(q.placements), list(k.placements)
    if qp == kp:
        fn, grads = attend, None
    else:
        group = cfg.n_heads // cfg.n_kv_heads
        n = q.shape[2] // next((q.device_mesh.size(i) for i, p in
                                enumerate(qp) if p == Shard(2)), 1)
        if n % group and group % n:
            q = shard(q, mesh, "batch", "seq", None, None)
            qp, fn, grads = list(q.placements), attend, None
        else:
            fn = functools.partial(_kv_slice, attend=attend, mesh=mesh,
                                   group=group)
            kv_grad = [Partial() if p == Shard(2) else r
                       for p, r in zip(qp, kp)]
            grads = (qp, kv_grad, kv_grad)
    return local_map(fn, out_placements=qp,
                     in_placements=(qp, kp, list(v.placements)),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def attention(params, x, cfg: ModelConfig, mesh, positions,
              causal_block_skip: bool = False):
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, mesh, positions)
    attend = functools.partial(blockwise_attention, cfg=cfg,
                               causal_block_skip=causal_block_skip)
    if mesh is not None:
        attend = _attend_on(mesh, q, k, v, cfg, attend)
    out = attend(q, k, v)
    # the heads merged (row-parallel wo); a constraint of its own, so the
    # backward pass brings the gradient back to the layout the merge left
    out = shard(out.reshape(B, S, cfg.n_heads * cfg.head_dim_), mesh,
                "batch", "seq", "heads")
    y = out @ params["wo"].to(x.dtype)
    return shard(y, mesh, "batch", "seq", None)


def _decode_core(q, k, v, cache_k, cache_v, cfg: ModelConfig, position: int,
                 seq_off: int = 0, psum_seq=None, pmax_seq=None):
    """The cache attention of one token: q (B, 1, H, dh), its k / v (B, 1,
    KVH, dh) and the cache's (B, S_cache, KVH, dh) slots ``seq_off`` on;
    with the cache's sequence split over devices, ``psum_seq`` /
    ``pmax_seq`` combine the slices' sums and maxima.  -> (B, KVH, G, dh)."""
    B, _, h, dh = q.shape
    kvh = cache_k.shape[2]
    dt = q.dtype
    G = h // kvh
    qg = q.reshape(B, kvh, G, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     cache_k.to(dt).float()) / math.sqrt(dh)
    Sc = cache_k.shape[1]
    kpos = seq_off + torch.arange(Sc, device=q.device)
    if cfg.sliding_window and Sc <= cfg.sliding_window:
        # ring buffer: all slots hold live positions once the window filled
        valid = (kpos < position) | (position >= cfg.sliding_window)
    else:
        valid = kpos < position
    s = torch.where(valid, s, NEG_INF)
    s_self = torch.einsum("bkgd,bkd->bkg", qg,
                          k[:, 0].float())[..., None] / math.sqrt(dh)
    m = s.amax(-1, keepdim=True)
    if pmax_seq is not None:
        m = pmax_seq(m)
    m = torch.maximum(m, s_self)
    p = torch.exp(s - m)
    p_self = torch.exp(s_self - m)
    total = p.sum(-1, keepdim=True)
    ctx = torch.einsum("bkgs,bskd->bkgd", p.to(dt).float(),
                       cache_v.to(dt).float())
    if psum_seq is not None:
        total, ctx = psum_seq(total), psum_seq(ctx)
    denom = total + p_self
    ctx = ctx + p_self * v[:, 0][:, :, None, :]
    return (ctx / denom).to(dt)


def _write(cache, new, slot: int) -> None:
    cache[:, slot] = new.to(cache.dtype)


def _decode_local(q, k, v, cache_k, cache_v, *, cfg, position: int, slot,
                  mesh, rep: int, seq_axes, seq_off: int, head_split: bool):
    """One device's ``decode_attention``: k / v arrive with every kv head
    (repeated ``rep`` times to the cache's), the cache with this device's
    heads and sequence slots; the token's slot is written where it lies."""
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    if head_split:
        n = cache_k.shape[2]
        lo = mesh.get_local_rank("model") * n
        k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]

    def over_seq(fn):
        def reduce(x):
            for a in seq_axes:
                x = fn(x, mesh, a)
            return x
        return reduce if seq_axes else None

    ctx = _decode_core(q, k, v, cache_k, cache_v, cfg, position, seq_off,
                       over_seq(psum), over_seq(pmax))
    if slot is not None and seq_off <= slot < seq_off + cache_k.shape[1]:
        _write(cache_k, k[:, 0], slot - seq_off)
        _write(cache_v, v[:, 0], slot - seq_off)
    return ctx.reshape(q.shape[0], q.shape[2], q.shape[3])


def decode_attention(params, x, cfg: ModelConfig, mesh, cache_k, cache_v,
                     position: int, slot: int | None = None):
    """Single-token decode against a (B, S_cache, KVH_store, dh) cache.

    Returns (y, k_new, v_new).  The current token joins through the
    online-softmax merge; with ``slot`` given, its k / v are written into
    the cache there (a ring buffer for SWA), else the caller writes them.

    KVH_store may be ``rep x n_kv_heads`` (rep = cache_k.shape[2] // kvh):
    on a mesh whose "model" axis the kv heads do not divide, the cache
    stores each kv head rep times so the head dim shards
    (``transformer._kv_repeat``).  Query head i attends stored head
    i // (G/rep), the layout the (B, KVH_store, G/rep, dh) reshape gives.
    On a mesh the attention runs under ``local_map``: each device's batch
    rows and heads against its slice of the cache, the slices' softmax
    sums and maxima combined over the axes that split the cache's
    sequence (the dry-run's ``kv_seq`` rules), as in flash decoding.
    """
    B = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    rep = cache_k.shape[2] // kvh
    dt = x.dtype
    q = _heads(x @ params["wq"].to(dt), mesh, "heads", h, (B, 1, h, dh))
    k = _heads(x @ params["wk"].to(dt), mesh, "kv_heads", kvh,
               (B, 1, kvh, dh))
    v = _heads(x @ params["wv"].to(dt), mesh, "kv_heads", kvh,
               (B, 1, kvh, dh))
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    if mesh is None:
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        ctx = _decode_core(q, k, v, cache_k, cache_v, cfg, position)
        if slot is not None:
            _write(cache_k, k[:, 0], slot)
            _write(cache_v, v[:, 0], slot)
        y = ctx.reshape(B, h * dh) @ params["wo"].to(dt)
        return y, k[:, 0], v[:, 0]
    ctx = _decode_on(mesh, q, k, v, cache_k, cache_v, cfg, position, slot,
                     rep)
    y = ctx.reshape(B, h * dh) @ params["wo"].to(dt)
    return shard(y, mesh, "batch", None), k[:, 0], v[:, 0]


def _decode_on(mesh, q, k, v, cache_k, cache_v, cfg, position, slot, rep):
    """``_decode_local`` under ``local_map`` (see ``decode_attention``)."""
    from torch.distributed.tensor import Shard

    from ..distributed.sharding import local_box

    cp = list(cache_k.placements)
    names = mesh.mesh_dim_names
    seq_axes = tuple(names[i] for i, p in enumerate(cp) if p == Shard(1))
    head_split = Shard(2) in cp
    q = shard(q, mesh, "batch", None, "heads" if head_split else None, None)
    k = shard(k, mesh, "batch", None, None, None)
    v = shard(v, mesh, "batch", None, None, None)
    qp = list(q.placements)
    out_p = [Shard(p.dim - 1) if p == Shard(2) else p for p in qp]
    fn = local_map(
        functools.partial(
            _decode_local, cfg=cfg, position=position, slot=slot, mesh=mesh,
            rep=rep, seq_axes=seq_axes, head_split=head_split,
            seq_off=local_box(tuple(cache_k.shape), mesh, cp)[0][1]),
        out_placements=out_p,
        in_placements=(qp, list(k.placements), list(v.placements), cp,
                       list(cache_v.placements)),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, cache_k, cache_v)


# ----------------------------------------------------------------------------
# MLP (SwiGLU)
# ----------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, ff: int | None = None):
    d = cfg.d_model
    ff = ff or cfg.d_ff
    return {
        "wg": pdef((d, ff), ("fsdp", "ff"), init="scaled"),
        "wu": pdef((d, ff), ("fsdp", "ff"), init="scaled"),
        "wd": pdef((ff, d), ("ff", "fsdp"), init="scaled"),
    }


def mlp(params, x, mesh=None):
    x = seq_whole(x, mesh)
    dt = x.dtype
    h = F.silu(x @ params["wg"].to(dt)) * (x @ params["wu"].to(dt))
    h = shard(h, mesh, "batch", "seq", "ff")
    y = h @ params["wd"].to(dt)
    return shard(y, mesh, "batch", "seq", None)


# ----------------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig):
    out = {"tok": pdef((cfg.vocab, cfg.d_model), ("vocab", "fsdp"))}
    if not cfg.tie_embeddings:
        out["unembed"] = pdef(
            (cfg.d_model, cfg.vocab), ("fsdp", "vocab"), init="scaled"
        )
    return out


def _vocab_split(mesh, vocab: int) -> bool:
    """Whether the vocab dim is split over a "model" axis of more than one
    device (the vocab-parallel embedding and cross-entropy)."""
    return mesh_axes(mesh).get("model", 1) > 1 and spec(
        mesh, ("vocab",), (vocab,))[0] is not None


def _data_axes(mesh, pspec) -> tuple:
    """The data axes a batch-leading PartitionSpec splits its dim 0 over."""
    e = pspec[0]
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def _embed_local(tok, ids, *, mesh, split: bool):
    """The rows of ``ids`` in this device's slice of the table; with the
    vocab split over "model", rows outside the slice give zeros and the
    slices' rows add up over the axis."""
    if not split:
        return tok[ids]
    v_loc = tok.shape[0]
    v0 = mesh.get_local_rank("model") * v_loc
    hit = (ids >= v0) & (ids < v0 + v_loc)
    rows = torch.where(hit, ids - v0, torch.zeros_like(ids))
    return psum(tok[rows] * hit[..., None].to(tok.dtype), mesh, "model")


def embed(params, tokens, cfg: ModelConfig, mesh=None):
    """Token ids (batch-leading, any rank) -> their rows in ``cfg.dtype``.
    On a mesh the lookup runs in ``local_map``: vocab-parallel where the
    vocab splits over "model" (Megatron's masked lookup and one all-reduce
    of the rows), each device's ids against its own table slice."""
    tok = params["tok"]
    if mesh is None:
        return tok[tokens.long()].to(torch_dtype(cfg.dtype))
    names = ("batch",) + (None,) * (tokens.ndim - 1)
    ids_spec = spec(mesh, names, tuple(tokens.shape))
    ids = shard(tokens.long(), mesh, *names)
    split = _vocab_split(mesh, cfg.vocab)
    tok_spec = ("model" if split else None, None)
    fn = shard_map_nocheck(
        functools.partial(_embed_local, mesh=mesh, split=split), mesh,
        in_specs=(tok_spec, ids_spec), out_specs=(*ids_spec, None),
        in_grad_specs=(partial_over(mesh, tok_spec,
                                    _data_axes(mesh, ids_spec)), None))
    x = fn(tok, ids).to(torch_dtype(cfg.dtype))
    return shard(x, mesh, *names, None)


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["tok"].T
    return params["unembed"]


def _ce_chunk(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _ce_local(xb, lb, W, *, mesh, split: bool):
    """One chunk's summed cross-entropy on this device's tokens; with the
    vocab split over "model", from its slice of the logits (Megatron's
    vocab-parallel cross-entropy: the max, the sum of exponentials and the
    label's logit combined over the axis)."""
    logits = xb @ W  # (B, chunk, V / model)
    if not split:
        return _ce_chunk(logits, lb).sum()
    lf = logits.float()
    v_loc = lf.shape[-1]
    v0 = mesh.get_local_rank("model") * v_loc
    m = pmax(lf.amax(-1).detach(), mesh, "model")
    z = psum(torch.exp(lf - m[..., None]).sum(-1), mesh, "model")
    hit = (lb >= v0) & (lb < v0 + v_loc)
    rows = torch.where(hit, lb - v0, torch.zeros_like(lb)).long()
    tgt = psum(torch.gather(lf, -1, rows[..., None])[..., 0] * hit, mesh,
               "model")
    return (m + torch.log(z) - tgt).sum()


def _ce_body(xb, lb, W, mesh, vocab: int):
    if mesh is None:
        return _ce_local(xb, lb, W, mesh=None, split=False)
    x_spec = spec(mesh, ("batch", None, None), tuple(xb.shape))
    data = _data_axes(mesh, x_spec)
    split = _vocab_split(mesh, vocab)
    w_spec = (None, "model" if split else None)
    fn = shard_map_nocheck(
        functools.partial(_ce_local, mesh=mesh, split=split), mesh,
        in_specs=(x_spec, x_spec[:2], w_spec),
        out_specs=partial_over(mesh, (), data),
        in_grad_specs=(partial_over(mesh, x_spec, ("model",) if split
                                    else ()), None,
                       partial_over(mesh, w_spec, data)))
    return fn(xb, lb, W)


def chunked_ce_loss(params, x, labels, cfg: ModelConfig, mesh=None,
                    chunk: int = 512):
    """Cross-entropy with the (B,S,V) logits computed seq-chunk at a time.

    Each chunk's body is rematerialized (``checkpoint``, the counterpart
    of the reference's ``nothing_saveable`` policy): autograd keeps no
    chunk's float32 logits for the backward pass, which recomputes them
    with one extra (B,chunk,D)x(D,V) product.
    """
    x = seq_whole(x, mesh)  # and the chunk split of the sequence
    B, S, D = x.shape
    W = unembed_matrix(params, cfg).to(x.dtype)
    chunk = min(chunk, S)
    nc = S // chunk
    xc = x.reshape(B, nc, chunk, D)
    lc = labels.reshape(B, nc, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        total = total + checkpoint(_ce_body, xc[:, i], lc[:, i], W, mesh,
                                   cfg.vocab, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (B * S)
