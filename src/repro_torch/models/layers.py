"""Transformer building blocks: norms, rotary, GQA attention (blockwise
online-softmax for prefill, cache attention for decode), SwiGLU MLP,
embeddings and the chunked cross-entropy loss.

The port's counterpart of the JAX package's ``models/layers.py`` on one
device: plain torch functions on tensors.  Where the reference asks XLA
for a float32 product of bfloat16 operands
(``preferred_element_type=float32``) the operands are widened to float32
first, which is what that product is; ``torch.einsum`` on bfloat16 would
round its result to bfloat16.  No library attention is used: the
blockwise online softmax is the reference's own, so both packages sum in
the same order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
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


def _qkv(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, S, h, dh)
    k = (x @ params["wk"].to(dt)).reshape(B, S, kvh, dh)
    v = (x @ params["wv"].to(dt)).reshape(B, S, kvh, dh)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


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


def attention(params, x, cfg: ModelConfig, positions,
              causal_block_skip: bool = False):
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    out = blockwise_attention(q, k, v, cfg,
                              causal_block_skip=causal_block_skip)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim_)
    return out @ params["wo"].to(x.dtype)


def decode_attention(params, x, cfg: ModelConfig, cache_k, cache_v,
                     position: int):
    """Single-token decode against a (B, S_cache, KVH, dh) cache.

    Returns (y, k_new, v_new); the caller writes the cache (a ring buffer
    for SWA).  The current token joins through the online-softmax merge.
    """
    B = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = x.dtype
    q = (x @ params["wq"].to(dt)).reshape(B, 1, h, dh)
    k = (x @ params["wk"].to(dt)).reshape(B, 1, kvh, dh)
    v = (x @ params["wv"].to(dt)).reshape(B, 1, kvh, dh)
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    G = h // kvh
    qg = q.reshape(B, kvh, G, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     cache_k.to(dt).float()) / math.sqrt(dh)
    Sc = cache_k.shape[1]
    kpos = torch.arange(Sc, device=x.device)
    if cfg.sliding_window and Sc <= cfg.sliding_window:
        # ring buffer: all slots hold live positions once the window filled
        valid = (kpos < position) | (position >= cfg.sliding_window)
    else:
        valid = kpos < position
    s = torch.where(valid, s, NEG_INF)
    s_self = torch.einsum("bkgd,bkd->bkg", qg,
                          k[:, 0].float())[..., None] / math.sqrt(dh)
    m = torch.maximum(s.amax(-1, keepdim=True), s_self)
    p = torch.exp(s - m)
    p_self = torch.exp(s_self - m)
    denom = p.sum(-1, keepdim=True) + p_self
    ctx = torch.einsum("bkgs,bskd->bkgd", p.to(dt).float(),
                       cache_v.to(dt).float())
    ctx = ctx + p_self * v[:, 0][:, :, None, :]
    ctx = (ctx / denom).to(dt)
    y = ctx.reshape(B, h * dh) @ params["wo"].to(dt)
    return y, k[:, 0], v[:, 0]


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


def mlp(params, x):
    dt = x.dtype
    h = F.silu(x @ params["wg"].to(dt)) * (x @ params["wu"].to(dt))
    return h @ params["wd"].to(dt)


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


def embed(params, tokens, cfg: ModelConfig):
    return params["tok"][tokens.long()].to(torch_dtype(cfg.dtype))


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["tok"].T
    return params["unembed"]


def _ce_chunk(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _ce_body(xb, lb, W):
    return _ce_chunk(xb @ W, lb).sum()


def chunked_ce_loss(params, x, labels, cfg: ModelConfig, chunk: int = 512):
    """Cross-entropy with the (B,S,V) logits computed seq-chunk at a time.

    Each chunk's body is rematerialized (``checkpoint``, the counterpart
    of the reference's ``nothing_saveable`` policy): autograd keeps no
    chunk's float32 logits for the backward pass, which recomputes them
    with one extra (B,chunk,D)x(D,V) product.
    """
    B, S, D = x.shape
    W = unembed_matrix(params, cfg).to(x.dtype)
    chunk = min(chunk, S)
    nc = S // chunk
    xc = x.reshape(B, nc, chunk, D)
    lc = labels.reshape(B, nc, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nc):
        total = total + checkpoint(_ce_body, xc[:, i], lc[:, i], W,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (B * S)
