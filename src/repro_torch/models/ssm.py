"""Mamba2 (SSD — state-space duality) layer: chunked prefill scan plus the
single-step recurrence for decode (the port of the JAX package's
``models/ssm.py``).

Per head h with state size N, head dim P, the SSM is

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t x_t^T        s in R^{N x P}
    y_t = C_t . s_t + D_h * x_t

The chunked algorithm (Dao & Gu '24) splits the sequence into chunks of Q:
an intra-chunk quadratic term (C B^T masked by the decay kernel L) plus an
inter-chunk recurrence on per-chunk states; the inter-chunk loop carries
only (H, N, P) states.  A causal depthwise conv (kernel 4) precedes the
SSM on the x/B/C paths, and a gated (silu z-branch) RMSNorm follows it.
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .params import pdef

__all__ = ["ssm_defs", "mamba2_block", "mamba2_decode_step", "ssm_state_shape"]


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1  # single B/C group
    return di, H, P, N, G


def ssm_defs(cfg: ModelConfig):
    d = cfg.d_model
    di, H, P, N, G = _dims(cfg)
    conv_dim = di + 2 * G * N
    return {
        # in_proj packs [z (di), x (di), B (G*N), C (G*N), dt (H)]
        "in_proj": pdef((d, 2 * di + 2 * G * N + H), ("fsdp", "model"),
                        init="scaled"),
        "conv_w": pdef((cfg.conv_kernel, conv_dim), (None, "model")),
        "conv_b": pdef((conv_dim,), ("model",), init="zeros"),
        "A_log": pdef((H,), ("model",), init="ones"),
        "D": pdef((H,), ("model",), init="ones"),
        "dt_bias": pdef((H,), ("model",), init="zeros"),
        "norm_scale": pdef((di,), ("model",), init="ones"),
        "out_proj": pdef((di, d), ("model", "fsdp"), init="scaled"),
    }


def ssm_state_shape(cfg: ModelConfig, batch: int):
    di, H, P, N, G = _dims(cfg)
    return {
        "ssm": (batch, H, N, P),
        "conv": (batch, cfg.conv_kernel - 1, di + 2 * G * N),
    }


def _split_proj(cfg: ModelConfig, proj):
    di, H, P, N, G = _dims(cfg)
    z = proj[..., :di]
    xBC = proj[..., di : 2 * di + 2 * G * N]
    dt = proj[..., 2 * di + 2 * G * N :]
    return z, xBC, dt


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(xBC, w, b, carry=None):
    """Depthwise causal conv along seq.  xBC (B,S,Cd), w (K,Cd).  Returns
    (silu(conv + b), the last K-1 input rows as the next carry)."""
    K = w.shape[0]
    S = xBC.shape[1]
    if carry is None:
        pad = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = carry.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    out = 0  # summed from 0 in tap order, as the reference's sum()
    for i in range(K):
        out = out + xp[:, i : i + S, :] * w[i][None, None, :]
    new_carry = xp[:, -(K - 1) :, :] if K > 1 else None
    return F.silu(out + b[None, None, :]), new_carry


def _gated_norm(y, z, scale, eps: float = 1e-6):
    y = y * F.silu(z.float())
    ms = (y * y).mean(-1, keepdim=True)
    return y * torch.rsqrt(ms + eps) * scale


def mamba2_block(params, x, cfg: ModelConfig, initial_state=None):
    """x: (B, S, d) -> ((B, S, d), final state (B, H, N, P) f32); S must be
    a multiple of ssm_chunk."""
    B, S, d = x.shape
    di, H, P, N, G = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    nc = S // Q
    dt_ = x.dtype
    dev = x.device
    f32 = torch.float32

    proj = x @ params["in_proj"].to(dt_)
    z, xBC, dtt = _split_proj(cfg, proj)
    xBC, _ = _causal_conv(xBC, params["conv_w"].to(dt_),
                          params["conv_b"].to(dt_))
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di : di + G * N].reshape(B, S, N).float()
    Cm = xBC[..., di + G * N :].reshape(B, S, N).float()
    dt = _softplus(dtt.float() + params["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(params["A_log"].float())  # (H,) negative

    # chunked SSD ------------------------------------------------------------
    xs_c = xs.reshape(B, nc, Q, H, P).float()
    B_c = Bm.reshape(B, nc, Q, N)
    C_c = Cm.reshape(B, nc, Q, N)
    dt_c = dt.reshape(B, nc, Q, H)
    dA = dt_c * A[None, None, None, :]  # (B,nc,Q,H)
    cum = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk
    # Stability clamp: decays below e^-20 are numerically zero, and the
    # clamp bounds exp(-cum) <= e^20 in the factorized intra-chunk term.
    cum = torch.clamp_min(cum, -20.0)
    total = cum[:, :, -1:, :]  # (B,nc,1,H)

    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, factorized as
    # exp(cum_i) * exp(-cum_j) so the (Q, Q) term never carries the head dim
    ii = torch.arange(Q, device=dev)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :]
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)  # (B,nc,Q,Q)
    M = torch.where(causal, cb, torch.zeros((), dtype=f32, device=dev))
    u = torch.exp(-cum)[..., None] * dt_c[..., None] * xs_c  # (B,nc,Q,H,P)
    y_intra = torch.exp(cum)[..., None] * torch.einsum(
        "bcij,bcjhp->bcihp", M, u)

    # per-chunk state contribution: sum_j exp(total - cum_j) dt_j B_j x_j^T
    decay_out = torch.exp(total - cum)  # (B,nc,Q,H)
    s_local = torch.einsum("bcjh,bcjh,bcjn,bcjhp->bchnp", decay_out, dt_c,
                           B_c, xs_c)  # (B,nc,H,N,P)

    # inter-chunk recurrence: s_c = exp(total_c) s_{c-1} + s_local_c
    g = torch.exp(total[:, :, 0, :])  # (B,nc,H)
    s = (torch.zeros((B, H, N, P), dtype=f32, device=dev)
         if initial_state is None else initial_state.float())
    s_in = []
    for c in range(nc):
        s_in.append(s)  # the state *entering* chunk c
        s = g[:, c, :, None, None] * s + s_local[:, c]
    s_in = torch.stack(s_in, dim=1)  # (B,nc,H,N,P)

    # inter-chunk output: y_j += exp(cum_j) C_j . s_in
    y_inter = torch.einsum("bcjh,bcjn,bchnp->bcjhp", torch.exp(cum), C_c,
                           s_in)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = _gated_norm(y.reshape(B, S, di), z, params["norm_scale"].float())
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    return out, s


def mamba2_decode_step(params, x, cfg: ModelConfig, state):
    """x: (B, d) single token; state dict {ssm (B,H,N,P), conv (B,K-1,Cd)}.
    Returns (y (B, d), the new state dict)."""
    B, d = x.shape
    di, H, P, N, G = _dims(cfg)
    dt_ = x.dtype
    proj = x @ params["in_proj"].to(dt_)
    z, xBC, dtt = _split_proj(cfg, proj)
    xBC, new_conv = _causal_conv(
        xBC[:, None, :], params["conv_w"].to(dt_), params["conv_b"].to(dt_),
        carry=state["conv"],
    )
    xBC = xBC[:, 0]
    xs = xBC[..., :di].reshape(B, H, P).float()
    Bm = xBC[..., di : di + G * N].float()  # (B,N)
    Cm = xBC[..., di + G * N :].float()
    dt = _softplus(dtt.float() + params["dt_bias"].float())  # (B,H)
    A = -torch.exp(params["A_log"].float())
    g = torch.exp(dt * A[None, :])  # (B,H)
    s = state["ssm"].float()
    s_new = g[:, :, None, None] * s + torch.einsum("bh,bn,bhp->bhnp", dt, Bm,
                                                   xs)
    y = torch.einsum("bn,bhnp->bhp", Cm, s_new)
    y = y + params["D"].float()[None, :, None] * xs
    y = _gated_norm(y.reshape(B, di), z, params["norm_scale"].float())
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    return out, {"ssm": s_new.to(state["ssm"].dtype), "conv": new_conv}
