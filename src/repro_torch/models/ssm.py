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
from ..distributed.sharding import shard, spec, to_placements
from .layers import seq_whole
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


def _ssd(xs, Bm, Cm, dt, A, initial_state, Q: int):
    """The chunked SSD scan: xs (B,S,H,P), Bm / Cm (B,S,N) f32, dt (B,S,H)
    f32, A (H,) f32 -> (y (B,S,H,P) f32 without the D skip, the final
    state (B,H,N,P) f32).  Each head is independent of the others."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    nc = S // Q
    dev = xs.device
    f32 = torch.float32

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
    return (y_intra + y_inter).reshape(B, S, H, P), s


def _ssd_sharded(xs, Bm, Cm, dt, A, initial_state, Q: int, mesh):
    """``_ssd`` on a mesh: batch over the data axes and heads over
    "model", each device's heads scanned where they lie (``local_map``;
    the heads need no collective, and DTensor's einsum views would have to
    flatten a head-sharded dim).  B and C feed every head: with the heads
    sharded, their gradients are partial sums over "model"; A feeds every
    sequence: with the batch sharded, its gradient is a partial sum over
    the data axes."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    xs = shard(xs, mesh, "batch", "seq", "heads", None)
    Bm = shard(Bm, mesh, "batch", "seq", None)
    Cm = shard(Cm, mesh, "batch", "seq", None)
    dt = shard(dt, mesh, "batch", "seq", "heads")
    A = shard(A, mesh, "heads")
    st = (None if initial_state is None
          else shard(initial_state, mesh, "batch", "heads", None, None))
    st_p = to_placements(mesh, spec(mesh, ("batch", "heads", None, None),
                                    (xs.shape[0], xs.shape[2], Bm.shape[-1],
                                     xs.shape[3])))
    bc_grad = [Partial() if p == Shard(2) else q
               for p, q in zip(xs.placements, Bm.placements)]
    a_grad = [Partial() if p == Shard(0) else q
              for p, q in zip(xs.placements, A.placements)]
    ins = (xs, Bm, Cm, dt, A, st)
    fn = local_map(
        lambda *a: _ssd(*a, Q), out_placements=(list(xs.placements), st_p),
        in_placements=tuple(None if t is None else list(t.placements)
                            for t in ins),
        in_grad_placements=tuple(
            bc_grad if i in (1, 2) else a_grad if i == 4 else None
            if t is None else list(t.placements) for i, t in enumerate(ins)),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(xs, Bm, Cm, dt, A, st)


def mamba2_block(params, x, cfg: ModelConfig, mesh=None,
                 initial_state=None):
    """x: (B, S, d) -> ((B, S, d), final state (B, H, N, P) f32); S must be
    a multiple of ssm_chunk."""
    x = seq_whole(x, mesh)
    B, S, d = x.shape
    di, H, P, N, G = _dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    dt_ = x.dtype

    proj = x @ params["in_proj"].to(dt_)
    z, xBC, dtt = _split_proj(cfg, proj)
    xBC, _ = _causal_conv(xBC, params["conv_w"].to(dt_),
                          params["conv_b"].to(dt_))
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di : di + G * N].reshape(B, S, N).float()
    Cm = xBC[..., di + G * N :].reshape(B, S, N).float()
    dt = _softplus(dtt.float() + params["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(params["A_log"].float())  # (H,) negative
    xs = shard(xs, mesh, "batch", "seq", "heads", None)

    if mesh is None:
        y, s = _ssd(xs, Bm, Cm, dt, A, initial_state, Q)
    else:
        y, s = _ssd_sharded(xs, Bm, Cm, dt, A, initial_state, Q, mesh)
    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = _gated_norm(y.reshape(B, S, di), z, params["norm_scale"].float())
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    return shard(out, mesh, "batch", "seq", None), s


def _ssd_step(xs, Bm, Cm, dt, A, s):
    """One token's SSM recurrence: xs (B,H,P), Bm / Cm (B,N), dt (B,H), A
    (H,), the state s (B,H,N,P) -> (y (B,H,P) without the D skip, the new
    state)."""
    g = torch.exp(dt * A[None, :])  # (B,H)
    s_new = g[:, :, None, None] * s + torch.einsum("bh,bn,bhp->bhnp", dt, Bm,
                                                   xs)
    return torch.einsum("bn,bhnp->bhp", Cm, s_new), s_new


def _ssd_step_sharded(xs, Bm, Cm, dt, A, s, mesh):
    """``_ssd_step`` on a mesh, each device's (batch, heads) block where it
    lies (``local_map``, as ``_ssd_sharded``)."""
    from torch.distributed.tensor.experimental import local_map

    args = (shard(xs, mesh, "batch", "heads", None),
            shard(Bm, mesh, "batch", None), shard(Cm, mesh, "batch", None),
            shard(dt, mesh, "batch", "heads"), shard(A, mesh, "heads"),
            shard(s, mesh, "batch", "heads", None, None))
    fn = local_map(_ssd_step, out_placements=(list(args[0].placements),
                                              list(args[5].placements)),
                   in_placements=tuple(list(t.placements) for t in args),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def mamba2_decode_step(params, x, cfg: ModelConfig, state, mesh=None):
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
    s = state["ssm"].float()
    if mesh is None:
        y, s_new = _ssd_step(xs, Bm, Cm, dt, A, s)
    else:
        y, s_new = _ssd_step_sharded(xs, Bm, Cm, dt, A, s, mesh)
    y = y + params["D"].float()[None, :, None] * xs
    y = _gated_norm(y.reshape(B, di), z, params["norm_scale"].float())
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    return (shard(out, mesh, "batch", None),
            {"ssm": s_new.to(state["ssm"].dtype), "conv": new_conv})
