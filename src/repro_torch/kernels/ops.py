"""Public wrappers the engine calls around the query-step kernels.

``fused_query_block`` is the engine's fused pass over a block of rows
(pass-1 histograms or pass-2 stop-masked scores): it broadcasts the
per-query scalars, casts to the kernels' dtypes and calls the kernel
wrapper of ``fused_query.py``, which launches the CUDA kernel for tensors on
the card and takes the plain torch version for tensors on the CPU.

``freq_level`` and ``weighted_lp_dist`` serve the unfused oracle route
(``use_kernels="off"``); they reach their plain versions on every device.
"""

from __future__ import annotations

import torch

from . import fused_query, ref

__all__ = ["freq_level", "fused_query_block", "weighted_lp_dist"]


def _per_query(v, q: int, dtype, dev):
    return torch.as_tensor(v, dtype=dtype, device=dev).expand(q).contiguous()


def freq_level(codes_p, codes_q, mu, c: int, n_levels: int, beta_q=None):
    """(Q, n) int32 first-frequent-level matrix (n_levels+1 = never)."""
    return ref.freq_level_ref(codes_p, codes_q, mu, c, n_levels, beta_q)


def weighted_lp_dist(queries, points, weight, p: float):
    """(Q, n) f32 weighted l_p distances under one weight vector."""
    return ref.weighted_lp_ref(queries, points, weight, p)


def fused_query_block(
    codes_p,  # (B, beta) int32 — one scan block of point codes
    points,  # (B, d) — the matching vector block
    codes_q,  # (Q, beta) int32 query bucket codes
    queries,  # (Q, d) query vectors
    q_weight,  # (Q, d) per-query weight vectors
    mu,  # (Q,) or scalar int32 collision thresholds
    r_min,  # (Q,) or scalar f32 radius bases (pass-1 good-level ceil)
    beta_q,  # (Q,) or scalar int32 per-member table counts; None = all
    *,
    boff: int,  # global row offset of this block
    n_valid: int,  # streaming live-row watermark (rows >= it are dead)
    c: int,
    n_levels: int,
    p: float,
    stop=None,  # None = pass-1 (histograms); (Q,) int32 = pass-2 (scores)
):
    """One fused query pass over a block of rows.

    Pass 1 (``stop=None``) returns ``(hist_f, hist_g)`` per-level
    frequent/good histogram contributions, each ``(Q, n_levels + 2)``
    int32 (bins 0..n_levels+1; dead rows are dropped).  Pass 2 (``stop``
    given) returns ``(Q, B)`` f32 distances with rows past the query's stop
    level (and dead rows) masked to +inf, ready for a top-k.
    """
    dev = codes_p.device
    q, beta = codes_q.shape
    mu = _per_query(mu, q, torch.int32, dev)
    r_min = _per_query(r_min, q, torch.float32, dev)
    beta_q = _per_query(beta if beta_q is None else beta_q, q, torch.int32,
                        dev)
    args = (
        codes_p.to(torch.int32).contiguous(),
        points.to(torch.float32).contiguous(),
        codes_q.to(torch.int32).contiguous(),
        queries.to(torch.float32).contiguous(),
        q_weight.to(torch.float32).contiguous(),
        mu,
        beta_q,
    )
    kw = dict(boff=int(boff), n_valid=int(n_valid), c=int(c),
              n_levels=int(n_levels), p=float(p))
    if stop is None:
        hf, hg = fused_query.fused_query_hist(*args, r_min, **kw)
        return hf[:, : n_levels + 2], hg[:, : n_levels + 2]
    stop = _per_query(stop, q, torch.int32, dev)
    return fused_query.fused_query_scores(*args, stop, **kw)
