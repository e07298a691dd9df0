"""Public wrappers the engine, the builder and the serving path call.

Each op broadcasts per-query scalars, casts to the kernels' dtypes and
calls a kernel wrapper, which launches the CUDA kernel for tensors on the
card and takes the plain torch version for tensors on the CPU:

  ``fused_query_block``  the engine's fused pass over a block of rows
                         (pass-1 histograms or pass-2 stop-masked scores)
                         -> ``fused_query.py``
  ``fused_query_keep``   the serving path's single scan: pass 1 that keeps
                         each (query, row)'s level and distance
  ``fused_query_mask``   pass 2 on that carry: the stop-masked scores
                         -> ``fused_query.py``
  ``hash_encode``        bucket codes (device-encode build, query encode)
                         -> ``hash_encode.py``
  ``freq_level``         first-frequent levels, stage 1 of the unfused
                         route -> ``freq_level.py``
  ``weighted_lp_dist``   weighted l_p distances under one weight; p != 2
                         -> ``weighted_lp.py``, p = 2 the norms expansion
                         (a matrix product, no kernel), as in the JAX
                         package
"""

from __future__ import annotations

import torch

from . import freq_level as _freq_level
from . import fused_query, ref
from . import hash_encode as _hash_encode
from . import weighted_lp as _weighted_lp

__all__ = ["freq_level", "fused_query_block", "fused_query_keep",
           "fused_query_mask", "hash_encode", "weighted_lp_dist"]


def _per_query(v, q: int, dtype, dev):
    return torch.as_tensor(v, dtype=dtype, device=dev).expand(q).contiguous()


def _f32(x):
    return x.to(torch.float32).contiguous()


def _vecs(x):
    """Stored vectors as the fused kernels read them: bfloat16 rows pass
    through (the kernels widen them as they stage them, so no float32
    copy of the block is made), anything else becomes float32."""
    if x.dtype == torch.bfloat16:
        return x.contiguous()
    return _f32(x)


def hash_encode(points, weight, proj, b_int, b_frac, width: float):
    """(n, beta) int32 level-1 bucket codes."""
    return _hash_encode.hash_encode(
        _f32(points), _f32(weight), _f32(proj),
        b_int.to(torch.int32).contiguous(), _f32(b_frac), float(width))


def freq_level(codes_p, codes_q, mu, c: int, n_levels: int, beta_q=None):
    """(Q, n) int32 first-frequent-level matrix (n_levels+1 = never).

    Dead rows are the caller's business; rows past a block multiple need
    no pad code (``int32 max // 2`` in the reference's padding), since the
    kernel walks exactly n rows.
    """
    dev = codes_p.device
    q, beta = codes_q.shape
    mu = _per_query(mu, q, torch.int32, dev)
    beta_q = _per_query(beta if beta_q is None else beta_q, q, torch.int32,
                        dev)
    return _freq_level.freq_level(
        codes_p.to(torch.int32).contiguous(),
        codes_q.to(torch.int32).contiguous(), mu, beta_q, c=int(c),
        n_levels=int(n_levels))


def weighted_lp_dist(queries, points, weight, p: float):
    """(Q, n) f32 weighted l_p distances under one weight vector."""
    if abs(p - 2.0) < 1e-9:
        return ref.weighted_lp_ref(queries, points, weight, p)
    return _weighted_lp.weighted_lp(_f32(queries), _f32(points),
                                    _f32(weight), float(p))


def _fused_args(codes_p, points, codes_q, queries, q_weight, mu, r_min,
                beta_q):
    """The fused kernels' row, query and per-query arguments, broadcast and
    cast (``r_min`` last)."""
    dev = codes_p.device
    q, beta = codes_q.shape
    return (
        codes_p.to(torch.int32).contiguous(),
        _vecs(points),
        codes_q.to(torch.int32).contiguous(),
        _f32(queries),
        _f32(q_weight),
        _per_query(mu, q, torch.int32, dev),
        _per_query(beta if beta_q is None else beta_q, q, torch.int32, dev),
        _per_query(r_min, q, torch.float32, dev),
    )


def fused_query_block(
    codes_p,  # (B, beta) int32 — one scan block of point codes
    points,  # (B, d) float32 or bfloat16 — the matching vector block
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
    *args, r_min = _fused_args(codes_p, points, codes_q, queries, q_weight,
                               mu, r_min, beta_q)
    kw = dict(boff=int(boff), n_valid=int(n_valid), c=int(c),
              n_levels=int(n_levels), p=float(p))
    if stop is None:
        hf, hg = fused_query.fused_query_hist(*args, r_min, **kw)
        return hf[:, : n_levels + 2], hg[:, : n_levels + 2]
    stop = _per_query(stop, codes_q.shape[0], torch.int32, codes_p.device)
    return fused_query.fused_query_scores(*args, stop, **kw)


def fused_query_keep(codes_p, points, codes_q, queries, q_weight, mu, r_min,
                     beta_q, *, boff: int, n_valid: int, c: int,
                     n_levels: int, p: float):
    """Pass 1 over a block of rows that keeps its per-(query, row) results.

    Takes ``fused_query_block``'s arguments and returns its pass-1
    ``(hist_f, hist_g)`` and the carry ``(lf, dist)`` of
    ``fused_query_mask``: each (query, row)'s first-frequent level
    ``(Q, B)`` uint8 (L+2 for a dead row) and distance ``(Q, B)`` f32
    (+inf for a dead row).
    """
    hf, hg, lf, dist = fused_query.fused_query_keep(
        *_fused_args(codes_p, points, codes_q, queries, q_weight, mu, r_min,
                     beta_q),
        boff=int(boff), n_valid=int(n_valid), c=int(c),
        n_levels=int(n_levels), p=float(p))
    return hf[:, : n_levels + 2], hg[:, : n_levels + 2], (lf, dist)


def fused_query_mask(lf, stop, dist):
    """Pass 2 on ``fused_query_keep``'s carry: ``dist`` with rows past the
    query's stop level (``lf > stop``) set to +inf, in place, and returned:
    ``fused_query_block``'s pass-2 scores, bit for bit."""
    stop = _per_query(stop, dist.shape[0], torch.int32, dist.device)
    fused_query.fused_query_mask(lf, stop, dist)
    return dist
