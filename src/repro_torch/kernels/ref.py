"""Plain torch versions of the query-step kernels.

These define the semantics the CUDA kernels are held to: integer outputs
exactly, distances to a float32 tolerance.  They run on any device; the
kernel wrappers (``fused_query.py``) take them for tensors on the CPU, and
``chip_smoke.py`` runs them on the card beside the kernels.  Shapes:

  hash_encode_ref : (n, d) x (d, beta) -> (n, beta) int32 bucket codes
  freq_level_ref  : (n, beta) codes x (Q, beta) query codes -> (Q, n) int32
                    first level j (0..n_levels) at which the point is
                    *frequent* for the query (collision count >= mu at
                    level-c^j buckets); n_levels + 1 if never frequent.
  weighted_lp_ref : (Q, d) x (n, d) -> (Q, n) distances under one weight

The fused-query versions (``fused_query_hist_ref`` /
``fused_query_scores_ref``) define one fused pass over a block of rows:
first-frequent level, weighted distance, good-level histogramming or
stop-mask scoring.  The unfused engine route calls the very same
``per_query_dist`` on the same shapes.

Every (query, row, table) intermediate is materialized, so the functions
walk the rows in chunks that keep it near 64 M elements; results do not
depend on the chunking (every output is per row, and histograms are integer
sums).

Precision: float32 throughout.  Matrix products run in full float32 (TF32
off, see ``repro_torch.kernels``).  ``log_c`` divides by a tensor on the
operand's device, not by a Python float: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which rounds differently from the
true division the kernels and the JAX reference perform.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "hash_encode_ref",
    "freq_level_ref",
    "weighted_lp_ref",
    "log_c",
    "per_query_l2",
    "per_query_lp",
    "per_query_dist",
    "fused_query_hist_ref",
    "fused_query_scores_ref",
]

_CHUNK_ELEMS = 1 << 26  # (Q, rows, beta-or-d) elements per row chunk


def _row_chunk(q: int, width: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, q * width))


def _is_p(p: float, v: float) -> bool:
    return abs(p - v) < 1e-9


def hash_encode_ref(points, proj, b_int, b_frac, weight, width):
    """floor((a . (W o x))/w + b_frac) + b_int, exact-int split of b*."""
    x = points.float() * weight.float()
    u = (x @ proj.float()) / torch.tensor(width, dtype=torch.float32,
                                         device=x.device) + b_frac
    return torch.floor(u).to(torch.int32) + b_int.to(torch.int32)


def freq_level_ref(codes_p, codes_q, mu, c: int, n_levels: int, beta_q=None):
    """First frequent level per (query, point); fuses all C2LSH radii.

    ``mu`` may be a scalar or (Q,); ``beta_q`` optionally limits each query
    to its first beta_q hash tables (default = all tables).  Floor division
    rounds toward minus infinity, as codes can be negative.
    """
    q, beta = codes_q.shape
    dev = codes_q.device
    mu = torch.as_tensor(mu, dtype=torch.int32, device=dev).expand(q)
    if beta_q is None:
        beta_q = beta
    beta_q = torch.as_tensor(beta_q, dtype=torch.int32, device=dev).expand(q)
    lane_ok = (torch.arange(beta, device=dev)[None, :]
               < beta_q[:, None])[:, None, :]  # (Q, 1, beta)
    never = n_levels + 1
    n = codes_p.shape[0]
    out = torch.full((q, n), never, dtype=torch.int32, device=dev)
    step = _row_chunk(q, beta)
    for lo in range(0, n, step):
        a = codes_p[lo : lo + step].to(torch.int32)
        b = codes_q.to(torch.int32)
        blk = out[:, lo : lo + step]
        for j in range(n_levels + 1):
            cnt = ((b[:, None, :] == a[None, :, :]) & lane_ok).sum(-1)
            hit = (cnt >= mu[:, None]) & (blk == never)
            blk.masked_fill_(hit, j)
            a = torch.div(a, c, rounding_mode="floor")
            b = torch.div(b, c, rounding_mode="floor")
    return out


def weighted_lp_ref(queries, points, weight, p: float):
    """(Q, n) weighted l_p distances under one weight vector, f32."""
    q = queries.shape[0]
    w = weight.float()
    return per_query_dist(queries.float(), w.expand(q, -1), points.float(), p)


def log_c(x, c: int):
    """log base c (true float32 division), the virtual-rehashing scale."""
    return torch.log(x) / torch.tensor(math.log(c), dtype=x.dtype,
                                       device=x.device)


def per_query_l2(q, w, pts):
    """(Q, B) weighted l2 with per-query weights, via two matmuls.

    The norms expansion ``qw2 - 2 cross + onorm`` is the reference's own
    formulation: its float32 rounding, not the exact difference form,
    decides good levels, so the port keeps it.
    """
    w2 = w * w
    qw2 = torch.sum(w2 * q * q, dim=-1)  # (Q,)
    cross = (w2 * q) @ pts.T  # (Q, B)
    onorm = w2 @ (pts * pts).T  # (Q, B)
    d2 = qw2[:, None] - 2.0 * cross + onorm
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def per_query_lp(q, w, pts, p: float):
    """(Q, B) weighted l_p (p != 2) with per-query weights, elementwise."""
    out = torch.empty((q.shape[0], pts.shape[0]), dtype=torch.float32,
                      device=pts.device)
    step = _row_chunk(q.shape[0], q.shape[1])
    for lo in range(0, pts.shape[0], step):
        x = pts[lo : lo + step]
        diff = torch.abs((q[:, None, :] - x[None, :, :]) * w[:, None, :])
        if _is_p(p, 1.0):
            out[:, lo : lo + step] = diff.sum(-1)
        else:
            out[:, lo : lo + step] = (diff**p).sum(-1) ** (1.0 / p)
    return out


def per_query_dist(q, w, pts, p: float):
    """Per-query-weight distance dispatch shared by every engine path."""
    if _is_p(p, 2.0):
        return per_query_l2(q, w, pts)
    return per_query_lp(q, w, pts, p)


def _fused_lf(codes_b, codes_q, mu, beta_q, row_ok, c, n_levels):
    """(Q, B) first-frequent level with excluded rows forced to L + 2.

    Excluded rows (rows at/after the streaming ``n_valid`` watermark) get
    the sentinel ``n_levels + 2``, past every histogram bin the stop logic
    reads (0..n_levels) and past every reachable stop level, so they vanish
    from both passes.
    """
    lf = freq_level_ref(codes_b, codes_q, mu, c, n_levels, beta_q)
    return torch.where(row_ok[None, :], lf,
                       torch.full_like(lf, n_levels + 2))


def good_level(lf, dist, r_min, c: int):
    """max(lf, ceil(max(log_c dist - log_c(c r_min), 0))), float32 order.

    The operation order is the reference's: ``log(max(dist, 1e-30)) /
    log(c)``, minus ``log(c * r_min) / log(c)`` with ``c * r_min`` in
    float32, clamped at 0, then ceil.  A flipped good level can move the
    stop level, and the stop level decides the ids.
    """
    jg = torch.ceil(torch.clamp_min(
        log_c(torch.clamp_min(dist, 1e-30), c)
        - log_c(c * r_min, c)[:, None], 0.0)).to(torch.int32)
    return torch.maximum(lf, jg)


def fused_query_hist_ref(codes_b, points_b, codes_q, queries, q_weight, mu,
                         beta_q, r_min, row_ok, c: int, n_levels: int,
                         p: float):
    """Pass-1 fused block step: (hist_f, hist_g) contributions, (Q, L+3).

    Level computation, distance, good-level ceil and one-hot binning per
    row chunk.  Bin L+2 collects excluded rows; levels above L+2 fall
    outside every bin.
    """
    L = n_levels
    q = codes_q.shape[0]
    dev = codes_q.device
    hist_f = torch.zeros((q, L + 3), dtype=torch.int32, device=dev)
    hist_g = torch.zeros((q, L + 3), dtype=torch.int32, device=dev)
    step = _row_chunk(q, max(codes_b.shape[1], points_b.shape[1]))
    for lo in range(0, codes_b.shape[0], step):
        sl = slice(lo, lo + step)
        ok = row_ok[sl]
        lf = _fused_lf(codes_b[sl], codes_q, mu, beta_q, ok, c, L)
        dist = per_query_dist(queries, q_weight, points_b[sl], p)
        good = torch.where(ok[None, :], good_level(lf, dist, r_min, c),
                           torch.full_like(lf, L + 2))
        hist_f += level_hist(lf, L + 3)
        hist_g += level_hist(good, L + 3)
    return hist_f, hist_g


def level_hist(levels, n_bins: int):
    """(Q, n_bins) int32 per-row counts of each level in ``levels`` (Q, B).

    Levels at or above ``n_bins`` fall outside every bin.
    """
    keep = levels < n_bins
    hist = torch.zeros((levels.shape[0], n_bins), dtype=torch.int32,
                       device=levels.device)
    return hist.scatter_add_(1, torch.where(keep, levels, 0).long(),
                             keep.to(torch.int32))


def fused_query_scores_ref(codes_b, points_b, codes_q, queries, q_weight, mu,
                           beta_q, stop, row_ok, c: int, n_levels: int,
                           p: float):
    """Pass-2 fused block step: (Q, B) stop-masked weighted distances.

    Rows whose first-frequent level exceeds the query's stop level, and
    every excluded row, score +inf, ready for the engine's top-k.
    """
    q = codes_q.shape[0]
    out = torch.empty((q, codes_b.shape[0]), dtype=torch.float32,
                      device=codes_q.device)
    step = _row_chunk(q, max(codes_b.shape[1], points_b.shape[1]))
    for lo in range(0, codes_b.shape[0], step):
        sl = slice(lo, lo + step)
        lf = _fused_lf(codes_b[sl], codes_q, mu, beta_q, row_ok[sl], c,
                       n_levels)
        dist = per_query_dist(queries, q_weight, points_b[sl], p)
        out[:, sl] = torch.where(lf <= stop[:, None], dist,
                                 torch.full_like(dist, math.inf))
    return out
