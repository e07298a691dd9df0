"""Plain torch versions of the query-step kernels.

These define the semantics the CUDA kernels are held to: integer outputs
exactly (hash codes too: the kernel takes ``hash_encode_ref``'s fused
multiply-adds in its order, and ``fma_f32`` rounds each once, as the
card's FMA does), distances to a float32 tolerance.  They run on any
device; the kernel wrappers (``fused_query.py``, ``hash_encode.py``,
``freq_level.py``, ``weighted_lp.py``) take them for tensors on the CPU,
and ``chip_smoke.py`` runs them on the card beside the kernels.  Shapes:

  hash_encode_ref : (n, d) x (d, beta) -> (n, beta) int32 bucket codes
  freq_level_ref  : (n, beta) codes x (Q, beta) query codes -> (Q, n) int32
                    first level j (0..n_levels) at which the point is
                    *frequent* for the query (collision count >= mu at
                    level-c^j buckets); n_levels + 1 if never frequent.
  weighted_lp_ref : (Q, d) x (n, d) -> (Q, n) distances under one weight
  count_level_ref : (n, beta) codes x (Q, beta) query codes -> (Q, n) int32
                    collision counts at the one level c**level (the
                    paper-faithful single radius; no kernel behind it)

``freq_level_words_ref`` computes ``freq_level_ref``'s output the way the
fused CUDA kernel does for c in {2, 3}: the first agreeing level of each
(row, lane) read off base-c digit words (``digit_words``,
``first_agreeing_level``), counted per level, the first level whose
running count reaches mu.  Only tests use it, to hold that method to the
level-by-level floor division.

The fused-query versions (``fused_query_hist_ref`` /
``fused_query_scores_ref``) define one fused pass over a block of rows:
first-frequent level, weighted distance, good-level histogramming or
stop-mask scoring.  The unfused engine route calls the very same
``per_query_dist`` on the same shapes.

Every (query, row, table) intermediate is materialized, so the functions
walk the rows in chunks that keep it near 64 M elements; results do not
depend on the chunking (every output is per row, and histograms are integer
sums).

Precision: float32 throughout.  The fused versions take a float32 or a
bfloat16 vector block and widen each row chunk with ``.float()``, as the
kernels widen each row as they stage it.  Matrix products run in full
float32 (TF32 off, see ``repro_torch.kernels``).  ``log_c`` divides by a tensor on the
operand's device, not by a Python float: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which rounds differently from the
true division the kernels and the JAX reference perform.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "fma_f32",
    "hash_encode_ref",
    "hash_code_window",
    "unbias_codes",
    "freq_level_ref",
    "count_level_ref",
    "dead_word",
    "digit_words",
    "first_agreeing_level",
    "freq_level_words_ref",
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


_RUN, _TILE = 8, 32  # hash_encode's sum order: 8-dim runs in 32-dim tiles
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1
_WINDOW_ULPS = 16.0  # hash_code_window's E, in units of 2**-24 * S


def fma_f32(x, a, c):
    """``fmaf(x, a, c)`` elementwise on float32 tensors: ``x * a + c``
    rounded once to float32 (to nearest, ties to even), as the card's FMA.

    ``x * a`` is exact in float64 (24 + 24 bits fit in 53).  The float64
    sum ``s`` of it and ``c`` is rounded to odd: where TwoSum finds it
    inexact and its last bit is even, it moves one ulp toward the exact
    value.  Rounding that to float32 gives the correctly rounded result;
    rounding the nearest float64 to float32 instead would round twice and
    could land on the wrong side of a float32 midpoint.
    """
    p = x.double() * a.double()
    r = c.double()
    s = p + r
    bb = s - p
    err = (p - (s - bb)) + (r - bb)  # TwoSum: s + err == p + r exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def hash_encode_ref(points, proj, b_int, b_frac, weight, width):
    """floor((a . (W o x))/w + b_frac) + b_int, exact-int split of b*.

    Every output is summed over d in one fixed order, whatever the number
    of rows.  With ``xw_i = RN(x_i w_i)`` in float32, the dims fall into
    32-dim tiles and each tile into 8-dim runs (the last run and tile may
    be ragged); ``run = fma(xw_i, a_ij, run)`` from 0 over a run's dims,
    each rounded once (``fma_f32``), then ``tile = RN(tile + run)`` after
    each run and ``acc = RN(acc + tile)`` after each tile.  The CUDA
    kernel takes the same steps with ``__fmaf_rn`` / ``__fadd_rn``, so the
    two agree bit for bit and a row encodes the same alone or in any
    batch.  At d = 400 this order stays within ~10 * 2**-24 * S of the
    exact sum (S = sum |x_i w_i a_ij|) on heavy-tailed (p <= 1)
    projections, where one sequential sum reaches ~40 and a blocked
    matrix product ~30; an FMA rounds once where a multiply and an add
    round twice, so it can only come closer.

    ``floor(u)`` converts to int32 saturating, as XLA's convert does:
    u >= 2**31 gives INT_MAX, u < -2**31 gives INT_MIN.  Then ``+ b_int``
    wraps in int32.
    """
    dev = points.device
    x = points.float() * weight.float()
    a = proj.float()
    n, d = x.shape
    beta = a.shape[1]
    w = torch.tensor(width, dtype=torch.float32, device=dev)
    out = torch.empty((n, beta), dtype=torch.int32, device=dev)
    step = _row_chunk(2, beta)  # fma_f32's float64 temporaries: half
    for lo in range(0, n, step):
        xs = x[lo : lo + step]
        acc = torch.zeros((len(xs), beta), dtype=torch.float32, device=dev)
        for t0 in range(0, d, _TILE):
            tile = torch.zeros_like(acc)
            for r0 in range(t0, min(d, t0 + _TILE), _RUN):
                run = torch.zeros_like(acc)
                for i in range(r0, min(d, r0 + _RUN)):
                    run = fma_f32(xs[:, i, None], a[i], run)
                tile += run
            acc += tile
        u = acc / w + b_frac.float()
        hi, low = u >= 2.0**31, u < -(2.0**31)
        v = torch.floor(torch.where(hi | low, 0.0, u)).to(torch.int32)
        v = torch.where(hi, _I32_MAX, torch.where(low, _I32_MIN, v))
        out[lo : lo + step] = v + b_int.to(torch.int32)
    return out


def hash_code_window(points, proj, b_frac, weight, width):
    """(lo, hi) int64 (n, beta): where a float32 encode's ``code - b_int``
    (wrapped to int32) may lie, from float64.

    With u = (x o w) @ a / width + b_frac and S = sum_i |x_i w_i a_ij| /
    width + |b_frac| in float64, and E = 16 * 2**-24 * S, the window is
    [floor(u - E), floor(u + E)] clamped to the int32 range: where u >=
    2**31 + E only INT_MAX is allowed, where u < -2**31 - E only INT_MIN.
    A truncating floor, a lost b_frac, an off-by-one b_int or a wrapped
    overflow falls outside it.
    """
    x = points.double() * weight.double()
    a = proj.double()
    bf = b_frac.double()
    lo = torch.empty((x.shape[0], a.shape[1]), dtype=torch.int64,
                     device=x.device)
    hi = torch.empty_like(lo)
    step = _row_chunk(4, a.shape[1])
    for r in range(0, x.shape[0], step):
        xs = x[r : r + step]
        u = xs @ a / width + bf
        s = xs.abs() @ a.abs() / abs(width) + bf.abs()
        e = _WINDOW_ULPS * 2.0**-24 * s
        lo[r : r + step] = torch.floor(u - e).clamp(_I32_MIN, _I32_MAX).long()
        hi[r : r + step] = torch.floor(u + e).clamp(_I32_MIN, _I32_MAX).long()
    return lo, hi


def unbias_codes(codes, b_int):
    """``codes - b_int`` wrapped to int32, as int64 (the floor of u)."""
    v = codes.long() - b_int.long()
    return (v + 2**31) % 2**32 - 2**31


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


def count_level_ref(codes_p, codes_q, c: int, level: int):
    """Collision counts at level c**level (paper-faithful single radius):
    (Q, n) int32, the tables on which ``codes // c**level`` of the query
    and of the row agree.  Floor division rounds toward minus infinity,
    as codes can be negative."""
    l = c**level
    q, beta = codes_q.shape
    n = codes_p.shape[0]
    b = torch.div(codes_q.to(torch.int32), l, rounding_mode="floor")
    out = torch.empty((q, n), dtype=torch.int32, device=codes_q.device)
    step = _row_chunk(q, beta)
    for lo in range(0, n, step):
        a = torch.div(codes_p[lo : lo + step].to(torch.int32), l,
                      rounding_mode="floor")
        out[:, lo : lo + step] = (b[:, None, :] == a[None, :, :]).sum(
            -1, dtype=torch.int32)
    return out


_P10, _TAB3 = 3**10, 3**6


def _wide(c: int, n_levels: int) -> bool:
    """The kernel's wide c = 3 word test (L > 16; see
    ``csrc/level_match.cuh``, struct Digits)."""
    return c == 3 and n_levels > 16


def dead_word(c: int, n_levels: int) -> int:
    """The word of a (query, lane) past the query's lanes: its high half
    differs from every code's, so it agrees at no level."""
    return (2 << 8 if _wide(c, n_levels) else 255 if c == 3 else 1) << 32


def digit_words(codes, c: int, n_levels: int):
    """int64 digit words ``hi << 32 | lo`` of int32 ``codes``, as the
    kernel forms them for c in {2, 3} at depth ``n_levels``.

    c = 2: lo = bits 0..30, hi = the sign (0 or 2**32 - 1).  c = 3: the 21
    base-3 digits of code + 3**20 (in [0, 3**21) for every int32); lo =
    digits 0..15, 2 bits each; hi = digits 16..20 as their value, or 2
    bits each for the wide test.  Built as the kernel builds them:
    floor(code / 3**10) + 3**10 and code mod 3**10, split at 3**6 into
    six-digit table entries.
    """
    a = codes.long()
    if c == 2:
        return (a & 0x7FFFFFFF) | ((a >> 31) & 0xFFFFFFFF) << 32
    v = torch.arange(_TAB3, device=a.device)
    tab = torch.zeros_like(v)
    for k in range(6):
        tab |= (v % 3) << (2 * k)
        v = v // 3
    q = torch.div(a, _P10, rounding_mode="floor")
    lo, hi = a - q * _P10, q + _P10
    low = (tab[lo % _TAB3] | (tab[lo // _TAB3] << 12)
           | (tab[hi % _TAB3] << 20))
    high = hi // _TAB3
    return low | (tab[high] if _wide(c, n_levels) else high) << 32


def _top_bit(x):
    """The highest set bit of each int64 x in [0, 2**32), -1 for 0."""
    _, bits = torch.frexp(x.double())
    return bits.long() - 1


def first_agreeing_level(wa, wb, c: int, n_levels: int):
    """First level j <= n_levels with floor(a / c^j) == floor(b / c^j),
    n_levels + 1 if none, from the digit words of a and b.

    With hd the highest differing digit of the low halves (-1 if equal):
    n_levels + 1 where the high halves differ, else min(hd + 1,
    n_levels + 1); the wide test takes hd over both halves and gives
    n_levels + 1 from the sign digit (20) up.
    """
    x = wa ^ wb
    lo, hi = x & 0xFFFFFFFF, (x >> 32) & 0xFFFFFFFF
    hd = _top_bit(lo) >> (c == 3)
    never = n_levels + 1
    if _wide(c, n_levels):
        hd = torch.where(hi != 0, 16 + (_top_bit(hi) >> 1), hd)
        return torch.where(hd >= 20, never, torch.clamp_max(hd + 1, never))
    return torch.where(hi != 0, never, torch.clamp_max(hd + 1, never))


def freq_level_words_ref(codes_p, codes_q, mu, c: int, n_levels: int,
                         beta_q=None):
    """``freq_level_ref`` by the fused kernel's method (c in {2, 3}).

    Each (query, row, lane) gets its first agreeing level from digit words,
    lanes at or past beta_q the dead word (level n_levels + 1); the result
    is the first level whose running count of lanes reaches mu.
    """
    q, beta = codes_q.shape
    dev = codes_q.device
    mu = torch.as_tensor(mu, dtype=torch.int64, device=dev).expand(q)
    if beta_q is None:
        beta_q = beta
    beta_q = torch.as_tensor(beta_q, dtype=torch.int64, device=dev).expand(q)
    lane_ok = torch.arange(beta, device=dev)[None, :] < beta_q[:, None]
    wq = torch.where(lane_ok, digit_words(codes_q, c, n_levels),
                     dead_word(c, n_levels))
    never = n_levels + 1
    n = codes_p.shape[0]
    out = torch.full((q, n), never, dtype=torch.int32, device=dev)
    step = _row_chunk(4 * q, beta)  # int64 and float64 temporaries
    for lo in range(0, n, step):
        wp = digit_words(codes_p[lo : lo + step], c, n_levels)
        m = first_agreeing_level(wq[:, None, :], wp[None], c, n_levels)
        cnt = torch.zeros(m.shape[:2] + (never + 1,), dtype=torch.int64,
                          device=dev).scatter_add_(2, m, torch.ones_like(m))
        hit = cnt[..., :never].cumsum(-1) >= mu[:, None, None]
        first = hit.int().argmax(-1).to(torch.int32)
        out[:, lo : lo + step] = torch.where(hit.any(-1), first, never)
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
        dist = per_query_dist(queries, q_weight, points_b[sl].float(), p)
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
        dist = per_query_dist(queries, q_weight, points_b[sl].float(), p)
        out[:, sl] = torch.where(lf <= stop[:, None], dist,
                                 torch.full_like(dist, math.inf))
    return out
