"""The work of one launch of each kernel, from the shapes it is given.

One function per kernel returns a ``Cost``: the operations it does, by
the unit that does them on an H100, and the bytes it must move, each
input read once and each output written once:

  ``f32_flops``  float32 multiply-adds on the CUDA cores, two FLOPs each
  ``f32_ops``    float32 instructions that do not fuse into one
                 multiply-add without changing the rounding (a subtract,
                 a multiply, an add of |t|), one a lane a clock
  ``int32_ops``  the level tests of the codes (one a table a row a query)
  ``sfu_ops``    special-function results (sqrt, log2, exp2)

``Cost.bound(hw)`` is the least time the card could take: the larger of
the bytes over ``hw.hbm_bw`` and the operations' time, which is the
largest of each unit's count over its rate (``launch.roofline.HW``).
The same numbers give the bound column of ``chip_smoke.py``'s kernel
table and the compute term of the dry-run's index cells
(``roofline.StepCounter`` prices each launch of a ``repro_torch`` op
through ``of_op``).

Where the work depends on the data, a caller that has the data passes
what it needs (``tests``: the level tests of this launch's ``beta_q``);
without it (meta tensors) every query tests all ``beta`` tables.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Cost", "freq_level", "fused_query_hist", "fused_query_keep",
           "fused_query_mask", "fused_query_scores", "hash_encode", "of_op",
           "weighted_lp"]


@dataclasses.dataclass(frozen=True)
class Cost:
    f32_flops: float = 0.0
    f32_ops: float = 0.0
    int32_ops: float = 0.0
    sfu_ops: float = 0.0
    bytes_read: int = 0
    bytes_written: int = 0

    @property
    def bytes(self) -> int:
        return self.bytes_read + self.bytes_written

    @property
    def flops(self) -> float:
        """Floating-point operations (a multiply-add counts two)."""
        return self.f32_flops + self.f32_ops

    def ops_s(self, hw) -> float:
        """Seconds of the busiest unit at its peak rate."""
        return max(self.f32_flops / hw.f32_flops, self.f32_ops / hw.f32_ops,
                   self.int32_ops / hw.int32_ops, self.sfu_ops / hw.sfu_ops)

    def bound(self, hw) -> tuple[float, str]:
        """(least seconds, "bytes" or "operations": what sets them)."""
        bytes_s, ops_s = self.bytes / hw.hbm_bw, self.ops_s(hw)
        return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                     else "operations")


def _lp_terms(p: float) -> dict:
    """Per (row, query, dim) term of an l_p distance, p != 2: a subtract,
    a multiply and an add of |t| (three float32 instructions), plus a sqrt
    for p = 0.5, or a powf's log2 and exp2 for any other p."""
    return dict(f32_ops=3, sfu_ops={1.0: 0, 0.5: 1}.get(float(p), 2))


def _fused(n, beta, q, d, vec_bytes, p, tests, out_bytes) -> Cost:
    tests = q * beta * n if tests is None else tests
    terms = q * n * d
    if abs(p - 2.0) < 1e-9:  # the cross term and the weighted norm
        work = dict(f32_flops=4 * terms)
    else:
        work = {k: v * terms for k, v in _lp_terms(p).items()}
    # codes, query codes, queries and weights, four per-query vectors
    read = 4 * (n * beta + q * beta + 2 * q * d + 4 * q) + vec_bytes * n * d
    return Cost(int32_ops=tests, bytes_read=read, bytes_written=out_bytes,
                **work)


def fused_query_hist(n, beta, q, d, n_levels, vec_bytes=4, p=2.0,
                     tests=None) -> Cost:
    """Pass 1 over ``n`` rows: two (Q, L+3) int32 histograms out."""
    return _fused(n, beta, q, d, vec_bytes, p, tests,
                  2 * 4 * q * (n_levels + 3))


def fused_query_scores(n, beta, q, d, vec_bytes=4, p=2.0,
                       tests=None) -> Cost:
    """Pass 2 over ``n`` rows: (Q, n) float32 scores out."""
    return _fused(n, beta, q, d, vec_bytes, p, tests, 4 * q * n)


def fused_query_keep(n, beta, q, d, n_levels, vec_bytes=4, p=2.0,
                     tests=None) -> Cost:
    """Pass 1 that keeps its carry: ``fused_query_hist``'s work, and the
    (Q, n) uint8 levels and float32 distances written besides."""
    return dataclasses.replace(
        fused_query_hist(n, beta, q, d, n_levels, vec_bytes, p, tests),
        bytes_written=2 * 4 * q * (n_levels + 3) + 5 * q * n)


def fused_query_mask(n, q) -> Cost:
    """Pass 2 on the carry: (Q, n) uint8 levels, float32 distances and
    (Q,) int32 stop levels read; the distances written back."""
    return Cost(bytes_read=5 * q * n + 4 * q, bytes_written=4 * q * n)


def hash_encode(n, d, beta) -> Cost:
    """(n, d) float32 rows through a (d, beta) projection."""
    return Cost(f32_flops=2 * n * d * beta,
                bytes_read=4 * (n * d + d + d * beta + 2 * beta),
                bytes_written=4 * n * beta)


def freq_level(n, beta, q, tests=None) -> Cost:
    """The (Q, n) int32 first-frequent levels."""
    return Cost(int32_ops=q * beta * n if tests is None else tests,
                bytes_read=4 * (n * beta + q * beta + 2 * q),
                bytes_written=4 * q * n)


def weighted_lp(q, n, d, p) -> Cost:
    """(Q, n) float32 l_p distances under one weight, p != 2."""
    return Cost(bytes_read=4 * (n * d + q * d + d), bytes_written=4 * q * n,
                **{k: v * q * n * d for k, v in _lp_terms(p).items()})


def of_op(name: str, args, kwargs) -> Cost:
    """The cost of one call of the ``repro_torch::<name>`` op on
    ``args``/``kwargs`` (tensors or meta tensors: shapes only)."""
    if name in ("fused_query_hist", "fused_query_keep",
                "fused_query_scores"):
        codes_p, points, _, queries = args[:4]
        (n, beta), (q, d) = codes_p.shape, queries.shape
        kw = dict(vec_bytes=points.element_size(), p=kwargs["p"])
        if name == "fused_query_scores":
            return fused_query_scores(n, beta, q, d, **kw)
        fn = (fused_query_hist if name == "fused_query_hist"
              else fused_query_keep)
        return fn(n, beta, q, d, kwargs["n_levels"], **kw)
    if name == "fused_query_mask":
        q, n = args[2].shape  # (lf, stop, dist)
        return fused_query_mask(n, q)
    if name == "hash_encode":
        points, _, proj = args[:3]
        return hash_encode(points.shape[0], points.shape[1], proj.shape[1])
    if name == "freq_level":
        codes_p, codes_q = args[:2]
        return freq_level(codes_p.shape[0], codes_p.shape[1],
                          codes_q.shape[0])
    if name == "weighted_lp":
        queries, points = args[:2]
        return weighted_lp(queries.shape[0], points.shape[0],
                           queries.shape[1], args[3])
    raise KeyError(f"no cost model for op {name!r}")
