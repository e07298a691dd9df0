"""The yardstick's copy of the port's cost model and the card's peak rates.

``Cost`` and the kernel functions below are a frozen copy of
``repro_torch.kernels.cost`` (operations by unit and bytes moved, from
the shapes of one launch), and ``HW`` of the rates in
``repro_torch.launch.roofline.HW``: the published peaks of one NVIDIA
H100 SXM at its 700 W limit.  The benchmark keeps its own copy so that a
change to the program's model cannot move the per-layer rooflines;
``perfbench/tests/test_perfbench_metrics.py`` holds the two equal at the
benchmark's shapes.  ``topk`` and ``rerank`` are the benchmark's own:
the least bytes the query step's selection and exact re-rank must move.
The fused passes also take ``code_bytes``, the width of a stored bucket
id (4 in the program's model; 8 where a configuration stores 64 bits).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's peak rates (NVIDIA H100 SXM data sheet, 700 W)."""

    hbm_bw: float = 3.35e12  # bytes/s
    f32_flops: float = 67e12  # an FMA counts two
    f32_ops: float = 132 * 128 * 1.98e9  # 128 lanes an SM, 132 SMs, boost
    int32_ops: float = 132 * 64 * 1.98e9
    sfu_ops: float = 132 * 16 * 1.98e9  # sqrt, log2, exp2
    name: str = "NVIDIA H100 80GB HBM3, 700 W"


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

    def ops_s(self, hw: HW) -> float:
        """Seconds of the busiest unit at its peak rate."""
        return max(self.f32_flops / hw.f32_flops, self.f32_ops / hw.f32_ops,
                   self.int32_ops / hw.int32_ops, self.sfu_ops / hw.sfu_ops)

    def bound(self, hw: HW) -> tuple[float, str]:
        """(least seconds, "bytes" or "operations": what sets them)."""
        bytes_s, ops_s = self.bytes / hw.hbm_bw, self.ops_s(hw)
        return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                     else "operations")


def _lp_terms(p: float) -> dict:
    return dict(f32_ops=3, sfu_ops={1.0: 0, 0.5: 1}.get(float(p), 2))


def _fused(n, beta, q, d, vec_bytes, p, tests, out_bytes,
           code_bytes) -> Cost:
    tests = q * beta * n if tests is None else tests
    terms = q * n * d
    if abs(p - 2.0) < 1e-9:
        work = dict(f32_flops=4 * terms)
    else:
        work = {k: v * terms for k, v in _lp_terms(p).items()}
    read = (code_bytes * (n * beta + q * beta) + 4 * (2 * q * d + 4 * q)
            + vec_bytes * n * d)
    return Cost(int32_ops=tests, bytes_read=read, bytes_written=out_bytes,
                **work)


def fused_query_hist(n, beta, q, d, n_levels, vec_bytes=4, p=2.0,
                     tests=None, code_bytes=4) -> Cost:
    """Pass 1 over ``n`` rows: two (Q, L+3) int32 histograms out."""
    return _fused(n, beta, q, d, vec_bytes, p, tests,
                  2 * 4 * q * (n_levels + 3), code_bytes)


def fused_query_scores(n, beta, q, d, vec_bytes=4, p=2.0,
                       tests=None, code_bytes=4) -> Cost:
    """Pass 2 over ``n`` rows: (Q, n) float32 scores out."""
    return _fused(n, beta, q, d, vec_bytes, p, tests, 4 * q * n, code_bytes)


def topk(n, q, k) -> Cost:
    """The k smallest of (Q, n) float32 scores: each score read once,
    (Q, k) values and int32 ids written."""
    return Cost(bytes_read=4 * q * n, bytes_written=8 * q * k)


def rerank(q, k, d, vec_bytes=4) -> Cost:
    """Exact distances of the (Q, k) survivors: their rows, the queries
    and weights read, (Q, k) values and ids written."""
    return Cost(f32_ops=3 * q * k * d,
                bytes_read=vec_bytes * q * k * d + 4 * (2 * q * d + q * k),
                bytes_written=8 * q * k)


def step_least_s(launch: dict, hw: HW = HW()) -> float:
    """Least seconds of one query-step launch: both fused passes, the
    top-k and the re-rank, each at its own bound.

    ``launch`` holds the state's ``n``, ``beta``, ``d``, ``q``, ``k``,
    ``n_levels``, ``vec_bytes``, ``code_bytes`` (of a stored bucket id),
    ``p`` and ``tests``: the level tests the launch's queries need (each
    query tests its own member's tables).
    """
    n, beta, q, d = launch["n"], launch["beta"], launch["q"], launch["d"]
    kw = dict(vec_bytes=launch["vec_bytes"], p=launch["p"],
              tests=launch["tests"], code_bytes=launch["code_bytes"])
    parts = (fused_query_hist(n, beta, q, d, launch["n_levels"], **kw),
             fused_query_scores(n, beta, q, d, **kw),
             topk(n, q, launch["k"]),
             rerank(q, launch["k"], d, launch["vec_bytes"]))
    return sum(c.bound(hw)[0] for c in parts)
