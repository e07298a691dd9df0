"""Seeded pass inputs for holding the fused passes to their plain
versions: codes that reach every level, and codes at the edges of the
kernels' digit-word level test.  numpy only; the card checks in
``chip_smoke.py`` and the port's tests share them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["EDGE_CODES", "make_edge_inputs", "make_pass_inputs"]


def make_pass_inputs(n, d, beta, q, c, L, seed=0):
    """Codes that agree with their query at every level 0..L+1 (and never).

    Each row copies one query's codes and perturbs each lane by up to
    c**j for a per-row j, so first-agreement levels spread over the whole
    level range; codes straddle zero to exercise floor division.
    """
    rng = np.random.default_rng(seed)
    cq = rng.integers(-(c ** (L + 2)), c ** (L + 2), (q, beta)).astype(np.int32)
    src = rng.integers(0, q, n)
    j = rng.integers(0, L + 3, n)
    noise = rng.integers(-1, 2, (n, beta)) * (
        rng.integers(0, 3, (n, beta)) * c ** j[:, None])
    cp = (cq[src] + noise).astype(np.int32)
    pts = rng.uniform(0, 1000, (n, d)).astype(np.float32)
    qs = rng.uniform(0, 1000, (q, d)).astype(np.float32)
    qw = rng.uniform(1, 10, (q, d)).astype(np.float32)
    mu = rng.integers(1, max(2, beta // 2), q).astype(np.int32)
    beta_q = rng.integers(max(1, beta // 2), beta + 1, q).astype(np.int32)
    r_min = rng.uniform(10.0, 200.0, q).astype(np.float32)
    stop = rng.integers(0, L + 1, q).astype(np.int32)
    return cp, cq, pts, qs, qw, mu, beta_q, r_min, stop


# codes at the edges of the kernel's digit-word level test: the int32
# extremes (p = 0.5 codes saturate there), the signs' meeting point, and
# c = 3's +-3^19 and 3^20 - 2^31 (the least a + 3^20)
EDGE_CODES = (-(2**31), 2**31 - 1, -1, 0, 1, 3**19, -(3**19), 3**20 - 2**31)


def make_edge_inputs(n, d, beta, q, c, L, seed=0):
    """``make_pass_inputs``' tuple with codes at the level test's edges.

    Query codes are uniform over int32, with 30% of the lanes from
    ``EDGE_CODES``.  70% of the rows copy one query's codes and move each
    lane by 0 or +-c^k (k up to the highest int32 digit), saturating at
    the int32 range, with 5% of the lanes from ``EDGE_CODES``; the rest are
    uniform.  mu is small (0..beta/8), so first frequent levels spread.
    """
    cp, cq, pts, qs, qw, mu, beta_q, r_min, stop = make_pass_inputs(
        n, d, beta, q, c, min(L, 8), seed)
    rng = np.random.default_rng(seed + 1)
    lo, hi = -(2**31), 2**31
    edge = np.array(EDGE_CODES, np.int64)
    cq = rng.integers(lo, hi, (q, beta))
    pick = rng.random(cq.shape) < 0.3
    cq[pick] = rng.choice(edge, int(pick.sum()))
    k = rng.integers(0, 21 if c == 3 else 31, (n, beta))
    step = rng.integers(-1, 2, (n, beta)) * np.power(np.int64(c), k)
    near = np.clip(cq[rng.integers(0, q, n)] + step, lo, hi - 1)
    cp = np.where(rng.random((n, 1)) < 0.7, near, rng.integers(lo, hi,
                                                                (n, beta)))
    pick = rng.random(cp.shape) < 0.05
    cp[pick] = rng.choice(edge, int(pick.sum()))
    mu = rng.integers(0, max(2, beta // 8), q).astype(np.int32)
    stop = rng.integers(0, L + 1, q).astype(np.int32)
    return (cp.astype(np.int32), cq.astype(np.int32), pts, qs, qw, mu,
            beta_q, r_min, stop)
