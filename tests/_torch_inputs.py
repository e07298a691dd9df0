"""Seeded inputs and score tolerances shared by the port's kernel tests.

Kept free of JAX so that the card-only tests can import it on a machine
that has no JAX.
"""

from __future__ import annotations

import numpy as np


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


def assert_scores_close(got, want, qs, qw, pts, p):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if abs(p - 2.0) < 1e-9:
        w2 = qw.astype(np.float64) ** 2
        s2 = (w2 * qs.astype(np.float64) ** 2).sum(1)[:, None] + w2 @ (
            pts.astype(np.float64) ** 2).T
        atol = 1e-6 * np.sqrt(s2)
        assert np.all(np.abs(got[fin] - want[fin]) <= atol[fin])
    else:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)
