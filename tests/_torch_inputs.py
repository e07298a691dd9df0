"""Seeded inputs and score tolerances shared by the port's kernel tests.

Kept free of JAX so that the card-only tests can import it on a machine
that has no JAX.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.probe_inputs import (  # noqa: F401
    EDGE_CODES, make_edge_inputs, make_pass_inputs)


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
