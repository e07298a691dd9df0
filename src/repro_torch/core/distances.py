"""Weighted l_p distance (Definition 4), host-side numpy.

``weighted_lp_np`` is the exact (float64) ground truth of the dense host
oracle and the tests; ``radius_bounds`` feeds the planner.
"""

from __future__ import annotations

import numpy as np

__all__ = ["weighted_lp_np", "radius_bounds"]


def weighted_lp_np(x, y, weight, p: float):
    """D_W(x, y) for the l_p distance in float64; broadcasts over rows."""
    diff = np.abs((np.asarray(x, np.float64) - np.asarray(y, np.float64)) * weight)
    if abs(p - 2.0) < 1e-9:
        return np.sqrt(np.sum(diff * diff, axis=-1))
    if abs(p - 1.0) < 1e-9:
        return np.sum(diff, axis=-1)
    return np.sum(diff**p, axis=-1) ** (1.0 / p)


def radius_bounds(weight, value_range: float, p: float, grid: float = 1.0):
    """(r_min^W, r_max^W): smallest/largest possible distances under W.

    The paper's data are integer-valued in [0, value_range] (Tables 3-4), so
    the smallest nonzero weighted l_p distance is ``min_i w_i * grid`` (two
    points differing by one grid step in the cheapest coordinate) and the
    largest is ``(sum_i (w_i * value_range)^p)^(1/p)``.
    """
    w = np.asarray(weight, dtype=np.float64)
    r_min = float(np.min(w)) * grid
    r_max = float(np.sum((w * value_range) ** p) ** (1.0 / p))
    return r_min, r_max
