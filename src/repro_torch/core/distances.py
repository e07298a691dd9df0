"""Weighted distance functions (Definition 4) for l_p, Hamming and
angular, host-side numpy.

``weighted_lp_np`` is the exact (float64) ground truth of the dense host
oracle and the tests; ``radius_bounds`` feeds the planner.  The Hamming
and angular forms (Appendix B) are references only: the index serves l_p.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "weighted_lp_np",
    "weighted_hamming_np",
    "weighted_angular_np",
    "radius_bounds",
]


def weighted_lp_np(x, y, weight, p: float):
    """D_W(x, y) for the l_p distance in float64; broadcasts over rows."""
    diff = np.abs((np.asarray(x, np.float64) - np.asarray(y, np.float64)) * weight)
    if abs(p - 2.0) < 1e-9:
        return np.sqrt(np.sum(diff * diff, axis=-1))
    if abs(p - 1.0) < 1e-9:
        return np.sum(diff, axis=-1)
    return np.sum(diff**p, axis=-1) ** (1.0 / p)


def weighted_hamming_np(x, y, weight):
    """Weighted Hamming: sum of w_i over differing coordinates (App. B)."""
    return np.sum(np.asarray(weight) * (np.asarray(x) != np.asarray(y)), axis=-1)


def weighted_angular_np(x, y, weight):
    """Angle between W o x and W o y in float64, in [0, pi] (App. B)."""
    wx = np.asarray(x, np.float64) * weight
    wy = np.asarray(y, np.float64) * weight
    num = np.sum(wx * wy, axis=-1)
    den = np.linalg.norm(wx, axis=-1) * np.linalg.norm(wy, axis=-1)
    return np.arccos(np.clip(num / np.maximum(den, 1e-300), -1.0, 1.0))


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
