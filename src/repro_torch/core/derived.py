"""Derived weighted LSH families: Theorem 1 bounds + bound relaxation.

Given tables built for center weight W and a query weight W', the derived
family H_{W->W'} hashes identically but its sensitivity bounds shrink:

  l_p:  R^up = R * max_i(w_i / w'_i),   (cR)^down = cR * min_i(w_i / w'_i)

Bound relaxation (Eqs. 14-15) replaces max/min with the v-th largest /
v'-th smallest of T = {w_i / w'_i}; v = v' = 1 recovers Theorem 1.  The
derived family is *useful* iff x^up < y^down for x = r_min^{W'},
y = c r_min^{W'}.

The ratio reduction runs in **float32**, weights included: the planner's
reference formulation computes T in single precision, and a partition is
only reproducible if every ratio bound rounds the same way (a float64
ratio can land on the other side of a beta bucket).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ratio_bounds", "derived_sensitivity", "angular_bounds"]


def _ratio_reduce(center: np.ndarray, targets: np.ndarray, v: int,
                  v_prime: int):
    """(hi, lo) where hi = v-th largest, lo = v'-th smallest of w_i/w'_i."""
    t = center[None, :] / targets  # (m, d) float32
    if v == 1 and v_prime == 1:
        return np.max(t, axis=-1), np.min(t, axis=-1)
    srt = np.sort(t, axis=-1)
    return srt[:, -v], srt[:, v_prime - 1]


def ratio_bounds(
    center: np.ndarray,
    targets: np.ndarray,
    v: int = 1,
    v_prime: int = 1,
    chunk: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """T^{(v)} and T^{(d+1-v')} per target weight vector (Eqs. 14-15).

    Returns float32 arrays (see the module note on precision).
    """
    targets = np.atleast_2d(np.asarray(targets, np.float64)).astype(np.float32)
    center = np.asarray(center, np.float64).astype(np.float32)
    his, los = [], []
    for i in range(0, len(targets), chunk):
        h, l = _ratio_reduce(center, targets[i : i + chunk], v, v_prime)
        his.append(h)
        los.append(l)
    return np.concatenate(his), np.concatenate(los)


def derived_sensitivity(
    x: np.ndarray, y: np.ndarray, hi: np.ndarray, lo: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x_up, y_down, useful) for the derived family at radii (x, y=c x).

    x_up = x * hi, y_down = y * lo (Theorem 2); useful iff 0 < x_up < y_down.
    """
    x_up = np.asarray(x) * hi
    y_down = np.asarray(y) * lo
    useful = (x_up > 0) & (x_up < y_down)
    return x_up, y_down, useful


def angular_bounds(center, target, R: float, c: float):
    """Theorem 1(3) bounds for the angular distance (reference only), in
    float64: (R^up, (cR)^down) of the family built for ``center`` and
    queried under ``target``."""
    t2 = (np.asarray(center, np.float64) / np.asarray(target, np.float64)) ** 2
    M, N = float(np.max(t2)), float(np.min(t2))
    X = np.cos(R) + (N - M) / M
    Y = M * np.cos(c * R) / N + (M - N) / N
    r_up = np.arccos(max(-1.0, X))
    cr_down = np.arccos(min(1.0, Y))
    return r_up, cr_down
