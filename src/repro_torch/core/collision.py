"""Collision probability functions P_{l_p}(r) for the p-stable LSH family.

P_{l_p}(r) = int_0^w (1/r) F_p(t/r) (1 - t/w) dt     (paper Sec. 2.2)

with F_p the PDF of |X| for symmetric p-stable X.  Closed forms exist for
p = 2 (Gaussian) and p = 1 (Cauchy) [Datar et al. '04]:

  p=2:  P(r) = 1 - 2 Phi(-w/r) - 2/(sqrt(2 pi) w/r) (1 - exp(-w^2/(2 r^2)))
  p=1:  P(r) = 2 arctan(w/r)/pi - 1/(pi w/r) ln(1 + (w/r)^2)

General p in (0,2) is evaluated with fixed quadrature over the numeric
p-stable density.  All functions are numpy (host-side planning math) and
vectorized over r.

Assumption 1 of the paper (P decreasing in r) holds for every family here;
``tests/test_collision.py`` checks it property-style.
"""

from __future__ import annotations

import numpy as np

from .pstable import pstable_pdf_abs

__all__ = ["collision_prob", "collision_prob_l2", "collision_prob_l1"]

_SQRT2PI = np.sqrt(2.0 * np.pi)


def _norm_cdf(x):
    try:
        from scipy.special import ndtr
    except ImportError:  # pragma: no cover - scalar fallback without scipy
        from math import erf

        return np.vectorize(lambda t: 0.5 * (1.0 + erf(t / np.sqrt(2.0))))(x)
    return ndtr(x)


def collision_prob_l2(r, w: float):
    """Closed-form P_{l_2}(r) for bucket width w."""
    r = np.asarray(r, dtype=np.float64)
    s = w / np.maximum(r, 1e-300)
    return (
        1.0
        - 2.0 * _norm_cdf(-s)
        - 2.0 / (_SQRT2PI * s) * (1.0 - np.exp(-(s**2) / 2.0))
    )


def collision_prob_l1(r, w: float):
    """Closed-form P_{l_1}(r) for bucket width w."""
    r = np.asarray(r, dtype=np.float64)
    s = w / np.maximum(r, 1e-300)
    return 2.0 * np.arctan(s) / np.pi - np.log1p(s**2) / (np.pi * s)


def _collision_prob_numeric(r, w: float, p: float, n_quad: int = 512):
    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    t = np.linspace(0.0, w, n_quad)
    # integrand(r, t) = (1/r) F_p(t/r) (1 - t/w)
    tr = t[None, :] / r[:, None]
    f = pstable_pdf_abs(tr, p)
    integ = f / r[:, None] * (1.0 - t[None, :] / w)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    out = trapezoid(integ, t, axis=1)
    return out


def collision_prob(r, w: float, p: float):
    """P_{l_p}(r): probability two points at l_p distance r collide.

    Vectorized over ``r``; scalar in ``w`` (bucket width) and ``p``.
    """
    if w <= 0:
        raise ValueError(f"bucket width must be positive, got {w}")
    if not (0.0 < p <= 2.0):
        raise ValueError(f"p must be in (0, 2], got {p}")
    scalar = np.isscalar(r) or np.ndim(r) == 0
    if abs(p - 2.0) < 1e-9:
        out = collision_prob_l2(r, w)
    elif abs(p - 1.0) < 1e-9:
        out = collision_prob_l1(r, w)
    else:
        out = _collision_prob_numeric(r, w, p)
    out = np.clip(out, 0.0, 1.0)
    return float(np.asarray(out).reshape(-1)[0]) if scalar else out
