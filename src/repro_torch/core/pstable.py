"""p-stable distributions: sampling, densities, and |X| PDFs (numpy).

The p-stable family underlies the l_p LSH functions (Datar et al., SoCG'04):
``h(x) = floor((a.x + b)/w)`` with entries of ``a`` drawn i.i.d. from the
symmetric p-stable distribution.  p=2 is the standard normal, p=1 is the
standard Cauchy; general p in (0,2) has no closed-form density and is
sampled with the Chambers-Mallows-Stuck (CMS) method and evaluated
numerically via the characteristic-function inversion

    f_p(x) = (1/pi) * int_0^inf cos(t x) exp(-t^p) dt.

Everything here is host-side numpy: these quantities feed index planning
(Eqs. 11-12) and the family sampler, never the device hot path.  Samples
are drawn from a seeded ``numpy.random.Generator`` exactly as the JAX
package's planner draws them, so both packages sample identical families.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["sample_pstable_np", "pstable_pdf", "pstable_pdf_abs"]


def _cms_transform(p: float, v, e, xp):
    """Chambers-Mallows-Stuck transform for symmetric p-stable.

    v ~ Uniform(-pi/2, pi/2), e ~ Exp(1).  Works for p in (0, 2]; p == 1
    reduces to tan(v) (Cauchy), p == 2 reduces to a scaled normal.
    """
    if abs(p - 1.0) < 1e-9:
        return xp.tan(v)
    if abs(p - 2.0) < 1e-9:
        # CMS at p=2 yields N(0, 2); rescale to the standard normal used by
        # the classical E2LSH family.
        s = xp.sin(2.0 * v) / xp.cos(v) ** (1.0 / 2.0) * (
            xp.cos(-v) / e
        ) ** ((1.0 - 2.0) / 2.0)
        return s / np.sqrt(2.0)
    s = (
        xp.sin(p * v)
        / xp.cos(v) ** (1.0 / p)
        * (xp.cos((1.0 - p) * v) / e) ** ((1.0 - p) / p)
    )
    return s


def sample_pstable_np(rng: np.random.Generator, p: float, shape) -> np.ndarray:
    """Draw i.i.d. symmetric p-stable samples (numpy, host-side)."""
    if abs(p - 2.0) < 1e-9:
        return rng.standard_normal(shape)
    if abs(p - 1.0) < 1e-9:
        return rng.standard_cauchy(shape)
    v = rng.uniform(-np.pi / 2 + 1e-12, np.pi / 2 - 1e-12, shape)
    e = rng.exponential(1.0, shape) + 1e-300
    return _cms_transform(p, v, e, np)


@functools.lru_cache(maxsize=64)
def _pdf_grid(p: float, umax: float, n_grid: int):
    """Tabulate f_p on [0, umax] via FFT characteristic-function inversion.

    f(x) = (1/pi) int_0^inf cos(tx) exp(-t^p) dt.  A plain quadrature
    aliases badly for small p (slow exp(-t^p) decay x fast cos(tx)
    oscillation); sampling t on the FFT-conjugate grid makes every
    oscillation exactly resolved: with t_j = j*dt, x_k = 2 pi k/(N dt),
    sum_j g_j cos(t_j x_k) = Re FFT(g)[k].
    """
    del n_grid  # grid density is set by the FFT length below
    # integrand support: cut where exp(-t^p) < 1e-12
    t_hi = (12.0 * np.log(10.0)) ** (1.0 / p)
    dt = np.pi / (1.05 * umax)  # x-range covers umax with margin
    n = int(2 ** np.ceil(np.log2(max(t_hi / dt, 4096.0))))
    t = np.arange(n) * dt
    g = np.exp(-(t**p))
    spec = np.fft.rfft(g)
    # trapezoid: half-weight the j=0 endpoint
    f = (np.real(spec) - 0.5 * g[0]) * dt / np.pi
    x = np.arange(len(f)) * (2.0 * np.pi / (n * dt))
    keep = x <= umax
    return x[keep], np.maximum(f[keep], 0.0)


def pstable_pdf(x, p: float, umax: float = 200.0, n_grid: int = 8192):
    """Density of the symmetric p-stable distribution (numpy, vectorized).

    Closed forms for p in {1, 2}; numeric inversion otherwise.  The numeric
    tail beyond ``umax`` is approximated by the exact asymptotic power law
    f_p(x) ~ p * sin(pi p / 2) * Gamma(p) / pi * x^{-(1+p)}.
    """
    x = np.abs(np.asarray(x, dtype=np.float64))
    if abs(p - 2.0) < 1e-9:
        return np.exp(-(x**2) / 2.0) / np.sqrt(2.0 * np.pi)
    if abs(p - 1.0) < 1e-9:
        return 1.0 / (np.pi * (1.0 + x**2))
    u, f = _pdf_grid(p, umax, n_grid)
    out = np.interp(x, u, f)
    try:  # pragma: no cover - scipy is available in this environment
        from scipy.special import gamma as _gamma

        tail = p * np.sin(np.pi * p / 2.0) * _gamma(p) / np.pi * np.where(
            x > 0, x, 1.0
        ) ** (-(1.0 + p))
        out = np.where(x > umax, tail, out)
    except Exception:
        pass
    return out


def pstable_pdf_abs(x, p: float):
    """PDF F_p of |X| for X symmetric p-stable (the paper's F_p)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, 2.0 * pstable_pdf(x, p), 0.0)
