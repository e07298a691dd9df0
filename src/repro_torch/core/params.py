"""C2LSH/WLSH parameter planning: beta / mu from Eqs. 4-5 and 11-12.

For a weight vector W_i served by tables centered at W_center:

    z    = sqrt(ln(2/gamma) / ln(1/eps))
    beta = ceil( ln(1/eps) / (2 (P(x_up) - P(y_down))^2) * (1+z)^2 )
    mu   = (z P(x_up) + P(y_down)) / (1+z) * beta

with x = r_min^{W_i}, y = c x, and x_up / y_down the derived-family bounds
(x_up = x, y_down = y when W_i == W_center, recovering C2LSH Eqs. 4-5).

``P`` is the collision probability at bucket width w (paper sets
w = r_min^{W_center}).  Collision-threshold reduction (Sec. 4.2.1) scales mu
by X = P((c^2 r)^up) / P((r)^up) < 1.

Defaults follow the paper: eps = 0.01, gamma = 100/n.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .collision import collision_prob

__all__ = ["PlanConfig", "beta_mu", "threshold_reduction_factor", "z_value"]


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    p: float = 2.0
    c: float = 3.0
    eps: float = 0.01
    gamma_n: float = 100.0  # gamma * n (paper: gamma = 100/n)
    n: int = 400_000

    @property
    def gamma(self) -> float:
        return self.gamma_n / self.n

    @property
    def z(self) -> float:
        return z_value(self.eps, self.gamma)


def z_value(eps: float, gamma: float) -> float:
    return math.sqrt(math.log(2.0 / gamma) / math.log(1.0 / eps))


def beta_mu(
    x_up,
    y_down,
    width,
    cfg: PlanConfig,
    beta_cap: int | None = None,
):
    """Vectorized Eqs. 11-12.

    Returns (beta, mu, p1, p2) arrays; entries where the derived family is
    useless (P(x_up) <= P(y_down)) get beta = inf.
    ``width`` may be scalar or per-entry (bucket width of the serving group).
    """
    x_up = np.atleast_1d(np.asarray(x_up, np.float64))
    y_down = np.atleast_1d(np.asarray(y_down, np.float64))
    width = np.broadcast_to(np.asarray(width, np.float64), x_up.shape)
    z = cfg.z
    p1 = np.empty_like(x_up)
    p2 = np.empty_like(x_up)
    # collision_prob is vectorized over r at fixed w; group by distinct widths
    for wv in np.unique(width):
        m = width == wv
        p1[m] = collision_prob(x_up[m], float(wv), cfg.p)
        p2[m] = collision_prob(y_down[m], float(wv), cfg.p)
    gap = p1 - p2
    ok = gap > 1e-12
    ln1e = math.log(1.0 / cfg.eps)
    beta = np.full(x_up.shape, np.inf)
    beta[ok] = np.ceil(ln1e / (2.0 * gap[ok] ** 2) * (1.0 + z) ** 2)
    if beta_cap is not None:
        beta = np.where(beta > beta_cap, np.inf, beta)
    mu = np.where(ok, (z * p1 + p2) / (1.0 + z) * beta, np.inf)
    return beta, mu, p1, p2


def threshold_reduction_factor(r_up, c: float, width, p: float):
    """X = P((c^2 r)^up) / P((r)^up) < 1 (Sec. 4.2.1).

    ``r_up`` is (r_min^{W_i})^up under the serving group's center; the c^2
    scaling commutes with the up-bound for l_p (Theorem 1(1) is linear in R).
    """
    r_up = np.asarray(r_up, np.float64)
    num = collision_prob(c * c * r_up, float(width), p)
    den = collision_prob(r_up, float(width), p)
    return np.clip(num / np.maximum(den, 1e-300), 0.0, 1.0)
