"""The plain reference's planner: the paper's Algorithm 1 in numpy.

A frozen copy of the port's host planner (``core/pstable.py``,
``collision.py``, ``derived.py``, ``params.py``, ``partition.py`` and the
family sampler of ``families.py``), kept with the benchmark so that the
reference works out the partition, each member's parameters and each
group's hash family again from the data, the weight set and the seed,
and takes none of them from the program.  It imports nothing of the
program; the arithmetic, precision and random draws are the port's as
of the benchmark's first version.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

# ------------------------------------------------------------ p-stable


def _cms_transform(p, v, e):
    if abs(p - 1.0) < 1e-9:
        return np.tan(v)
    if abs(p - 2.0) < 1e-9:
        s = np.sin(2.0 * v) / np.cos(v) ** 0.5 * (np.cos(-v) / e) ** -0.5
        return s / np.sqrt(2.0)
    return (np.sin(p * v) / np.cos(v) ** (1.0 / p)
            * (np.cos((1.0 - p) * v) / e) ** ((1.0 - p) / p))


def sample_pstable(rng, p, shape):
    """i.i.d. symmetric p-stable samples, drawn as the port draws them."""
    if abs(p - 2.0) < 1e-9:
        return rng.standard_normal(shape)
    if abs(p - 1.0) < 1e-9:
        return rng.standard_cauchy(shape)
    v = rng.uniform(-np.pi / 2 + 1e-12, np.pi / 2 - 1e-12, shape)
    e = rng.exponential(1.0, shape) + 1e-300
    return _cms_transform(p, v, e)


@functools.lru_cache(maxsize=16)
def _pdf_grid(p, umax):
    t_hi = (12.0 * np.log(10.0)) ** (1.0 / p)
    dt = np.pi / (1.05 * umax)
    n = int(2 ** np.ceil(np.log2(max(t_hi / dt, 4096.0))))
    g = np.exp(-((np.arange(n) * dt) ** p))
    f = (np.real(np.fft.rfft(g)) - 0.5 * g[0]) * dt / np.pi
    x = np.arange(len(f)) * (2.0 * np.pi / (n * dt))
    keep = x <= umax
    return x[keep], np.maximum(f[keep], 0.0)


def _pstable_pdf(x, p, umax=200.0):
    x = np.abs(np.asarray(x, dtype=np.float64))
    if abs(p - 2.0) < 1e-9:
        return np.exp(-(x**2) / 2.0) / np.sqrt(2.0 * np.pi)
    if abs(p - 1.0) < 1e-9:
        return 1.0 / (np.pi * (1.0 + x**2))
    u, f = _pdf_grid(p, umax)
    out = np.interp(x, u, f)
    from scipy.special import gamma

    tail = p * np.sin(np.pi * p / 2.0) * gamma(p) / np.pi * np.where(
        x > 0, x, 1.0) ** (-(1.0 + p))
    return np.where(x > umax, tail, out)


# ------------------------------------------------------ collision prob


def collision_prob(r, w, p):
    """P_{l_p}(r): two points at distance r share a bucket of width w."""
    r = np.asarray(r, dtype=np.float64)
    s = w / np.maximum(r, 1e-300)
    if abs(p - 2.0) < 1e-9:
        from scipy.special import ndtr

        out = (1.0 - 2.0 * ndtr(-s) - 2.0 / (np.sqrt(2.0 * np.pi) * s)
               * (1.0 - np.exp(-(s**2) / 2.0)))
    elif abs(p - 1.0) < 1e-9:
        out = 2.0 * np.arctan(s) / np.pi - np.log1p(s**2) / (np.pi * s)
    else:
        r1 = np.atleast_1d(r)
        t = np.linspace(0.0, w, 512)
        tr = t[None, :] / r1[:, None]
        f = np.where(tr >= 0, 2.0 * _pstable_pdf(tr, p), 0.0)
        integ = f / r1[:, None] * (1.0 - t[None, :] / w)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        out = trapezoid(integ, t, axis=1).reshape(r.shape)
    return np.clip(out, 0.0, 1.0)


# ------------------------------------------------------ plan parameters


@dataclasses.dataclass(frozen=True)
class PlanParams:
    p: float
    c: float
    eps: float
    gamma_n: float
    n: int

    @property
    def z(self) -> float:
        gamma = self.gamma_n / self.n
        return math.sqrt(math.log(2.0 / gamma) / math.log(1.0 / self.eps))


def beta_mu(x_up, y_down, width, cfg: PlanParams, beta_cap=None):
    """Eqs. 11-12: (beta, mu) per (x_up, y_down); beta = inf where useless."""
    x_up = np.atleast_1d(np.asarray(x_up, np.float64))
    y_down = np.atleast_1d(np.asarray(y_down, np.float64))
    width = np.broadcast_to(np.asarray(width, np.float64), x_up.shape)
    p1 = np.empty_like(x_up)
    p2 = np.empty_like(x_up)
    for wv in np.unique(width):
        m = width == wv
        p1[m] = collision_prob(x_up[m], float(wv), cfg.p)
        p2[m] = collision_prob(y_down[m], float(wv), cfg.p)
    gap = p1 - p2
    ok = gap > 1e-12
    z = cfg.z
    beta = np.full(x_up.shape, np.inf)
    beta[ok] = np.ceil(math.log(1.0 / cfg.eps) / (2.0 * gap[ok] ** 2)
                       * (1.0 + z) ** 2)
    if beta_cap is not None:
        beta = np.where(beta > beta_cap, np.inf, beta)
    mu = np.where(ok, (z * p1 + p2) / (1.0 + z) * beta, np.inf)
    return beta, mu


def _reduction_factor(r_up, c, width, p):
    r_up = np.asarray(r_up, np.float64)
    num = collision_prob(c * c * r_up, float(width), p)
    den = collision_prob(r_up, float(width), p)
    return np.clip(num / np.maximum(den, 1e-300), 0.0, 1.0)


def _radius_bounds(weight, value_range, p):
    w = np.asarray(weight, dtype=np.float64)
    return float(np.min(w)), float(np.sum((w * value_range) ** p) ** (1.0 / p))


def _ratio_bounds(center, targets, v, v_prime):
    """v-th largest and v'-th smallest of w_i / w'_i, in float32."""
    targets = np.atleast_2d(np.asarray(targets, np.float64)).astype(np.float32)
    center = np.asarray(center, np.float64).astype(np.float32)
    t = center[None, :] / targets
    if v == 1 and v_prime == 1:
        return np.max(t, axis=-1), np.min(t, axis=-1)
    srt = np.sort(t, axis=-1)
    return srt[:, -v], srt[:, v_prime - 1]


def _derived(x, y, hi, lo):
    x_up = np.asarray(x) * hi
    y_down = np.asarray(y) * lo
    return x_up, y_down, (x_up > 0) & (x_up < y_down)


# ------------------------------------------------------------ partition


@dataclasses.dataclass
class RefGroup:
    center_id: int
    member_ids: np.ndarray
    betas: np.ndarray  # int, per member
    mus: np.ndarray  # int32 effective thresholds, per member
    r_min: np.ndarray  # float64, per member
    n_levels: np.ndarray  # int, per member
    beta_group: int
    width: float
    ratio_cap: float


@dataclasses.dataclass
class RefPlan:
    groups: list
    group_of: np.ndarray
    member_slot: np.ndarray
    weights: np.ndarray
    p: float
    c: int
    budget_extra: int  # ceil(gamma * n): the query budget is k + this


def partition(weights, cfg: PlanParams, value_range, tau, v, v_prime):
    """Function Partition() of Sec. 4.2: greedy weighted set cover over
    nested prefix candidates, then one group per chosen set."""
    m = len(weights)
    radii = [_radius_bounds(w, value_range, cfg.p) for w in weights]
    r_min = np.array([r[0] for r in radii])
    r_max = np.array([r[1] for r in radii])
    B = np.empty((m, m))
    for i in range(m):
        hi, lo = _ratio_bounds(weights[i], weights, v, v_prime)
        x_up, y_down, useful = _derived(r_min, cfg.c * r_min, hi, lo)
        row = np.full(m, np.inf)
        if useful.any():
            cap = int(tau) if np.isfinite(tau) else None
            row[useful] = beta_mu(x_up[useful], y_down[useful], r_min[i],
                                  cfg, beta_cap=cap)[0]
        B[i] = row
    if tau < float(np.max(np.diag(B))):
        raise ValueError("tau below tau_min: no feasible partition")
    order = np.argsort(B, axis=1, kind="stable")
    B_sorted = np.take_along_axis(B, order, axis=1)
    uncovered = np.ones(m, dtype=bool)
    chosen = []
    valid = B_sorted <= tau
    while uncovered.any():
        gain = np.cumsum(uncovered[order], axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            eff = np.where(valid & (gain > 0), B_sorted / gain, np.inf)
        ci, pj = np.unravel_index(np.argmin(eff), eff.shape)
        if not np.isfinite(eff[ci, pj]):
            raise ValueError("no admissible candidate set")
        chosen.append((int(ci), int(pj) + 1))
        uncovered[order[ci, : pj + 1]] = False
    group_of = np.full(m, -1, dtype=np.int64)
    best = np.full(m, np.inf)
    for gi, (ci, pj) in enumerate(chosen):
        members = order[ci, :pj]
        betas = B[ci, members]
        better = betas < best[members]
        group_of[members[better]] = gi
        best[members[better]] = betas[better]
    groups, member_slot, remap = [], np.zeros(m, dtype=np.int64), {}
    for gi, (ci, _) in enumerate(chosen):
        members = np.where(group_of == gi)[0]
        if len(members) == 0:
            continue
        remap[gi] = len(groups)
        members = members[np.argsort(B[ci, members], kind="stable")]
        betas = B[ci, members]
        hi, lo = _ratio_bounds(weights[ci], weights[members], v, v_prime)
        x_up, y_down, _ = _derived(r_min[members], cfg.c * r_min[members],
                                   hi, lo)
        _, mus = beta_mu(x_up, y_down, r_min[ci], cfg)
        reduced = np.maximum(_reduction_factor(x_up, cfg.c, r_min[ci], cfg.p)
                             * mus, 1.0)
        n_levels = np.ceil(np.log(np.maximum(r_max[members] / r_min[members],
                                             1.0 + 1e-9))
                           / math.log(cfg.c)).astype(np.int64) + 1
        member_slot[members] = np.arange(len(members))
        groups.append(RefGroup(
            center_id=int(ci), member_ids=members,
            betas=betas.astype(np.int64),
            mus=np.maximum(1, np.ceil(reduced - 1e-9)).astype(np.int32),
            r_min=r_min[members], n_levels=n_levels,
            beta_group=int(np.max(betas)), width=float(r_min[ci]),
            ratio_cap=float(np.max(r_max[members] / r_min[members]))))
    group_of = np.array([remap[g] for g in group_of], dtype=np.int64)
    return groups, group_of, member_slot


def sample_family(d, beta, p, width, center_weight, ratio_cap, c, seed):
    """beta functions of H_{a,b*,W_center} (Eq. 7), as the port samples
    them: ``b*/w`` split into an exact integer and a fraction."""
    rng = np.random.default_rng(seed)
    f = max(int(round(c ** math.ceil(math.log(max(ratio_cap, 1.0 + 1e-9),
                                              c)))), 1)
    proj = sample_pstable(rng, p, (d, beta)).astype(np.float32)
    b_int = rng.integers(0, f, size=(beta,), dtype=np.int64).astype(np.int32)
    b_frac = rng.uniform(0.0, 1.0, size=(beta,)).astype(np.float32)
    return dict(proj=proj, b_int=b_int, b_frac=b_frac, width=float(width),
                center_weight=np.asarray(center_weight, np.float32))


def plan(weights, config: dict, n: int, seed: int):
    """(RefPlan, [family of each group]) for ``weights`` under ``config``
    (the configuration file's planner keys), families seeded from
    ``seed`` as the index seeds them (``seed + 7919 * group``)."""
    weights = np.asarray(weights, np.float64)
    cfg = PlanParams(p=float(config["p"]), c=float(config["c"]),
                     eps=float(config["eps"]),
                     gamma_n=float(config["gamma_n"]), n=n)
    groups, group_of, member_slot = partition(
        weights, cfg, float(config["value_range"]), float(config["tau"]),
        int(config["v"]), int(config["v_prime"]))
    fams = [sample_family(weights.shape[1], g.beta_group, cfg.p, g.width,
                          weights[g.center_id], g.ratio_cap, cfg.c,
                          seed + 7919 * gi)
            for gi, g in enumerate(groups)]
    ref = RefPlan(groups=groups, group_of=group_of, member_slot=member_slot,
                  weights=weights, p=cfg.p, c=int(round(cfg.c)),
                  budget_extra=int(math.ceil(cfg.gamma_n)))
    return ref, fams
