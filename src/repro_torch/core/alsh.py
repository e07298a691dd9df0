"""SL-ALSH / S2-ALSH baselines (Lei et al., ICML'19) for the weighted l_2.

Two pieces, matching how the paper uses them:

1. **Space model** (Table 7 / Appendix A): rho_SL (Eq. 17) and rho_S2
   (Eq. 18) by numeric grid minimization; required tables L = n^rho.  Data
   are shifted/rescaled into [0, V]^d (V <= pi), so the radius R entering
   the formulas is R * V / value_range; eta_W = sqrt(d) * ||W/||W||_1||_2.

2. **Query path** (Table 8 / Figs. 8-9): the asymmetric reduction of
   weighted-l2 NN to MIPS via monomial augmentation

       P(o)    = [o^2, o, sqrt(1 - ||.||^2)] / scale      (data, W-independent)
       Q(q, W) = [-w^2, 2 w^2 * q, 0] (normalized)        (query, W-aware)

   so that Q.P is monotone in -D_W(q,o)^2.  SL-ALSH hashes the augmented
   sphere with the p-stable l_2 family (compound m, L tables); S2-ALSH uses
   sign random projections (SimHash) — consistent with the collision
   probabilities appearing in Eqs. 17-18.  Following the paper's protocol
   (Table 12), queries are answered under a *candidate budget* matched to
   WLSH's I/O, sweeping m and keeping the best ratio.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .collision import collision_prob_l2
from .distances import weighted_lp_np
from .params import PlanConfig

__all__ = ["rho_sl", "rho_s2", "alsh_tables", "ALSHIndex"]


def _eta(weights: np.ndarray, d: int) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    w = w / np.sum(np.abs(w), axis=-1, keepdims=True)  # ||W||_1 = 1
    return math.sqrt(d) * np.linalg.norm(w, axis=-1)


def rho_sl(
    weights: np.ndarray,
    R: float,
    c: float,
    value_range: float = 10_000.0,
    w_grid=None,
    v_grid=None,
) -> float:
    """Eq. 17: min over (w, V) of max over W_i of ln P1 / ln P2."""
    d = weights.shape[1]
    eta = _eta(weights, d)
    w_grid = np.geomspace(0.25, 64.0, 25) if w_grid is None else w_grid
    v_grid = np.linspace(0.5, math.pi, 24) if v_grid is None else v_grid
    best = np.inf
    for V in v_grid:
        r = R * V / value_range
        if c * r - V**4 / 12.0 <= r:
            continue
        a1 = np.sqrt(np.maximum(2.0 * eta - 2.0 + r, 1e-12))
        a2 = np.sqrt(np.maximum(2.0 * eta - 2.0 + c * r - V**4 / 12.0, 1e-12))
        for w in w_grid:
            p1 = np.clip(collision_prob_l2(a1, w), 1e-12, 1 - 1e-12)
            p2 = np.clip(collision_prob_l2(a2, w), 1e-12, 1 - 1e-12)
            rho = float(np.max(np.log(p1) / np.log(p2)))
            if 0 < rho < best:
                best = rho
    return best


def rho_s2(
    weights: np.ndarray,
    R: float,
    c: float,
    value_range: float = 10_000.0,
    v_grid=None,
) -> float:
    """Eq. 18: min over V of max over W_i of ln P1 / ln P2 (SimHash form)."""
    d = weights.shape[1]
    eta = _eta(weights, d)
    v_grid = np.linspace(0.5, math.pi, 48) if v_grid is None else v_grid
    best = np.inf
    for V in v_grid:
        r = R * V / value_range
        if c * r - V**4 / 12.0 <= r:
            continue
        x1 = np.clip((1.0 - 0.5 * r) / eta, -1.0, 1.0)
        x2 = np.clip((1.0 - 0.5 * c * r + V**4 / 24.0) / eta, -1.0, 1.0)
        p1 = np.clip(1.0 - np.arccos(x1) / math.pi, 1e-12, 1 - 1e-12)
        p2 = np.clip(1.0 - np.arccos(x2) / math.pi, 1e-12, 1 - 1e-12)
        rho = float(np.max(np.log(p1) / np.log(p2)))
        if 0 < rho < best:
            best = rho
    return best


def alsh_tables(n: int, rho: float) -> int:
    """Required total number of hash tables, L = n^rho (Appendix A)."""
    return int(math.ceil(n**rho))


# --------------------------------------------------------------------------
# Query path: augmented MIPS reduction + (E2LSH | SimHash) on the sphere.
# --------------------------------------------------------------------------


def _augment_data(data: np.ndarray) -> tuple[np.ndarray, float]:
    """Appendix A preconditions: data rescaled into [0, V]^d (V <= pi) by the
    caller; monomial augmentation then stays O(1) per coordinate."""
    o = np.asarray(data, np.float64)
    P = np.concatenate([o**2, o], axis=1)
    scale = float(np.max(np.linalg.norm(P, axis=1))) or 1.0
    P = P / scale
    last = np.sqrt(np.maximum(1.0 - np.sum(P**2, axis=1), 0.0))
    return np.concatenate([P, last[:, None]], axis=1).astype(np.float32), scale


def _augment_query(q: np.ndarray, weight: np.ndarray) -> np.ndarray:
    w2 = np.asarray(weight, np.float64) ** 2
    Q = np.concatenate([-w2, 2.0 * w2 * np.asarray(q, np.float64), [0.0]])
    nrm = np.linalg.norm(Q) or 1.0
    return (Q / nrm).astype(np.float32)


@dataclasses.dataclass
class _Tables:
    proj: np.ndarray  # (L, D, m)
    bias: np.ndarray | None  # (L, m) for SL; None for S2
    codes: np.ndarray  # (L, n, m) per-table compound codes


class ALSHIndex:
    """SL-ALSH (variant='sl') or S2-ALSH (variant='s2') query engine.

    Candidate generation is a *dense multiprobe oracle*: points are ranked
    by total compound-code agreement with the query across all L tables
    (sum over tables of #matching hash dims), and the top ``budget`` are
    checked.  Any physical probing sequence with the same budget retrieves a
    subset of candidates no better-ordered than this, so the baselines'
    reported accuracy is an upper bound — the same only-favors-the-baseline
    stance the paper takes for their table counts (Sec. 5.2.2).
    """

    def __init__(
        self,
        data: np.ndarray,
        cfg: PlanConfig,
        variant: str = "sl",
        m: int = 12,
        L: int = 16,
        width: float = 1.0,
        seed: int = 0,
        value_range: float = 10_000.0,
        V: float = math.pi,
    ):
        assert variant in ("sl", "s2")
        self.data = np.asarray(data, np.float32)
        self.cfg = cfg
        self.variant = variant
        self.m, self.L, self.width = m, L, width
        # Appendix A: rescale data into [0, V]^d, V <= pi (ranking under any
        # W is invariant to the common rescale; weights are L1-normalized at
        # query time).
        self._rescale = V / float(value_range)
        self.aug, self._scale = _augment_data(self.data * self._rescale)
        rng = np.random.default_rng(seed)
        D = self.aug.shape[1]
        proj = rng.standard_normal((L, D, m)).astype(np.float32)
        bias = None
        if variant == "sl":
            bias = rng.uniform(0, width, size=(L, m)).astype(np.float32)
        codes = np.empty((L, len(self.data), m), np.int32)
        for l in range(L):
            u = self.aug @ proj[l]
            if variant == "sl":
                codes[l] = np.floor((u + bias[l]) / width).astype(np.int32)
            else:
                codes[l] = (u >= 0).astype(np.int32)
        self.tables = _Tables(proj=proj, bias=bias, codes=codes)

    def _query_codes(self, aq: np.ndarray) -> np.ndarray:
        """(L, m) compound code of the (augmented) query."""
        u = np.einsum("d,ldm->lm", aq, self.tables.proj)
        if self.variant == "sl":
            return np.floor((u + self.tables.bias) / self.width).astype(
                np.int32
            )
        return (u >= 0).astype(np.int32)

    def query(self, q: np.ndarray, weight: np.ndarray, k: int, budget: int):
        """Check up to ``budget`` candidates; return (ids, dists, n_checked)."""
        w1 = np.asarray(weight, np.float64)
        w1 = w1 / np.sum(np.abs(w1))  # ||W||_1 = 1 (Appendix A)
        aq = _augment_query(np.asarray(q, np.float64) * self._rescale, w1)
        qc = self._query_codes(aq)  # (L, m)
        # agreement score per point: sum over tables/dims of matching hashes
        score = np.einsum(
            "lnm->n", (self.tables.codes == qc[:, None, :]).astype(np.int32)
        )
        budget = min(budget, len(self.data))
        cand = np.argpartition(-score, budget - 1)[:budget]
        ids = np.full(k, -1, dtype=np.int64)
        dists = np.full(k, np.inf)
        d = weighted_lp_np(self.data[cand], q, weight, 2.0)
        top = np.argsort(d, kind="stable")[:k]
        ids[: top.size] = cand[top]
        dists[: top.size] = d[top]
        return ids, dists, len(cand)
