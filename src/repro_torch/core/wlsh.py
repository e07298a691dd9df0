"""WLSH index: Preprocess (Algorithm 1) + the dense host oracle, numpy.

The planner partitions the weight vector set into table groups, samples
each group's hash family and computes its host codes; ``export_serving_plan``
hands the result to the device layers as a ``ServingPlan``.
``search_dense`` is the single-pass dense formulation of the paper's
Search (Algorithm 2) in numpy, the oracle the device engine is held to.

Glossary against the paper:
  * group            = S_i in the partition (one physical table group)
  * plan.betas/mus   = beta_{W_i}, mu_{W_i} from Eqs. 11-12
  * level j          = radius R = r_min^{W_i} * c^j, bucket = floor(h / c^j)
  * stop conditions  = (1) k (R,c)-WNNs found; (2) k + gamma*n candidates
                       checked at some radius
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .distances import weighted_lp_np
from .families import LpFamilyParams, hash_codes_np, sample_lp_family
from .params import PlanConfig
from .partition import GroupPlan, PartitionResult, partition
from .serving_plan import GroupServingPlan, ServingPlan

__all__ = ["WLSHIndex", "SearchResult", "SearchStats"]


@dataclasses.dataclass
class SearchStats:
    stop_level: int
    n_checked: int  # candidates whose exact distance was computed
    n_collisions: int  # (point, table) pairs colliding at the stop level
    found_k: bool


@dataclasses.dataclass
class SearchResult:
    ids: np.ndarray  # (k,) indices into the data set (-1 = missing)
    dists: np.ndarray  # (k,) distances under the query weight
    stats: SearchStats


@dataclasses.dataclass
class BuiltGroup:
    plan: GroupPlan
    fam: LpFamilyParams
    codes: np.ndarray  # (n, beta) int32 raw codes (dense path / export)
    _sorted: tuple[np.ndarray, np.ndarray] | None = None

    def sorted_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(sorted_codes, sorted_ids), each (beta, n) int32, built on demand.

        Only the host C2LSH level loop reads the per-table sorted order, so
        it is computed on first use: at n = 400k and beta ~ 450 the argsort
        costs tens of seconds per group.
        """
        if self._sorted is None:
            order = np.argsort(self.codes, axis=0, kind="stable")
            sorted_codes = np.take_along_axis(self.codes, order, axis=0).T.copy()
            self._sorted = (sorted_codes, order.T.astype(np.int32).copy())
        return self._sorted


class WLSHIndex:
    """Multi-weight (c, k)-WNN index over one data set.

    Parameters follow the paper: ``tau`` caps per-group tables, ``v/v_prime``
    enable bound relaxation (1/1 = strict Theorem 1), ``use_reduction``
    applies collision-threshold reduction at query time.
    """

    def __init__(
        self,
        data: np.ndarray,
        weights: np.ndarray,
        cfg: PlanConfig,
        tau: float,
        value_range: float = 10_000.0,
        v: int = 1,
        v_prime: int = 1,
        use_reduction: bool = True,
        seed: int = 0,
        materialize: bool = False,
    ):
        if abs(cfg.c - round(cfg.c)) > 1e-9 or cfg.c < 2:
            raise ValueError("virtual rehashing requires integer c >= 2")
        self.data = np.asarray(data, dtype=np.float32)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.cfg = dataclasses.replace(cfg, n=len(self.data))
        self.tau = tau
        self.value_range = value_range
        self.v, self.v_prime = v, v_prime
        self.use_reduction = use_reduction
        self.seed = seed
        self.part: PartitionResult = partition(
            self.weights, self.cfg, value_range, tau, v=v, v_prime=v_prime
        )
        self._built: dict[int, BuiltGroup] = {}
        if materialize:
            for gi in range(len(self.part.groups)):
                self._group(gi)

    # ------------------------------------------------------------------ build

    @property
    def beta_total(self) -> int:
        return self.part.beta_total

    @property
    def n(self) -> int:
        return len(self.data)

    def _group(self, gi: int) -> BuiltGroup:
        if gi in self._built:
            return self._built[gi]
        plan = self.part.groups[gi]
        fam = sample_lp_family(
            d=self.data.shape[1],
            beta=plan.beta_group,
            p=self.cfg.p,
            width=plan.width,
            center_weight=self.weights[plan.center_id],
            ratio_cap=plan.ratio_cap,
            c=self.cfg.c,
            seed=self.seed + 7919 * gi,
        )
        built = BuiltGroup(plan=plan, fam=fam,
                           codes=hash_codes_np(self.data, fam))
        self._built[gi] = built
        return built

    # ----------------------------------------------------------------- export

    def _effective_mus(self, plan: GroupPlan) -> np.ndarray:
        """Per-member integer collision thresholds (reduction applied)."""
        mus = plan.mus_reduced if self.use_reduction else plan.mus
        return np.maximum(1, np.ceil(mus - 1e-9)).astype(np.int32)

    def export_serving_plan(self, include_codes: bool = True) -> ServingPlan:
        """Flat, serializable description of every table group.

        This is the only core -> device handoff: the engine and the
        retrieval service consume the plan, never `WLSHIndex` internals.
        ``include_codes`` ships the host-computed bucket codes so the
        device engine reproduces the host oracle's candidate sets exactly.
        """
        groups = []
        for gi in range(len(self.part.groups)):
            built = self._group(gi)
            plan = built.plan
            groups.append(
                GroupServingPlan(
                    group_id=gi,
                    center_id=int(plan.center_id),
                    beta_group=int(plan.beta_group),
                    width=float(built.fam.width),
                    levels_cap=int(built.fam.levels_cap),
                    member_ids=plan.member_ids.astype(np.int64),
                    beta_members=plan.betas.astype(np.int32),
                    mu_members=self._effective_mus(plan),
                    r_min_members=plan.r_min_members.astype(np.float64),
                    n_levels_members=plan.n_levels.astype(np.int32),
                    proj=built.fam.proj,
                    b_int=built.fam.b_int,
                    b_frac=built.fam.b_frac,
                    center_weight=built.fam.center_weight,
                    p=float(self.cfg.p),
                    codes=built.codes if include_codes else None,
                )
            )
        return ServingPlan(
            n=self.n,
            d=self.data.shape[1],
            p=float(self.cfg.p),
            c=int(round(self.cfg.c)),
            gamma_n=float(self.cfg.gamma_n),
            tau=float(self.part.tau),
            weights=self.weights.copy(),
            group_of=self.part.group_of.copy(),
            member_slot=self.part.member_slot.copy(),
            groups=tuple(groups),
            corpus_epoch=self.n,
        )

    # ----------------------------------------------------------------- search

    def _member_params(self, weight_id: int):
        gi = int(self.part.group_of[weight_id])
        built = self._group(gi)
        slot = int(self.part.member_slot[weight_id])
        plan = built.plan
        beta_i = int(plan.betas[slot])
        mu_i = int(self._effective_mus(plan)[slot])
        return built, slot, beta_i, mu_i

    @staticmethod
    def _c_eff(cfg_c: float, c: float | None) -> int:
        """Resolve an optional approximation-ratio override to int >= 2."""
        c_eff = cfg_c if c is None else c
        if c_eff != int(round(c_eff)) or int(round(c_eff)) < 2:
            raise ValueError(
                f"approximation ratio c must be an integer >= 2, got {c_eff}"
            )
        return int(round(c_eff))

    def search_dense(
        self, q: np.ndarray, weight_id: int, k: int = 1,
        c: float | None = None,
    ) -> SearchResult:
        """Single-pass dense search (the device formulation, numpy oracle).

        Computes jmin per (point, table), takes the mu-th order statistic to
        get L_freq, then applies the paper's stop conditions level-by-level
        analytically.  ``c`` optionally overrides the configured
        approximation ratio (an integer >= the planned one).
        """
        built, slot, beta_i, mu_i = self._member_params(weight_id)
        plan = built.plan
        w_i = self.weights[weight_id]
        r_min = float(plan.r_min_members[slot])
        n_levels = int(plan.n_levels[slot])
        c = self._c_eff(self.cfg.c, c)
        n = self.n
        budget = k + int(math.ceil(self.cfg.gamma_n))  # == gamma * n, float-exact

        q = np.asarray(q, dtype=np.float32)
        q_codes = hash_codes_np(q[None, :], built.fam)[0][:beta_i]
        codes = built.codes[:, :beta_i]

        # codes are int32, so the int32 floor division is exact
        jmin = np.full((n, beta_i), n_levels + 1, dtype=np.int16)
        a = codes.astype(np.int32)
        b = q_codes.astype(np.int32)
        for j in range(n_levels + 1):
            eq = (a == b[None, :]) & (jmin > n_levels)
            jmin[eq] = j
            a = a // c
            b = b // c
        if mu_i > beta_i:
            l_freq = np.full(n, n_levels + 1, dtype=np.int16)
        else:
            l_freq = np.partition(jmin, mu_i - 1, axis=1)[:, mu_i - 1]

        dists = weighted_lp_np(self.data, q, w_i, self.cfg.p)
        stop_level, n_checked, found_k = n_levels, 0, False
        for j in range(n_levels + 1):
            freq = l_freq <= j
            n_freq = int(np.sum(freq))
            n_chk = min(n_freq, budget)
            R = r_min * (c**j)
            n_good = int(np.sum(freq & (dists <= c * R)))
            if n_good >= k or n_chk >= budget:
                stop_level, n_checked, found_k = j, n_chk, n_good >= k
                break
            n_checked = n_chk
        freq = l_freq <= stop_level
        idx = np.where(freq)[0]
        top = idx[np.argsort(dists[idx], kind="stable")[:k]]
        out_ids = np.full(k, -1, dtype=np.int64)
        out_d = np.full(k, np.inf)
        out_ids[: top.size] = top
        out_d[: top.size] = dists[top]
        stats = SearchStats(
            stop_level=stop_level,
            n_checked=n_checked,
            n_collisions=int(np.sum(jmin <= stop_level)),
            found_k=found_k,
        )
        return SearchResult(ids=out_ids, dists=out_d, stats=stats)
