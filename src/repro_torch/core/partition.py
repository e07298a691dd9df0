"""Partitioning S into table-sharing groups (paper Sec. 4.2, Function
Partition) via maximal candidate subsets + greedy weighted set cover.

Pipeline:
  1. Pairwise plan: for every candidate center W_i, compute the derived
     beta_{W_k | center=i} for every target W_k (Eq. 11 with bucket width
     w = r_min^{W_i}); infeasible pairs (x_up >= y_down) get beta = inf.
  2. Candidate sets: for each center, sort targets by beta; every maximal
     prefix with weight = j-th smallest beta <= tau is a candidate set
     (condition (2) of Step 1 — only prefixes at distinct beta values).
  3. Greedy weighted set cover (Chvatal '79, O(ln|S|) approx): repeatedly
     pick the (center, prefix) minimizing weight / #newly-covered.
  4. Deduplicate into a disjoint partition; recompute per-group parameters.

The O(|S|^2 d) pairwise reduction is the planning hot spot; it runs as a
chunked float32 numpy reduction (derived.ratio_bounds).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .derived import derived_sensitivity, ratio_bounds
from .distances import radius_bounds
from .params import PlanConfig, beta_mu, threshold_reduction_factor

__all__ = ["GroupPlan", "PartitionResult", "pairwise_beta", "partition", "tau_min"]


@dataclasses.dataclass
class GroupPlan:
    center_id: int
    member_ids: np.ndarray  # indices into S, ascending beta
    betas: np.ndarray  # per-member beta_{W_i}
    mus: np.ndarray  # per-member collision threshold mu_{W_i}
    mus_reduced: np.ndarray  # after collision-threshold reduction
    beta_group: int  # max over members (tables to build)
    width: float  # bucket width w = r_min^{W_center}
    ratio_cap: float  # r^{S_i}_max/min (b* range, Lemma 1)
    n_levels: np.ndarray  # per-member ceil(log_c r_max/r_min) + 1
    r_min_members: np.ndarray  # per-member r_min^{W_i}


@dataclasses.dataclass
class PartitionResult:
    groups: list[GroupPlan]
    group_of: np.ndarray  # (|S|,) group index for every weight vector
    member_slot: np.ndarray  # (|S|,) position inside the group
    beta_total: int
    tau: float
    n_candidate_sets: int


def _per_weight_radii(weights: np.ndarray, value_range: float, p: float):
    r_min = np.empty(len(weights))
    r_max = np.empty(len(weights))
    for i, w in enumerate(weights):
        r_min[i], r_max[i] = radius_bounds(w, value_range, p)
    return r_min, r_max


def pairwise_beta(
    weights: np.ndarray,
    cfg: PlanConfig,
    value_range: float,
    v: int = 1,
    v_prime: int = 1,
    tau: float | None = None,
):
    """B[i, k] = beta_{W_k | center=i} (inf if infeasible or > tau).

    Also returns (r_min, r_max) per weight vector and the up-bounded radius
    X_UP[i, k] = (r_min^{W_k})^up used later for threshold reduction.
    """
    m = len(weights)
    r_min, r_max = _per_weight_radii(weights, value_range, cfg.p)
    B = np.empty((m, m))
    XUP = np.empty((m, m))
    for i in range(m):
        hi, lo = ratio_bounds(weights[i], weights, v=v, v_prime=v_prime)
        x = r_min
        y = cfg.c * r_min
        x_up, y_down, useful = derived_sensitivity(x, y, hi, lo)
        beta = np.full(m, np.inf)
        if useful.any():
            cap = int(tau) if tau is not None and np.isfinite(tau) else None
            b, _, _, _ = beta_mu(
                x_up[useful], y_down[useful], r_min[i], cfg, beta_cap=cap
            )
            beta[useful] = b
        B[i] = beta
        XUP[i] = x_up
    return B, XUP, r_min, r_max


def tau_min(B: np.ndarray) -> float:
    """max_i beta_{W_i | center=i}: each vector served by its own group."""
    return float(np.max(np.diag(B)))


def _greedy_wsc(B_sorted, order, tau: float):
    """Greedy weighted set cover over nested prefix candidates.

    B_sorted[i, j] = (j+1)-th smallest beta for center i (== prefix weight);
    order[i, j] = target index at that rank.  Returns list of
    (center, prefix_len) chosen sets, in selection order.
    """
    m = B_sorted.shape[0]
    uncovered = np.ones(m, dtype=bool)
    chosen: list[tuple[int, int]] = []
    valid = B_sorted <= tau  # (m, m) prefix admissible
    while uncovered.any():
        # newly-covered count per (center, prefix): cumsum of uncovered in
        # sorted order, zeroed where the prefix is inadmissible.
        unc_sorted = uncovered[order]  # (m, m)
        gain = np.cumsum(unc_sorted, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            eff = np.where(valid & (gain > 0), B_sorted / gain, np.inf)
        flat = np.argmin(eff)
        ci, pj = np.unravel_index(flat, eff.shape)
        if not np.isfinite(eff[ci, pj]):
            raise ValueError(
                "no admissible candidate set covers the remaining weight "
                "vectors; increase tau (>= tau_min)"
            )
        chosen.append((int(ci), int(pj) + 1))
        uncovered[order[ci, : pj + 1]] = False
    return chosen


def partition(
    weights: np.ndarray,
    cfg: PlanConfig,
    value_range: float,
    tau: float,
    v: int = 1,
    v_prime: int = 1,
) -> PartitionResult:
    """Function Partition() + Process(): disjoint groups minimizing beta_S."""
    m = len(weights)
    B, XUP, r_min, r_max = pairwise_beta(
        weights, cfg, value_range, v=v, v_prime=v_prime, tau=tau
    )
    tmin = tau_min(B)
    if tau < tmin:
        raise ValueError(f"tau={tau} < tau_min={tmin}; no feasible partition")

    order = np.argsort(B, axis=1, kind="stable")
    B_sorted = np.take_along_axis(B, order, axis=1)
    n_candidates = int(np.sum(B_sorted <= tau))
    chosen = _greedy_wsc(B_sorted, order, tau)

    # Deduplicate: assign each weight vector to the chosen set with the
    # smallest required beta for it (paper Step 3).
    group_of = np.full(m, -1, dtype=np.int64)
    best_beta = np.full(m, np.inf)
    for gi, (ci, pj) in enumerate(chosen):
        members = order[ci, :pj]
        betas = B[ci, members]
        better = betas < best_beta[members]
        sel = members[better]
        group_of[sel] = gi
        best_beta[sel] = betas[better]
    assert (group_of >= 0).all()

    groups: list[GroupPlan] = []
    member_slot = np.zeros(m, dtype=np.int64)
    kept = 0
    remap = {}
    for gi, (ci, _) in enumerate(chosen):
        members = np.where(group_of == gi)[0]
        if len(members) == 0:
            continue
        remap[gi] = kept
        kept += 1
        members = members[np.argsort(B[ci, members], kind="stable")]
        betas = B[ci, members]
        # Recompute mu on the exact member set (Eq. 12).
        hi, lo = ratio_bounds(weights[ci], weights[members], v=v, v_prime=v_prime)
        x_up, y_down, _ = derived_sensitivity(
            r_min[members], cfg.c * r_min[members], hi, lo
        )
        _, mus, _, _ = beta_mu(x_up, y_down, r_min[ci], cfg)
        xfac = threshold_reduction_factor(x_up, cfg.c, r_min[ci], cfg.p)
        n_levels = (
            np.ceil(
                np.log(np.maximum(r_max[members] / r_min[members], 1.0 + 1e-9))
                / math.log(cfg.c)
            ).astype(np.int64)
            + 1
        )
        ratio_cap = float(np.max(r_max[members] / r_min[members]))
        member_slot[members] = np.arange(len(members))
        groups.append(
            GroupPlan(
                center_id=int(ci),
                member_ids=members,
                betas=betas,
                mus=mus,
                mus_reduced=np.maximum(xfac * mus, 1.0),
                beta_group=int(np.max(betas)),
                width=float(r_min[ci]),
                ratio_cap=ratio_cap,
                n_levels=n_levels,
                r_min_members=r_min[members],
            )
        )
    group_of = np.array([remap[g] for g in group_of], dtype=np.int64)
    beta_total = int(sum(g.beta_group for g in groups))
    return PartitionResult(
        groups=groups,
        group_of=group_of,
        member_slot=member_slot,
        beta_total=beta_total,
        tau=tau,
        n_candidate_sets=n_candidates,
    )
