"""Batching core of the synchronous retrieval frontend.

The paper's query procedure (Algorithm 2) answers each query inside its
weight's table group; everything the frontend does around that is
frontend-independent:

  route     (query, weight_id) -> plan.group_of[weight_id]     Batcher.route
  coalesce  same-group submission indices -> q_batch chunks    coalesce()
  pad       ragged tails cycle the batch's real rows           pad_take()
  execute   one query step per *shape signature* (groups       Batcher.run_batch
            quantized onto beta/level buckets share a step
            through QueryStepCache)
  merge     real rows scattered back to submission order       run_plans()

``coalesce``/``pad_take``/``run_plans``/``merge_topk`` are pure numpy.
``Batcher`` owns the stateful side: every group's state resident on the
service's device (built on first use or by ``warmup``), the step cache,
query encoding and per-group serving counters.  Query codes come from the
same encoding as the group's data codes: host float64 when the plan ships
host codes, the device encode (``hash_encode``) when the state was built
on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.serving_plan import ServingPlan
from ..index.builder import build_group_state, pad_cols
from ..index.config import IndexConfig, pad_beta, pad_levels
from ..index.engine import QueryState, QueryStepCache, encode_queries
from ..kernels import platform as kplatform

__all__ = [
    "BatchPlan",
    "Batcher",
    "GroupServeStats",
    "ServiceConfig",
    "coalesce",
    "merge_topk",
    "pad_take",
    "run_plans",
]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving-side knobs (plan parameters come from the ServingPlan)."""

    k: int = 10
    q_batch: int = 8  # batch shape; ragged tails are padded
    vec_dtype: str = "float32"
    use_kernels: bool | str = "on"  # kernel path (kernels.platform): "on"
    # = fused passes (CUDA kernels on the card, plain torch on the CPU),
    # "off" = unfused oracle; True/False are normalized below
    beta_buckets: tuple[int, ...] | None = None  # None = config.pad_beta
    level_step: int = 4  # level-loop bound rounding (config.pad_levels)
    budget_override: int | None = None  # None = k + ceil(gamma * n)
    n_shards: int = 1  # devices each group's rows are sharded across
    device: str = "cuda"  # where the group states live and queries run

    def __post_init__(self):
        object.__setattr__(self, "use_kernels",
                           kplatform.normalize(self.use_kernels))
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.q_batch < 1:
            raise ValueError(f"q_batch must be >= 1, got {self.q_batch}")
        if self.level_step < 1:
            raise ValueError(f"level_step must be >= 1, got {self.level_step}")
        if self.budget_override is not None and self.budget_override < 1:
            raise ValueError(
                f"budget_override must be >= 1 or None, got "
                f"{self.budget_override}"
            )
        if self.beta_buckets is not None and (
            len(self.beta_buckets) == 0
            or any(b < 1 for b in self.beta_buckets)
        ):
            raise ValueError(
                f"beta_buckets must be a non-empty tuple of positive table "
                f"counts or None, got {self.beta_buckets!r}"
            )
        if self.n_shards != 1:
            raise NotImplementedError(
                f"n_shards={self.n_shards}: sharding group states across "
                f"devices is not ported yet"
            )
        if self.vec_dtype != "float32":
            raise NotImplementedError(
                f"vec_dtype {self.vec_dtype!r}: only float32 vector "
                f"storage is supported so far"
            )


# --------------------------------------------------------------- pure helpers


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One step launch: up to q_batch same-group submission rows."""

    group_id: int
    rows: np.ndarray  # global submission indices, submission order


def pad_take(n_real: int, q_batch: int) -> np.ndarray:
    """Gather indices padding ``n_real`` rows to a full ``q_batch``.

    Padding cycles the real rows (a real query repeated is still a valid
    query for the step); callers slice outputs back to ``[:n_real]`` so
    padded rows never reach a result.
    """
    if not 1 <= n_real <= q_batch:
        raise ValueError(
            f"n_real must be in [1, q_batch={q_batch}], got {n_real}"
        )
    return np.arange(q_batch) % n_real


def coalesce(group_ids: np.ndarray, q_batch: int) -> list[BatchPlan]:
    """Stable-partition submission indices by group and chunk into batches.

    Within each group the submission order is preserved; every index lands
    in exactly one plan and every plan holds 1..q_batch rows of one group.
    """
    if q_batch < 1:
        raise ValueError(f"q_batch must be >= 1, got {q_batch}")
    group_ids = np.atleast_1d(np.asarray(group_ids))
    plans: list[BatchPlan] = []
    for gi in np.unique(group_ids):
        sel = np.where(group_ids == gi)[0]  # ascending = submission order
        for lo in range(0, len(sel), q_batch):
            plans.append(BatchPlan(int(gi), sel[lo : lo + q_batch]))
    return plans


def run_plans(plans, queries, weight_ids, run_batch, k):
    """Execute every BatchPlan and merge outputs back to submission order.

    ``run_batch(group_id, queries, weight_ids)`` must return per-row
    ``(ids, dists, stop_levels, n_checked)`` for exactly the real rows it
    was handed (padding is its private business).
    """
    nq = len(queries)
    out_ids = np.full((nq, k), -1, np.int32)
    out_d = np.full((nq, k), np.inf, np.float32)
    out_stop = np.zeros(nq, np.int32)
    out_chk = np.zeros(nq, np.int32)
    for bp in plans:
        ids, d, stop, chk = run_batch(
            bp.group_id, queries[bp.rows], weight_ids[bp.rows]
        )
        out_ids[bp.rows] = ids
        out_d[bp.rows] = d
        out_stop[bp.rows] = stop
        out_chk[bp.rows] = chk
    return out_ids, out_d, out_stop, out_chk


def merge_topk(ids, dists, extra_ids, extra_dists, k, drop=None):
    """Merge indexed hits with extra (delta-scan) hits into per-row top-k.

    ``ids``/``dists`` are the index path's per-row candidates (sorted
    ascending, -1/inf = missing); ``extra_ids``/``extra_dists`` further
    exact hits (same conventions, disjoint ids).  ``drop`` is a tombstone
    id set: dropped ids never appear, their slots backfilled from the
    remaining candidates.  Invariants:

    * exactly ``k`` columns, sorted ascending by distance, missing slots
      -1/inf at the end (also when the inputs hold fewer than k slots)
    * no candidate duplicated or invented; tombstoned ids filtered
    * distance ties prefer the indexed operand (then lower slot), so with
      no extra hits and no tombstones the indexed rows pass through
      bit-exactly
    """
    ids = np.atleast_2d(np.asarray(ids)).astype(np.int64)
    dists = np.atleast_2d(np.asarray(dists, np.float32))
    extra_ids = np.atleast_2d(np.asarray(extra_ids)).astype(np.int64)
    extra_dists = np.atleast_2d(np.asarray(extra_dists, np.float32))
    rows = max(len(ids), len(extra_ids))
    if ids.shape[1] == 0:
        ids = np.zeros((rows, 0), np.int64)
        dists = np.zeros((rows, 0), np.float32)
    if extra_ids.shape[1] == 0:
        extra_ids = np.zeros((rows, 0), np.int64)
        extra_dists = np.zeros((rows, 0), np.float32)
    short = max(0, k - ids.shape[1] - extra_ids.shape[1])
    cand_ids = np.concatenate(
        [ids, extra_ids, np.full((rows, short), -1, np.int64)], axis=1)
    cand_d = np.concatenate(
        [dists, extra_dists, np.full((rows, short), np.inf, np.float32)],
        axis=1)
    invalid = cand_ids < 0
    if drop:
        tomb = np.fromiter(drop, np.int64, count=len(drop))
        invalid |= np.isin(cand_ids, tomb)
    cand_d = np.where(invalid, np.float32(np.inf), cand_d)
    cand_ids = np.where(invalid, np.int64(-1), cand_ids)
    order = np.argsort(cand_d, axis=1, kind="stable")[:, :k]
    out_ids = np.take_along_axis(cand_ids, order, axis=1)
    out_d = np.take_along_axis(cand_d, order, axis=1)
    out_ids = np.where(np.isinf(out_d), np.int64(-1), out_ids)
    return out_ids.astype(np.int32), out_d.astype(np.float32)


# ---------------------------------------------------------------------- stats


@dataclasses.dataclass
class GroupServeStats:
    """Per-group serving counters since the service was built."""

    n_queries: int = 0
    n_batches: int = 0
    n_padded: int = 0
    stop_level_sum: int = 0
    n_checked_sum: int = 0

    @property
    def occupancy(self) -> float:
        """Real-row fraction of the launched (padded) batch rows."""
        filled = self.n_queries + self.n_padded
        return self.n_queries / filled if filled else 0.0

    def summary(self) -> dict:
        """Flat per-group report consumed by the launcher."""
        nq = self.n_queries
        return dict(
            n_queries=nq,
            n_batches=self.n_batches,
            occupancy=self.occupancy,
            mean_stop_level=self.stop_level_sum / nq if nq else float("nan"),
            mean_n_checked=self.n_checked_sum / nq if nq else float("nan"),
        )


# --------------------------------------------------------------------- core


class Batcher:
    """Stateful batching core: resident group states, steps, stats.

    Every group's state stays resident on ``cfg.device`` once built: it is
    built on the group's first launch, or by ``warmup``.  ``step_cache``
    counts distinct shape signatures, which stays far below the group count
    on real plans.
    """

    def __init__(self, plan: ServingPlan, points: np.ndarray,
                 cfg: ServiceConfig | None = None):
        if cfg is None:
            cfg = ServiceConfig()
        points = np.ascontiguousarray(points, dtype=np.float32)
        if points.shape != (plan.n, plan.d):
            raise ValueError(
                f"points shape {points.shape} != plan ({plan.n}, {plan.d})"
            )
        self.plan = plan
        self.points = points
        self.cfg = cfg
        self.device = kplatform.resolve_device(cfg.device)
        self.step_cache = QueryStepCache()
        self.states: dict[int, QueryState] = {}
        self._group_cfgs: dict[int, IndexConfig] = {}
        self.stats: dict[int, GroupServeStats] = {
            gi: GroupServeStats() for gi in range(plan.n_groups)
        }

    # ------------------------------------------------------------- per group

    def group_config(self, gi: int) -> IndexConfig:
        """Padded IndexConfig for group ``gi`` (the step-cache key)."""
        cfg = self._group_cfgs.get(gi)
        if cfg is None:
            g = self.plan.groups[gi]
            cfg = IndexConfig(
                n=self.plan.n,
                d=self.plan.d,
                beta=pad_beta(g.beta_group, self.cfg.beta_buckets),
                q_batch=self.cfg.q_batch,
                k=self.cfg.k,
                c=int(self.plan.c),
                n_levels=pad_levels(g.n_levels_max, self.cfg.level_step),
                p=self.plan.p,
                gamma_n=self.plan.gamma_n,
                budget_override=self.cfg.budget_override,
                vec_dtype=self.cfg.vec_dtype,
                use_kernels=self.cfg.use_kernels,
                n_shards=self.cfg.n_shards,
            )
            self._group_cfgs[gi] = cfg
        return cfg

    def state(self, gi: int) -> QueryState:
        """Group ``gi``'s resident state, built on first use."""
        st = self.states.get(gi)
        if st is None:
            st = build_group_state(self.group_config(gi), self.points,
                                   self.plan.groups[gi], device=self.device)
            self.states[gi] = st
        return st

    def warmup(self, groups=None) -> None:
        """Build states and steps ahead of traffic."""
        gids = groups if groups is not None else range(self.plan.n_groups)
        for gi in gids:
            self.step_cache.get(self.device, self.group_config(int(gi)))
            self.state(int(gi))

    @property
    def resident_bytes(self) -> int:
        """Device bytes held by the resident group states."""
        return sum(st.nbytes for st in self.states.values())

    def stats_summary(self) -> dict[int, dict]:
        """Per-group summaries for groups that served at least one batch."""
        return {gi: s.summary() for gi, s in self.stats.items()
                if s.n_batches}

    # --------------------------------------------------------------- serving

    def route(self, weight_ids) -> np.ndarray:
        """(Q,) serving group per weight_id, validated against the plan."""
        weight_ids = np.atleast_1d(np.asarray(weight_ids, np.int64))
        if len(weight_ids) and (
            weight_ids.min() < 0 or weight_ids.max() >= self.plan.n_weights
        ):
            raise ValueError("weight_id out of range for the serving plan")
        return self.plan.group_of[weight_ids].astype(np.int32)

    def run_batch(self, gi: int, queries, weight_ids):
        """One step launch for 1..q_batch same-group requests.

        Pads ragged input by cycling the real rows, encodes the queries
        and returns ``(ids, dists, stop_levels, n_checked)`` sliced back to
        the real rows.  Host f64 query codes pair only with plan-shipped
        host codes; a device-built (f32) state needs device-encoded
        queries, or floor-boundary jitter mixes the two encodings and a
        query can miss its own point.  Both encodes are row-independent,
        so padding cannot perturb real rows: the host path encodes each
        real row once and gathers, the device path encodes the padded
        batch.
        """
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        weight_ids = np.atleast_1d(np.asarray(weight_ids, np.int64))
        cfg = self.group_config(gi)
        step = self.step_cache.get(self.device, cfg)
        real = len(queries)
        take = pad_take(real, cfg.q_batch)
        g = self.plan.groups[gi]
        wtake = weight_ids[take]
        slots = self.plan.member_slot[wtake]
        dev = self.device
        state = self.state(gi)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

        q_dev = put(queries[take], np.float32)
        if g.codes is None:
            codes = encode_queries(state, q_dev)
        else:
            codes = put(pad_cols(g.encode_host(queries), cfg.beta)[take],
                        np.int32)
        d_b, i_b, stop_b, chk_b = step(
            state,
            q_dev,
            codes,
            put(self.plan.weights[wtake], np.float32),
            put(g.mu_members[slots], np.int32),
            put(g.r_min_members[slots], np.float32),
            put(g.beta_members[slots], np.int32),
            put(g.n_levels_members[slots], np.int32),
        )
        ids = i_b.cpu().numpy()[:real]
        dists = d_b.cpu().numpy()[:real]
        stop = stop_b.cpu().numpy()[:real]
        chk = chk_b.cpu().numpy()[:real]
        s = self.stats[gi]
        s.n_batches += 1
        s.n_queries += real
        s.n_padded += cfg.q_batch - real
        s.stop_level_sum += int(np.sum(stop))
        s.n_checked_sum += int(np.sum(chk))
        return ids, dists, stop, chk
