"""Shared batching core for the retrieval frontends.

The paper's query procedure (Algorithm 2) answers each query inside its
weight's table group; everything a serving frontend does around that is
frontend-independent.  This module is that shared core, consumed by the
synchronous ``RetrievalService`` (all queries present up front) and the
asynchronous ``AsyncRetrievalService`` (queries trickle in and batches
launch on fill or deadline):

  route     (query, weight_id) -> plan.group_of[weight_id]     Batcher.route
  coalesce  same-group submission indices -> q_batch chunks    coalesce()
  pad       ragged tails cycle the batch's real rows           pad_take()
  execute   one query step per *shape signature* (groups       Batcher.run_batch
            quantized onto beta/level buckets share a step
            through QueryStepCache)
  merge     real rows scattered back to submission order       run_plans()

``coalesce``/``pad_take``/``run_plans``/``merge_topk`` are pure numpy.
``Batcher`` owns the stateful side: per-group device states paged through
a budgeted ``StateCache`` (lazy build, LRU eviction, host offload and
restore through ``index.builder.StatePager``), the step cache, query
encoding, and the serving counters in one ``obs.MetricsRegistry``.  Every
launch leases its group's state from the cache and pins it only for the
launch, so deadline-driven partial launches cannot thrash each other's
states.  Query codes come from the same encoding as the group's data
codes: host float64 when the plan ships host codes, the device encode
(``hash_encode``) when the state was built on the device.  Streaming
writes go to a lazily created ``delta.DeltaIndex``; every state holds
``ServiceConfig.delta_reserve_rows`` rows of capacity past the corpus
for its compactions (``row_capacity``).  With ``ServiceConfig.obs`` the
core also stamps per-query trace spans, attributes step builds and
dispatch time per shape signature, and (``recall_sample_rate``) offers
sampled answers to the shadow recall estimator: host bookkeeping that
leaves every answer bit for bit as it is.  With ``ServiceConfig.n_shards
> 1`` (or an explicit ``Batcher(devices=...)``) every group state's rows
are split across devices (``distributed.group_sharding``); the frontends
see no difference.  Each layer boundary is a layer span
(``obs.trace.span``, ``Batcher.span``): ``wlsh_route``, and per launch
``wlsh_batch`` holding ``wlsh_lease``, ``wlsh_encode``, ``wlsh_upload``,
``wlsh_step``, ``wlsh_download``, ``wlsh_release`` and ``wlsh_merge``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..core.serving_plan import ServingPlan
from ..distributed import group_sharding
from ..index.builder import StatePager, build_group_state, pad_cols
from ..index.config import VEC_DTYPES, IndexConfig, pad_beta, pad_levels
from ..index.engine import QueryStepCache, encode_queries
from ..kernels import platform as kplatform
from ..obs import MetricsRegistry, Profiler, RecallEstimator, Tracer
from ..obs.trace import span
from .qos import DegradeStep
from .state_cache import StateCache

_NULL_SCOPE = contextlib.nullcontext()  # profiler-off dispatch scope

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
    vec_dtype: str = "float32"  # group-state vector storage: "float32" or
    # "bfloat16" (half the bytes; every distance is still computed in f32)
    use_kernels: bool | str = "on"  # kernel path (kernels.platform): "on"
    # = fused passes (CUDA kernels on the card, plain torch on the CPU),
    # "off" = unfused oracle; True/False are normalized below
    beta_buckets: tuple[int, ...] | None = None  # None = config.pad_beta
    level_step: int = 4  # level-loop bound rounding (config.pad_levels)
    budget_override: int | None = None  # None = k + ceil(gamma * n)
    max_delay_ms: float = 5.0  # async frontend: a partial batch launches
    # once its oldest request has waited this long (0 = launch on next poll)
    max_resident_groups: int | None = None  # StateCache: keep at most this
    # many group states on device (None = all groups stay resident)
    device_budget_bytes: int | None = None  # StateCache: keep resident
    # state bytes (IndexConfig.state_nbytes accounting, times the shards
    # that share the fullest device) under this budget
    offload_evicted: bool = True  # evicted states keep a host copy (restore
    # = one upload); False discards them (re-acquire rebuilds from scratch)
    delta_seal_rows: int = 1024  # streaming: a group's open delta memtable
    # seals into a hashed segment at this row count
    delta_reserve_rows: int = 0  # row capacity reserved per group state for
    # compacted inserts; 0 = static index (inserts still serve from the
    # delta scan, but compaction has nowhere to append)
    auto_compact_segments: int | None = None  # compact a group once it
    # holds this many sealed segments (None = compaction only on explicit
    # compact() calls / the async frontend's idle poll)
    max_pending: int | None = None  # async backpressure: cap per-group
    # pending buffers; submit raises Overloaded instead of growing unbounded
    n_shards: int = 1  # devices each group's rows are sharded across
    # (distributed.group_sharding.serving_devices: cuda:0 .. cuda:S-1, or
    # S CPU devices); per-shard passes merge exactly, so answers are bit
    # for bit those of one device.  An explicit Batcher(devices=...) wins
    obs: bool = False  # observability: per-query trace spans (obs.Tracer)
    # and profiling hooks (obs.Profiler) on the serving path.  Host-side
    # bookkeeping only: results are bit-exact on or off.  The metrics
    # registry (Batcher.metrics) always exists regardless: the stats
    # surfaces are views over it
    obs_trace_capacity: int = 4096  # tracer ring: retain at most this
    # many finished spans (older spans fall off; totals stay exact)
    degrade_ladder: tuple = ()  # pre-planned (c, k) relaxation rungs
    # (qos.DegradeStep, mildest first).  Rung 0 is this config's strict
    # (plan.c, k); rung r >= 1 serves at degrade_ladder[r - 1].  Every
    # rung's step is built at warmup (c/k are shape-signature keys), and
    # rung answers with k' < k are padded -1/inf back to k so result
    # shapes never change
    recall_sample_rate: float = 0.0  # shadow-exact recall telemetry:
    # sample this fraction of served queries (deterministic hash of the
    # span's query id, no wall randomness) into shadow jobs re-ranked
    # against the exact host oracle off the serving path.  > 0 implies
    # obs (spans carry the query identity); answers stay bit-exact
    recall_shadow_max: int = 1024  # shadow queue depth cap; offers
    # beyond it are dropped and counted, never buffered unbounded
    recall_shadow_slice: int = 8  # shadow jobs executed per idle tick
    # (ServiceDriver idle_work), so shadow re-ranking never competes
    # with deadline launches
    recall_floor: float = 0.0  # observed-recall reference bound for the
    # strict rung 0 (rungs >= 1 use degrade_ladder[r-1].recall_bound);
    # feeds the wlsh_recall_bound_margin gauge and the below-bound alert
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
        if not (self.max_delay_ms >= 0):  # also rejects NaN
            raise ValueError(
                f"max_delay_ms must be >= 0, got {self.max_delay_ms}"
            )
        if self.max_resident_groups is not None and (
            self.max_resident_groups < 1
        ):
            raise ValueError(
                f"max_resident_groups must be >= 1 or None, got "
                f"{self.max_resident_groups}"
            )
        if self.device_budget_bytes is not None and (
            self.device_budget_bytes < 1
        ):
            raise ValueError(
                f"device_budget_bytes must be >= 1 or None, got "
                f"{self.device_budget_bytes}"
            )
        if self.delta_seal_rows < 1:
            raise ValueError(
                f"delta_seal_rows must be >= 1, got {self.delta_seal_rows}"
            )
        if self.delta_reserve_rows < 0:
            raise ValueError(
                f"delta_reserve_rows must be >= 0, got "
                f"{self.delta_reserve_rows}"
            )
        if self.auto_compact_segments is not None and (
            self.auto_compact_segments < 1
        ):
            raise ValueError(
                f"auto_compact_segments must be >= 1 or None, got "
                f"{self.auto_compact_segments}"
            )
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None, got {self.max_pending}"
            )
        if self.obs_trace_capacity < 1:
            raise ValueError(
                f"obs_trace_capacity must be >= 1, got "
                f"{self.obs_trace_capacity}"
            )
        for i, step in enumerate(self.degrade_ladder):
            if not isinstance(step, DegradeStep):
                raise ValueError(
                    f"degrade_ladder[{i}] must be a qos.DegradeStep, got "
                    f"{step!r}"
                )
            if step.k > self.k:
                raise ValueError(
                    f"degrade_ladder[{i}].k={step.k} exceeds the strict "
                    f"k={self.k} (relaxation must not widen results)"
                )
        if not (0.0 <= self.recall_sample_rate <= 1.0):  # also rejects NaN
            raise ValueError(
                f"recall_sample_rate must be in [0, 1], got "
                f"{self.recall_sample_rate}"
            )
        if self.recall_shadow_max < 1:
            raise ValueError(
                f"recall_shadow_max must be >= 1, got "
                f"{self.recall_shadow_max}"
            )
        if self.recall_shadow_slice < 1:
            raise ValueError(
                f"recall_shadow_slice must be >= 1, got "
                f"{self.recall_shadow_slice}"
            )
        if not (0.0 <= self.recall_floor <= 1.0):
            raise ValueError(
                f"recall_floor must be in [0, 1], got {self.recall_floor}"
            )
        if self.recall_sample_rate > 0 and not self.obs:
            # shadow sampling keys on the tracer's query ids; force the
            # obs layer on (bit-exact either way) rather than silently
            # sampling nothing
            object.__setattr__(self, "obs", True)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.vec_dtype not in VEC_DTYPES:
            raise NotImplementedError(
                f"vec_dtype {self.vec_dtype!r}: vectors are stored as one "
                f"of {VEC_DTYPES}"
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


def run_plans(plans, queries, weight_ids, run_batch, k, spans=None):
    """Execute every BatchPlan and merge outputs back to submission order.

    ``run_batch(group_id, queries, weight_ids)`` must return per-row
    ``(ids, dists, stop_levels, n_checked)`` for exactly the real rows it
    was handed (padding is its private business).

    ``spans`` (optional) is one ``obs.TraceSpan`` per submission row;
    each launch is handed its rows' spans through a ``spans=`` keyword so
    the executor can stamp launch-side stages.  Executors without the
    keyword keep working: it is only passed when spans are present.
    """
    nq = len(queries)
    out_ids = np.full((nq, k), -1, np.int32)
    out_d = np.full((nq, k), np.inf, np.float32)
    out_stop = np.zeros(nq, np.int32)
    out_chk = np.zeros(nq, np.int32)
    for bp in plans:
        kw = {}
        if spans is not None:
            kw["spans"] = [spans[i] for i in bp.rows]
        ids, d, stop, chk = run_batch(
            bp.group_id, queries[bp.rows], weight_ids[bp.rows], **kw
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


class GroupServeStats:
    """Per-group serving counters (reset with ``Batcher.reset_stats``).

    A read-only view over the stack's ``obs.MetricsRegistry``:
    ``Batcher.run_batch`` and the ``StateCache`` increment the registry
    counters directly, and each attribute here reads the value labeled
    with this view's group.  Running sums, not samples, so a long-lived
    service never grows state with traffic.
    """

    # attribute -> registry counter (all labeled {group=<gi>})
    _COUNTERS = {
        "n_queries": "wlsh_group_queries_total",
        "n_batches": "wlsh_group_batches_total",
        "n_padded": "wlsh_group_padded_rows_total",
        "stop_level_sum": "wlsh_group_stop_levels_total",
        "n_checked_sum": "wlsh_group_checked_total",
        # state-paging counters, shared with CacheStats (same series)
        "n_state_hits": "wlsh_state_hits_total",
        "n_state_builds": "wlsh_state_builds_total",
        "n_state_restores": "wlsh_state_restores_total",
        "n_state_evictions": "wlsh_state_evictions_total",
        "n_state_invalidations": "wlsh_state_invalidations_total",
        "n_state_prefetches": "wlsh_state_prefetches_total",
        "n_state_prefetch_wasted": "wlsh_state_prefetch_wasted_total",
        "n_state_restore_overlapped":
            "wlsh_state_restore_overlapped_total",
    }

    def __init__(self, metrics: MetricsRegistry, group_id: int):
        """View over ``metrics`` restricted to ``group_id``'s series."""
        self._metrics = metrics
        self._group_id = int(group_id)

    def __getattr__(self, name: str) -> int:
        """Read the registry counter backing attribute ``name``."""
        metric = self._COUNTERS.get(name)
        if metric is None:
            raise AttributeError(name)
        return int(
            self._metrics.counter(metric).value(group=self._group_id)
        )

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
            n_state_hits=self.n_state_hits,
            n_state_builds=self.n_state_builds,
            n_state_restores=self.n_state_restores,
            n_state_evictions=self.n_state_evictions,
            n_state_invalidations=self.n_state_invalidations,
            n_state_prefetches=self.n_state_prefetches,
            n_state_prefetch_wasted=self.n_state_prefetch_wasted,
            n_state_restore_overlapped=self.n_state_restore_overlapped,
        )


# --------------------------------------------------------------------- core


class Batcher:
    """Stateful batching core shared by the sync and async frontends.

    States and steps are built lazily per group (call ``warmup`` to
    front-load them); ``step_cache.n_compiled`` counts distinct shape
    signatures, which stays far below the group count on real plans.

    Group states live in a budgeted ``StateCache``: under
    ``cfg.max_resident_groups`` / ``cfg.device_budget_bytes`` the
    least-recently-used groups are evicted (offloaded to host memory by
    default, through ``self.pager``) and restored on their next launch,
    bit for bit.  Every operational counter lands in one
    ``obs.MetricsRegistry`` (``self.metrics``, shared with the state
    cache, driver and QoS layers); ``stats``/``cache_summary`` are views
    over it.  With ``cfg.obs`` the batcher also opens per-query
    ``obs.TraceSpan``s (``self.tracer``) and attributes step builds and
    dispatch time per shape signature (``self.profiler``); with
    ``cfg.recall_sample_rate > 0`` it offers sampled answers to the
    shadow recall estimator (``self.recall``).  All host-side: results
    stay bit-exact.  ``self.clock`` is the injectable time source for
    span stamps; the async frontend re-binds it to its own clock, so
    ``ManualClock`` replays trace deterministically.

    ``cfg.n_shards > 1`` splits every group state's rows across that many
    devices (``group_sharding.serving_devices``); ``devices=`` names them
    explicitly and wins over ``cfg.n_shards`` and ``cfg.device``, as the
    JAX package's explicit ``mesh`` does.  It may name one card more than
    once: ``devices=("cuda:0",) * 4`` runs four shards on one card, one
    after another on its stream, which is how a one-card host exercises
    the sharded path.  Answers and merges land on ``devices[0]``
    (``self.device``).
    """

    def __init__(self, plan: ServingPlan, points: np.ndarray,
                 cfg: ServiceConfig | None = None, devices=None):
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
        for i, step in enumerate(cfg.degrade_ladder):
            if step.c < plan.c:
                raise ValueError(
                    f"degrade_ladder[{i}].c={step.c} is below the strict "
                    f"plan c={plan.c} (relaxation must not tighten the "
                    f"approximation ratio)"
                )
        # the shards' devices; an explicit list wins over cfg.n_shards
        if devices is not None:
            devices = tuple(kplatform.resolve_device(d) for d in devices)
            if not devices:
                raise ValueError("devices must name at least one device")
        elif cfg.n_shards > 1:
            devices = group_sharding.serving_devices(cfg.n_shards,
                                                     cfg.device)
        else:
            devices = (kplatform.resolve_device(cfg.device),)
        self.devices = devices
        self.device = devices[0]
        self.clock = time.monotonic  # injectable; async frontend re-binds
        self.metrics = MetricsRegistry()
        self.tracer = (Tracer(cfg.obs_trace_capacity, metrics=self.metrics)
                       if cfg.obs else None)
        self.profiler = Profiler(device=self.device) if cfg.obs else None
        # shadow-exact recall telemetry (obs.recall): sampled served
        # queries are re-ranked against the exact host oracle off the
        # serving path.  None when sampling is off
        self.recall = (RecallEstimator(self)
                       if cfg.recall_sample_rate > 0 else None)
        self._cache_events: list[str] | None = None  # span attribution
        self.step_cache = QueryStepCache()
        if self.profiler is not None:
            self.step_cache.on_compile = (
                lambda c: self.profiler.record_compile(
                    str(c.shape_signature())
                )
            )
        self._group_cfgs: dict[tuple[int, int], IndexConfig] = {}
        self._delta = None  # streaming DeltaIndex, created on first write
        self.pager = StatePager(self.devices)
        on_card = self.device.type == "cuda"
        self.state_cache = StateCache(
            build=self._build_state,
            nbytes_of=self.state_nbytes,
            max_resident_groups=cfg.max_resident_groups,
            device_budget_bytes=cfg.device_budget_bytes,
            offload=self.pager.offload if cfg.offload_evicted else None,
            restore=self.pager.restore if cfg.offload_evicted else None,
            on_event=self._note_cache_event,
            metrics=self.metrics,
            # an asynchronous upload is priced by its copy's device time
            restore_timings=self.pager.restore_timings if on_card else None,
        )
        self.stats: dict[int, GroupServeStats] = {
            gi: GroupServeStats(self.metrics, gi)
            for gi in range(plan.n_groups)
        }

    # ------------------------------------------------------------- per group

    def row_capacity(self) -> int:
        """Row capacity of every group state (base corpus + delta reserve).

        ``ServiceConfig.delta_reserve_rows`` preallocates the rows that
        streaming compaction appends into without changing any shape; the
        capacity is rounded up to a multiple of the shard count so the
        row slices stay even.  All groups share one capacity, which keeps
        the shape-bucket step sharing.
        """
        cap = self.plan.n + self.cfg.delta_reserve_rows
        return cap + (-cap) % self.n_shards

    @property
    def n_shards(self) -> int:
        """Devices every group state's rows are split across."""
        return len(self.devices)

    def state_nbytes(self, gi: int) -> int:
        """Accounted bytes of group ``gi``'s state on its fullest device.

        ``IndexConfig.state_nbytes`` prices one shard's slice; shards that
        share a device (``devices=("cuda:0",) * S``) add up there, so the
        residency budget and ``resident_bytes`` count them all.
        """
        per_device = max(self.devices.count(d) for d in self.devices)
        return per_device * self.group_config(gi).state_nbytes

    @property
    def n_rungs(self) -> int:
        """Ladder depth: valid rungs are ``0`` (strict) .. ``n_rungs``."""
        return len(self.cfg.degrade_ladder)

    def rung_params(self, rung: int) -> tuple[int, int]:
        """Effective ``(c, k)`` at ladder ``rung`` (0 = strict)."""
        if not 0 <= rung <= self.n_rungs:
            raise ValueError(
                f"rung must be in [0, {self.n_rungs}], got {rung}"
            )
        if rung == 0:
            return int(self.plan.c), int(self.cfg.k)
        step = self.cfg.degrade_ladder[rung - 1]
        return int(step.c), int(step.k)

    def recall_bound_of(self, rung: int) -> float:
        """The observed-recall reference bound at ladder ``rung``.

        Rung 0 (strict) answers carry ``ServiceConfig.recall_floor``;
        rung ``r >= 1`` answers carry the planned
        ``degrade_ladder[r - 1].recall_bound``.  The shadow recall
        estimator publishes ``wlsh_recall_bound_margin`` (observed -
        bound) against this value.
        """
        if not 0 <= rung <= self.n_rungs:
            raise ValueError(
                f"rung must be in [0, {self.n_rungs}], got {rung}"
            )
        if rung == 0:
            return float(self.cfg.recall_floor)
        return float(self.cfg.degrade_ladder[rung - 1].recall_bound)

    def group_config(self, gi: int, rung: int = 0) -> IndexConfig:
        """Padded IndexConfig for group ``gi`` (the step-cache key).

        ``rung`` selects a rung of the pre-planned (c, k) relaxation
        ladder (``ServiceConfig.degrade_ladder``); rung 0 is the strict
        config.  Rung configs differ only in ``c``/``k`` (and the derived
        budget): state shapes are identical, so every rung serves from the
        same cached group state, each through its own step.
        """
        key = (gi, rung)
        cfg = self._group_cfgs.get(key)
        if cfg is None:
            g = self.plan.groups[gi]
            c_eff, k_eff = self.rung_params(rung)
            cfg = IndexConfig(
                n=self.row_capacity(),
                d=self.plan.d,
                beta=pad_beta(g.beta_group, self.cfg.beta_buckets),
                q_batch=self.cfg.q_batch,
                k=k_eff,
                c=c_eff,
                n_levels=pad_levels(g.n_levels_max, self.cfg.level_step),
                p=self.plan.p,
                gamma_n=self.plan.gamma_n,
                budget_override=self.cfg.budget_override,
                vec_dtype=self.cfg.vec_dtype,
                use_kernels=self.cfg.use_kernels,
                delta_seal_rows=self.cfg.delta_seal_rows,
                n_shards=self.n_shards,
            )
            self._group_cfgs[key] = cfg
        return cfg

    def _build_state(self, gi: int):
        """Cold-path StateCache builder: materialize group ``gi``.

        A group that has absorbed delta compactions rebuilds over its
        union corpus (base points + compacted rows, sealed codes reused),
        so discard-mode paging can never drop streamed rows; after a
        tombstone purge only the surviving base rows enter, so a rebuild
        can never resurrect purged rows.
        """
        extra_points = extra_codes = base_rows = None
        with self.span("wlsh_build"):
            if self._delta is not None:
                extra_points, extra_codes = self._delta.compacted_rows(gi)
                base_rows = self._delta.base_rows()
            return self.pager.adopt(gi, build_group_state(
                self.group_config(gi), self.points, self.plan.groups[gi],
                device=self.devices, extra_points=extra_points,
                extra_codes=extra_codes, base_rows=base_rows))

    def _note_cache_event(self, gi: int, kind: str) -> None:
        """Record a StateCache event for trace-span stage attribution.

        Counters live in the shared metrics registry (the StateCache
        increments them itself); this hook only captures which paging
        events happened inside the current launch's lease, so its spans
        can mark their prefetch/restore stage.
        """
        events = self._cache_events
        if events is not None:
            events.append(kind)

    def span(self, name: str):
        """The layer span ``name`` (``obs.trace.span``), counted in
        ``self.metrics`` when ``cfg.obs`` is on."""
        return span(name, self.metrics if self.cfg.obs else None)

    @contextlib.contextmanager
    def lease(self, gi: int):
        """Lease group ``gi``'s state from the ``StateCache``, ordered on
        the current stream after the copy, build or write that made it.

        Every use of a state's tensors goes through here: a launch
        (``run_batch``), a seal's device encode and a compaction's write.
        A sharded state is readied shard by shard, each on its device's
        current stream.  The acquire and the ordering are the layer span
        ``wlsh_lease`` (holding any offload, restore or build they run),
        the release ``wlsh_release`` (any offload the budget then asks for).
        """
        cache = self.state_cache
        with self.span("wlsh_lease"):
            state = cache.acquire(gi)
            try:
                self.pager.ready(gi, state)
            except BaseException:
                cache.release(gi)
                raise
        try:
            yield state
        finally:
            with self.span("wlsh_release"):
                cache.release(gi)

    def replace_state(self, gi: int, state) -> None:
        """Install ``state`` (a compaction's result, written on the current
        stream) as group ``gi``'s new version.

        The pager adopts it first, so its next offload reuses the group's
        pinned buffers, and uses on other streams wait for the write.
        """
        self.pager.adopt(gi, state)
        self.state_cache.replace(gi, state)

    def warmup(self, groups=None) -> None:
        """Build states and steps ahead of traffic.

        Every ladder rung's step is built here too, so runtime QoS
        degradation only switches among existing steps.  Under a
        residency budget (default offload mode) the earliest-built states
        are evicted to host as later ones land, leaving the tail resident
        and the rest warm for restore: first traffic to any group then
        pays one upload, never a rebuild.  In discard mode
        (``offload_evicted=False``) evicted builds would be pure waste, so
        only the budget-fitting tail is prebuilt; the rest build on first
        traffic.
        """
        gids = [
            int(gi) for gi in
            (groups if groups is not None else range(self.plan.n_groups))
        ]
        for gi in gids:
            for rung in range(self.n_rungs + 1):
                self.step_cache.get(self.device, self.group_config(gi, rung))
        if not self.cfg.offload_evicted:
            gids = self._budget_fitting_tail(gids)
        for gi in gids:
            with self.state_cache.lease(gi):
                pass

    def _budget_fitting_tail(self, gids: list[int]) -> list[int]:
        """Longest suffix of ``gids`` that fits the residency budget."""
        cap = self.cfg.max_resident_groups
        budget = self.cfg.device_budget_bytes
        keep: list[int] = []
        nbytes = 0
        for gi in reversed(gids):
            nb = self.state_nbytes(gi)
            if cap is not None and len(keep) + 1 > cap:
                break
            if budget is not None and nbytes + nb > budget:
                break
            keep.append(gi)
            nbytes += nb
        return list(reversed(keep))

    @property
    def resident_bytes(self) -> int:
        """Accounted device bytes of the resident group states."""
        return self.state_cache.resident_bytes

    def reset_stats(self) -> None:
        """Zero every per-group counter and the aggregate cache counters.

        Counters and latency histograms under the serving prefixes reset
        in the registry (the view objects in ``stats`` are unchanged);
        gauges (current state, like resident bytes) are preserved.
        """
        self.metrics.reset("wlsh_group_")
        self.metrics.reset("wlsh_query_")
        self.state_cache.reset_stats()

    def stats_summary(self) -> dict[int, dict]:
        """Per-group summaries for groups that served at least one batch."""
        return {gi: s.summary() for gi, s in self.stats.items()
                if s.n_batches}

    def cache_summary(self) -> dict:
        """Aggregate state-paging report (counters + current residency)."""
        return dict(
            **self.state_cache.stats.summary(),
            n_resident=self.state_cache.n_resident,
            n_groups=self.plan.n_groups,
            max_resident_groups=self.cfg.max_resident_groups,
            device_budget_bytes=self.cfg.device_budget_bytes,
        )

    def mean_occupancy(self) -> float:
        """Unweighted mean batch occupancy over groups that served traffic."""
        occs = [s.occupancy for s in self.stats.values() if s.n_batches]
        return float(np.mean(occs)) if occs else float("nan")

    # ------------------------------------------------------------- streaming

    @property
    def delta(self):
        """The streaming ``DeltaIndex``, or None before the first write."""
        return self._delta

    def delta_index(self):
        """Create on first use (and return) the streaming ``DeltaIndex``."""
        if self._delta is None:
            from .delta import DeltaIndex  # deferred: delta imports batching

            self._delta = DeltaIndex(self)
        return self._delta

    def insert(self, vector, weight_id) -> int:
        """Insert one vector into ``weight_id``'s group; returns its id."""
        return self.delta_index().insert(vector, weight_id)

    def delete(self, point_id: int) -> None:
        """Tombstone ``point_id``: it never appears in results again."""
        self.delta_index().delete(point_id)

    def compact(self, group: int | None = None, purge: bool = False) -> int:
        """Compact sealed delta segments into the main group state(s).

        Returns the number of rows absorbed (0 with nothing sealed or no
        streaming writes yet).  ``purge=True`` upgrades the sweep to a
        tombstone purge (see ``DeltaIndex.compact``): states rebuild over
        their surviving corpus, ``n_valid`` capacity is reclaimed, and
        the tombstone set is cleared.
        """
        if self._delta is None:
            return 0
        return self._delta.compact(group, purge=purge)

    def delta_summary(self) -> dict:
        """Aggregate streaming counters (empty dict before any write)."""
        return self._delta.summary() if self._delta is not None else {}

    # --------------------------------------------------------------- serving

    def route(self, weight_ids) -> np.ndarray:
        """(Q,) serving group per weight_id, validated against the plan
        (the layer span ``wlsh_route``)."""
        with self.span("wlsh_route"):
            weight_ids = np.atleast_1d(np.asarray(weight_ids, np.int64))
            if len(weight_ids) and (
                weight_ids.min() < 0
                or weight_ids.max() >= self.plan.n_weights
            ):
                raise ValueError(
                    "weight_id out of range for the serving plan")
            return self.plan.group_of[weight_ids].astype(np.int32)

    def _encode(self, gi: int, cfg: IndexConfig, state, queries,
                take: np.ndarray) -> torch.Tensor:
        """(q_batch, beta) int32 codes for real ``queries`` padded via
        ``take`` (the layer span ``wlsh_encode``): in host memory from
        the host encode, on the first shard's device from the device
        encode.

        Query and data codes must come from the same encoding: host f64
        only pairs with plan-shipped host codes; a device-built (f32)
        state needs device-encoded queries, or floor-boundary jitter
        mixes the two encodings and a query can miss its own point.
        Encoding is row-independent, so the host path encodes each real
        row once and gathers, while the device path encodes the padded
        batch (uploading the padded queries itself).  ``run_batch``
        uploads host codes with the other step inputs (``wlsh_upload``);
        the step copies the codes from the first shard's device to every
        other shard's.
        """
        g = self.plan.groups[gi]
        with self.span("wlsh_encode"):
            if g.codes is None:
                return encode_queries(state, queries[take])
            codes = pad_cols(g.encode_host(queries), cfg.beta)[take]
            return torch.from_numpy(np.ascontiguousarray(codes, np.int32))

    def run_batch(self, gi: int, queries, weight_ids, rung: int = 0,
                  spans=None):
        """One step launch for 1..q_batch same-group requests.

        Pads ragged input by cycling the real rows, encodes the queries
        (``_encode``; row-independent, so padding cannot perturb real
        rows) and returns ``(ids, dists, stop_levels, n_checked)`` sliced
        back to the real rows.  Both frontends answer every query through
        this method, which is what makes them bit-exact on identical
        traffic.

        ``rung`` serves the batch at a rung of the (c, k) relaxation
        ladder: the same group state, that rung's step, and answers padded
        ``-1``/``inf`` back to the strict ``k``.  Rung 0 is the strict
        path.

        The state is leased from the ``StateCache`` around the launch:
        pinned while the step runs, then released, so a budgeted cache
        can page any group between launches but never under one.  A
        restored state's upload is ordered before the launch on the
        calling thread's current stream (``Batcher.lease``), and the
        outputs reach the host before the lease ends.  With streaming
        writes, ``DeltaIndex.augment`` then translates appended rows to
        global ids and merges the exact scan of the group's pending
        rows, dropping tombstoned ids.

        ``spans`` is the frontend's per-row ``obs.TraceSpan`` list (one
        per real row, submission order): paging, launch and merge stages
        are stamped on them here.  With tracing on and no spans passed (a
        direct ``run_batch`` caller), spans are opened *and* resolved
        here, so every query still yields exactly one span.

        The launch is the layer span ``wlsh_batch``.  Inside the lease
        (``wlsh_lease`` ... ``wlsh_release``) come the encode
        (``wlsh_encode``), the host-to-device copies of the codes and of
        the six per-query inputs (``wlsh_upload``), the step
        (``wlsh_step``) and the four downloads, each waiting for the
        device (``wlsh_download``); after it, ``wlsh_merge``.  The
        profiler's dispatch scope encloses the uploads, the step and the
        downloads, so a dispatch time covers the device work.
        """
        with self.span("wlsh_batch"):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            weight_ids = np.atleast_1d(np.asarray(weight_ids, np.int64))
            cfg = self.group_config(gi, rung)
            step = self.step_cache.get(self.device, cfg)
            real = len(queries)
            take = pad_take(real, cfg.q_batch)
            g = self.plan.groups[gi]
            wtake = weight_ids[take]
            slots = self.plan.member_slot[wtake]
            dev = self.device
            tr = self.tracer
            own_spans = tr is not None and spans is None
            if own_spans:
                t_sub = self.clock()
                spans = []
                for wid in weight_ids:
                    s = tr.begin(weight_id=int(wid), group_id=int(gi))
                    s.mark("submit", t_sub)
                    s.mark("route", t_sub)
                    s.mark("queue", t_sub)
                    spans.append(s)
            if tr is not None:
                self._cache_events = []

            def put(x, dtype):
                return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dev)

            with self.lease(gi) as state:
                if tr is not None and spans:
                    # attribute this launch's paging work: a consumed
                    # prefetch marks "prefetch", a blocking restore/build
                    # marks "restore" (a plain hit marks neither)
                    t_acq = self.clock()
                    kinds = set(self._cache_events or ())
                    for s in spans:
                        if "restore_overlapped" in kinds:
                            s.mark("prefetch", t_acq)
                        if kinds & {"restore", "build"}:
                            s.mark("restore", t_acq)
                codes = self._encode(gi, cfg, state, queries, take)
                if tr is not None and spans:
                    t_launch = self.clock()
                    for s in spans:
                        s.mark("launch", t_launch)
                dispatch_scope = (
                    self.profiler.dispatch(str(cfg.shape_signature()))
                    if self.profiler is not None else _NULL_SCOPE
                )
                with dispatch_scope:
                    with self.span("wlsh_upload"):
                        inputs = (
                            put(queries[take], np.float32),
                            codes.to(dev),
                            put(self.plan.weights[wtake], np.float32),
                            put(g.mu_members[slots], np.int32),
                            put(g.r_min_members[slots], np.float32),
                            put(g.beta_members[slots], np.int32),
                            put(g.n_levels_members[slots], np.int32),
                        )
                    d_b, i_b, stop_b, chk_b = step(state, *inputs)
                    # on the host before the lease ends: the state must stay
                    # resident until the device has finished reading it
                    with self.span("wlsh_download"):
                        ids = i_b.cpu().numpy()[:real]
                        dists = d_b.cpu().numpy()[:real]
                        stop = stop_b.cpu().numpy()[:real]
                        chk = chk_b.cpu().numpy()[:real]
            with self.span("wlsh_merge"):
                return self._merge(gi, cfg, rung, queries, weight_ids, ids,
                                   dists, stop, chk, spans, own_spans)

    def _merge(self, gi, cfg, rung, queries, weight_ids, ids, dists, stop,
               chk, spans, own_spans):
        """A launch's answers padded back to the strict ``k``, augmented
        by the delta, counted, stamped on the spans and offered to the
        recall estimator."""
        real = len(ids)
        tr = self.tracer
        if cfg.k < self.cfg.k:
            # degraded rung: pad the short top-k back to the strict width
            pad_ids = np.full((real, self.cfg.k), -1, ids.dtype)
            pad_d = np.full((real, self.cfg.k), np.inf, dists.dtype)
            pad_ids[:, : cfg.k] = ids
            pad_d[:, : cfg.k] = dists
            ids, dists = pad_ids, pad_d
        if self._delta is not None:
            # translate appended state rows to global ids, merge the exact
            # delta-scan hits, filter tombstones (a group with nothing
            # pending passes through bit for bit)
            ids, dists = self._delta.augment(
                gi, queries, weight_ids, ids, dists
            )
        m = self.metrics
        m.counter("wlsh_group_batches_total",
                  "compiled-step launches").inc(group=gi)
        m.counter("wlsh_group_queries_total",
                  "real rows served").inc(real, group=gi)
        m.counter("wlsh_group_padded_rows_total",
                  "padding rows across ragged batches").inc(
            cfg.q_batch - real, group=gi)
        m.counter("wlsh_group_stop_levels_total",
                  "summed histogram stop levels").inc(
            int(np.sum(stop)), group=gi)
        m.counter("wlsh_group_checked_total",
                  "summed candidates verified (n_checked)").inc(
            int(np.sum(chk)), group=gi)
        if tr is not None and spans:
            self._cache_events = None
            t_merge = self.clock()
            budget = int(cfg.budget)
            for i, s in enumerate(spans):
                s.mark("merge", t_merge)
                s.group_id = int(gi)
                s.rung = int(rung)
                s.n_shards = int(cfg.n_shards)
                s.stop_level = int(stop[i])
                s.n_checked = int(chk[i])
                s.budget = budget
                s.budget_capped = bool(int(chk[i]) >= budget)
                if own_spans:
                    s.mark("resolve", t_merge)
                    tr.finish(s)
            if self.recall is not None:
                # shadow-sample by a deterministic hash of the span's
                # query id: enqueue only (host copies); the answer arrays
                # are returned untouched, so sampling is bit-invisible
                for i, s in enumerate(spans):
                    self.recall.offer(
                        s, queries[i], int(weight_ids[i]), int(gi),
                        int(rung), ids[i]
                    )
        return ids, dists, stop, chk
