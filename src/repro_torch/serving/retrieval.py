"""Multi-group WLSH retrieval service, synchronous frontend.

The host planner partitions the weight vector set S into table groups
(Algorithm 1); every incoming query carries a ``weight_id`` naming its
distance function, and is answered in *that* weight's group (Algorithm 2).
All queries of a ``query`` call are present up front, so they are routed,
coalesced into same-group batches of ``q_batch``, answered through
``Batcher.run_batch`` and returned in submission order.  The asynchronous
frontend (``async_service.AsyncRetrievalService``) wraps the same
``Batcher``, so both answer every query through the same step and are
bit-exact on identical traffic.  With a plan that
ships host codes, query bucket codes are computed on the host in float64
against the exported family, so the answers are bit-exact with
``WLSHIndex.search_dense``'s candidate sets.  A plan exported without
codes (``include_codes=False``) is encoded on the device, data and
queries alike, through the ``hash_encode`` kernel.  ``insert``/``delete``/
``compact`` are the streaming writes (``serving.delta.DeltaIndex``).
With ``ServiceConfig.obs`` every query gets one trace span
(``batcher.tracer``).  A ``query`` call is the layer span ``wlsh_query``
(``obs.trace.span``), around ``wlsh_route`` and each launch's
``wlsh_batch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.serving_plan import ServingPlan
from .batching import Batcher, GroupServeStats, ServiceConfig, coalesce, run_plans

__all__ = [
    "GroupServeStats",
    "RetrievalResult",
    "RetrievalService",
    "ServiceConfig",
]


@dataclasses.dataclass
class RetrievalResult:
    """Per-query answers, in submission order."""

    ids: np.ndarray  # (Q, k) int32, -1 = missing
    dists: np.ndarray  # (Q, k) f32, +inf = missing
    group_ids: np.ndarray  # (Q,) int32 serving group per query
    stop_levels: np.ndarray  # (Q,) int32
    n_checked: np.ndarray  # (Q,) int32


class RetrievalService:
    """Synchronous weight-routed frontend over the ``Batcher`` core.

    Group states are built on ``cfg.device`` (default ``"cuda"``; pass
    ``device="cpu"`` in the config for the plain torch path) lazily per
    group; call ``warmup`` to front-load them.  Under
    ``ServiceConfig.max_resident_groups`` / ``device_budget_bytes`` the
    states are paged by a ``StateCache`` (LRU eviction, host offload and
    restore), bit for bit.  Pass the service (or its ``batcher``) to
    ``AsyncRetrievalService`` to serve streaming traffic over the same
    states, stats and step cache.

    ``ServiceConfig.n_shards`` splits every group state's rows across
    that many devices; ``devices=`` names them explicitly (one card may
    be named more than once, see ``Batcher``).
    """

    def __init__(self, plan: ServingPlan, points: np.ndarray,
                 cfg: ServiceConfig = ServiceConfig(), devices=None):
        self.batcher = Batcher(plan, points, cfg=cfg, devices=devices)

    @property
    def plan(self) -> ServingPlan:
        """The ServingPlan this service answers under."""
        return self.batcher.plan

    @property
    def points(self) -> np.ndarray:
        """The (n, d) host corpus the group states are built from."""
        return self.batcher.points

    @property
    def cfg(self) -> ServiceConfig:
        """Serving-side configuration (shared with the batching core)."""
        return self.batcher.cfg

    @property
    def device(self):
        """The torch device the answers land on (the first shard's)."""
        return self.batcher.device

    @property
    def devices(self) -> tuple:
        """The devices group states are sharded across, one per shard."""
        return self.batcher.devices

    @property
    def step_cache(self):
        """Query-step cache, shared across groups."""
        return self.batcher.step_cache

    @property
    def state_cache(self):
        """Budgeted per-group device-state cache (see ``StateCache``)."""
        return self.batcher.state_cache

    @property
    def metrics(self):
        """The stack's unified ``obs.MetricsRegistry``."""
        return self.batcher.metrics

    @property
    def stats(self) -> dict[int, GroupServeStats]:
        """Per-group serving counters, keyed by group id."""
        return self.batcher.stats

    @property
    def resident_bytes(self) -> int:
        """Accounted device bytes of the resident group states."""
        return self.batcher.resident_bytes

    def group_config(self, gi: int):
        """Padded IndexConfig for group ``gi`` (the step-cache key)."""
        return self.batcher.group_config(gi)

    def warmup(self, groups=None) -> None:
        """Build states and steps ahead of traffic."""
        self.batcher.warmup(groups)

    def reset_stats(self) -> None:
        """Zero the per-group serving counters and cache counters."""
        self.batcher.reset_stats()

    def stats_summary(self) -> dict[int, dict]:
        """Per-group summaries for groups that served at least one batch."""
        return self.batcher.stats_summary()

    def cache_summary(self) -> dict:
        """Aggregate state-paging report (counters + current residency)."""
        return self.batcher.cache_summary()

    def mean_occupancy(self) -> float:
        """Unweighted mean batch occupancy over groups that served traffic."""
        return self.batcher.mean_occupancy()

    # ------------------------------------------------------------- streaming

    def insert(self, vector, weight_id) -> int:
        """Insert one vector into ``weight_id``'s table group.

        Returns the assigned global point id.  The row is queryable at
        once (exact delta scan) and is written into the group's state on
        the device by a later compaction, which needs
        ``ServiceConfig.delta_reserve_rows`` capacity to append into.
        """
        return self.batcher.insert(vector, weight_id)

    def delete(self, point_id: int) -> None:
        """Tombstone a global point id; it never appears in results again."""
        self.batcher.delete(point_id)

    def compact(self, group: int | None = None, purge: bool = False) -> int:
        """Flush and compact delta segments into the main group state(s).

        Returns the number of rows absorbed.  Only the compacted groups'
        cached states change (at a bumped version); query steps are
        untouched.  ``purge=True`` also drops every tombstoned row from
        the rebuilt states, reclaims their ``n_valid`` capacity and clears
        the tombstone set.
        """
        return self.batcher.compact(group, purge=purge)

    def delta_summary(self) -> dict:
        """Streaming counters (inserts/seals/compactions/tombstones)."""
        return self.batcher.delta_summary()

    # --------------------------------------------------------------- serving

    def query(self, queries: np.ndarray, weight_ids) -> RetrievalResult:
        """Answer a mixed batch of (query, weight_id) requests.

        Queries are grouped by serving group, coalesced into q_batch-sized
        sub-batches, and results are returned in submission order.  The
        call is the layer span ``wlsh_query``: its self time is the
        coalescing and the merge back to submission order.
        """
        with self.batcher.span("wlsh_query"):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            weight_ids = np.atleast_1d(np.asarray(weight_ids, np.int64))
            if len(weight_ids) != len(queries):
                raise ValueError("queries and weight_ids length mismatch")
            gids = self.batcher.route(weight_ids)
            tr = self.batcher.tracer
            spans = None
            if tr is not None:
                # one span per submitted query; the whole call is one
                # synchronous submit/route/queue instant on the clock
                t_sub = self.batcher.clock()
                spans = []
                for wid, gi in zip(weight_ids, gids):
                    s = tr.begin(weight_id=int(wid), group_id=int(gi))
                    s.mark("submit", t_sub)
                    s.mark("route", t_sub)
                    s.mark("queue", t_sub)
                    spans.append(s)
            out_ids, out_d, out_stop, out_chk = run_plans(
                coalesce(gids, self.cfg.q_batch),
                queries,
                weight_ids,
                self.batcher.run_batch,
                self.cfg.k,
                spans=spans,
            )
            if tr is not None:
                t_res = self.batcher.clock()
                for s in spans:
                    s.mark("resolve", t_res)
                    tr.finish(s)
            return RetrievalResult(
                ids=out_ids,
                dists=out_d,
                group_ids=gids,
                stop_levels=out_stop,
                n_checked=out_chk,
            )
