"""Group-state memory manager: lazy build, LRU eviction, host offload.

WLSH's planner (Algorithm 1) deliberately produces *many* table groups to
cover the weight set, and each group's device state — codes ``(n, beta)``
plus vectors ``(n, d)`` — dominates the serving footprint.  Keeping every
``build_group_state`` result resident forever caps scale at
``device_bytes / state_nbytes`` groups, far below a production plan.  The
``StateCache`` bounds residency under an explicit budget instead:

  build     a group's state is built on first acquire (cold miss)
  evict     before a miss materializes a new state, *unpinned*,
            *unprotected* groups are evicted until the incoming state
            fits ``max_resident_groups`` / ``device_budget_bytes`` (its
            size is known up front, so the budget holds at peak
            residency); with an ``offload`` hook the evicted state is
            pulled to host memory first, otherwise it is discarded.  The
            victim is least-recently-used by default; an
            ``eviction_policy`` hook (see ``serving.scheduler``) makes
            the choice pluggable — the cost-aware default there scores
            recency against ``state_nbytes`` restore cost
  restore   re-acquiring an offloaded group uploads the host copy (warm
            miss: one host-to-device copy, bit-identical bytes, no
            re-encode and no new query step)
  prefetch  ``prefetch(gi)`` starts the restore (or build) *ahead* of
            the acquire that will need it — the scheduler issues it from
            the pending-deadline schedule, so the host-to-device upload
            (asynchronous on the card: a pinned-host copy enqueued on a
            dedicated CUDA copy stream, which the launch stream waits on
            through a CUDA event) overlaps in-flight launches instead of
            serializing into a launch's critical path.  A prefetched
            state consumed by a later acquire counts a hit (and
            ``n_restore_overlapped`` when the prefetch restored); one
            evicted or invalidated before any acquire counts
            ``n_prefetch_wasted``
  protect   ``protect(gis)`` marks groups scheduled to launch within
            their restore horizon: they are never chosen as eviction
            victims (the budget goes soft instead, like pinning), so a
            prefetch can never evict a state that is about to launch
  pin       an acquired state is pinned until ``release`` — a launch in
            flight can never lose its state to a concurrent acquire, and
            deadline-driven partial launches cannot thrash each other
  version   keys are versioned: streaming compaction replaces or
            invalidates exactly one group's cached bytes (``replace`` /
            ``invalidate`` bump that group's version and drop its device
            and host copies) while every other group's state — and every
            query step — survives untouched

Misses are fault-tolerant: a raising restore/build executor is retried a
bounded number of times (``restore_retries``, with optional doubling
backoff) before the error propagates, the host copy survives a failed
restore, and a failing *prefetch* is contained entirely — counted
``n_prefetch_wasted``, never raising into the scheduler tick.  Observed
miss timings feed a ``RestoreCostModel`` (EWMA bytes/s) that prices
``restore_eta(gi)`` for the scheduler's learned prefetch horizon.  A host
timer around an asynchronous upload sees only its enqueue, so with a
``restore_timings`` hook restores are priced by the copy's own device
time instead, once the copy is done.

Byte accounting comes from ``IndexConfig.state_nbytes`` (the *padded*
shapes actually materialized), so budgets are enforceable before any state
is built.  Counters (hits / builds / restores / evictions) are recorded
directly in the serving stack's unified ``MetricsRegistry`` as
``wlsh_state_*`` series labeled by group — ``CacheStats`` (and the
per-group ``Batcher.stats`` views) read the same series, so nothing is
mirrored.  Query steps
are deliberately *not* managed here: ``QueryStepCache`` keys on shape
signatures, so evicting a group's state never forces a new step.

The cache is single-threaded like the frontends that drive it; the budget
is soft under pinning — if every resident state is pinned, an acquire may
temporarily exceed the budget rather than deadlock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Callable

from ..obs import MetricsRegistry

__all__ = [
    "CacheStats",
    "EvictionCandidate",
    "RestoreCostModel",
    "StateCache",
]

# Cache event kind -> unified registry counter (labeled by group).
_EVENT_COUNTERS = {
    "hit": "wlsh_state_hits_total",
    "build": "wlsh_state_builds_total",
    "restore": "wlsh_state_restores_total",
    "evict": "wlsh_state_evictions_total",
    "invalidate": "wlsh_state_invalidations_total",
    "prefetch": "wlsh_state_prefetches_total",
    "prefetch_wasted": "wlsh_state_prefetch_wasted_total",
    "restore_overlapped": "wlsh_state_restore_overlapped_total",
}


class RestoreCostModel:
    """Learned host-to-device restore bandwidth (EWMA bytes/second).

    The scheduler's prefetch horizon used to be a hand-set knob
    (``DeadlinePrefetch.horizon_s``); this model learns the real figure
    from observed restore (and cold-build) timings instead.  Every
    ``StateCache`` miss feeds ``observe(nbytes, seconds)``; the
    exponentially-weighted moving average smooths transient latency
    spikes while tracking genuine bandwidth shifts.  ``eta(nbytes)``
    then prices a pending restore, and the prefetch policy widens its
    horizon to ``max(floor, margin * eta)`` — the hand-set horizon
    survives as a deterministic floor, so virtual-time replays (whose
    deadlines are not wall-clock commensurable) behave exactly as
    before, while a deployment whose restores are genuinely slow gets a
    proportionally earlier prefetch.
    """

    def __init__(
        self,
        alpha: float = 0.2,
        default_bytes_per_s: float = 4e9,
    ):
        if not (0 < alpha <= 1):
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not (default_bytes_per_s > 0):
            raise ValueError(
                f"default_bytes_per_s must be > 0, got {default_bytes_per_s}"
            )
        self.alpha = float(alpha)
        self._bytes_per_s = float(default_bytes_per_s)
        self.n_observed = 0

    @property
    def bytes_per_s(self) -> float:
        """Current bandwidth estimate (the prior until first observed)."""
        return self._bytes_per_s

    def observe(self, nbytes: int, seconds: float) -> None:
        """Fold one observed transfer into the EWMA (bad samples skipped)."""
        if nbytes <= 0 or not (seconds > 0):
            return  # clock granularity can produce 0.0 — not a rate
        rate = nbytes / seconds
        if self.n_observed == 0:
            self._bytes_per_s = rate  # first sample replaces the prior
        else:
            self._bytes_per_s += self.alpha * (rate - self._bytes_per_s)
        self.n_observed += 1

    def eta(self, nbytes: int) -> float:
        """Predicted seconds to restore an ``nbytes`` state."""
        return max(nbytes, 0) / self._bytes_per_s


class CacheStats:
    """Cache counters as a read-only view over the unified registry.

    Every count lives in the serving stack's :class:`MetricsRegistry`
    (``wlsh_state_*`` counters labeled by group, plus the
    ``wlsh_state_resident_bytes`` gauge); this class is a thin summing
    view so callers keep the classic ``stats.n_hits`` spelling.  Reset
    with ``StateCache.reset_stats`` (residency and budget survive).
    """

    # attribute -> registry counter it sums over (all group labels)
    _COUNTERS = {
        "n_hits": "wlsh_state_hits_total",
        "n_builds": "wlsh_state_builds_total",
        "n_restores": "wlsh_state_restores_total",
        "n_evictions": "wlsh_state_evictions_total",
        "n_invalidations": "wlsh_state_invalidations_total",
        "n_prefetches": "wlsh_state_prefetches_total",
        "n_prefetch_wasted": "wlsh_state_prefetch_wasted_total",
        "n_restore_overlapped": "wlsh_state_restore_overlapped_total",
        "n_restore_retries": "wlsh_state_restore_retries_total",
    }

    def __init__(self, metrics: MetricsRegistry,
                 device_budget_bytes: int | None = None):
        """Bind the view to ``metrics`` (see ``StateCache.metrics``)."""
        self._metrics = metrics
        self.device_budget_bytes = device_budget_bytes

    def __getattr__(self, name: str) -> int:
        """Resolve ``n_*`` counter reads against the registry."""
        metric = type(self)._COUNTERS.get(name)
        if metric is None:
            raise AttributeError(name)
        return int(self._metrics.counter(metric).total())

    @property
    def resident_bytes(self) -> int:
        """Current accounted residency (gauge: survives reset_stats)."""
        return int(
            self._metrics.gauge("wlsh_state_resident_bytes").value()
        )

    @property
    def n_misses(self) -> int:
        """Acquires that had to build or restore."""
        return self.n_builds + self.n_restores

    @property
    def hit_rate(self) -> float:
        """Resident-hit fraction over all acquires (nan with no traffic).

        Prefetch-issued restores/builds count in the denominator — a
        prefetch that is never consumed must not look free.
        """
        total = self.n_hits + self.n_misses
        return self.n_hits / total if total else float("nan")

    @property
    def budget_utilization(self) -> float:
        """Resident bytes as a fraction of the byte budget.

        nan when the cache has no ``device_budget_bytes`` budget.
        """
        if not self.device_budget_bytes:
            return float("nan")
        return self.resident_bytes / self.device_budget_bytes

    def summary(self) -> dict:
        """Flat dict of every counter plus the derived rates/residency."""
        return dict(
            n_hits=self.n_hits,
            n_builds=self.n_builds,
            n_restores=self.n_restores,
            n_evictions=self.n_evictions,
            n_invalidations=self.n_invalidations,
            n_prefetches=self.n_prefetches,
            n_prefetch_wasted=self.n_prefetch_wasted,
            n_restore_overlapped=self.n_restore_overlapped,
            n_restore_retries=self.n_restore_retries,
            hit_rate=self.hit_rate,
            resident_bytes=self.resident_bytes,
            budget_utilization=self.budget_utilization,
        )


@dataclasses.dataclass(frozen=True)
class EvictionCandidate:
    """One evictable resident group, as seen by an eviction policy.

    ``last_use`` is a monotone access tick (smaller = staler); policies
    compare ticks, never wall-clock.  ``prefetched`` marks a state brought
    in by ``prefetch`` and not yet consumed by any acquire.
    """

    group_id: int
    last_use: int
    nbytes: int
    prefetched: bool = False


@dataclasses.dataclass
class _Entry:
    """One group's cache slot: at most one of state/host is populated."""

    state: object | None = None  # device-resident QueryState
    host: object | None = None  # offloaded host copy
    nbytes: int = 0
    pins: int = 0
    version: int = 0  # group version the stored bytes correspond to
    last_use: int = 0  # monotone access tick (acquire/prefetch/replace)
    prefetched: str | None = None  # "restore"/"build" while brought in by
    # prefetch and not yet consumed by an acquire


class StateCache:
    """LRU cache of per-group device states under a device-memory budget.

    Parameters
    ----------
    build:
        ``build(group_id) -> state`` — materialize a group's device state
        from scratch (cold path).
    nbytes_of:
        ``nbytes_of(group_id) -> int`` — the group's device footprint,
        derivable without building (``IndexConfig.state_nbytes``).
    max_resident_groups:
        Keep at most this many groups resident (None = unbounded).
    device_budget_bytes:
        Keep total resident bytes at or under this budget (None =
        unbounded).  Both limits may be set; eviction enforces both.
    offload:
        Optional ``offload(state) -> host_copy`` run at eviction; evicted
        groups restore from the copy instead of rebuilding.  None
        discards evicted states (rebuild on next acquire).
    restore:
        ``restore(group_id, host_copy) -> state`` — upload an offloaded
        copy.  Required when ``offload`` is set.
    on_event:
        Optional ``on_event(group_id, kind)`` observer with kind in
        ``{"hit", "build", "restore", "evict", "invalidate", "prefetch",
        "prefetch_wasted", "restore_overlapped"}`` — the hook ``Batcher``
        uses to attribute cache activity to in-flight trace spans (the
        counters themselves live in the shared registry, no mirroring).
    eviction_policy:
        Optional victim selector ``policy(candidates) -> group_id`` over
        a tuple of ``EvictionCandidate`` (every unpinned, unprotected
        resident group).  None keeps the classic least-recently-used
        choice; ``serving.scheduler.CostAwareEviction`` is the cost-aware
        default the real-time driver installs.
    restore_retries:
        Bounded retry budget for a failing restore or build: a raising
        executor is retried up to this many times per miss before the
        exception propagates (``acquire``) or the prefetch is written
        off as wasted (``prefetch``).  A transient device hiccup —
        exactly the regime paging exists for — therefore recovers
        instead of poisoning a lease.  0 disables retries.
    retry_backoff_s:
        Base backoff slept between retry attempts (doubling per
        attempt).  The default 0.0 retries immediately, keeping every
        test and virtual-time replay free of wall-clock sleeps.
    cost_model:
        The learned restore-bandwidth model fed by observed miss
        timings (``RestoreCostModel``); None installs a default one.
    metrics:
        The unified ``MetricsRegistry`` the cache's ``wlsh_state_*``
        counters and residency gauge live in — ``Batcher`` passes its
        own so every layer shares one registry; None creates a private
        one (standalone caches stay self-contained).
    timer:
        Injectable clock for restore/build timing (feeds the
        ``RestoreCostModel``); defaults to ``time.perf_counter``.
    restore_timings:
        Optional ``restore_timings() -> [(nbytes, seconds), ...]``: the
        device-side times of the restores whose copies have finished
        since the previous call.  With it, restores feed the cost model
        from these (polled at every acquire, prefetch and
        ``restore_eta``) rather than from ``timer``, which around an
        asynchronous upload measures only the enqueue; builds keep
        ``timer``.  None (the default) times restores with ``timer``.
    sleep:
        Injectable retry-backoff sleep; defaults to ``time.sleep``.
    """

    def __init__(
        self,
        build: Callable[[int], object],
        nbytes_of: Callable[[int], int],
        *,
        max_resident_groups: int | None = None,
        device_budget_bytes: int | None = None,
        offload: Callable[[object], object] | None = None,
        restore: Callable[[int, object], object] | None = None,
        on_event: Callable[[int, str], None] | None = None,
        eviction_policy: Callable[[tuple], int] | None = None,
        restore_retries: int = 2,
        retry_backoff_s: float = 0.0,
        cost_model: RestoreCostModel | None = None,
        metrics: MetricsRegistry | None = None,
        timer: Callable[[], float] = time.perf_counter,
        sleep: Callable[[float], None] | None = None,
        restore_timings: Callable[[], list] | None = None,
    ):
        if max_resident_groups is not None and max_resident_groups < 1:
            raise ValueError(
                f"max_resident_groups must be >= 1 or None, got "
                f"{max_resident_groups}"
            )
        if device_budget_bytes is not None and device_budget_bytes < 1:
            raise ValueError(
                f"device_budget_bytes must be >= 1 or None, got "
                f"{device_budget_bytes}"
            )
        if offload is not None and restore is None:
            raise ValueError("offload requires a restore callable")
        if restore_retries < 0:
            raise ValueError(
                f"restore_retries must be >= 0, got {restore_retries}"
            )
        if retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}"
            )
        self.restore_retries = int(restore_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._sleep = sleep if sleep is not None else time.sleep
        self._timer = timer
        self._restore_timings = restore_timings
        self.cost_model = (
            cost_model if cost_model is not None else RestoreCostModel()
        )
        self._build = build
        self._nbytes_of = nbytes_of
        self.max_resident_groups = max_resident_groups
        self.device_budget_bytes = device_budget_bytes
        self._offload = offload
        self._restore = restore
        self._on_event = on_event or (lambda gi, kind: None)
        self.eviction_policy = eviction_policy
        # LRU order: first = least recently used.  Non-resident entries
        # (host copy only) live in _offloaded.
        self._resident: OrderedDict[int, _Entry] = OrderedDict()
        self._resident_nbytes = 0  # running sum over self._resident
        self._offloaded: dict[int, _Entry] = {}
        # versioned keys: cached bytes (device or host) are only valid for
        # the group's current version; invalidate/replace bump it so a
        # compacted group can never serve a pre-compaction copy
        self._versions: dict[int, int] = {}
        self._protected: frozenset[int] = frozenset()
        self._tick = 0  # monotone access counter for recency scoring
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = CacheStats(
            self.metrics, device_budget_bytes=device_budget_bytes
        )

    def _event(self, gi: int, kind: str) -> None:
        """Count one cache event in the registry and notify the hook."""
        self.metrics.counter(
            _EVENT_COUNTERS[kind], "state-cache events by kind"
        ).inc(group=gi)
        self._on_event(gi, kind)

    # ------------------------------------------------------------- inspection

    @property
    def resident_bytes(self) -> int:
        """Total accounted bytes of the currently resident states."""
        return self._resident_nbytes

    @property
    def n_resident(self) -> int:
        """Number of groups currently resident on device."""
        return len(self._resident)

    def resident_group_ids(self) -> tuple[int, ...]:
        """Resident groups, least recently used first."""
        return tuple(self._resident)

    def is_resident(self, gi: int) -> bool:
        """Whether group ``gi`` is on device right now."""
        return gi in self._resident

    def pin_count(self, gi: int) -> int:
        """Outstanding acquires of group ``gi`` (0 = evictable)."""
        entry = self._resident.get(int(gi))
        return entry.pins if entry is not None else 0

    def nbytes_of(self, gi: int) -> int:
        """Accounted device footprint of group ``gi``'s state.

        The resident entry's priced size when the group is on device,
        otherwise the ``nbytes_of`` estimate — what eviction, budgets and
        the scheduler's imminent-set clamp all price with.
        """
        entry = self._resident.get(int(gi))
        return entry.nbytes if entry is not None else self._nbytes_of(gi)

    def restore_eta(self, gi: int) -> float:
        """Predicted seconds to page group ``gi`` in, from observed rates.

        ``RestoreCostModel`` bandwidth applied to the group's accounted
        bytes — what the scheduler's prefetch policy widens its horizon
        with (0.0 for an already-resident group: nothing to restore).
        """
        gi = int(gi)
        self._price_restores()
        if gi in self._resident:
            return 0.0
        return self.cost_model.eta(self.nbytes_of(gi))

    def version_of(self, gi: int) -> int:
        """Current version of group ``gi`` (bumped by invalidate/replace)."""
        return self._versions.get(int(gi), 0)

    def protected_group_ids(self) -> frozenset[int]:
        """Groups currently shielded from eviction (see ``protect``)."""
        return self._protected

    def reset_stats(self) -> None:
        """Zero the counters (current residency/budget figures survive).

        Registry gauges survive ``reset`` by design, so the residency
        figure carries across while every ``wlsh_state_*`` counter
        starts over.
        """
        self.metrics.reset("wlsh_state_")

    def _add_bytes(self, delta: int) -> None:
        """Adjust the accounted residency (mirrored into the gauge)."""
        self._resident_nbytes += delta
        self.metrics.gauge(
            "wlsh_state_resident_bytes", "accounted resident state bytes"
        ).set(self._resident_nbytes)

    def _touch(self, entry: _Entry) -> None:
        """Stamp ``entry`` with the next monotone access tick."""
        self._tick += 1
        entry.last_use = self._tick

    # ---------------------------------------------------------------- serving

    def acquire(self, gi: int) -> object:
        """Return group ``gi``'s device state, pinned until ``release``.

        Resident: a hit (refreshes LRU position).  Offloaded: the host
        copy is uploaded (restore).  Unknown: built from scratch.  On
        either miss path, least-recently-used unpinned groups are evicted
        *before* the new state materializes (its size is known up front
        from ``nbytes_of``), so the budget holds at the moment of peak
        residency — never exceeded transiently by the incoming group.
        """
        gi = int(gi)
        self._price_restores()
        entry = self._resident.get(gi)
        if entry is not None and entry.version == self.version_of(gi):
            self._resident.move_to_end(gi)
            self._touch(entry)
            entry.pins += 1
            self._event(gi, "hit")
            if entry.prefetched is not None:
                # the prefetch paid off: the upload happened before this
                # acquire needed it, off the launch's critical path
                if entry.prefetched == "restore":
                    self._event(gi, "restore_overlapped")
                entry.prefetched = None
            return entry.state
        entry, _ = self._materialize(gi)
        entry.pins += 1
        return entry.state

    def _materialize(self, gi: int) -> tuple[_Entry, str]:
        """Shared miss path of ``acquire`` and ``prefetch``.

        Evicts to fit, then restores the host copy or cold-builds, and
        installs the state resident (unpinned).
        """
        version = self.version_of(gi)
        if self._resident.get(gi) is not None:  # stale resident copy
            self.evict(gi)  # (defensive: invalidate/replace drop eagerly)
        entry = self._offloaded.get(gi)
        if entry is not None and entry.version != version:
            del self._offloaded[gi]
            entry = None
        nbytes = entry.nbytes if entry is not None else self._nbytes_of(gi)
        self._evict_to_fit(nbytes)
        if entry is not None:
            # restore before popping: if the upload raises (device OOM —
            # the regime paging exists for), the host copy survives and a
            # retry restores instead of silently cold-rebuilding
            host = entry.host
            entry.state = self._attempt(
                lambda: self._restore(gi, host), nbytes,
                device_timed=self._restore_timings is not None,
            )
            del self._offloaded[gi]
            entry.host = None
            kind = "restore"
        else:
            entry = _Entry(
                state=self._attempt(lambda: self._build(gi), nbytes),
                nbytes=nbytes, version=version,
            )
            kind = "build"
        self._resident[gi] = entry  # newest LRU position
        self._touch(entry)
        self._add_bytes(entry.nbytes)
        self._event(gi, kind)
        entry.prefetched = None
        return entry, kind

    def _attempt(self, run: Callable[[], object], nbytes: int,
                 device_timed: bool = False) -> object:
        """One restore/build with bounded retries and timing feedback.

        Retries a raising executor up to ``restore_retries`` times
        (optionally backing off, doubling per attempt) before letting
        the exception propagate — a transient failure recovers in place
        instead of poisoning the caller's lease.  Successful attempts
        feed their observed transfer time to the ``RestoreCostModel``:
        the host timer's, or, when ``device_timed``, the copy's own time
        from ``restore_timings`` once it has finished.
        """
        for attempt in range(self.restore_retries + 1):
            t0 = self._timer()
            try:
                state = run()
            except Exception:
                if attempt >= self.restore_retries:
                    raise
                self.metrics.counter(
                    "wlsh_state_restore_retries_total",
                    "failed restore/build attempts that were retried",
                ).inc()
                backoff = self.retry_backoff_s * (2 ** attempt)
                if backoff > 0:
                    self._sleep(backoff)
                continue
            if not device_timed:
                self.cost_model.observe(nbytes, self._timer() - t0)
            return state

    def _price_restores(self) -> None:
        """Fold the device times of finished restore copies into the
        cost model (no-op without a ``restore_timings`` hook)."""
        if self._restore_timings is not None:
            for nbytes, seconds in self._restore_timings():
                self.cost_model.observe(nbytes, seconds)

    def release(self, gi: int) -> None:
        """Unpin one ``acquire`` of group ``gi`` (making it evictable)."""
        entry = self._resident.get(int(gi))
        if entry is None or entry.pins < 1:
            raise ValueError(f"release without matching acquire (group {gi})")
        entry.pins -= 1
        self._enforce_budget()

    @contextlib.contextmanager
    def lease(self, gi: int):
        """Context-managed acquire/release pair around one launch."""
        state = self.acquire(gi)
        try:
            yield state
        finally:
            self.release(gi)

    # ------------------------------------------------------------ prefetching

    def prefetch(self, gi: int) -> bool:
        """Start bringing group ``gi``'s state on device ahead of its launch.

        A no-op (returning False) when the state is already resident at
        its current version.  Otherwise the same evict-to-fit + restore /
        build path as a miss runs *now* — and since a restore's
        host-to-device copy is enqueued on its own CUDA stream, the upload
        overlaps whatever launches the caller runs next instead of
        blocking the acquire that will eventually need this state.  The state is installed resident but
        *unpinned*; a later ``acquire`` consumes it as a hit (counting
        ``n_restore_overlapped`` when the prefetch restored), while an
        eviction or invalidation before any acquire counts the work as
        ``n_prefetch_wasted``.  Returns True when work was issued.

        A prefetch whose restore/build *fails* (after the cache's
        bounded retries) is contained here: the work is written off as
        ``n_prefetch_wasted`` and False is returned, with no exception
        escaping — a speculative page-in must never take the scheduler
        tick down, and the eventual launch-time ``acquire`` still
        surfaces a persistent fault.  The host copy survives a failed
        restore (see ``_materialize``), so nothing is lost either way.
        """
        gi = int(gi)
        self._price_restores()
        entry = self._resident.get(gi)
        if entry is not None and entry.version == self.version_of(gi):
            return False
        try:
            entry, kind = self._materialize(gi)
        except Exception:
            # speculative work only: swallow, count, let acquire retry
            self._event(gi, "prefetch")
            self._event(gi, "prefetch_wasted")
            return False
        entry.prefetched = kind
        self._event(gi, "prefetch")
        return True

    def protect(self, group_ids) -> None:
        """Shield ``group_ids`` from eviction until the next ``protect``.

        The scheduler's per-tick contract: groups scheduled to launch
        within their restore horizon are protected, so neither a prefetch
        nor a concurrent miss can evict a state that is about to be
        acquired.  Like pinning, protection makes the budget soft rather
        than deadlocking — each call *replaces* the previous set (pass an
        empty iterable to clear), so stale protection cannot accumulate.
        """
        self._protected = frozenset(int(g) for g in group_ids)

    # --------------------------------------------------------------- eviction

    def _over_budget(self, incoming_groups: int = 0,
                     incoming_bytes: int = 0) -> bool:
        if self.max_resident_groups is not None and (
            len(self._resident) + incoming_groups > self.max_resident_groups
        ):
            return True
        return self.device_budget_bytes is not None and (
            self.resident_bytes + incoming_bytes > self.device_budget_bytes
        )

    def _pick_victim(self) -> int | None:
        """Choose the next eviction victim, or None when nothing is evictable.

        Only unpinned, unprotected residents are candidates (LRU without
        a policy); None means soft budget, never a deadlock.
        """
        candidates = tuple(
            EvictionCandidate(
                group_id=gi, last_use=e.last_use, nbytes=e.nbytes,
                prefetched=e.prefetched is not None,
            )
            for gi, e in self._resident.items()
            if e.pins == 0 and gi not in self._protected
        )
        if not candidates:
            return None
        if self.eviction_policy is None:
            return candidates[0].group_id  # insertion order = LRU first
        victim = int(self.eviction_policy(candidates))
        if victim not in {c.group_id for c in candidates}:
            raise ValueError(
                f"eviction policy chose group {victim}, which is not an "
                f"evictable candidate"
            )
        return victim

    def _evict_lru_while(self, over) -> None:
        while over():
            victim = self._pick_victim()
            if victim is None:  # everything pinned/protected: soft budget
                return
            self.evict(victim)

    def _evict_to_fit(self, nbytes: int) -> None:
        """Make room for one incoming ``nbytes``-sized state up front."""
        self._evict_lru_while(lambda: self._over_budget(1, nbytes))

    def _enforce_budget(self) -> None:
        self._evict_lru_while(self._over_budget)

    def evict(self, gi: int) -> None:
        """Evict group ``gi`` from device (offloading first if configured)."""
        gi = int(gi)
        entry = self._resident.get(gi)
        if entry is None:
            return
        if entry.pins:
            raise ValueError(f"cannot evict pinned group {gi}")
        del self._resident[gi]
        self._add_bytes(-entry.nbytes)
        if self._offload is not None:
            entry.host = self._offload(entry.state)
            self._offloaded[gi] = entry
        entry.state = None  # drop the device reference either way
        self._mark_wasted_prefetch(gi, entry)
        self._event(gi, "evict")

    def _mark_wasted_prefetch(self, gi: int, entry: _Entry) -> None:
        """Count a prefetched state that left the device unconsumed."""
        if entry.prefetched is not None:
            entry.prefetched = None
            self._event(gi, "prefetch_wasted")

    def clear(self) -> None:
        """Drop every unpinned resident state (keeping host copies)."""
        for gi in [g for g, e in self._resident.items() if e.pins == 0]:
            self.evict(gi)

    # ------------------------------------------------------------ versioning

    def invalidate(self, gi: int) -> None:
        """Bump group ``gi``'s version and drop every cached copy of it.

        The compaction-driven invalidation path: the group's stored bytes
        (device state *and* host offload copy) no longer describe its
        corpus, so both are discarded and the next ``acquire`` cold-builds
        at the new version.  Only this group is touched — other groups'
        cached states and every query step survive.  Raises while the
        group is pinned (a launch in flight must never lose its state).
        """
        gi = int(gi)
        entry = self._resident.get(gi)
        if entry is not None:
            if entry.pins:
                raise ValueError(f"cannot invalidate pinned group {gi}")
            del self._resident[gi]
            self._add_bytes(-entry.nbytes)
            entry.state = None
            self._mark_wasted_prefetch(gi, entry)
        self._offloaded.pop(gi, None)
        self._versions[gi] = self.version_of(gi) + 1
        self._event(gi, "invalidate")

    def replace(self, gi: int, state: object, nbytes: int | None = None
                ) -> None:
        """Install ``state`` as group ``gi``'s new current version.

        The in-place compaction path: the caller has already produced the
        post-compaction state (``append_to_state`` on the leased old one),
        so instead of invalidate-then-rebuild the new state is installed
        directly at a bumped version — one version event, no cold build.
        Stale host copies are dropped; residency budgets are re-enforced
        against the (possibly re-priced) entry.  Raises while pinned.
        """
        gi = int(gi)
        entry = self._resident.get(gi)
        if entry is not None and entry.pins:
            raise ValueError(f"cannot replace pinned group {gi}")
        if entry is None:
            if nbytes is None:
                nbytes = self._nbytes_of(gi)
            self._evict_to_fit(nbytes)
            entry = _Entry(nbytes=nbytes)
            self._resident[gi] = entry
            self._add_bytes(nbytes)
        else:
            if nbytes is not None:
                self._add_bytes(nbytes - entry.nbytes)
                entry.nbytes = nbytes
            self._mark_wasted_prefetch(gi, entry)
        self._offloaded.pop(gi, None)
        self._versions[gi] = self.version_of(gi) + 1
        entry.version = self._versions[gi]
        entry.state = state
        entry.host = None
        self._resident.move_to_end(gi)
        self._touch(entry)
        self._event(gi, "invalidate")
        self._enforce_budget()
