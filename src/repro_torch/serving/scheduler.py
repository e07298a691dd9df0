"""Real-time scheduler: deadline-driven driver, prefetch, cost-aware evict.

The deadline-aware frontend is inert on its own: ``AsyncRetrievalService``
only launches work inside ``submit``/``poll``/``drain``, and the
``StateCache`` pages group states with a pure-LRU policy that knows
nothing about what is *about to* launch or what a restore costs.  But the
pending buffers are a schedule — every request carries a deadline, and a
deadline is a launch time — so the serving stack can be driven
predictively instead of reactively.  This module is that driver layer:

  ``ServiceDriver``      owns the service in real time.  Step-driven
                         (``step()`` on the injectable clock /
                         ``ManualClock`` — the deterministic form every
                         test and trace replay uses) or thread-backed
                         (``start()``/``stop()`` for wall-clock
                         deployments).  Each tick reads the pending
                         schedule, issues prefetches, fires expired
                         deadlines through ``poll``, and spends idle
                         ticks on background work
                         (``AsyncRetrievalService.idle_work``, handed
                         off from the undriven ``poll`` path).
  ``PrefetchPolicy``     decides which group states to bring on device
                         ahead of their launches.  The default
                         ``DeadlinePrefetch`` reads per-group pending
                         depth + oldest deadline and prefetches groups
                         launching within a restore horizon (or with
                         buffers near the batch size), soonest deadline
                         first, protecting them from eviction.
  ``EvictionPolicy``     makes the ``StateCache`` victim choice
                         pluggable.  ``LRUEviction`` reproduces the
                         classic choice; the driver's default
                         ``CostAwareEviction`` scores staleness against
                         ``state_nbytes`` restore cost, so a cheap
                         state is sacrificed before an expensive one of
                         similar recency.

Everything here only *reorders* paging work — prefetch is the same
restore issued earlier, eviction policies only choose among states the
LRU policy could also have evicted — so answers stay bit-exact with the
undriven ``poll()`` loop, prefetch on or off, paged or not.

On the card a prefetch's restore is enqueued on the ``StatePager``'s copy
stream, so it overlaps the launches of the same tick; the launch that
reads the state waits on the copy's event on its own stream, which in
thread mode is the driver thread's current stream.  The streaming
writes (``insert``/``delete``/``compact``) pass through under the
driver's lock, and idle ticks compact the sealed delta backlog or run a
slice of the shadow recall queue.  A ``HealthMonitor`` (``health=``) is
evaluated once per tick, and its firing alerts end the tick summary.
"""

from __future__ import annotations

import dataclasses
import math
import threading

from .async_service import (
    AsyncRetrievalService,
    ManualClock,
    QueryFuture,
    _replay,
)
from .state_cache import EvictionCandidate

__all__ = [
    "CostAwareEviction",
    "DeadlinePrefetch",
    "DriverStats",
    "EvictionPolicy",
    "LRUEviction",
    "PrefetchPolicy",
    "ServiceDriver",
    "replay_with_driver",
]


def _fmt_delta(v: float) -> str:
    """Format a tick-summary counter delta (integral values as ints)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else f"{f:.6g}"


# ------------------------------------------------------------------ eviction


class EvictionPolicy:
    """Pluggable ``StateCache`` victim choice.

    A policy is called with a non-empty tuple of ``EvictionCandidate``
    (every unpinned, unprotected resident group — pinned and protected
    groups are never offered) and must return one candidate's
    ``group_id``.  Policies see monotone access ticks, never wall-clock,
    so the choice is deterministic and replayable.
    """

    def __call__(
        self, candidates: tuple[EvictionCandidate, ...]
    ) -> int:
        """Return the ``group_id`` of the candidate to evict."""
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    """The classic choice: evict the least-recently-used candidate."""

    def __call__(
        self, candidates: tuple[EvictionCandidate, ...]
    ) -> int:
        """Return the candidate with the smallest ``last_use`` tick."""
        return min(
            candidates, key=lambda c: (c.last_use, c.group_id)
        ).group_id


@dataclasses.dataclass(frozen=True)
class CostAwareEviction(EvictionPolicy):
    """Evict the stalest state *per byte of restore cost*.

    Pure LRU treats a 4 MiB state and a 400 MiB state as equally cheap
    to lose, but re-acquiring them is not equally cheap: restore cost is
    one host-to-device copy of ``state_nbytes``.  This policy scores
    every candidate as ``age / nbytes`` — age in monotone access ticks
    since last use — and evicts the maximum: a state must be
    proportionally staler to justify evicting proportionally more
    restore bytes.  With equal sizes it degrades exactly to LRU.  Ties
    break toward the staler candidate, then the smaller group id, so
    the ordering is total and deterministic.

    ``cost_exponent`` tempers the size term (``age / nbytes**e``):
    1.0 is the balanced default, 0.0 recovers pure LRU.
    """

    cost_exponent: float = 1.0

    def __call__(
        self, candidates: tuple[EvictionCandidate, ...]
    ) -> int:
        """Return the candidate maximizing staleness per restore byte."""
        now = max(c.last_use for c in candidates) + 1

        def key(c: EvictionCandidate):
            age = now - c.last_use
            cost = max(c.nbytes, 1) ** self.cost_exponent
            return (age / cost, -c.last_use, -c.group_id)

        return max(candidates, key=key).group_id


# ----------------------------------------------------------------- prefetch


class PrefetchPolicy:
    """Decides which group states to page in ahead of their launches."""

    def plan(
        self,
        pending: dict[int, tuple[int, float]],
        q_batch: int,
        now: float,
        cache=None,
    ) -> tuple[list[int], set[int]]:
        """Return ``(prefetch_order, protect_set)`` for this tick.

        ``pending`` maps group id to ``(depth, oldest_deadline)`` per
        ``AsyncRetrievalService.pending_depths``.  ``prefetch_order`` is
        the list of groups to ``StateCache.prefetch``, most urgent
        first; ``protect_set`` is shielded from eviction until the next
        tick (it must contain every group the order asks to prefetch,
        or a later prefetch could evict an earlier one).  ``cache``
        optionally passes the shared ``StateCache`` so a policy can read
        learned restore-cost estimates (``restore_eta``); policies must
        accept ``cache=None`` and fall back to static knobs.
        """
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DeadlinePrefetch(PrefetchPolicy):
    """Prefetch groups that are scheduled to launch soon.

    A group is *imminent* when its oldest pending deadline falls within
    ``horizon_s`` of now (the restore horizon: the upload must start at
    least one restore-time before the launch), or when its buffer has
    filled past ``depth_fraction`` of ``q_batch`` (a full buffer
    launches immediately on the next submit, deadline notwithstanding).
    Imminent groups are prefetched soonest-deadline-first and protected
    from eviction for the tick, so a prefetch can never evict a state
    that is itself about to launch.

    Groups whose deadline has *already expired* are protected but not
    prefetched: their launch happens this very tick, so a restore issued
    now would serialize into the launch's critical path anyway — letting
    the launch fault it in keeps the hit/overlap counters honest (a
    same-tick restore must count as a miss, not an overlap).

    When the driver passes the shared ``StateCache``, the horizon is
    *learned* per group: the cache's ``RestoreCostModel`` (EWMA bytes/s
    over observed restore timings) predicts that group's restore time,
    and the effective horizon is ``max(horizon_s, eta_margin * eta)`` —
    a big state whose restore takes longer than the static knob is
    prefetched proportionally earlier, while ``horizon_s`` stays a
    deterministic floor so behaviour without timing data (and every
    virtual-time replay) is unchanged.
    """

    horizon_s: float = 0.050
    depth_fraction: float = 0.5
    eta_margin: float = 1.5  # prefetch this many predicted-restores early

    def plan(
        self,
        pending: dict[int, tuple[int, float]],
        q_batch: int,
        now: float,
        cache=None,
    ) -> tuple[list[int], set[int]]:
        """Imminent groups, soonest oldest-deadline first."""
        fill = max(1, math.ceil(self.depth_fraction * q_batch))
        due, coming = [], []
        for gi, (depth, deadline) in pending.items():
            horizon = self.horizon_s
            if cache is not None:
                horizon = max(
                    horizon, self.eta_margin * cache.restore_eta(gi)
                )
            if deadline <= now:  # launching this tick: protect only
                due.append(gi)
            elif deadline - now <= horizon or depth >= fill:
                coming.append((deadline, gi))
        order = [gi for _, gi in sorted(coming)]
        return order, set(order) | set(due)


# ------------------------------------------------------------------- driver


class DriverStats:
    """Running driver counters (one ``ServiceDriver`` lifetime).

    A *deadline miss* is counted when a group's oldest pending deadline
    has expired while its state is off-device — the restore (or cold
    build) then serializes into that launch's critical path.  Misses are
    accounted before the tick's prefetches run, so a prefetch issued in
    the same tick as the launch does not hide the miss.

    A read-only view over the stack's ``obs.MetricsRegistry``
    (``wlsh_driver_*`` counters); attaching a fresh driver resets the
    prefix, so one view spans one driver lifetime.
    """

    # attribute -> the (unlabeled) registry counter behind it
    _COUNTERS = {
        "n_ticks": "wlsh_driver_ticks_total",
        "n_launches": "wlsh_driver_launches_total",
        "n_deadlines_due": "wlsh_driver_deadlines_due_total",
        "n_deadline_misses": "wlsh_driver_deadline_misses_total",
        "n_prefetches_issued": "wlsh_driver_prefetches_issued_total",
        "n_idle_compactions": "wlsh_driver_idle_compactions_total",
    }

    def __init__(self, metrics):
        """Bind the view to ``metrics`` (the service stack's registry)."""
        self._metrics = metrics

    def __getattr__(self, name: str) -> int:
        """Read the registry counter backing attribute ``name``."""
        metric = type(self)._COUNTERS.get(name)
        if metric is None:
            raise AttributeError(name)
        return int(self._metrics.counter(metric).total())

    @property
    def deadline_miss_rate(self) -> float:
        """Missed fraction of expired deadlines (nan with none due)."""
        if not self.n_deadlines_due:
            return float("nan")
        return self.n_deadline_misses / self.n_deadlines_due

    def summary(self) -> dict:
        """Flat dict of every counter plus the derived miss rate."""
        return dict(
            n_ticks=self.n_ticks,
            n_launches=self.n_launches,
            n_deadlines_due=self.n_deadlines_due,
            n_deadline_misses=self.n_deadline_misses,
            n_prefetches_issued=self.n_prefetches_issued,
            n_idle_compactions=self.n_idle_compactions,
            deadline_miss_rate=self.deadline_miss_rate,
        )


class ServiceDriver:
    """Deadline-driven real-time driver over an ``AsyncRetrievalService``.

    One ``step()`` is a scheduler tick:

    1. read the pending schedule (``pending_depths``);
    2. account deadline misses (expired deadline, state off-device);
    3. run the prefetch policy — protect imminent groups from eviction
       and issue ``StateCache.prefetch`` for the non-resident ones, so
       their host-to-device uploads overlap the launches below;
    4. ``poll()`` — launch every group whose oldest deadline expired;
    5. on an idle tick (nothing launched), run one slice of background
       work (``AsyncRetrievalService.idle_work``).

    Step-driven use (tests, trace replay) calls ``step`` explicitly on
    the service's injectable clock — fully deterministic, no wall-clock
    sleeps anywhere.  Wall-clock use calls ``start()``: a daemon thread
    sleeps until the next pending deadline (or ``tick_s`` when idle),
    waking early on ``submit``.  In thread mode, go through the
    driver's passthroughs ``submit``/``drain``, which serialize against
    the driver thread; the step-driven form has no second thread and
    needs no locking.

    Constructing the driver takes ownership of the service's idle-time
    work (undriven ``poll`` stops running it) and installs ``eviction``
    on the shared ``StateCache`` (pass None to keep the cache's current
    policy); ``detach()`` reverses both.
    """

    def __init__(
        self,
        service: AsyncRetrievalService,
        *,
        prefetch: PrefetchPolicy | None = DeadlinePrefetch(),
        eviction: EvictionPolicy | None = CostAwareEviction(),
        tick_s: float = 0.005,
        health: "HealthMonitor | None" = None,
    ):
        if not (tick_s > 0):
            raise ValueError(f"tick_s must be > 0, got {tick_s}")
        if service.driver is not None:
            raise ValueError("service already has a driver attached")
        self.svc = service
        self.cache = service.batcher.state_cache
        self.prefetch = prefetch
        self.tick_s = float(tick_s)
        # driver counters live in the stack's unified registry; a fresh
        # driver over a reused service starts its lifetime at zero
        self.metrics = service.batcher.metrics
        self.metrics.reset("wlsh_driver_")
        self.stats = DriverStats(self.metrics)
        # SLO burn-rate alerting (obs.health.HealthMonitor): evaluated
        # once per tick after poll, surfaced in tick_summary.  None =
        # no alerting
        self.health = health
        self._last_snap: dict | None = None  # tick_summary diff baseline
        self._prev_policy = self.cache.eviction_policy
        if eviction is not None:
            self.cache.eviction_policy = eviction
        service.driver = self
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- stepping

    def step(self, now: float | None = None) -> int:
        """One scheduler tick; returns the number of batches launched.

        The policy's imminent set is clamped to the cache budget before
        it is protected or prefetched (soonest deadline first), so
        scheduling can never turn over-budget residency into a steady
        state — the budget stays the budget, and anything past it simply
        faults in at launch time like an undriven service.  A tick is the
        layer span ``wlsh_tick`` (``obs.trace.span``).
        """
        with self._lock, self.svc.batcher.span("wlsh_tick"):
            if now is None:
                now = self.svc.clock()
            m = self.metrics
            pending = self.svc.pending_depths()
            due = []
            for gi, (_, deadline) in pending.items():
                if deadline <= now:
                    due.append((deadline, gi))
                    m.counter("wlsh_driver_deadlines_due_total",
                              "group-deadlines found expired").inc()
                    if not self.cache.is_resident(gi):
                        m.counter(
                            "wlsh_driver_deadline_misses_total",
                            "expired deadlines with state off-device",
                        ).inc()
            if self.prefetch is not None:
                order, shield = self.prefetch.plan(
                    pending, self.svc.batcher.cfg.q_batch, now,
                    cache=self.cache,
                )
                due_gis = [gi for _, gi in sorted(due)]
                kept = self._clamp_to_budget(
                    due_gis
                    + [gi for gi in order if gi not in set(due_gis)]
                )
                self.cache.protect(shield & kept)
                for gi in order:
                    if gi in kept and self.cache.prefetch(gi):
                        m.counter(
                            "wlsh_driver_prefetches_issued_total",
                            "prefetch calls that issued paging work",
                        ).inc()
            n = self.svc.poll(now)
            m.counter("wlsh_driver_launches_total",
                      "batches launched by driver ticks").inc(n)
            if self.svc.qos is not None:
                # close the tick for degradation hysteresis: sustained
                # deferral pressure steps degradable tenants down the
                # (c, k) ladder; sustained clear ticks step them back up
                self.svc.qos.observe_tick()
            if n == 0 and self.svc.idle_work():
                m.counter("wlsh_driver_idle_compactions_total",
                          "idle ticks that absorbed sealed rows").inc()
            m.counter("wlsh_driver_ticks_total",
                      "scheduler ticks").inc()
            # close the tick for SLO alerting: publish the queue depth
            # the gauge rules watch, then evaluate every alert rule on
            # this tick's counter movement
            if self.health is not None:
                m.gauge("wlsh_pending_queue_depth",
                        "requests queued across pending buffers").set(
                    self.svc.pending_count)
                self.health.observe(now)
            return n

    def _clamp_to_budget(self, priority: list[int]) -> set[int]:
        """Longest prefix of ``priority`` the cache budget can hold.

        ``priority`` is the imminent groups, most urgent first (due
        launches, then the prefetch order).  Without the clamp, a
        horizon wider than the deadline budget would protect every
        pending group and make over-budget residency the steady state;
        clamped, protection + prefetch together never claim more groups
        (or bytes) than the configured budget.
        """
        cap = self.cache.max_resident_groups
        budget = self.cache.device_budget_bytes
        if cap is None and budget is None:
            return set(priority)
        kept: set[int] = set()
        nbytes = 0
        for gi in priority:
            nb = self.cache.nbytes_of(gi)
            if cap is not None and len(kept) + 1 > cap:
                break
            if budget is not None and nbytes + nb > budget:
                break
            kept.add(gi)
            nbytes += nb
        return kept

    def tick_summary(self) -> str:
        """One-line counter movement since the previous summary call.

        Built from ``MetricsRegistry.diff`` against the snapshot the
        last call took — the driver's human-readable heartbeat (the
        launcher prints it after a driven replay).  The layer spans' host
        clock counters (``wlsh_layer_*``) are left out: the heartbeat
        counts work, on the service's clock or none.
        """
        diff = {name: d for name, d in
                self.metrics.diff(self._last_snap).items()
                if not name.startswith("wlsh_layer_")}
        self._last_snap = self.metrics.snapshot()
        firing = ([a.rule for a in self.health.firing()]
                  if self.health is not None else [])
        suffix = (" | ALERTS: " + ",".join(firing)) if firing else ""
        if not diff:
            return "driver: idle (no counter movement)" + suffix
        parts = []
        for name in sorted(diff):
            total = sum(diff[name].values())
            short = name.removeprefix("wlsh_").removesuffix("_total")
            parts.append(f"{short}=+{_fmt_delta(total)}")
        return "driver: " + " ".join(parts) + suffix

    def submit(self, query, weight_id, deadline: float | None = None,
               tenant: str | None = None) -> QueryFuture:
        """Thread-safe ``AsyncRetrievalService.submit`` passthrough.

        Serializes against a running driver thread; a full buffer still
        launches inside the call, and the sleeping thread is woken so
        the new request's deadline is picked up immediately.
        """
        with self._lock:
            return self.svc.submit(query, weight_id, deadline,
                                   tenant=tenant)

    def drain(self) -> int:
        """Thread-safe ``AsyncRetrievalService.drain`` passthrough."""
        with self._lock:
            return self.svc.drain()

    def insert(self, vector, weight_id) -> int:
        """Thread-safe ``AsyncRetrievalService.insert`` passthrough.

        Streaming writes mutate the same per-group delta structures the
        driver thread's idle-tick compaction rewrites, so in thread mode
        they go through the driver's lock like ``submit``.
        """
        with self._lock:
            return self.svc.insert(vector, weight_id)

    def delete(self, point_id: int) -> None:
        """Thread-safe ``AsyncRetrievalService.delete`` passthrough."""
        with self._lock:
            self.svc.delete(point_id)

    def compact(self, group: int | None = None, purge: bool = False) -> int:
        """Thread-safe ``AsyncRetrievalService.compact`` passthrough."""
        with self._lock:
            return self.svc.compact(group, purge=purge)

    def notify_submit(self) -> None:
        """Wake the driver thread early (called by the service's submit)."""
        self._wake.set()

    # ---------------------------------------------------------- thread mode

    @property
    def running(self) -> bool:
        """Whether the wall-clock driver thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "ServiceDriver":
        """Launch the wall-clock driver thread (returns self).

        Requires a real (monotonic) clock: a ``ManualClock`` only moves
        when a test advances it, so a thread sleeping on it would spin
        on a frozen deadline — step-driven mode is the deterministic
        form, use ``step()`` there instead.
        """
        if isinstance(self.svc.clock, ManualClock):
            raise TypeError(
                "thread mode needs a real clock; drive a ManualClock "
                "service with step() instead"
            )
        if self.running:
            raise RuntimeError("driver thread already running")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="wlsh-service-driver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the driver thread; ``drain`` flushes remaining requests.

        Idempotent, and safe to call with the thread never started (the
        drain still runs, so no submitted future is left unresolvable).
        """
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.drain()

    def detach(self) -> None:
        """Release the service, reversing everything the attach did.

        Stops the thread (without draining), hands idle-time work back
        to ``poll``, restores the cache's previous eviction policy, and
        clears this driver's eviction protection.
        """
        self.stop(drain=False)
        self.cache.protect(())
        self.cache.eviction_policy = self._prev_policy
        if self.svc.driver is self:
            self.svc.driver = None

    def _run(self) -> None:
        while not self._stop.is_set():
            self.step()
            with self._lock:
                nd = self.svc.next_deadline()
                now = self.svc.clock()
            wait = self.tick_s if nd is None else (
                min(max(nd - now, 0.0), self.tick_s)
            )
            if wait > 0:
                self._wake.wait(wait)
            self._wake.clear()


# -------------------------------------------------------------- trace replay


def replay_with_driver(driver: ServiceDriver, queries, weight_ids,
                       arrivals, tenants=None):
    """Open-loop trace replay stepped by a ``ServiceDriver`` (virtual time).

    The driver-owned parameterization of the same replay core behind
    ``async_service.replay_open_loop``: the same absolute arrival
    schedule on a ``ManualClock``, but every event — each arrival and
    each expiring deadline — is a ``driver.step()``, so prefetches are
    issued from the pending schedule between launches exactly as a
    wall-clock driver thread would issue them.  Stepping at arrivals
    launches nothing extra (no deadline has newly expired there), so
    results are bit-exact with the undriven ``poll()`` replay of the
    same trace.

    Returns ``(RetrievalResult, waits)`` in submission order, where
    ``waits[i]`` is the virtual seconds request ``i`` spent queued.
    """
    return _replay(driver.svc, queries, weight_ids, arrivals,
                   tick=driver.step, tick_at_arrivals=True,
                   tenants=tenants)
