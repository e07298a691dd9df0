"""Deadline-aware asynchronous frontend over the shared batching core.

The synchronous ``RetrievalService`` only fills a batch when a full
``q_batch`` of same-group traffic arrives in one call — under
open-loop streaming traffic (each request submitted alone as it arrives)
every launch pads ``q_batch - 1`` dead rows and occupancy collapses to
``1/q_batch``.  This module trades a bounded wait
for occupancy:

  submit    each (query, weight_id[, deadline]) enters its group's
            pending buffer and gets a ``QueryFuture``
  fill      a buffer reaching q_batch launches immediately
  deadline  ``poll()`` launches any group whose oldest pending request
            has expired (default budget ``ServiceConfig.max_delay_ms``)
  drain     flushes everything regardless of deadline (shutdown / end of
            trace)

Launches go through ``Batcher.run_batch`` — the same padding, encoding
and step path as the sync frontend — so the two are bit-exact on
identical traffic, and ``QueryStepCache`` builds nothing new when an
async frontend is layered over a warmed sync service.  Futures resolve
in submission order within each launch.

The clock is injectable: real deployments use ``time.monotonic`` (the
default), while tests and open-loop trace replay (``replay_open_loop``)
drive a deterministic ``ManualClock`` so deadline behaviour is exact and
repeatable.

Streaming writes (``insert``/``delete``/``compact``) apply at once, and
an idle poll compacts the sealed delta backlog (``compact_on_idle``) or
runs a slice of the shadow recall queue.  With ``ServiceConfig.obs``
every accepted submit opens one trace span, resolved with its future.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np

from .batching import Batcher
from .qos import DEFAULT_TENANT, QosScheduler
from .retrieval import RetrievalResult, RetrievalService

__all__ = [
    "AsyncRetrievalService",
    "ManualClock",
    "Overloaded",
    "QueryAnswer",
    "QueryFuture",
    "replay_open_loop",
]


class Overloaded(RuntimeError):
    """Backpressure: a group's pending buffer is at ``max_pending``.

    Raised by ``AsyncRetrievalService.submit`` *before* the request is
    enqueued (the caller holds no future and has lost nothing).  Carries
    the observed depth so callers can shed load or back off:

    * ``group_id`` — the group whose buffer is full
    * ``depth`` — its pending depth at rejection time
    * ``max_pending`` — the configured ``ServiceConfig.max_pending`` cap
    """

    def __init__(self, group_id: int, depth: int, max_pending: int):
        super().__init__(
            f"group {group_id} pending buffer is full "
            f"({depth}/{max_pending}); poll() or drain() frees it"
        )
        self.group_id = int(group_id)
        self.depth = int(depth)
        self.max_pending = int(max_pending)


class ManualClock:
    """Deterministic monotonic clock for tests and trace replay."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        """Move the clock forward by ``dt`` seconds (dt < 0 raises)."""
        if dt < 0:
            raise ValueError(f"clock must not run backwards (dt={dt})")
        self.t += dt
        return self.t

    def advance_to(self, t: float) -> float:
        """Jump the clock to absolute time ``t`` (going backwards raises)."""
        if t < self.t:
            raise ValueError(f"clock must not run backwards ({t} < {self.t})")
        self.t = float(t)
        return self.t


@dataclasses.dataclass(frozen=True)
class QueryAnswer:
    """One query's answer (the async counterpart of a RetrievalResult row)."""

    ids: np.ndarray  # (k,) int32, -1 = missing
    dists: np.ndarray  # (k,) f32, +inf = missing
    group_id: int
    stop_level: int
    n_checked: int


class QueryFuture:
    """Handle for one submitted query, resolved when its batch launches."""

    __slots__ = ("_answer", "_done", "t_resolved")

    def __init__(self):
        self._answer = None
        self._done = False
        self.t_resolved: float | None = None  # clock time of the launch

    def done(self) -> bool:
        """Whether the query's batch has launched and the answer is set."""
        return self._done

    def result(self) -> QueryAnswer:
        """The resolved ``QueryAnswer`` (raises while still pending)."""
        if not self._done:
            raise RuntimeError(
                "query still pending — its batch has not launched yet "
                "(advance the clock past the deadline and poll(), or drain())"
            )
        return self._answer

    def _resolve(self, answer: QueryAnswer, now: float) -> None:
        self._answer = answer
        self._done = True
        self.t_resolved = now


@dataclasses.dataclass(eq=False)  # identity semantics: requests may repeat
class _Pending:
    query: np.ndarray
    weight_id: int
    deadline: float
    t_submit: float
    future: QueryFuture
    tenant: str = DEFAULT_TENANT
    span: object = None  # obs.TraceSpan when tracing is enabled


class AsyncRetrievalService:
    """Deadline-aware streaming frontend: fill-or-deadline batch launches.

    Wraps an existing ``RetrievalService`` (or its ``Batcher``) so group
    states, serving stats and the step cache are shared across
    frontends.  ``max_delay_ms`` overrides ``ServiceConfig.max_delay_ms``
    as the default per-request deadline budget; an explicit ``deadline``
    (absolute clock time) on ``submit`` overrides both.

    Single-threaded by design: launches happen inside ``submit`` (batch
    full), ``poll`` (deadline expired) and ``drain``.  A real-time caller
    polls on its event loop at ``next_deadline()``; trace replay drives a
    ``ManualClock`` through the same code path.

    Every launch leases its group's state from the shared ``StateCache``
    (pinned only while the step runs), so under a residency
    budget a burst of deadline-driven partial launches pages states
    between launches — never under one — and answers stay bit-exact.
    """

    def __init__(
        self,
        service: RetrievalService | Batcher,
        max_delay_ms: float | None = None,
        clock=time.monotonic,
        compact_on_idle: bool = True,
        qos: QosScheduler | None = None,
    ):
        self.batcher = (
            service.batcher if isinstance(service, RetrievalService)
            else service
        )
        if max_delay_ms is None:
            max_delay_ms = self.batcher.cfg.max_delay_ms
        if not (max_delay_ms >= 0):  # also rejects NaN
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        self.max_delay_ms = float(max_delay_ms)
        self.clock = clock
        # the batcher keeps time on the same clock, so ManualClock
        # replays are deterministic end to end
        self.batcher.clock = clock
        # multi-tenant QoS: admission control + per-class SLO deadlines
        # on submit, weighted-fair capacity-bounded dequeue on poll, and
        # (driver-stepped) (c, k) degradation under sustained overload.
        # None = single-tenant service, bit-identical to the pre-QoS path
        self.qos = qos
        if qos is not None:
            # fold the scheduler's standalone counters into the serving
            # stack's unified registry: one source of truth per stack
            qos.bind_metrics(self.batcher.metrics)
        # background compaction: an idle poll (nothing expired to launch)
        # absorbs the streaming delta's *sealed* backlog into the group
        # states, capacity permitting
        self.compact_on_idle = bool(compact_on_idle)
        # a scheduler.ServiceDriver that has taken ownership of idle-time
        # work (background compaction) and wants submit wake-ups; None =
        # undriven (poll() runs idle_work on idle ticks itself)
        self.driver = None
        # pending buffers keyed (group_id, tenant): one tenant's queries
        # never share a launch with another's, so a degraded tenant's
        # relaxed step cannot touch a strict tenant's answers.  The
        # default tenant keeps the pre-QoS one-buffer-per-group layout
        self._pending: dict[
            tuple[int, str], collections.deque[_Pending]
        ] = collections.defaultdict(collections.deque)
        # launch-cause counters (visible to tests and the launcher)
        self.n_launched_full = 0
        self.n_launched_deadline = 0
        self.n_launched_drain = 0

    # ------------------------------------------------------------- inspection

    @property
    def pending_count(self) -> int:
        """Total queued requests across every group's pending buffer."""
        return sum(len(q) for q in self._pending.values())

    def next_deadline(self) -> float | None:
        """Earliest pending deadline across groups (None = nothing pending)."""
        deadlines = [
            min(r.deadline for r in q)
            for q in self._pending.values() if q
        ]
        return min(deadlines) if deadlines else None

    def pending_depths(self) -> dict[int, tuple[int, float]]:
        """Per-group ``(depth, oldest_deadline)`` over non-empty buffers.

        The scheduler's view of the pending schedule: a deadline is a
        launch time, so the prefetch policy reads this to decide which
        group states to bring on device ahead of their launches.
        Per-tenant buffers aggregate to their group here — prefetch
        cares which *state* is about to launch, not for whom.
        """
        out: dict[int, tuple[int, float]] = {}
        for (gi, _tenant), q in self._pending.items():
            if not q:
                continue
            oldest = min(r.deadline for r in q)
            depth, prev = out.get(gi, (0, oldest))
            out[gi] = (depth + len(q), min(prev, oldest))
        return out

    def pending_tenant_depths(self) -> dict[tuple[int, str],
                                            tuple[int, float]]:
        """Per-``(group, tenant)`` ``(depth, oldest_deadline)`` snapshot.

        The fair queue's view: what ``QosScheduler.plan_launches``
        orders by deadline and serves by deficit round robin.
        """
        return {
            key: (len(q), min(r.deadline for r in q))
            for key, q in self._pending.items() if q
        }

    # ---------------------------------------------------------------- serving

    def submit(self, query, weight_id, deadline: float | None = None,
               tenant: str | None = None) -> QueryFuture:
        """Enqueue one request; launches its group's batch if now full.

        ``tenant`` names the submitting tenant class.  With a
        ``QosScheduler`` attached, the tenant must be registered
        (``KeyError`` otherwise), the submit is admission-controlled
        (typed ``RateLimited`` *before* enqueueing when the class's
        token bucket is empty), and a missing explicit ``deadline``
        takes the class's SLO budget instead of ``max_delay_ms``.
        Backpressure (``Overloaded``) is checked against the group's
        total pending depth across tenants, before any token is spent —
        a rejected caller never consumes admission budget.
        """
        now = self.clock()
        if tenant is None:
            tenant = DEFAULT_TENANT
        query = np.asarray(query, np.float32).reshape(-1)
        if query.shape != (self.batcher.plan.d,):
            raise ValueError(
                f"query must be a single ({self.batcher.plan.d},) vector, "
                f"got shape {query.shape}"
            )
        gi = int(self.batcher.route(weight_id)[0])
        max_pending = self.batcher.cfg.max_pending
        if max_pending is not None:
            depth = sum(
                len(q) for (g, _t), q in self._pending.items() if g == gi
            )
            if depth >= max_pending:
                # reject before enqueueing: the caller holds no future,
                # the buffer stays bounded, poll()/drain() frees capacity
                raise Overloaded(gi, depth, max_pending)
        if self.qos is not None:
            # admission last among the reject paths: a raise after the
            # token was spent would leak admission budget
            self.qos.admit(tenant, now)
        if deadline is None:
            if self.qos is not None:
                deadline = self.qos.deadline_for(
                    tenant, now, self.max_delay_ms / 1e3
                )
            else:
                deadline = now + self.max_delay_ms / 1e3
        elif not np.isfinite(deadline):
            # a NaN/inf deadline would never compare expired in poll() and
            # would poison next_deadline() for every event-loop driver
            raise ValueError(f"deadline must be finite, got {deadline}")
        tr = self.batcher.tracer
        span = None
        if tr is not None:
            # past every reject path: an Overloaded / RateLimited /
            # invalid submit never opens a span, so exactly one span
            # exists per accepted query
            span = tr.begin(weight_id=int(weight_id), group_id=gi,
                            tenant=str(tenant))
            t_routed = self.clock()
            span.mark("submit", now)
            span.mark("route", t_routed)
            if self.qos is not None:
                span.mark("admit", t_routed)
            span.mark("queue", t_routed)
        fut = QueryFuture()
        pend = _Pending(query, int(weight_id), float(deadline), now, fut,
                        str(tenant), span)
        q = self._pending[(gi, str(tenant))]
        q.append(pend)
        # with QoS attached, a full buffer launches at the next poll tick
        # instead of inside submit: *every* launch then flows through the
        # weighted-fair queue under the capacity, so no tenant can buy
        # extra capacity by bursting a buffer full
        if len(q) >= self.batcher.cfg.q_batch and self.qos is None:
            try:
                self._launch((gi, str(tenant)), "full")
            except Exception:
                # submit is atomic too: the caller never receives ``fut`` on
                # a raise, so withdraw their request (it is the newest, put
                # back last by the launch rollback) — a retry re-submits it,
                # while earlier requests stay queued with live futures
                if q and q[-1] is pend:
                    q.pop()
                raise
        if self.driver is not None:
            self.driver.notify_submit()  # wake a sleeping driver thread
        return fut

    def poll(self, now: float | None = None) -> int:
        """Launch every group whose oldest pending deadline has expired.

        Returns the number of batches launched.  An idle poll (nothing
        launched) additionally runs ``idle_work``, so background work
        rides the event loop's quiet ticks, never delaying a launch.
        With a ``scheduler.ServiceDriver`` attached, idle-time work is
        the driver's (its ticks call ``idle_work`` themselves).

        With a ``QosScheduler`` attached, launchable buffers (oldest
        deadline expired *or* filled to ``q_batch`` — submit defers full
        launches to the tick under QoS) instead go through
        ``QosScheduler.plan_launches``: deadline-ordered, served
        weighted-fair by deficit round robin under the scheduler's
        per-tick capacity.  Deferred launchable buffers register
        overload pressure; a tick with nothing launchable registers a
        clear tick, so the degradation hysteresis sees both.

        An undriven poll is the layer span ``wlsh_tick``; a driven one
        runs inside the driver's.
        """
        tick = (self.batcher.span("wlsh_tick") if self.driver is None
                else contextlib.nullcontext())  # else in the driver's tick
        with tick:
            if now is None:
                now = self.clock()
            n = 0
            if self.qos is None:
                for key in list(self._pending):
                    q = self._pending[key]
                    if q and min(r.deadline for r in q) <= now:
                        self._launch(key, "deadline")
                        n += 1
            else:
                qb = self.batcher.cfg.q_batch
                launchable = [
                    (min(r.deadline for r in q), key[0], key[1])
                    for key, q in self._pending.items()
                    if q and (min(r.deadline for r in q) <= now
                              or len(q) >= qb)
                ]
                if launchable:
                    for gi, tenant in self.qos.plan_launches(launchable, now):
                        key = (gi, tenant)
                        cause = (
                            "full" if len(self._pending[key]) >= qb
                            else "deadline"
                        )
                        self._launch(key, cause)
                        n += 1
                else:
                    self.qos.note_idle_tick()
            if n == 0 and self.driver is None:
                self.idle_work()
            return n

    def idle_work(self) -> int:
        """One slice of idle-time background work, returning rows compacted.

        Compacts the streaming delta's *sealed* backlog when
        ``compact_on_idle`` is set, returning the rows absorbed.  Called
        by an undriven idle ``poll()``, or by the ``ServiceDriver``'s idle
        ticks once one owns the service.  A tick with nothing to compact
        instead executes one bounded slice of the shadow recall queue
        (``ServiceConfig.recall_shadow_slice`` oracle re-ranks): quality
        telemetry rides the quiet ticks, never a launch.
        """
        n = 0
        if self.compact_on_idle and self.batcher.delta is not None:
            n = self.batcher.delta.compact_sealed()
        recall = self.batcher.recall
        if n == 0 and recall is not None and recall.backlog:
            recall.run(max_jobs=recall.slice)
        return n

    # ------------------------------------------------------------- streaming

    def insert(self, vector, weight_id) -> int:
        """Insert one vector into ``weight_id``'s group (applied at once).

        Writes are synchronous even on the async frontend: the row is in
        its group's delta memtable, and visible to queries, when this
        returns.  Returns the assigned global point id.
        """
        return self.batcher.insert(vector, weight_id)

    def delete(self, point_id: int) -> None:
        """Tombstone a global point id; it never appears in results again."""
        self.batcher.delete(point_id)

    def compact(self, group: int | None = None, purge: bool = False) -> int:
        """Flush and compact delta segments (see ``Batcher.compact``).

        ``purge=True`` runs the tombstone-purging rebuild.
        """
        return self.batcher.compact(group, purge=purge)

    def drain(self) -> int:
        """Flush all pending buffers regardless of deadline."""
        n = 0
        for key in list(self._pending):
            while self._pending[key]:
                self._launch(key, "drain")
                n += 1
        return n

    def _launch(self, key: tuple[int, str], cause: str) -> None:
        gi, tenant = key
        q = self._pending[key]
        qb = self.batcher.cfg.q_batch
        batch = [q.popleft() for _ in range(min(qb, len(q)))]
        # the tenant's current degradation rung picks which prebuilt
        # (c, k) step serves this launch; rung 0 (and qos=None) is the
        # strict configured parameters
        rung = self.qos.rung_of(tenant) if self.qos is not None else 0
        tr = self.batcher.tracer
        try:
            ids, dists, stop, chk = self.batcher.run_batch(
                gi,
                np.stack([r.query for r in batch]),
                np.array([r.weight_id for r in batch], np.int64),
                rung=rung,
                spans=(
                    [r.span for r in batch] if tr is not None else None
                ),
            )
        except Exception:
            # atomic launch: put the batch back (original order, ahead of
            # anything newer) so a caller that retries after a device error
            # has lost nothing and no future is stranded unresolvable
            q.extendleft(reversed(batch))
            raise
        if cause == "full":
            self.n_launched_full += 1
        elif cause == "deadline":
            self.n_launched_deadline += 1
        else:
            self.n_launched_drain += 1
        now = self.clock()
        wait_h = self.batcher.metrics.histogram(
            "wlsh_query_wait_seconds",
            "submit-to-resolve wait on the service clock",
        )
        for i, r in enumerate(batch):  # submission order within the launch
            r.future._resolve(QueryAnswer(
                ids=ids[i], dists=dists[i], group_id=gi,
                stop_level=int(stop[i]), n_checked=int(chk[i]),
            ), now)
            wait_h.observe(now - r.t_submit)
            if r.span is not None:
                r.span.cause = cause
                r.span.mark("resolve", now)
                tr.finish(r.span)
            if self.qos is not None:
                self.qos.on_resolved(
                    r.tenant, now - r.t_submit, now > r.deadline, rung
                )


def _replay(svc: AsyncRetrievalService, queries, weight_ids, arrivals,
            tick, tick_at_arrivals: bool = False, tenants=None):
    """Shared open-loop replay core (``replay_open_loop`` and the
    scheduler's ``replay_with_driver`` parameterize only the tick).

    ``tick`` fires expired deadlines (``poll`` undriven,
    ``ServiceDriver.step`` driven); ``tick_at_arrivals`` additionally
    ticks at every arrival instant — those ticks never launch anything
    (no deadline has newly expired there), they only give a driver's
    prefetch policy its lead time, so both parameterizations stay
    bit-exact on the same trace by construction.  ``tenants`` optionally
    names the submitting tenant per request (multi-tenant QoS traces);
    admission rejections (``RateLimited``) propagate to the caller.
    """
    if not isinstance(svc.clock, ManualClock):
        raise TypeError("open-loop replay requires a ManualClock service")
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    weight_ids = np.atleast_1d(np.asarray(weight_ids, np.int64))
    arrivals = np.atleast_1d(np.asarray(arrivals, np.float64))
    nq = len(queries)
    if not (len(weight_ids) == len(arrivals) == nq):
        raise ValueError("queries / weight_ids / arrivals length mismatch")
    if tenants is not None and len(tenants) != nq:
        raise ValueError("tenants length must match queries")
    if np.any(np.diff(arrivals) < 0):
        raise ValueError("arrivals must be non-decreasing")
    k = svc.batcher.cfg.k
    if nq == 0:  # degenerate trace: agree with the sync frontend
        return RetrievalResult(
            ids=np.empty((0, k), np.int32),
            dists=np.empty((0, k), np.float32),
            group_ids=np.empty(0, np.int32),
            stop_levels=np.empty(0, np.int32),
            n_checked=np.empty(0, np.int32),
        ), np.empty(0)

    def fire(nd: float) -> None:
        # a QoS capacity can defer expired work, so nd may already be in
        # the past — hold time still and tick again (each tick grants a
        # fresh fair-queue budget).  A tick that then launches nothing is
        # a permanent stall (capacity below the cheapest launch cost):
        # fail loudly instead of spinning forever
        svc.clock.advance_to(max(nd, svc.clock()))
        before = svc.pending_count
        tick()
        if svc.pending_count == before and svc.next_deadline() == nd:
            raise RuntimeError(
                "replay stalled: an expired launch never fires — is "
                "qos capacity_per_tick below the cheapest launch cost?"
            )

    futs: list[QueryFuture] = []
    for i in range(nq):
        while True:  # fire deadlines that expire before this arrival
            nd = svc.next_deadline()
            if nd is None or nd > arrivals[i]:
                break
            fire(nd)
        svc.clock.advance_to(arrivals[i])
        if tick_at_arrivals:
            tick()
        tenant = None if tenants is None else tenants[i]
        futs.append(svc.submit(queries[i], weight_ids[i], tenant=tenant))
    while svc.pending_count:  # run out the tail
        fire(svc.next_deadline())

    answers = [f.result() for f in futs]
    t_resolved = np.array([f.t_resolved for f in futs])
    res = RetrievalResult(
        ids=np.stack([a.ids for a in answers]).astype(np.int32),
        dists=np.stack([a.dists for a in answers]).astype(np.float32),
        group_ids=np.array([a.group_id for a in answers], np.int32),
        stop_levels=np.array([a.stop_level for a in answers], np.int32),
        n_checked=np.array([a.n_checked for a in answers], np.int32),
    )
    assert res.ids.shape == (nq, k)
    return res, t_resolved - arrivals


def replay_open_loop(svc: AsyncRetrievalService, queries, weight_ids,
                     arrivals, tenants=None):
    """Open-loop trace replay on a ManualClock (virtual time).

    ``arrivals`` are absolute non-decreasing virtual times, one per query;
    each request is submitted alone at its arrival (the open-loop regime
    that starves a fill-only frontend), with the clock jumping to every
    deadline that expires between arrivals.  Device compute is off-clock:
    waits measure pure batching delay, which is what the deadline knob
    trades against occupancy.

    Returns ``(RetrievalResult, waits)`` in submission order, where
    ``waits[i]`` is the virtual seconds request ``i`` spent queued before
    its batch launched.
    """
    return _replay(svc, queries, weight_ids, arrivals, tick=svc.poll,
                   tenants=tenants)
