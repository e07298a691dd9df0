"""Multi-tenant QoS: admission, weighted fairness, SLO-aware degradation.

The real-time driver (``serving.scheduler``) schedules *paging* — which
states to bring on device ahead of their launches — but treats every
request identically: one tenant's burst can starve another's deadlines,
and overload only manifests as ``Overloaded`` rejections or deadline
misses.  This module turns the stack into a traffic-shaping layer:

  ``QosClass``           one tenant class: fair-share ``weight``,
                         token-bucket admission (``rate``/``burst``),
                         per-class SLO deadline budget (``slo_ms``) and
                         whether the tenant may be *degraded* under
                         overload.
  ``TokenBucket``        deterministic admission control on the
                         service's injectable clock — ``submit`` raises
                         a typed ``RateLimited`` before enqueueing, so
                         a rejected caller has lost nothing.
  ``DeficitRoundRobin``  weighted-fair dequeue across per-tenant launch
                         queues: every round credits each backlogged
                         tenant ``quantum * weight``, and a launch
                         spends its modeled cost from that deficit.
                         Low-weight tenants accumulate credit across
                         rounds, so they drain slower but are never
                         starved.
  ``DegradeStep``        one rung of the pre-planned (c, k) relaxation
                         ladder — the paper's accuracy-for-efficiency
                         trade (bound relaxation, Eqs. 14-15) applied
                         at serve time.  Each rung's step is built at
                         warmup (``c``/``k`` are part of
                         ``IndexConfig.shape_signature()``), so
                         stepping a tenant down the ladder never
                         builds a new one.
  ``QosScheduler``       ties it together: admits, orders launches
                         fairly under a per-tick capacity, watches for
                         sustained overload and steps *degradable*
                         tenants down the ladder (restoring strict
                         parameters once pressure clears), and keeps
                         per-tenant SLO statistics.

Everything here is pure host-side bookkeeping on the injectable clock —
no wall-clock reads, no device work — so every fairness and admission
property is deterministic and replayable (``tests/test_torch_qos.py``).
"""

from __future__ import annotations

import dataclasses
import math

from ..obs import MetricsRegistry

__all__ = [
    "DEFAULT_TENANT",
    "DegradeStep",
    "DeficitRoundRobin",
    "QosClass",
    "QosScheduler",
    "RateLimited",
    "TenantStats",
    "TokenBucket",
]

DEFAULT_TENANT = "default"  # tenant label used when the caller passes none


class RateLimited(RuntimeError):
    """Admission control rejected a submit: the token bucket is empty.

    Raised by ``AsyncRetrievalService.submit`` *before* the request is
    enqueued (like ``Overloaded``, the caller holds no future and has
    lost nothing).  Carries the tenant and its configured rate/burst so
    callers can back off per class:

    * ``tenant`` — the rejected tenant's class name
    * ``rate`` — its admitted queries/second
    * ``burst`` — its bucket capacity in queries
    """

    def __init__(self, tenant: str, rate: float, burst: float):
        super().__init__(
            f"tenant {tenant!r} exceeded its admission rate "
            f"({rate}/s, burst {burst}); retry after backoff"
        )
        self.tenant = str(tenant)
        self.rate = float(rate)
        self.burst = float(burst)


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One tenant class: priority weight, admission budget, SLO.

    * ``weight`` — deficit-round-robin fair share (relative; a weight-4
      tenant drains four launches for every one of a weight-1 tenant
      under contention, but the weight-1 tenant still drains).
    * ``rate``/``burst`` — token-bucket admission: at most ``rate``
      admitted queries/second sustained, ``burst`` in a spike.  ``rate
      = None`` disables admission control for the class.
    * ``slo_ms`` — per-class deadline budget: a submit without an
      explicit deadline gets ``now + slo_ms / 1e3``.  ``None`` falls
      back to the service's ``max_delay_ms``.
    * ``degradable`` — whether sustained overload may step this
      tenant's effective (c, k) down the scheduler's relaxation ladder.
      Strict-recall tenants keep ``False`` and are never degraded.
    """

    name: str
    weight: float = 1.0
    rate: float | None = None
    burst: float = 1.0
    slo_ms: float | None = None
    degradable: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant class name must be non-empty")
        if not (self.weight > 0):
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.rate is not None and not (self.rate > 0):
            raise ValueError(f"rate must be > 0 or None, got {self.rate}")
        if not (self.burst >= 1):
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.slo_ms is not None and not (self.slo_ms >= 0):
            raise ValueError(
                f"slo_ms must be >= 0 or None, got {self.slo_ms}"
            )


class TokenBucket:
    """Deterministic token bucket on an injectable clock.

    Refills continuously at ``rate`` tokens/second up to ``burst``; one
    admitted request spends one token.  All arithmetic runs on the
    caller-supplied ``now`` (the service clock), so admission decisions
    are exact and replayable on a ``ManualClock`` — conservation (number
    admitted over any window never exceeds ``burst + rate * window``) is
    property-tested, not hoped for.
    """

    def __init__(self, rate: float, burst: float = 1.0):
        if not (rate > 0):
            raise ValueError(f"rate must be > 0, got {rate}")
        if not (burst >= 1):
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)  # a fresh bucket starts full
        self._last: float | None = None

    def _refill(self, now: float) -> None:
        if self._last is None:
            self._last = now
        elif now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now

    def tokens_at(self, now: float) -> float:
        """Tokens available at clock time ``now`` (after refill)."""
        self._refill(now)
        return self._tokens

    def try_take(self, now: float, n: float = 1.0) -> bool:
        """Spend ``n`` tokens if available at ``now``; False = rejected."""
        self._refill(now)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


@dataclasses.dataclass(frozen=True)
class DegradeStep:
    """One rung of the (c, k) relaxation ladder.

    ``c`` is the relaxed approximation ratio (integer ``>=`` the strict
    plan's ``c`` — virtual rehashing needs an integer base, and a larger
    ``c`` stops the level loop earlier at a quantified recall cost);
    ``k`` the relaxed result count (``<=`` the strict ``k``; missing
    tail slots are padded ``-1``/``inf`` so answer shapes never change);
    ``cost`` the rung's modeled relative launch cost (strict = 1.0) —
    what the fair queue charges a degraded launch, so degradation frees
    capacity for the backlog.  ``recall_bound`` is the *planned*
    recall-vs-strict floor for the rung (what serve_bench sweep 8
    validates the measured recall against).
    """

    c: int
    k: int
    cost: float = 1.0
    recall_bound: float = 0.0

    def __post_init__(self):
        if self.c < 2 or self.c != int(self.c):
            raise ValueError(
                f"degrade rung needs integer c >= 2, got {self.c}"
            )
        if self.k < 1:
            raise ValueError(f"degrade rung needs k >= 1, got {self.k}")
        if not (self.cost > 0):
            raise ValueError(f"rung cost must be > 0, got {self.cost}")
        if not (0.0 <= self.recall_bound <= 1.0):
            raise ValueError(
                f"recall_bound must be in [0, 1], got {self.recall_bound}"
            )


class DeficitRoundRobin:
    """Weighted-fair launch ordering across per-tenant queues.

    Classic deficit round robin: each *round* credits every backlogged
    tenant ``quantum * weight``; a tenant then launches while its
    deficit covers the next launch's cost.  Deficits persist across
    calls while a tenant stays backlogged and reset when its queue
    drains (the textbook rule that bounds per-round unfairness), so:

    * **no starvation** — a backlogged tenant's deficit grows every
      round and eventually covers any bounded launch cost;
    * **work conservation** — rounds continue while capacity and
      backlog remain, so capacity is never idle with work pending;
    * **weighted shares** — over a contended window tenants drain in
      proportion to their weights.
    """

    def __init__(self, quantum: float = 1.0):
        if not (quantum > 0):
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self.quantum = float(quantum)
        self._deficit: dict[str, float] = {}

    def deficit_of(self, tenant: str) -> float:
        """Current carried deficit of ``tenant`` (0.0 when drained)."""
        return self._deficit.get(tenant, 0.0)

    def select(
        self,
        queues: dict[str, list],
        weight_of,
        cost_of,
        budget: float = math.inf,
    ) -> list:
        """Fair-order launches from per-tenant ``queues`` under ``budget``.

        ``queues`` maps tenant -> list of opaque launch items (urgency
        order, consumed front-first); ``weight_of(tenant)`` and
        ``cost_of(tenant)`` supply the fair-share weight and the
        per-launch cost.  Returns the selected items in service order;
        items not selected (budget exhausted) stay in ``queues`` —
        the caller sees exactly what was deferred.
        """
        order = sorted(queues, key=lambda t: (-weight_of(t), t))
        selected: list = []
        active = [t for t in order if queues[t]]
        while active:
            progress = False
            for t in list(active):
                if not queues[t]:
                    active.remove(t)
                    self._deficit[t] = 0.0
                    continue
                self._deficit[t] = (
                    self._deficit.get(t, 0.0)
                    + self.quantum * weight_of(t)
                )
                cost = cost_of(t)
                while queues[t] and self._deficit[t] >= cost and (
                    budget >= cost
                ):
                    selected.append(queues[t].pop(0))
                    self._deficit[t] -= cost
                    budget -= cost
                    progress = True
                if not queues[t]:
                    active.remove(t)
                    self._deficit[t] = 0.0
            if not progress:
                if all(budget < cost_of(t) for t in active):
                    break  # capacity exhausted: the rest is deferred
        return selected


class TenantStats:
    """Per-tenant running counters (one ``QosScheduler`` lifetime).

    A read-only view over the ``wlsh_tenant_*`` series of the
    scheduler's registry.  The registry is read through a callable
    because ``bind_metrics`` re-homes a standalone scheduler's counters
    onto the serving stack's registry — views handed out before the
    bind keep reading the live location.
    """

    # attribute -> registry counter (labeled {tenant=<name>})
    _COUNTERS = {
        "n_admitted": "wlsh_tenant_admitted_total",
        "n_rate_limited": "wlsh_tenant_rate_limited_total",
        "n_resolved": "wlsh_tenant_resolved_total",
        "n_slo_misses": "wlsh_tenant_slo_misses_total",
        "n_degraded": "wlsh_tenant_degraded_total",
        "wait_sum": "wlsh_tenant_wait_seconds_total",
    }

    def __init__(self, metrics_fn, tenant: str):
        """Bind the view: ``metrics_fn()`` returns the live registry."""
        self._metrics_fn = metrics_fn
        self._tenant = str(tenant)

    def __getattr__(self, name: str):
        """Read the registry counter backing attribute ``name``."""
        metric = type(self)._COUNTERS.get(name)
        if metric is None:
            raise AttributeError(name)
        v = self._metrics_fn().counter(metric).value(tenant=self._tenant)
        return float(v) if name == "wait_sum" else int(v)

    @property
    def slo_miss_rate(self) -> float:
        """Missed-SLO fraction of resolved queries (nan with none)."""
        if not self.n_resolved:
            return float("nan")
        return self.n_slo_misses / self.n_resolved

    @property
    def mean_wait_s(self) -> float:
        """Mean queued seconds per resolved query (nan with none)."""
        if not self.n_resolved:
            return float("nan")
        return self.wait_sum / self.n_resolved

    def summary(self) -> dict:
        """Flat dict of every counter plus the derived rates."""
        return dict(
            n_admitted=self.n_admitted,
            n_rate_limited=self.n_rate_limited,
            n_resolved=self.n_resolved,
            n_slo_misses=self.n_slo_misses,
            n_degraded=self.n_degraded,
            slo_miss_rate=self.slo_miss_rate,
            mean_wait_s=self.mean_wait_s,
        )


class QosScheduler:
    """Per-tenant admission, weighted fairness and (c, k) degradation.

    Attach one to an ``AsyncRetrievalService`` (``qos=`` constructor
    argument): ``submit`` consults ``admit``/``deadline_for``, ``poll``
    orders expired launches through ``plan_launches`` under
    ``capacity_per_tick``, and a ``ServiceDriver`` calls
    ``observe_tick`` once per tick so sustained overload steps every
    *degradable* tenant down the ladder and sustained clearance steps
    them back up.  Without a driver the service still admits and
    dequeues fairly — rungs simply stay strict.

    Parameters
    ----------
    classes:
        The tenant classes.  Unknown tenants raise ``KeyError`` at
        submit unless a class named ``DEFAULT_TENANT`` is included.
    ladder:
        The pre-planned ``DegradeStep`` relaxation rungs, mildest
        first.  Rung 0 (implicit) is the strict service config; rung
        ``r >= 1`` serves degradable tenants at ``ladder[r - 1]``.
        Empty = degradation disabled (fairness/admission still apply).
    capacity_per_tick:
        Launch-cost units one ``poll`` may spend (strict launch = 1.0).
        Expired launches past the budget stay pending — *that* deferral
        is the overload signal the degradation controller watches.
        ``None`` = unbounded (every expired launch fires, as undriven).
    quantum:
        Deficit-round-robin per-round credit multiplier.
    degrade_after / restore_after:
        Consecutive overloaded (resp. clear) ticks before stepping the
        ladder down (resp. up) — hysteresis, so one bursty tick cannot
        flap the rung.
    """

    def __init__(
        self,
        classes,
        *,
        ladder=(),
        capacity_per_tick: float | None = None,
        quantum: float = 1.0,
        degrade_after: int = 3,
        restore_after: int = 3,
    ):
        classes = tuple(classes)
        if not classes:
            raise ValueError("QosScheduler needs at least one QosClass")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant class names: {names}")
        if capacity_per_tick is not None and not (capacity_per_tick > 0):
            raise ValueError(
                f"capacity_per_tick must be > 0 or None, got "
                f"{capacity_per_tick}"
            )
        if degrade_after < 1 or restore_after < 1:
            raise ValueError(
                "degrade_after and restore_after must be >= 1"
            )
        self.classes: dict[str, QosClass] = {c.name: c for c in classes}
        self.ladder = tuple(ladder)
        self.capacity_per_tick = capacity_per_tick
        self.degrade_after = int(degrade_after)
        self.restore_after = int(restore_after)
        self.drr = DeficitRoundRobin(quantum=quantum)
        self._buckets = {
            c.name: TokenBucket(c.rate, c.burst)
            for c in classes if c.rate is not None
        }
        self._rung: dict[str, int] = {c.name: 0 for c in classes}
        self._over_streak = 0
        self._clear_streak = 0
        self._pressure = False  # expired work deferred on the last poll
        self.n_degrade_steps = 0
        self.n_restore_steps = 0
        # standalone registry until an AsyncRetrievalService attaches
        # this scheduler and re-homes the counters (bind_metrics)
        self.metrics = MetricsRegistry()
        self.stats: dict[str, TenantStats] = {
            c.name: TenantStats(lambda: self.metrics, c.name)
            for c in classes
        }

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Re-home the tenant counters onto the serving stack's registry.

        Called when an ``AsyncRetrievalService`` attaches this
        scheduler: the stack's stale ``wlsh_tenant_*`` series (a
        previously attached scheduler's) are reset, anything this
        scheduler counted standalone is merged in, and future
        increments land in ``registry`` — the ``TenantStats`` views
        follow automatically through their registry callable.
        """
        if registry is self.metrics:
            return
        registry.reset("wlsh_tenant_")
        registry.merge_from(self.metrics)
        self.metrics = registry

    # ------------------------------------------------------------- admission

    def qos_class(self, tenant: str) -> QosClass:
        """The tenant's ``QosClass`` (unknown tenants raise KeyError)."""
        return self.classes[tenant]

    def admit(self, tenant: str, now: float) -> None:
        """Admission-control one submit at clock time ``now``.

        Raises ``KeyError`` for an unregistered tenant and a typed
        ``RateLimited`` when the tenant's token bucket is empty; on
        return the request is admitted (and counted).
        """
        cls = self.qos_class(tenant)
        bucket = self._buckets.get(tenant)
        if bucket is not None and not bucket.try_take(now):
            self.metrics.counter(
                "wlsh_tenant_rate_limited_total",
                "submits rejected by admission control",
            ).inc(tenant=tenant)
            raise RateLimited(tenant, cls.rate, cls.burst)
        self.metrics.counter(
            "wlsh_tenant_admitted_total", "admitted submits"
        ).inc(tenant=tenant)

    def deadline_for(
        self, tenant: str, now: float, default_s: float
    ) -> float:
        """Deadline for a submit with no explicit deadline.

        The class SLO budget when set, else the service default.
        """
        cls = self.qos_class(tenant)
        budget = default_s if cls.slo_ms is None else cls.slo_ms / 1e3
        return now + budget

    # ------------------------------------------------------------ fair queue

    def rung_of(self, tenant: str) -> int:
        """Tenant's current ladder rung (0 = strict parameters)."""
        return self._rung.get(tenant, 0)

    def cost_of(self, tenant: str) -> float:
        """Modeled launch cost at the tenant's current rung."""
        rung = self.rung_of(tenant)
        return 1.0 if rung == 0 else self.ladder[rung - 1].cost

    def recall_bound_of(self, rung: int, strict_bound: float = 1.0
                        ) -> float:
        """The planned recall floor at ladder ``rung``.

        Rung 0 (strict parameters) carries ``strict_bound`` — the
        caller's reference for undegraded answers (the serving stack
        passes ``ServiceConfig.recall_floor``); rung ``r >= 1`` carries
        ``ladder[r - 1].recall_bound``.  The shadow recall estimator
        and the ``recall_below_bound`` alert compare observed recall
        against this value per rung.
        """
        if not 0 <= rung <= len(self.ladder):
            raise ValueError(
                f"rung must be in [0, {len(self.ladder)}], got {rung}"
            )
        if rung == 0:
            return float(strict_bound)
        return float(self.ladder[rung - 1].recall_bound)

    def plan_launches(self, expired, now: float) -> list:
        """Fair-order the tick's expired launches under the capacity.

        ``expired`` is a list of ``(deadline, group_id, tenant)`` whose
        oldest pending deadline has passed.  Returns the launches to
        perform this tick as ``(group_id, tenant)`` pairs in service
        order; anything left over is deferred to a later tick and
        recorded as overload pressure for ``observe_tick``.
        """
        queues: dict[str, list] = {}
        for deadline, gi, tenant in sorted(
            expired, key=lambda e: (e[0], e[1])
        ):
            queues.setdefault(tenant, []).append((gi, tenant))
        budget = (
            math.inf if self.capacity_per_tick is None
            else self.capacity_per_tick
        )
        selected = self.drr.select(
            queues,
            weight_of=lambda t: self.qos_class(t).weight,
            cost_of=self.cost_of,
            budget=budget,
        )
        self._pressure = any(q for q in queues.values())
        return selected

    def note_idle_tick(self) -> None:
        """Record a tick with nothing expired (clears overload pressure)."""
        self._pressure = False

    # ----------------------------------------------------------- degradation

    @property
    def overloaded(self) -> bool:
        """Whether the last tick deferred expired work past the capacity."""
        return self._pressure

    def observe_tick(self) -> None:
        """Advance the degradation controller by one driver tick.

        ``degrade_after`` consecutive pressured ticks step every
        degradable tenant one rung down the ladder; ``restore_after``
        consecutive clear ticks step one rung back up.  Each transition
        restarts its streak, so every further step requires another
        full sustained window (hysteresis in both directions).
        """
        if self._pressure:
            self._over_streak += 1
            self._clear_streak = 0
        else:
            self._clear_streak += 1
            self._over_streak = 0
        if not self.ladder:
            return
        if self._over_streak >= self.degrade_after:
            self._over_streak = 0
            stepped = False
            for name, cls in self.classes.items():
                if cls.degradable and self._rung[name] < len(self.ladder):
                    self._rung[name] += 1
                    stepped = True
            if stepped:
                self.n_degrade_steps += 1
        elif self._clear_streak >= self.restore_after:
            self._clear_streak = 0
            stepped = False
            for name in self.classes:
                if self._rung[name] > 0:
                    self._rung[name] -= 1
                    stepped = True
            if stepped:
                self.n_restore_steps += 1

    # ----------------------------------------------------------- accounting

    def on_resolved(
        self, tenant: str, wait_s: float, missed: bool, rung: int
    ) -> None:
        """Record one resolved query (called by the service per future)."""
        m = self.metrics
        m.counter("wlsh_tenant_resolved_total",
                  "resolved queries").inc(tenant=tenant)
        m.counter("wlsh_tenant_wait_seconds_total",
                  "queued seconds over resolved queries").inc(
            float(wait_s), tenant=tenant)
        if missed:
            m.counter("wlsh_tenant_slo_misses_total",
                      "resolved queries past their deadline").inc(
                tenant=tenant)
        if rung > 0:
            m.counter("wlsh_tenant_degraded_total",
                      "resolved queries answered at rung > 0").inc(
                tenant=tenant)

    def summary(self) -> dict:
        """Per-tenant summaries plus the controller's transition counts."""
        return dict(
            tenants={
                name: dict(
                    **st.summary(),
                    weight=self.classes[name].weight,
                    degradable=self.classes[name].degradable,
                    rung=self._rung[name],
                )
                for name, st in self.stats.items()
            },
            n_degrade_steps=self.n_degrade_steps,
            n_restore_steps=self.n_restore_steps,
            capacity_per_tick=self.capacity_per_tick,
            n_rungs=len(self.ladder),
        )
