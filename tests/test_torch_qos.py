"""The port's multi-tenant QoS: admission, fairness, SLO-aware degradation.

The reference's ``tests/test_qos.py``, run against ``repro_torch`` on
the CPU with its faults injected through ``tests/_torch_faults.py``,
the two shutdown tests that interleave streaming inserts included (their
reference versions fail under the installed jax, so their assertions
run on the port alone).  Also the same plan and overloaded
``ManualClock`` replay through both packages: the same QoS rung per
tick, the same launches, and the same answers.

The traffic-shaping layer must hold its contracts *deterministically* —
everything here runs on a ``ManualClock`` (or no clock at all), with the
fairness and admission invariants property-tested under hypothesis and
the executor faults injected through ``tests/_faults.py``:

* **token-bucket conservation** — over any take schedule the admitted
  count never exceeds ``burst + rate * elapsed``, and a drained bucket
  readmits after ``1/rate`` seconds;
* **no starvation / work conservation** — budgeted deficit-round-robin
  ticks drain every backlogged tenant in bounded calls, never idling a
  tick while the budget covers a pending launch;
* **priority monotonicity** — a higher-weight tenant is never behind a
  lower-weight one while both stay backlogged, and end-to-end its mean
  wait under contention is no worse;
* **SLO-aware degradation** — sustained overload steps only *degradable*
  tenants down the pre-planned (c, k) ladder; every rung is bit-exact
  with the host oracle queried at the rung's relaxed parameters, recall
  stays above the rung's planned bound for every p in {2, 1, 0.5},
  recovery is bit-exact strict, and no rung switch ever compiles;
* **fault containment** — injected restore/build faults are retried
  with bounded doubling backoff, a failing prefetch is written off as
  ``n_prefetch_wasted`` without ever deadlocking the pinned group, and
  a driven replay stays bit-exact through transient faults.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_faults import FaultyExecutor, InjectedFault, record_backoffs
from _torch_serving import (
    build_port_parity,
    cpu_config,
    jax_service,
    launch_log,
    port_service,
    serving_module,
)
from repro_torch.serving import (
    AsyncRetrievalService,
    DeficitRoundRobin,
    DegradeStep,
    ManualClock,
    Overloaded,
    QosClass,
    QosScheduler,
    RateLimited,
    RetrievalService,
    ServiceDriver,
    TokenBucket,
    replay_open_loop,
)

ServiceConfig = cpu_config
build_parity_service = build_port_parity
K = 5
LADDER = (DegradeStep(c=4, k=3, cost=0.5, recall_bound=0.3),)


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5],
                ids=lambda p: f"p{p}")
def parity_setup(request):
    """(p, data, weights, host, plan, svc) of the port per exponent."""
    return build_port_parity(request.param)


# ------------------------------------------------------------- construction


def test_qos_class_validation():
    with pytest.raises(ValueError, match="non-empty"):
        QosClass("")
    with pytest.raises(ValueError, match="weight"):
        QosClass("t", weight=0.0)
    with pytest.raises(ValueError, match="rate"):
        QosClass("t", rate=-1.0)
    with pytest.raises(ValueError, match="burst"):
        QosClass("t", rate=1.0, burst=0.5)
    with pytest.raises(ValueError, match="slo_ms"):
        QosClass("t", slo_ms=-1.0)


def test_degrade_step_validation():
    with pytest.raises(ValueError, match="integer c"):
        DegradeStep(c=1, k=1)
    with pytest.raises(ValueError, match="integer c"):
        DegradeStep(c=2.5, k=1)
    with pytest.raises(ValueError, match="k >= 1"):
        DegradeStep(c=2, k=0)
    with pytest.raises(ValueError, match="cost"):
        DegradeStep(c=2, k=1, cost=0.0)
    with pytest.raises(ValueError, match="recall_bound"):
        DegradeStep(c=2, k=1, recall_bound=1.5)


def test_qos_scheduler_validation():
    with pytest.raises(ValueError, match="at least one"):
        QosScheduler([])
    with pytest.raises(ValueError, match="duplicate"):
        QosScheduler([QosClass("a"), QosClass("a")])
    with pytest.raises(ValueError, match="capacity_per_tick"):
        QosScheduler([QosClass("a")], capacity_per_tick=0.0)
    with pytest.raises(ValueError, match="degrade_after"):
        QosScheduler([QosClass("a")], degrade_after=0)
    with pytest.raises(KeyError):
        QosScheduler([QosClass("a")]).admit("nobody", 0.0)


# -------------------------------------------------------------- token bucket


def test_token_bucket_starts_full_and_refills():
    bucket = TokenBucket(rate=10.0, burst=2.0)
    assert bucket.try_take(0.0) and bucket.try_take(0.0)
    assert not bucket.try_take(0.0)  # drained
    assert not bucket.try_take(0.05)  # half a token: still short
    assert bucket.try_take(0.1)  # 1/rate elapsed -> one token back
    # refill caps at burst, never beyond
    assert bucket.tokens_at(100.0) == 2.0


@given(
    rate=st.floats(0.5, 50.0),
    burst=st.floats(1.0, 8.0),
    gaps=st.lists(st.floats(0.0, 0.5), min_size=1, max_size=60),
)
@settings(max_examples=100, deadline=None)
def test_token_bucket_conservation_property(rate, burst, gaps):
    """Conservation: admits over any window <= burst + rate * elapsed."""
    bucket = TokenBucket(rate, burst)
    now = 0.0
    admitted, times = 0, []
    for gap in gaps:
        now += gap
        times.append(now)
        if bucket.try_take(now):
            admitted += 1
    elapsed = times[-1] - times[0]
    assert admitted <= burst + rate * elapsed + 1e-6
    assert bucket.tokens_at(now) >= 0.0


# ------------------------------------------------------ deficit round robin


@st.composite
def _tenant_queues(draw):
    """Random per-tenant backlogs with weights and per-tenant costs."""
    n = draw(st.integers(1, 5))
    names = [f"t{i}" for i in range(n)]
    weights = {t: draw(st.floats(0.25, 8.0)) for t in names}
    costs = {t: draw(st.sampled_from([0.5, 1.0, 2.0])) for t in names}
    queues = {
        t: [(t, j) for j in range(draw(st.integers(0, 12)))]
        for t in names
    }
    return weights, costs, queues


@given(_tenant_queues())
@settings(max_examples=100, deadline=None)
def test_drr_unbudgeted_select_is_a_permutation(tq):
    """Conservation: with no budget every queued item is served exactly
    once and every drained tenant's deficit resets."""
    weights, costs, queues = tq
    all_items = [item for q in queues.values() for item in q]
    drr = DeficitRoundRobin()
    out = drr.select(
        {t: list(q) for t, q in queues.items()},
        weight_of=weights.__getitem__,
        cost_of=costs.__getitem__,
    )
    assert sorted(out) == sorted(all_items)
    for t in weights:
        assert drr.deficit_of(t) == 0.0


@given(_tenant_queues(), st.floats(2.0, 6.0))
@settings(max_examples=100, deadline=None)
def test_drr_budgeted_ticks_drain_without_starvation(tq, budget):
    """No starvation + work conservation: budgeted ticks (budget >= the
    dearest launch) each serve at least one launch, every backlogged
    tenant is eventually served, and the backlog drains in bounded
    calls — no permanent deferral, no lost or duplicated item."""
    weights, costs, queues = tq
    all_items = [item for q in queues.values() for item in q]
    queues = {t: list(q) for t, q in queues.items()}
    backlogged = {t for t, q in queues.items() if q}
    total = len(all_items)
    drr = DeficitRoundRobin()
    served: list = []
    first_served: dict[str, int] = {}
    calls = 0
    while any(queues.values()):
        got = drr.select(
            queues, weights.__getitem__, costs.__getitem__, budget=budget
        )
        calls += 1
        assert got, "work conservation: backlog pending, budget covers " \
                    "every cost, yet the tick served nothing"
        for item in got:
            first_served.setdefault(item[0], calls)
        served.extend(got)
        assert calls <= total + 8, "drain did not terminate"
    assert sorted(served) == sorted(all_items)  # nothing lost, nothing twice
    assert set(first_served) == backlogged


@given(
    w_hi=st.sampled_from([1.0, 1.5, 2.0, 3.0, 4.0]),
    w_lo=st.sampled_from([1.0, 1.5, 2.0, 3.0, 4.0]),
    m=st.integers(1, 12),
    budget=st.sampled_from([1.0, 2.0, 3.5]),
)
@settings(max_examples=100, deadline=None)
def test_drr_priority_monotonicity_property(w_hi, w_lo, m, budget):
    """While both tenants stay backlogged, the higher-weight tenant's
    served count never falls behind the lower-weight tenant's."""
    if w_hi < w_lo:
        w_hi, w_lo = w_lo, w_hi
    weights = {"a_hi": w_hi, "b_lo": w_lo}
    queues = {t: [(t, j) for j in range(m)] for t in weights}
    drr = DeficitRoundRobin()
    cum = {"a_hi": 0, "b_lo": 0}
    while any(queues.values()):
        got = drr.select(
            queues, weights.__getitem__, lambda t: 1.0, budget=budget
        )
        assert got
        for item in got:
            cum[item[0]] += 1
        if queues["a_hi"]:  # hi still backlogged: must not be behind
            assert cum["a_hi"] >= cum["b_lo"]
    assert cum == {"a_hi": m, "b_lo": m}


def test_drr_weighted_shares_under_contention():
    """A weight-4 tenant drains 4 launches per weight-1 launch while both
    stay backlogged (quantum 1, unit costs, ample per-round budget)."""
    weights = {"gold": 4.0, "bronze": 1.0}
    queues = {t: [(t, j) for j in range(20)] for t in weights}
    drr = DeficitRoundRobin()
    got = drr.select(
        queues, weights.__getitem__, lambda t: 1.0, budget=10.0
    )
    assert sum(1 for it in got if it[0] == "gold") == 8
    assert sum(1 for it in got if it[0] == "bronze") == 2


# ----------------------------------------------------- scheduler unit tests


def _two_class_qos(**kw):
    kw.setdefault("ladder", (DegradeStep(c=4, k=3, cost=0.5),
                             DegradeStep(c=6, k=2, cost=0.25)))
    return QosScheduler(
        [QosClass("gold", weight=4.0, slo_ms=20.0),
         QosClass("bronze", weight=1.0, slo_ms=100.0, degradable=True)],
        **kw,
    )


def test_deadline_for_uses_class_slo_and_falls_back():
    qos = QosScheduler([QosClass("gold", slo_ms=20.0), QosClass("other")])
    assert qos.deadline_for("gold", 1.0, 0.005) == 1.0 + 0.020
    assert qos.deadline_for("other", 1.0, 0.005) == 1.0 + 0.005


def test_admit_counts_and_rate_limits():
    qos = QosScheduler([QosClass("t", rate=10.0, burst=2.0)])
    qos.admit("t", 0.0)
    qos.admit("t", 0.0)
    with pytest.raises(RateLimited) as exc:
        qos.admit("t", 0.0)
    assert exc.value.tenant == "t" and exc.value.rate == 10.0
    qos.admit("t", 0.2)  # bucket refilled
    st_ = qos.stats["t"]
    assert st_.n_admitted == 3 and st_.n_rate_limited == 1


def test_plan_launches_orders_by_deadline_and_weight():
    """Within a tenant, soonest deadline first; across tenants, the
    heavier class is served first and the leftovers register pressure."""
    qos = _two_class_qos(capacity_per_tick=2.0)
    expired = [
        (0.9, 1, "bronze"), (0.5, 0, "gold"), (0.7, 2, "gold"),
        (0.1, 3, "bronze"),
    ]
    got = qos.plan_launches(expired, now=1.0)
    assert got == [(0, "gold"), (2, "gold")]  # gold first, deadline order
    assert qos.overloaded  # bronze deferred past the capacity
    qos.note_idle_tick()
    assert not qos.overloaded


def test_observe_tick_hysteresis_and_rung_caps():
    """degrade_after pressured ticks step degradable tenants one rung
    down; restore_after clear ticks step back up; one bursty tick resets
    the streak; the strict tenant never moves."""
    qos = _two_class_qos(capacity_per_tick=1.0, degrade_after=3,
                         restore_after=2)

    def tick(n_expired: int):
        if n_expired:
            qos.plan_launches(
                [(0.0, g, "bronze") for g in range(n_expired)], now=1.0
            )
        else:
            qos.note_idle_tick()
        qos.observe_tick()

    tick(2), tick(2)
    assert qos.rung_of("bronze") == 0  # 2 < degrade_after
    tick(0)  # burst cleared: the streak resets
    tick(2), tick(2), tick(2)
    assert qos.rung_of("bronze") == 1 and qos.rung_of("gold") == 0
    assert qos.n_degrade_steps == 1
    # at rung 1 the cost halves, so 2 launches now FIT capacity 1 —
    # degradation relieving the overload by design; pressure must stay
    # heavier than the relaxed cost to force the second step
    tick(2)
    assert not qos.overloaded
    tick(3), tick(3), tick(3)
    assert qos.rung_of("bronze") == 2  # second full window, second step
    tick(5), tick(5), tick(5)
    assert qos.rung_of("bronze") == 2  # capped at the ladder depth
    assert qos.cost_of("bronze") == 0.25 and qos.cost_of("gold") == 1.0
    tick(0), tick(0)
    assert qos.rung_of("bronze") == 1
    assert qos.n_restore_steps == 1
    tick(0), tick(0)
    assert qos.rung_of("bronze") == 0
    tick(0), tick(0)
    assert qos.rung_of("bronze") == 0  # floor at strict
    summary = qos.summary()
    assert summary["n_degrade_steps"] == 2
    assert summary["n_restore_steps"] == 2
    assert summary["tenants"]["bronze"]["rung"] == 0


# --------------------------------------------------- service-level serving


def _qos_service(plan, data, qos, q_batch=4, **cfg_kw):
    svc = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=K, q_batch=q_batch, degrade_ladder=LADDER,
                          **cfg_kw),
    )
    return svc, AsyncRetrievalService(
        svc.batcher, max_delay_ms=5.0, clock=ManualClock(), qos=qos
    )


def _group_queries(data, plan, gi, n, seed=11):
    """n queries all routed to group ``gi`` (its member weight ids)."""
    rng = np.random.default_rng(seed)
    members = np.asarray(plan.groups[gi].member_ids, np.int64)
    wids = rng.choice(members, n)
    qpts = data[rng.choice(len(data), n, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return qpts, wids


def test_tenants_never_share_a_launch():
    """Per-(group, tenant) buffers: one tenant's queries never ride in
    another tenant's batch, so a relaxed step cannot touch strict
    answers even within one group."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = _two_class_qos()
    svc, asvc = _qos_service(plan, data, qos)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 4)
    futs = [asvc.submit(qpts[i], wids[i],
                        tenant="gold" if i % 2 else "bronze")
            for i in range(3)]
    assert set(asvc.pending_tenant_depths()) == {(gi, "gold"),
                                                 (gi, "bronze")}
    asvc.clock.advance_to(1.0)  # both past their SLO deadlines
    assert asvc.poll() == 2  # one launch per tenant, never merged
    assert all(f.done() for f in futs)
    assert asvc.pending_count == 0


def test_full_buffer_defers_to_the_fair_queue_under_qos():
    """With QoS attached a full buffer must NOT launch inside submit —
    every launch flows through the weighted-fair queue at the next
    tick, so a bursting tenant cannot buy capacity past its share."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = _two_class_qos()
    svc, asvc = _qos_service(plan, data, qos)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 4)
    futs = [asvc.submit(qpts[i], wids[i], tenant="gold") for i in range(4)]
    assert asvc.pending_count == 4  # full, but no launch inside submit
    assert not any(f.done() for f in futs)
    assert asvc.poll() == 1  # deadline NOT expired: launched as "full"
    assert asvc.n_launched_full == 1
    assert all(f.done() for f in futs)


def test_rate_limited_rejects_before_enqueue_and_overload_spends_no_token():
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = QosScheduler([
        QosClass("limited", rate=10.0, burst=1.0),
        QosClass("filler"),
    ])
    svc, asvc = _qos_service(plan, data, qos, max_pending=2)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 4)
    with pytest.raises(KeyError):
        asvc.submit(qpts[0], wids[0], tenant="stranger")
    asvc.submit(qpts[0], wids[0], tenant="limited")
    with pytest.raises(RateLimited):
        asvc.submit(qpts[1], wids[1], tenant="limited")
    assert asvc.pending_count == 1  # the rejected caller enqueued nothing
    asvc.submit(qpts[1], wids[1], tenant="filler")  # depth now 2 == cap
    with pytest.raises(Overloaded):
        asvc.submit(qpts[2], wids[2], tenant="limited")
    # backpressure precedes admission: the Overloaded attempt spent no
    # token, so after the bucket's 1/rate refill the tenant is admitted
    asvc.clock.advance_to(0.1)
    asvc.drain()
    asvc.submit(qpts[2], wids[2], tenant="limited")
    assert qos.stats["limited"].n_admitted == 2
    assert qos.stats["limited"].n_rate_limited == 1
    asvc.drain()


def test_priority_monotonicity_end_to_end_on_manual_clock():
    """Same trace, same SLOs, contended capacity: the weight-4 tenant's
    mean wait is no worse than the weight-1 tenant's."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = QosScheduler(
        [QosClass("hi", weight=4.0, slo_ms=1.0),
         QosClass("lo", weight=1.0, slo_ms=1.0)],
        capacity_per_tick=1.0,
    )
    svc, asvc = _qos_service(plan, data, qos, q_batch=2)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 12)
    arrivals = np.arange(12) * 1e-4  # a burst: all due almost at once
    tenants = ["hi" if i % 2 else "lo" for i in range(12)]
    replay_open_loop(asvc, qpts, wids, arrivals, tenants=tenants)
    s = qos.summary()["tenants"]
    assert s["hi"]["n_resolved"] == 6 and s["lo"]["n_resolved"] == 6
    assert s["hi"]["mean_wait_s"] <= s["lo"]["mean_wait_s"] + 1e-12


def test_replay_stall_guard_catches_undersized_capacity():
    """A capacity below the cheapest launch cost can never fire expired
    work — the replay must fail loudly instead of spinning forever."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = QosScheduler([QosClass("t")], capacity_per_tick=0.25)
    svc, asvc = _qos_service(plan, data, qos)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 2)
    with pytest.raises(RuntimeError, match="stalled"):
        replay_open_loop(asvc, qpts, wids, [0.0, 1e-4],
                         tenants=["t", "t"])


# ------------------------------------------------- degradation ladder recall


def test_degraded_rung_is_bit_exact_vs_relaxed_oracle(parity_setup):
    """Each ladder rung answers bit-exactly like the host oracle queried
    at the rung's relaxed (c, k) — same hashes, same stop conditions —
    with the tail padded -1/inf back to the strict k; degraded recall
    vs the strict answers stays above the rung's planned bound; and
    recovery (rung 0 again) is bit-exact strict.  Per p in {2, 1, 0.5}."""
    p, data, weights, host, plan, _ = parity_setup
    svc = RetrievalService(
        plan, data, cfg=ServiceConfig(k=K, q_batch=4, degrade_ladder=LADDER)
    )
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    svc.batcher.warmup(groups=[gi])  # compiles rung 0 AND rung 1 steps
    n_compiled = svc.step_cache.n_compiled
    assert svc.batcher.n_rungs == 1
    assert svc.batcher.rung_params(1) == (4, 3)
    qpts, wids = _group_queries(data, plan, gi, 8, seed=13)

    def run(rung):
        outs = [svc.batcher.run_batch(gi, qpts[i:i + 4], wids[i:i + 4],
                                      rung=rung)
                for i in (0, 4)]
        return tuple(np.concatenate(parts) for parts in zip(*outs))

    ids0, d0, stop0, chk0 = run(0)
    ids1, d1, stop1, chk1 = run(1)
    step = LADDER[0]
    recalls = []
    for qi in range(len(qpts)):
        want = host.search_dense(qpts[qi], weight_id=int(wids[qi]),
                                 k=step.k, c=step.c)
        np.testing.assert_array_equal(
            ids1[qi, :step.k], want.ids.astype(np.int32),
            err_msg=f"rung-1 ids mismatch at query {qi} (p={p})",
        )
        assert int(stop1[qi]) == want.stats.stop_level
        assert int(chk1[qi]) == want.stats.n_checked
        np.testing.assert_array_equal(ids1[qi, step.k:], -1)
        assert np.all(np.isinf(d1[qi, step.k:]))
        m = ids1[qi, :step.k] >= 0
        np.testing.assert_allclose(
            d1[qi, :step.k][m], want.dists[m], rtol=1e-4, atol=1e-2
        )
        strict = set(ids0[qi][ids0[qi] >= 0].tolist())
        got = set(ids1[qi][ids1[qi] >= 0].tolist())
        recalls.append(len(got & strict) / max(1, len(strict)))
    assert np.mean(recalls) >= step.recall_bound, (
        f"planned rung recall bound violated at p={p}: "
        f"{np.mean(recalls):.3f} < {step.recall_bound}"
    )
    # recovery: strict again, bit-exact with the pre-degradation answers
    ids0b, d0b, stop0b, chk0b = run(0)
    np.testing.assert_array_equal(ids0b, ids0)
    np.testing.assert_array_equal(d0b, d0)
    np.testing.assert_array_equal(stop0b, stop0)
    np.testing.assert_array_equal(chk0b, chk0)
    # every rung switch hit the pre-compiled steps: nothing new compiled
    assert svc.step_cache.n_compiled == n_compiled


def test_overload_degrades_and_recovery_restores_end_to_end():
    """Driver-observed hysteresis on the real service: sustained deferral
    steps the degradable tenant down (answers padded to the strict k,
    counted n_degraded), sustained clear ticks restore rung 0, and the
    strict tenant's rung never moves."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = QosScheduler(
        [QosClass("gold", weight=4.0, slo_ms=2.0),
         QosClass("bronze", weight=1.0, slo_ms=2.0, degradable=True)],
        ladder=LADDER, capacity_per_tick=1.0,
        degrade_after=2, restore_after=2,
    )
    svc, asvc = _qos_service(plan, data, qos, q_batch=2)
    driver = ServiceDriver(asvc, prefetch=None)
    clock = asvc.clock
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 12, seed=17)
    gis = [int(np.argmax([g.n_members for g in plan.groups]))]
    # two expired bronze buffers per tick vs capacity 1 -> one deferred
    # every tick: sustained pressure
    other = next(g for g in range(plan.n_groups) if g not in gis)
    oq, ow = _group_queries(data, plan, other, 6, seed=19)
    i = j = 0
    for tick in range(2):
        asvc.submit(qpts[i], wids[i], deadline=clock(), tenant="bronze")
        asvc.submit(oq[j], ow[j], deadline=clock(), tenant="bronze")
        i, j = i + 1, j + 1
        driver.step()
    assert qos.rung_of("bronze") == 1 and qos.rung_of("gold") == 0
    assert qos.n_degrade_steps == 1
    # a bronze answer served now is degraded: padded past the rung k
    fut = asvc.submit(qpts[i], wids[i], deadline=clock(), tenant="bronze")
    while not fut.done():
        driver.step()
    ans = fut.result()
    assert ans.ids.shape == (K,)
    assert np.all(ans.ids[LADDER[0].k:] == -1)
    assert qos.stats["bronze"].n_degraded >= 1
    # drain the backlog, then sustained clear ticks restore strict
    asvc.drain()
    driver.step(), driver.step()
    assert qos.rung_of("bronze") == 0
    assert qos.n_restore_steps == 1
    # strict again: bit-exact vs the sync frontend on fresh queries
    fut = asvc.submit(qpts[i + 1], wids[i + 1], deadline=clock(),
                      tenant="gold")
    driver.step()
    sync = svc.query(qpts[i + 1][None], [wids[i + 1]])
    np.testing.assert_array_equal(fut.result().ids, sync.ids[0])


# ------------------------------------------------------------ fault injection


def test_transient_faults_retry_with_doubling_backoff():
    ex = FaultyExecutor(fail_restores=2)
    cache = ex.make_cache(max_resident_groups=1, restore_retries=2,
                          retry_backoff_s=0.01)
    backoffs = record_backoffs(cache)
    with cache.lease(0):
        pass
    with cache.lease(1):  # 0 offloaded
        pass
    with cache.lease(0):  # restore fails twice, third attempt lands
        pass
    assert cache.stats.n_restore_retries == 2
    assert cache.stats.n_restores == 1
    assert backoffs == [0.01, 0.02]  # doubling, recorded — never slept
    assert ex.n_calls("restore") == 3


def test_exhausted_retries_propagate_and_heal_in_place():
    ex = FaultyExecutor(fail_builds=float("inf"))
    cache = ex.make_cache(restore_retries=1)
    with pytest.raises(InjectedFault, match="injected"):
        cache.acquire(0)
    assert not cache.is_resident(0)
    assert cache.pin_count(0) == 0  # the failed acquire leaked no pin
    ex.fail_builds = 0  # heal: the next acquire cold-builds cleanly
    with cache.lease(0) as state:
        assert state == ("dev", 0)
    assert cache.stats.n_restore_retries == 1


def test_failed_prefetch_counts_wasted_and_never_deadlocks():
    """The satellite regression: a prefetch whose restore keeps failing
    is written off as n_prefetch_wasted — no exception escapes into the
    tick, the pinned group is untouched, and the group restores fine
    once the fault clears."""
    ex = FaultyExecutor()
    cache = ex.make_cache(max_resident_groups=2, restore_retries=1)
    with cache.lease(0):
        pass
    with cache.lease(1):
        pass
    with cache.lease(2):  # evicts 0 (offloaded)
        pass
    ex.fail_restores = float("inf")
    pinned = cache.acquire(1)  # a launch in flight
    assert cache.prefetch(0) is False  # contained: no raise
    s = cache.stats
    assert s.n_prefetches == 1 and s.n_prefetch_wasted == 1
    assert s.n_restore_retries == 1  # the bounded retry ran inside
    assert not cache.is_resident(0)
    assert cache.pin_count(1) == 1 and pinned == ("dev", 1)
    cache.release(1)  # no deadlock: the pinned lease completes normally
    ex.fail_restores = 0
    with cache.lease(0) as state:  # the eventual acquire restores
        assert state == ("dev", 0)
    assert cache.stats.n_restores == 1


def test_driven_replay_bit_exact_through_transient_restore_faults():
    """End to end: transient restore faults during a driven, paged, QoS
    replay are retried invisibly — every answer stays bit-exact with
    the fault-free sync reference."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = QosScheduler(
        [QosClass("gold", weight=4.0), QosClass("bronze", degradable=True)],
        ladder=LADDER, capacity_per_tick=4.0,
    )
    svc, asvc = _qos_service(plan, data, qos, max_resident_groups=1)
    cache = svc.batcher.state_cache
    real_restore, fail_every = cache._restore, 3
    calls = {"n": 0}

    def flaky_restore(gi, h):
        calls["n"] += 1
        if calls["n"] % fail_every == 0:
            raise InjectedFault(f"injected restore fault (group {gi})")
        return real_restore(gi, h)

    cache._restore = flaky_restore
    driver = ServiceDriver(asvc)
    rng = np.random.default_rng(23)
    wids = rng.integers(0, len(weights), 24)
    qpts = data[rng.choice(len(data), 24, replace=False)].astype(np.float32)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, 24))
    tenants = [("gold", "bronze")[i % 2] for i in range(24)]
    from repro_torch.serving import replay_with_driver
    res, _ = replay_with_driver(driver, qpts, wids, arrivals,
                                tenants=tenants)
    sync = svc.query(qpts, wids)
    np.testing.assert_array_equal(res.ids, sync.ids)
    np.testing.assert_array_equal(res.dists, sync.dists)
    assert cache.stats.n_restore_retries >= 1  # faults actually fired
    assert calls["n"] >= fail_every


def test_stop_drain_resolves_everything_on_manual_clock():
    """Step-driven shutdown: stop(drain=True) on a never-started driver
    resolves every pending future (QoS attached, inserts interleaved)
    and performs no tick."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = _two_class_qos()
    svc, asvc = _qos_service(plan, data, qos, delta_seal_rows=2,
                             delta_reserve_rows=16)
    driver = ServiceDriver(asvc, prefetch=None)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 6)
    w_in = int(plan.groups[gi].member_ids[0])
    futs = []
    for i in range(6):
        futs.append(driver.submit(qpts[i], wids[i],
                                  tenant="gold" if i % 2 else "bronze"))
        if i % 2:
            driver.insert((data[3] + 50_000.0 + i).astype(np.float32),
                          w_in)
    ticks = driver.stats.n_ticks
    driver.stop(drain=True)  # never started: drain still runs
    assert all(f.done() for f in futs)
    assert asvc.pending_count == 0
    assert driver.stats.n_ticks == ticks  # stop never ticks
    assert not driver.running
    assert svc.delta_summary()["n_inserts"] == 3


def test_thread_stop_drain_races_submit_and_insert_drops_no_future():
    """Thread-mode regression: stop(drain=True) racing a feeder thread
    (submits + streaming inserts through the driver's locked
    passthroughs) strands no future (everything submitted resolves), and
    the driver never ticks after its thread joins."""
    p, data, weights, host, plan, _ = build_parity_service(2.0)
    qos = _two_class_qos()
    svc = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=K, q_batch=4, degrade_ladder=LADDER,
                          delta_seal_rows=2, delta_reserve_rows=16),
    )
    svc.warmup()
    asvc = AsyncRetrievalService(svc.batcher, max_delay_ms=0.5, qos=qos)
    driver = ServiceDriver(asvc, tick_s=0.001)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    qpts, wids = _group_queries(data, plan, gi, 16)
    w_in = int(plan.groups[gi].member_ids[0])
    futs: list = []
    errs: list = []
    started = threading.Event()

    def feeder():
        try:
            for i in range(len(qpts)):
                futs.append(driver.submit(
                    qpts[i], wids[i],
                    tenant="gold" if i % 2 else "bronze",
                ))
                started.set()
                if i % 5 == 0:
                    driver.insert(
                        (data[3] + 50_000.0 + i).astype(np.float32), w_in
                    )
        except Exception as e:  # pragma: no cover - the regression itself
            errs.append(e)

    driver.start()
    t = threading.Thread(target=feeder)
    t.start()
    started.wait(timeout=10.0)
    driver.stop(drain=True)  # races the feeder mid-stream
    t.join(timeout=30.0)
    assert not t.is_alive() and not errs
    assert not driver.running
    ticks = driver.stats.n_ticks
    driver.drain()  # catch submits that landed after stop's drain
    assert len(futs) == len(qpts)
    assert all(f.done() for f in futs), "shutdown dropped futures"
    assert driver.stats.n_ticks == ticks  # no tick after join
    for f in futs:  # answers are well-formed, strict-k shaped
        assert f.result().ids.shape == (K,)
    driver.stop()  # idempotent


# ------------------------------------------------- the port against JAX


def _overloaded_run(svc, qpts, wids, tenants):
    """Every request submitted at once to a QoS-driven service whose
    per-tick capacity they overload, then driver ticks with the clock
    held past every deadline until all resolve, then clear ticks.
    Returns the futures' answers, the launches, and each tenant's rung
    after every tick."""
    mod = serving_module(svc)
    qos = mod.QosScheduler(
        [mod.QosClass("gold", weight=4.0, slo_ms=2.0),
         mod.QosClass("bronze", weight=1.0, slo_ms=2.0, degradable=True)],
        ladder=svc.cfg.degrade_ladder, capacity_per_tick=1.0,
        degrade_after=2, restore_after=2,
    )
    clock = mod.ManualClock()
    asvc = mod.AsyncRetrievalService(svc.batcher, max_delay_ms=5.0,
                                     clock=clock, qos=qos)
    driver = mod.ServiceDriver(asvc)
    launches = launch_log(svc.batcher, clock, qpts)
    futs = [asvc.submit(qpts[i], wids[i], tenant=tenants[i])
            for i in range(len(qpts))]
    rungs = []

    def tick():
        driver.step()
        rungs.append((clock(), qos.rung_of("gold"), qos.rung_of("bronze")))

    clock.advance_to(0.003)  # past every SLO deadline
    while asvc.pending_count:
        tick()
    for _ in range(3):  # nothing pending: clear ticks restore the ladder
        clock.advance(0.001)
        tick()
    answers = [f.result() for f in futs]
    return answers, launches, rungs, qos.summary()


def test_qos_rungs_per_tick_match_jax(parity_setup):
    """The same plan and overloading traffic through both packages'
    QoS-driven, paged services: the same rung per tick for each tenant
    (the degradable tenant steps down and back), the same launches
    (group, rows, tick, rung), and the same answers: ids, stop and
    n_checked exact, p = 2 distances to 1e-6 relative."""
    p, data, weights, host, plan, _ = parity_setup
    rng = np.random.default_rng(29)
    n = 24
    wids = rng.integers(0, len(weights), n)
    qpts = data[rng.choice(len(data), n, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    tenants = [("gold", "bronze")[i % 2] for i in range(n)]
    kw = dict(k=K, q_batch=2, degrade_ladder=LADDER, max_resident_groups=2)
    got, got_l, got_r, got_s = _overloaded_run(port_service(p, **kw), qpts,
                                               wids, tenants)
    want, want_l, want_r, want_s = _overloaded_run(jax_service(p, **kw),
                                                   qpts, wids, tenants)
    assert got_r == want_r
    assert any(b == 1 for _, _, b in got_r)  # the overload degraded
    assert got_r[-1][1:] == (0, 0)  # and the clear ticks restored
    assert got_l == want_l
    for key in ("n_degrade_steps", "n_restore_steps"):
        assert got_s[key] == want_s[key], key
    for a, b in zip(got, want):
        assert (a.group_id, a.stop_level, a.n_checked) == (
            b.group_id, b.stop_level, b.n_checked)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-6)
