"""The port's real-time scheduler: driver ticks, prefetch, cost-aware evict.

The reference's ``tests/test_scheduler.py``, run against ``repro_torch``
on the CPU (its idle-compaction test included; the reference version
fails under the installed jax, so its assertions run on the port
alone).  Also the same plan and driven ``ManualClock`` replay
through both packages: the same prefetch, protection and eviction
choices, the same metrics registry, the same launches and answers.

Everything here is deterministic — drivers are stepped on a ``ManualClock``
and the cache-level behaviour is pinned against fake build/offload/restore
executors (no device, no wall-clock sleeps):

* prefetch brings a state on device ahead of its acquire (the consuming
  acquire is a hit and counts the overlapped restore), never evicts a
  pinned or protected (about-to-launch) state, and unconsumed prefetches
  are counted as wasted;
* the cost-aware eviction policy orders victims by staleness per restore
  byte (hypothesis property test against the argmax model), degrading to
  LRU at equal sizes;
* a ``ServiceDriver``-stepped replay is bit-exact with the undriven
  ``poll()`` replay of the same trace, per p in {2, 1, 0.5};
* no deadline fires late when capacity allows: every future resolves at
  its deadline tick, never after.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_serving import (
    build_port_parity,
    cache_log,
    cpu_config,
    jax_service,
    launch_log,
    port_service,
    serving_module,
)
from repro_torch.serving import (
    AsyncRetrievalService,
    CostAwareEviction,
    DeadlinePrefetch,
    EvictionCandidate,
    LRUEviction,
    ManualClock,
    RetrievalService,
    ServiceDriver,
    StateCache,
    replay_open_loop,
    replay_with_driver,
)

ServiceConfig = cpu_config
K = 5


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5],
                ids=lambda p: f"p{p}")
def parity_setup(request):
    """(p, data, weights, host, plan, svc) of the port per exponent."""
    return build_port_parity(request.param)


# ------------------------------------------------- fake-executor unit tests


def _fake_cache(cap=None, budget=None, nbytes=lambda gi: 10, log=None,
                policy=None):
    """StateCache over fake build/offload/restore executors (no device)."""
    return StateCache(
        build=lambda gi: ("dev", gi),
        nbytes_of=nbytes,
        max_resident_groups=cap,
        device_budget_bytes=budget,
        offload=lambda state: ("host", state),
        restore=lambda gi, host: host[1],
        on_event=(lambda gi, kind: log.append((gi, kind)))
        if log is not None else None,
        eviction_policy=policy,
    )


def test_prefetch_restore_then_acquire_counts_overlap():
    cache = _fake_cache(cap=1)
    with cache.lease(0):
        pass
    with cache.lease(1):  # 0 offloaded
        pass
    assert cache.prefetch(0) is True  # evicts 1, restores 0 ahead of time
    assert cache.is_resident(0) and not cache.is_resident(1)
    assert cache.stats.n_prefetches == 1
    assert cache.pin_count(0) == 0  # prefetched, not pinned
    with cache.lease(0):  # the consuming acquire: a hit, overlapped
        pass
    s = cache.stats
    assert s.n_hits == 1
    assert s.n_restore_overlapped == 1
    assert s.n_prefetch_wasted == 0
    # consuming twice must not double-count the overlap
    with cache.lease(0):
        pass
    assert cache.stats.n_restore_overlapped == 1


def test_prefetch_of_resident_state_is_noop():
    cache = _fake_cache(cap=2)
    with cache.lease(0):
        pass
    assert cache.prefetch(0) is False
    assert cache.stats.n_prefetches == 0


def test_unconsumed_prefetch_counts_wasted():
    log = []
    cache = _fake_cache(cap=1, log=log)
    assert cache.prefetch(0) is True  # cold prefetch = build
    with cache.lease(1):  # evicts 0 before anything consumed it
        pass
    s = cache.stats
    assert s.n_prefetch_wasted == 1
    assert s.n_restore_overlapped == 0
    assert (0, "prefetch_wasted") in log


def test_prefetch_never_evicts_pinned_or_protected_state():
    """The satellite invariant: a prefetch must not evict a pinned state
    or one protected as about-to-launch — the budget goes soft instead."""
    cache = _fake_cache(cap=1)
    cache.acquire(0)  # pinned (launch in flight)
    cache.protect([1])
    with cache.lease(1):
        pass
    assert cache.is_resident(0) and cache.is_resident(1)
    cache.prefetch(2)  # over budget, but 0 pinned and 1 protected
    assert cache.is_resident(0) and cache.is_resident(1)
    assert cache.is_resident(2)
    assert cache.n_resident == 3  # soft budget, nothing thrashed
    cache.release(0)
    cache.protect(())  # next enforcement point reclaims the excess
    with cache.lease(2):
        pass
    assert cache.n_resident == 1


def test_protection_is_replaced_not_accumulated():
    cache = _fake_cache(cap=1)
    cache.protect([0, 1])
    assert cache.protected_group_ids() == frozenset({0, 1})
    cache.protect([2])
    assert cache.protected_group_ids() == frozenset({2})


def test_cost_aware_eviction_spares_expensive_restores():
    """With distinct sizes the cost-aware policy deviates from LRU: the
    small (cheap-to-restore) state goes first even though the large one
    is staler."""
    sizes = {0: 100, 1: 10, 2: 10}
    cache = _fake_cache(budget=115, nbytes=lambda gi: sizes[gi],
                        policy=CostAwareEviction())
    with cache.lease(0):  # large, older
        pass
    with cache.lease(1):  # small, newer
        pass
    with cache.lease(2):  # 120 > 115: must evict 1 although 0 is staler
        pass
    assert cache.is_resident(0) and cache.is_resident(2)
    assert not cache.is_resident(1)
    assert cache.resident_bytes == 110


def test_lru_policy_matches_default_choice():
    log_a, log_b = [], []
    a = _fake_cache(cap=2, log=log_a)  # built-in LRU
    b = _fake_cache(cap=2, log=log_b, policy=LRUEviction())
    for cache in (a, b):
        for gi in (0, 1, 2, 0, 3):
            with cache.lease(gi):
                pass
    assert [e for e in log_a if e[1] == "evict"] == (
        [e for e in log_b if e[1] == "evict"]
    )
    assert a.resident_group_ids() == b.resident_group_ids()


def test_eviction_policy_returning_non_candidate_raises():
    cache = _fake_cache(cap=1, policy=lambda cands: 999)
    with cache.lease(0):
        pass
    with pytest.raises(ValueError, match="policy"):
        cache.acquire(1)


@st.composite
def _candidate_set(draw):
    """Distinct-group candidates with arbitrary recency ticks and sizes."""
    n = draw(st.integers(1, 8))
    last_uses = draw(st.lists(st.integers(0, 100), min_size=n, max_size=n))
    nbytes = draw(st.lists(st.integers(1, 1 << 20), min_size=n, max_size=n))
    flags = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    return tuple(
        EvictionCandidate(group_id=gi, last_use=last_uses[gi],
                          nbytes=nbytes[gi], prefetched=flags[gi])
        for gi in range(n)
    )


@given(_candidate_set())
@settings(max_examples=200, deadline=None)
def test_cost_aware_ordering_property(candidates):
    """The satellite property: CostAwareEviction picks exactly the argmax
    of staleness-per-restore-byte (ties: staler first, then smaller
    group id), always from the offered candidates; with equal sizes it
    is exactly LRU."""
    policy = CostAwareEviction()
    victim = policy(candidates)
    ids = {c.group_id for c in candidates}
    assert victim in ids
    now = max(c.last_use for c in candidates) + 1

    def key(c):
        return ((now - c.last_use) / c.nbytes, -c.last_use, -c.group_id)

    best = max(candidates, key=key)
    assert victim == best.group_id
    # equal sizes: degrades to the LRU choice exactly
    flat = tuple(
        EvictionCandidate(c.group_id, c.last_use, 64, c.prefetched)
        for c in candidates
    )
    lru_victims = [
        c.group_id for c in flat
        if c.last_use == min(x.last_use for x in flat)
    ]
    assert policy(flat) == min(lru_victims)
    assert LRUEviction()(flat) == min(lru_victims)


# --------------------------------------------------- driver-stepped serving


def _paged_async(plan, data, cap=1, q_batch=4, **svc_kw):
    svc = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=K, q_batch=q_batch,
                          max_resident_groups=cap, **svc_kw),
    )
    svc.warmup()
    svc.reset_stats()
    return AsyncRetrievalService(svc.batcher, max_delay_ms=2.0,
                                 clock=ManualClock())


def _mixed_queries(data, weights, n_queries, seed=43):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n_queries)
    qpts = data[rng.choice(len(data), n_queries, replace=False)].astype(
        np.float32
    )
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return qpts, wids


def test_driver_stepped_replay_bit_exact_vs_poll_loop(parity_setup):
    """Acceptance: the driver-stepped replay (prefetch + cost-aware
    eviction on) answers bit-exactly like the undriven poll() replay and
    the sync frontend, per p in {2, 1, 0.5}, under a paging budget."""
    p, data, weights, host, plan, svc = parity_setup
    qpts, wids = _mixed_queries(data, weights, 24, seed=31)
    rng = np.random.default_rng(7)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, len(qpts)))
    sync = svc.query(qpts, wids)  # unpaged sync reference

    undriven = _paged_async(plan, data)
    res_u, _ = replay_open_loop(undriven, qpts, wids, arrivals)

    driven = _paged_async(plan, data)
    driver = ServiceDriver(driven)
    res_d, _ = replay_with_driver(driver, qpts, wids, arrivals)

    for res in (res_u, res_d):
        np.testing.assert_array_equal(res.ids, sync.ids)
        np.testing.assert_array_equal(res.dists, sync.dists)
        np.testing.assert_array_equal(res.stop_levels, sync.stop_levels)
        np.testing.assert_array_equal(res.n_checked, sync.n_checked)
    # the driver actually scheduled: prefetches were issued and consumed
    cs = driven.batcher.state_cache.stats
    assert driver.stats.n_prefetches_issued > 0
    assert cs.n_restore_overlapped > 0
    assert driver.stats.n_launches == driven.n_launched_deadline


def test_no_deadline_fires_late_when_capacity_allows(parity_setup):
    """Stepping the driver at each deadline resolves every future exactly
    at its deadline — never after, and never before its batch is due."""
    p, data, weights, host, plan, _ = parity_setup
    asvc = _paged_async(plan, data)
    driver = ServiceDriver(asvc)
    clock = asvc.clock
    qpts, wids = _mixed_queries(data, weights, 8, seed=3)
    futs = []
    for i in range(len(qpts)):
        target = 0.0005 * (i + 1)
        while True:  # fire every deadline expiring before this arrival
            nd = asvc.next_deadline()
            if nd is None or nd > target:
                break
            clock.advance_to(nd)
            driver.step()
        clock.advance_to(target)
        futs.append(driver.submit(qpts[i], wids[i]))
    while asvc.pending_count:
        nd = asvc.next_deadline()
        clock.advance_to(nd)
        driver.step()
    for fut, _ in zip(futs, qpts):
        assert fut.done()
    deadline_budget = asvc.max_delay_ms / 1e3
    for i, fut in enumerate(futs):
        # submitted at (i+1)*0.5ms; resolved by its own deadline at the
        # latest (full-batch launches resolve earlier)
        submit_t = 0.0005 * (i + 1)
        assert fut.t_resolved <= submit_t + deadline_budget + 1e-9
    assert driver.stats.n_deadline_misses <= driver.stats.n_deadlines_due


def test_driver_owns_idle_background_compaction(parity_setup):
    """Idle-work handoff: with a driver attached, an undriven poll() no
    longer compacts; the driver's idle ticks do."""
    p, data, weights, host, plan, _ = parity_setup
    asvc = _paged_async(plan, data, cap=None, delta_seal_rows=2,
                        delta_reserve_rows=16)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    w_in = int(plan.groups[gi].member_ids[0])
    v = (data[3] + 50_000.0).astype(np.float32)
    asvc.insert(v, w_in)
    asvc.insert(v + 1.0, w_in)  # seals at 2 rows
    assert asvc.batcher.delta.summary()["n_sealed_segments"] == 1
    driver = ServiceDriver(asvc)
    asvc.poll()  # idle poll, but the driver owns idle work now
    assert asvc.batcher.delta.summary()["n_compactions"] == 0
    driver.step()  # idle driver tick compacts the sealed backlog
    assert asvc.batcher.delta.summary()["n_compactions"] == 1
    assert driver.stats.n_idle_compactions == 1
    driver.detach()  # handoff reverses: undriven polls compact again
    asvc.insert(v + 2.0, w_in)
    asvc.insert(v + 3.0, w_in)
    asvc.poll()
    assert asvc.batcher.delta.summary()["n_compactions"] == 2


def test_driver_attach_detach_contract(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    asvc = _paged_async(plan, data)
    cache = asvc.batcher.state_cache
    assert cache.eviction_policy is None
    driver = ServiceDriver(asvc)
    assert asvc.driver is driver
    assert isinstance(cache.eviction_policy, CostAwareEviction)
    with pytest.raises(ValueError, match="already has a driver"):
        ServiceDriver(asvc)
    with pytest.raises(TypeError, match="ManualClock"):
        driver.start()  # thread mode refuses a manual clock
    driver.detach()
    assert asvc.driver is None
    assert cache.eviction_policy is None
    assert cache.protected_group_ids() == frozenset()


def test_driver_never_makes_over_budget_residency_steady(parity_setup):
    """The scheduler's imminent set is clamped to the cache budget: with
    a wide prefetch horizon and a cap of 1 group, protection + prefetch
    must not hold extra states resident in steady state — peak residency
    stays within cap + the one launch-transient group."""
    p, data, weights, host, plan, _ = parity_setup
    asvc = _paged_async(plan, data, cap=1)
    cache = asvc.batcher.state_cache
    peaks = []
    orig = cache._on_event
    cache._on_event = lambda gi, kind: (
        peaks.append(cache.n_resident), orig(gi, kind)
    )
    driver = ServiceDriver(asvc)  # default horizon >> 2 ms deadlines
    qpts, wids = _mixed_queries(data, weights, 24, seed=31)
    rng = np.random.default_rng(7)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, len(qpts)))
    replay_with_driver(driver, qpts, wids, arrivals)
    assert max(peaks) <= 2  # cap (protected/prefetched) + launch transient
    assert cache.n_resident <= 1


def test_prefetch_policy_reads_depth_and_deadline():
    policy = DeadlinePrefetch(horizon_s=0.010, depth_fraction=0.5)
    pending = {
        3: (1, 1.005),  # deadline within the 10 ms horizon
        5: (1, 9.000),  # far future, shallow: not imminent
        7: (4, 9.000),  # far future but buffer >= half of q_batch=8
        2: (1, 1.001),  # most imminent deadline
    }
    order, shield = policy.plan(pending, q_batch=8, now=1.0)
    assert order == [2, 3, 7]  # soonest deadline first
    assert shield == {2, 3, 7}


def test_driver_thread_start_stop_resolves_futures(parity_setup):
    """Thread-mode smoke on the real clock: start/submit/stop(drain) must
    resolve every future (stop drains, so this holds even on a machine
    too slow for the thread to tick) — no sleeps, no timing asserts."""
    p, data, weights, host, plan, _ = parity_setup
    svc = RetrievalService(
        plan, data, cfg=ServiceConfig(k=K, q_batch=4,
                                      max_resident_groups=1),
    )
    svc.warmup()
    asvc = AsyncRetrievalService(svc.batcher, max_delay_ms=0.5)
    driver = ServiceDriver(asvc, tick_s=0.001)
    driver.start()
    assert driver.running
    qpts, wids = _mixed_queries(data, weights, 6, seed=23)
    futs = [driver.submit(qpts[i], wids[i]) for i in range(len(qpts))]
    driver.stop(drain=True)
    assert not driver.running
    assert all(f.done() for f in futs)
    sync = svc.query(qpts, wids)  # thread-mode answers are still bit-exact
    got = np.stack([f.result().ids for f in futs])
    np.testing.assert_array_equal(got, sync.ids)
    driver.stop()  # idempotent


# ------------------------------------------------- the port against JAX


def _driven_replay(svc, qpts, wids, arrivals, policy):
    """A driven replay with DeadlinePrefetch and ``policy`` eviction;
    returns the answers, launches, cache events, protected sets, the
    eviction policy's choices and the metrics snapshot."""
    mod = serving_module(svc)
    svc.warmup()
    svc.reset_stats()
    asvc = mod.AsyncRetrievalService(svc.batcher, max_delay_ms=2.0,
                                     clock=mod.ManualClock())
    cache = svc.batcher.state_cache
    launches = launch_log(svc.batcher, asvc.clock, qpts)
    events = cache_log(cache)
    protected, choices = [], []
    protect = cache.protect

    def logged_protect(gis):
        protected.append(sorted(int(g) for g in gis))
        protect(gis)

    cache.protect = logged_protect
    evict = getattr(mod, policy)()

    def logged_policy(candidates):
        victim = evict(candidates)
        choices.append((sorted(c.group_id for c in candidates), victim))
        return victim

    driver = mod.ServiceDriver(asvc, prefetch=mod.DeadlinePrefetch(),
                               eviction=logged_policy)
    res, waits = mod.replay_with_driver(driver, qpts, wids, arrivals)
    return (res, waits, launches, events, protected, choices,
            svc.batcher.metrics.snapshot())


@pytest.mark.parametrize("policy", ["CostAwareEviction", "LRUEviction"])
@pytest.mark.parametrize("cap", [1, 2])
def test_driven_replay_matches_jax(parity_setup, cap, policy):
    """The same plan and trace through both packages' driven, paged
    services (DeadlinePrefetch, cost-aware or LRU eviction): the same
    protected sets and prefetches, the same eviction choices, the same
    cache events and registry (every wlsh_state_* and wlsh_driver_*
    count), the same launches (group, rows, tick) and waits, and the same
    answers: ids, stop and n_checked exact, p = 2 distances to 1e-6
    relative."""
    p, data, weights, host, plan, svc = parity_setup
    qpts, wids = _mixed_queries(data, weights, 32, seed=61)
    rng = np.random.default_rng(67)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, len(qpts)))
    kw = dict(k=K, q_batch=4, max_resident_groups=cap)
    got = _driven_replay(port_service(p, **kw), qpts, wids, arrivals,
                         policy)
    want = _driven_replay(jax_service(p, **kw), qpts, wids, arrivals,
                          policy)
    names = ("launches", "events", "protected", "choices", "metrics")
    for name, a, b in zip(names, got[2:], want[2:]):
        assert a == b, name
    assert any(kind == "restore_overlapped" for _, kind in got[3])
    assert got[5]  # the policy chose victims
    np.testing.assert_array_equal(got[1], want[1])
    for f in ("ids", "group_ids", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(got[0], f),
                                      getattr(want[0], f), err_msg=f)
    np.testing.assert_allclose(got[0].dists, want[0].dists, rtol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--async", "--driver", "--prefetch", "--max-resident-groups", "1"],
    ["--async", "--driver", "--qos", "--device-budget", "1MB"],
], ids=["driven", "qos"])
def test_cli_driven_replay_matches_jax(flags, capsys):
    """The launcher's driven replay on the CPU reports what the JAX
    launcher reports for the same arguments: the per-group serving
    stats, the state-cache counters, the waits and launch causes, and
    the driver's (and QoS scheduler's) counters."""
    from repro.launch import retrieval as jax_launch
    from repro_torch.launch import retrieval as port_launch

    argv = ["--n", "1024", "--d", "16", "--n-weights", "8", "--n-subset",
            "4", "--n-queries", "24", "--k", "5", "--v", "4", "--q-batch",
            "4", *flags]
    check = [] if "--qos" in flags else ["--check"]
    got = port_launch.main(argv + check + ["--device", "cpu"])
    want = jax_launch.main(argv + check)
    out = capsys.readouterr().out
    assert "state cache:" in out and "driver:" in out
    for key in ("n_groups", "stats", "cache", "async", "n_check_failures"):
        # through json, where nan equals nan
        assert json.dumps(got[key], sort_keys=True) == json.dumps(
            want[key], sort_keys=True), key
    assert got["cache"]["n_restores"] > 0
