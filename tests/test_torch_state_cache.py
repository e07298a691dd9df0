"""The port's group-state paging under a device-memory budget.

The reference's ``tests/test_state_cache.py``, run against
``repro_torch``'s ``StateCache`` and its services on the CPU, plus the
same plan through both packages: the same ``StateCache`` event sequence
under ``max_resident_groups=1`` and under a byte budget, and the same
answers.

The StateCache must page per-group device states (lazy build, LRU
eviction, host offload/restore) without ever changing an answer: with
``max_resident_groups`` capped below the plan's group count, both
frontends must stay bit-exact vs ``WLSHIndex.search_dense`` for every
supported exponent p in {2, 1, 0.5}, while ``Batcher.stats`` reports the
eviction/restore traffic.  LRU order, pin-during-launch and counter
consistency are property-tested against fake build/offload/restore
executors (no device); the compiled-step cache is pinned to show
eviction never forces a recompilation for same-shape groups.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_serving import (
    build_port_parity,
    cache_log,
    cpu_config,
    jax_service,
    port_service,
)
from repro_torch.serving import RetrievalService, StateCache
from repro_torch.serving.async_service import (
    AsyncRetrievalService,
    ManualClock,
    replay_open_loop,
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
                offload=True):
    """StateCache over fake build/offload/restore executors (no device)."""
    kw = {}
    if offload:
        kw = dict(offload=lambda state: ("host", state),
                  restore=lambda gi, host: host[1])
    return StateCache(
        build=lambda gi: ("dev", gi),
        nbytes_of=nbytes,
        max_resident_groups=cap,
        device_budget_bytes=budget,
        on_event=(lambda gi, kind: log.append((gi, kind)))
        if log is not None else None,
        **kw,
    )


def test_lru_eviction_order_deterministic():
    log = []
    cache = _fake_cache(cap=2, log=log)
    for gi in (0, 1, 2):  # 2 evicts 0 (LRU), not 1
        with cache.lease(gi):
            pass
    assert cache.resident_group_ids() == (1, 2)
    assert [e for e in log if e[1] == "evict"] == [(0, "evict")]
    with cache.lease(1):  # refresh 1 -> 2 becomes LRU
        pass
    with cache.lease(0):  # restore 0, evicting 2
        pass
    assert cache.resident_group_ids() == (1, 0)
    assert cache.stats.n_builds == 3
    assert cache.stats.n_restores == 1  # 0 came back from its host copy
    assert cache.stats.n_evictions == 2
    assert cache.stats.n_hits == 1


def test_byte_budget_eviction():
    cache = _fake_cache(budget=25, nbytes=lambda gi: 10)
    for gi in (0, 1, 2):
        with cache.lease(gi):
            pass
    assert cache.resident_group_ids() == (1, 2)  # 30 > 25 -> evict LRU
    assert cache.resident_bytes == 20


def test_miss_evicts_before_materializing():
    """The budget must hold at peak residency: on a miss, room is made
    *before* the new state is built/restored (its size is known up
    front), never by going transiently over budget."""
    peaks = []

    def build(gi):
        peaks.append(cache.resident_bytes + 10)
        return ("dev", gi)

    cache = StateCache(
        build=build, nbytes_of=lambda gi: 10, device_budget_bytes=25,
        offload=lambda s: ("host", s), restore=lambda gi, h: build(gi),
    )
    for gi in (0, 1, 2, 0, 1):  # last two restore, not build
        with cache.lease(gi):
            pass
    assert cache.stats.n_restores == 2
    assert peaks and all(p <= 25 for p in peaks)


def test_pinned_states_are_never_evicted():
    cache = _fake_cache(cap=1)
    cache.acquire(0)  # pinned
    with cache.lease(1):  # over budget, but both pinned -> soft budget
        assert cache.n_resident == 2
        with pytest.raises(ValueError):
            cache.evict(1)
    # releasing 1 makes it the only evictable state: budget enforcement
    # must pick it even though 0 is least recently used
    assert cache.resident_group_ids() == (0,)
    assert cache.pin_count(0) == 1
    cache.release(0)
    assert cache.stats.n_evictions == 1


def test_discard_mode_rebuilds_instead_of_restoring():
    cache = _fake_cache(cap=1, offload=False)
    with cache.lease(0):
        pass
    with cache.lease(1):
        pass
    with cache.lease(0):
        pass
    assert cache.stats.n_builds == 3  # 0 was discarded, not offloaded
    assert cache.stats.n_restores == 0


def test_transient_restore_failure_retries_in_place():
    """A restore that raises once (device OOM) is retried inside the
    same acquire — the caller sees a working lease, and the retry is
    counted instead of surfacing as an exception."""
    fail = {"next": True}

    def restore(gi, host):
        if fail["next"]:
            fail["next"] = False
            raise RuntimeError("injected device OOM")
        return host[1]

    cache = StateCache(
        build=lambda gi: ("dev", gi), nbytes_of=lambda gi: 10,
        max_resident_groups=1,
        offload=lambda s: ("host", s), restore=restore,
    )
    with cache.lease(0):
        pass
    with cache.lease(1):  # evicts 0 to host
        pass
    with cache.lease(0) as state:  # transient failure recovers in place
        assert state == ("dev", 0)
    assert cache.stats.n_restore_retries == 1
    assert cache.stats.n_restores == 1
    assert cache.stats.n_builds == 2  # 0 was never rebuilt after offload


def test_failed_restore_keeps_host_copy():
    """A restore that keeps raising past the retry budget must propagate
    *and* leave the host copy in place so a later acquire restores
    instead of silently cold-rebuilding."""
    fail = {"left": 10}

    def restore(gi, host):
        if fail["left"] > 0:
            fail["left"] -= 1
            raise RuntimeError("injected device OOM")
        return host[1]

    cache = StateCache(
        build=lambda gi: ("dev", gi), nbytes_of=lambda gi: 10,
        max_resident_groups=1, restore_retries=2,
        offload=lambda s: ("host", s), restore=restore,
    )
    with cache.lease(0):
        pass
    with cache.lease(1):  # evicts 0 to host
        pass
    with pytest.raises(RuntimeError, match="injected"):
        cache.acquire(0)  # burns 3 attempts (1 + 2 retries), all fail
    assert not cache.is_resident(0)
    assert cache.stats.n_restore_retries == 2
    fail["left"] = 0  # fault clears
    with cache.lease(0) as state:  # retry restores the preserved copy
        assert state == ("dev", 0)
    assert cache.stats.n_restores == 1
    assert cache.stats.n_builds == 2  # 0 was never rebuilt after offload


def test_cache_validation():
    with pytest.raises(ValueError):
        _fake_cache(cap=0)
    with pytest.raises(ValueError):
        _fake_cache(budget=0)
    with pytest.raises(ValueError):
        StateCache(build=lambda gi: gi, nbytes_of=lambda gi: 1,
                   offload=lambda s: s)  # offload without restore
    cache = _fake_cache()
    with pytest.raises(ValueError):
        cache.release(0)  # release without acquire


def test_invalidate_drops_device_and_host_copies():
    """Compaction-driven invalidation: the group's resident state *and*
    its host offload copy are discarded at a bumped version, so the next
    acquire cold-builds; nothing else is touched."""
    log = []
    cache = _fake_cache(cap=1, log=log)
    with cache.lease(0):
        pass
    with cache.lease(1):  # evicts 0 to its host copy
        pass
    assert cache.version_of(0) == 0
    cache.invalidate(0)
    assert cache.version_of(0) == 1
    assert cache.stats.n_invalidations == 1
    with cache.lease(0):  # host copy gone: cold build, not restore
        pass
    assert cache.stats.n_restores == 0
    assert cache.stats.n_builds == 3
    assert (0, "invalidate") in log
    # the resident variant: invalidating a resident group frees its slot
    cache.invalidate(0)
    assert not cache.is_resident(0)
    assert cache.version_of(0) == 2


def test_replace_installs_new_state_at_bumped_version():
    cache = _fake_cache(cap=2)
    with cache.lease(0):
        pass
    cache.replace(0, ("dev", "compacted-0"))
    assert cache.version_of(0) == 1
    assert cache.stats.n_invalidations == 1
    with cache.lease(0) as state:  # hit: the replaced state serves
        assert state == ("dev", "compacted-0")
    assert cache.stats.n_hits == 1 and cache.stats.n_builds == 1
    # replace of a non-resident group installs it (and evicts LRU to fit)
    with cache.lease(1):
        pass
    with cache.lease(2):
        pass
    cache.replace(3, ("dev", "compacted-3"))
    assert cache.is_resident(3) and cache.n_resident == 2


def test_invalidate_and_replace_refuse_pinned_groups():
    cache = _fake_cache()
    cache.acquire(0)
    with pytest.raises(ValueError):
        cache.invalidate(0)
    with pytest.raises(ValueError):
        cache.replace(0, ("dev", "new"))
    cache.release(0)
    cache.invalidate(0)  # unpinned: fine


def test_stale_offload_copy_is_never_restored():
    """A host copy whose version lags the group's current version must be
    dropped, not restored (defense in depth behind eager invalidation)."""
    cache = _fake_cache(cap=1)
    with cache.lease(0):
        pass
    with cache.lease(1):  # 0 offloaded at version 0
        pass
    cache._versions[0] = 7  # simulate an out-of-band version bump
    with cache.lease(0):
        pass
    assert cache.stats.n_restores == 0  # stale copy discarded
    assert cache.stats.n_builds == 3


@st.composite
def _access_trace(draw):
    """Arbitrary group access sequence plus a residency cap."""
    ops = draw(st.lists(st.integers(0, 5), min_size=1, max_size=60))
    cap = draw(st.integers(1, 4))
    return ops, cap


@st.composite
def _versioned_trace(draw):
    """Interleaved accesses and compaction-driven invalidations."""
    ops = draw(st.lists(
        st.tuples(st.sampled_from(["lease", "invalidate", "replace"]),
                  st.integers(0, 3)),
        min_size=1, max_size=60,
    ))
    cap = draw(st.integers(1, 3))
    return ops, cap


@given(_versioned_trace())
@settings(max_examples=100, deadline=None)
def test_versioned_counter_invariants_property(trace):
    """Under arbitrary interleavings of leases, invalidations and
    replaces: every acquire after a version bump rebuilds (never serves
    stale bytes), versions grow monotonically, and the counter identity
    hits + builds + restores == leases holds with n_invalidations equal
    to the version-bump count."""
    ops, cap = trace
    cache = _fake_cache(cap=cap)
    versions = {gi: 0 for gi in range(4)}
    expected = {gi: ("dev", gi) for gi in range(4)}  # current payload
    n_leases = n_bumps = 0
    for op, gi in ops:
        if op == "lease":
            with cache.lease(gi) as state:
                assert state == expected[gi]
            n_leases += 1
        elif op == "invalidate":
            versions[gi] += 1
            n_bumps += 1
            cache.invalidate(gi)
            assert not cache.is_resident(gi)
            expected[gi] = ("dev", gi)  # next acquire cold-builds
        else:
            versions[gi] += 1
            n_bumps += 1
            expected[gi] = ("dev", gi, versions[gi])
            cache.replace(gi, expected[gi])
            assert cache.is_resident(gi)
        assert cache.version_of(gi) == versions[gi]
    s = cache.stats
    assert s.n_hits + s.n_builds + s.n_restores == n_leases
    assert s.n_invalidations == n_bumps
    assert all(cache.version_of(g) == versions[g] for g in versions)


@given(_access_trace())
@settings(max_examples=100, deadline=None)
def test_lru_and_counter_invariants_property(trace):
    """The cache must track a reference LRU model exactly: residency order,
    cap, and hit/build/restore/eviction counter consistency on arbitrary
    access sequences."""
    ops, cap = trace
    cache = _fake_cache(cap=cap)
    model: OrderedDict[int, bool] = OrderedDict()
    seen: set[int] = set()
    for gi in ops:
        with cache.lease(gi) as state:
            assert state == ("dev", gi)
            assert cache.pin_count(gi) == 1
        assert cache.pin_count(gi) == 0
        if gi in model:
            model.move_to_end(gi)
        else:
            model[gi] = True
        seen.add(gi)
        while len(model) > cap:
            model.popitem(last=False)
        assert cache.resident_group_ids() == tuple(model)
    s = cache.stats
    assert s.n_hits + s.n_builds + s.n_restores == len(ops)
    assert s.n_builds == len(seen)  # offload mode: at most one cold build
    assert s.n_restores <= s.n_evictions
    assert cache.n_resident == len(model) <= cap


# ----------------------------------------------- service-level paging tests


def _paged_service(plan, data, cap, q_batch=4):
    svc = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=K, q_batch=q_batch, max_resident_groups=cap),
    )
    svc.warmup()
    svc.reset_stats()
    return svc


def _mixed_queries(data, weights, n_queries, seed=43):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n_queries)
    qpts = data[rng.choice(len(data), n_queries, replace=False)].astype(
        np.float32
    )
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return qpts, wids


def test_paged_service_matches_search_dense(parity_setup):
    """Bit-exact vs the host oracle with max_resident_groups < n_groups,
    per p in {2, 1, 0.5}, with live eviction/restore traffic."""
    p, data, weights, host, plan, svc = parity_setup
    assert plan.n_groups >= 3
    psvc = _paged_service(plan, data, cap=1)
    qpts, wids = _mixed_queries(data, weights, 24)
    # submit in small chunks so group launches interleave and page
    res_ids, res_stop = [], []
    for lo in range(0, len(qpts), 4):
        r = psvc.query(qpts[lo : lo + 4], wids[lo : lo + 4])
        res_ids.append(r.ids)
        res_stop.append(r.stop_levels)
    res_ids = np.concatenate(res_ids)
    res_stop = np.concatenate(res_stop)
    for qi in range(len(qpts)):
        want = host.search_dense(qpts[qi], weight_id=int(wids[qi]), k=K)
        np.testing.assert_array_equal(
            res_ids[qi], want.ids.astype(np.int32),
            err_msg=f"paged ids mismatch at query {qi} (p={p})",
        )
        assert int(res_stop[qi]) == want.stats.stop_level
    # the run actually paged: Batcher.stats reports evictions and restores
    evictions = sum(s.n_state_evictions for s in psvc.stats.values())
    restores = sum(s.n_state_restores for s in psvc.stats.values())
    assert evictions > 0 and restores > 0
    assert psvc.state_cache.n_resident == 1


def test_paged_async_frontend_matches_sync(parity_setup):
    """The async frontend over a capped cache stays bit-exact with the
    unpaged sync service on identical traffic, per p in {2, 1, 0.5}."""
    p, data, weights, host, plan, svc = parity_setup
    qpts, wids = _mixed_queries(data, weights, 24, seed=47)
    sync = svc.query(qpts, wids)  # unpaged reference
    psvc = _paged_service(plan, data, cap=1)
    rng = np.random.default_rng(11)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, len(qpts)))
    asvc = AsyncRetrievalService(psvc.batcher, max_delay_ms=2.0,
                                 clock=ManualClock())
    res, _ = replay_open_loop(asvc, qpts, wids, arrivals)
    np.testing.assert_array_equal(res.ids, sync.ids)
    np.testing.assert_array_equal(res.dists, sync.dists)
    np.testing.assert_array_equal(res.stop_levels, sync.stop_levels)
    np.testing.assert_array_equal(res.n_checked, sync.n_checked)
    assert psvc.cache_summary()["n_evictions"] > 0


def test_state_pinned_during_launch(parity_setup):
    """While a launch is in flight its group's state is pinned (and the
    budget is temporarily soft); after the launch it is evictable again."""
    p, data, weights, host, plan, svc = parity_setup
    psvc = _paged_service(plan, data, cap=1)
    batcher = psvc.batcher
    observed = []
    orig_encode = batcher._encode

    def spying_encode(gi, cfg, state, queries, take):
        observed.append((gi, batcher.state_cache.pin_count(gi)))
        return orig_encode(gi, cfg, state, queries, take)

    batcher._encode = spying_encode
    try:
        qpts, wids = _mixed_queries(data, weights, 8, seed=13)
        psvc.query(qpts, wids)
    finally:
        batcher._encode = orig_encode
    assert observed and all(pins == 1 for _, pins in observed)
    assert all(
        batcher.state_cache.pin_count(gi) == 0 for gi in range(plan.n_groups)
    )


def test_eviction_does_not_recompile(parity_setup):
    """QueryStepCache keys on shape signatures, not states: serving with a
    capped cache (states paging constantly) must compile exactly the same
    number of steps as full residency, and re-traffic compiles nothing."""
    p, data, weights, host, plan, svc = parity_setup
    psvc = _paged_service(plan, data, cap=1)
    signatures = {
        psvc.group_config(gi).shape_signature()
        for gi in range(plan.n_groups)
    }
    assert psvc.step_cache.n_compiled == len(signatures)
    qpts, wids = _mixed_queries(data, weights, 16, seed=17)
    for lo in range(0, len(qpts), 4):  # interleave groups -> page states
        psvc.query(qpts[lo : lo + 4], wids[lo : lo + 4])
    assert psvc.cache_summary()["n_evictions"] > 0  # paging happened
    assert psvc.step_cache.n_compiled == len(signatures)  # no recompiles


def test_discard_mode_warmup_skips_doomed_builds(parity_setup):
    """With offload disabled, warmup must not build states the budget
    would immediately discard — only the budget-fitting tail prebuilds."""
    p, data, weights, host, plan, svc = parity_setup
    dsvc = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=K, q_batch=4, max_resident_groups=1,
                          offload_evicted=False),
    )
    dsvc.warmup()
    assert dsvc.cache_summary()["n_builds"] == 1  # not n_groups
    assert dsvc.cache_summary()["n_evictions"] == 0
    # all steps still compiled during warmup, and answers stay exact
    signatures = {
        dsvc.group_config(gi).shape_signature()
        for gi in range(plan.n_groups)
    }
    assert dsvc.step_cache.n_compiled == len(signatures)
    qpts, wids = _mixed_queries(data, weights, 8, seed=19)
    np.testing.assert_array_equal(
        dsvc.query(qpts, wids).ids, svc.query(qpts, wids).ids
    )


def test_state_nbytes_accounts_built_state(parity_setup):
    """IndexConfig.state_nbytes must equal the actual bytes of the built
    (padded) QueryState, so byte budgets are enforceable before build."""
    p, data, weights, host, plan, svc = parity_setup
    svc.warmup()

    for gi in range(plan.n_groups):
        state = svc.batcher.state_cache.acquire(gi)
        try:
            actual = state.nbytes + 4  # the tensors + the n_valid int32
        finally:
            svc.batcher.state_cache.release(gi)
        assert svc.group_config(gi).state_nbytes == actual


def test_service_config_rejects_bad_budgets():
    with pytest.raises(ValueError):
        ServiceConfig(max_resident_groups=0)
    with pytest.raises(ValueError):
        ServiceConfig(device_budget_bytes=0)


# ------------------------------------------------- the port against JAX


def _paging_run(svc, qpts, wids):
    """Serve in chunks of 4 (so groups interleave and page); returns the
    answers and the cache's event sequence."""
    svc.warmup()
    svc.reset_stats()
    log = cache_log(svc.batcher.state_cache)
    outs = [svc.query(qpts[lo : lo + 4], wids[lo : lo + 4])
            for lo in range(0, len(qpts), 4)]
    res = {f: np.concatenate([getattr(r, f) for r in outs])
           for f in ("ids", "dists", "stop_levels", "n_checked")}
    return res, log, svc.cache_summary(), svc.batcher.metrics.snapshot()


@pytest.mark.parametrize("budget", ["one_group", "bytes"])
def test_paging_events_match_jax(parity_setup, budget):
    """The same plan and traffic through both packages' paged services:
    the same StateCache event sequence (hits, builds, restores, evictions,
    group by group), the same counters, and the same answers: ids, stop
    and n_checked exact, p = 2 distances to 1e-6 relative."""
    p, data, weights, host, plan, svc = parity_setup
    if budget == "one_group":
        kw = dict(max_resident_groups=1)
    else:  # room for the two smallest states, not for every group
        sizes = sorted(svc.group_config(g).state_nbytes
                       for g in range(plan.n_groups))
        kw = dict(device_budget_bytes=sizes[0] + sizes[1])
    qpts, wids = _mixed_queries(data, weights, 24, seed=53)
    got, got_log, got_cache, got_m = _paging_run(
        port_service(p, k=K, q_batch=4, **kw), qpts, wids)
    want, want_log, want_cache, want_m = _paging_run(
        jax_service(p, k=K, q_batch=4, **kw), qpts, wids)
    assert got_log == want_log
    assert got_m == want_m  # every wlsh_group_* and wlsh_state_* series
    assert any(kind == "restore" for _, kind in got_log)
    for key in ("n_hits", "n_builds", "n_restores", "n_evictions",
                "n_resident", "resident_bytes"):
        assert got_cache[key] == want_cache[key], key
    for f in ("ids", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["dists"], want["dists"], rtol=1e-6)
