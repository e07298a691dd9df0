"""The port's async deadline-aware frontend vs its sync service.

The reference's ``tests/test_async_retrieval.py``, run against
``repro_torch`` on the CPU (the ``tiny`` plan from the port's own
planner, the parity plans carried over from the JAX fixture), plus the
same plan and ``ManualClock`` replay through both packages: the same
launch schedule (group, rows, tick) and the same answers.

The async frontend must launch a compiled step immediately when a group's
pending buffer fills, launch a *partial* (padded) batch once the oldest
request's deadline budget expires, share group states / serving stats /
the compiled-step cache with the sync frontend (compile counter pinned),
and answer identical traffic bit-exactly vs `RetrievalService.query` for
every supported exponent p in {2, 1, 0.5}.  Deadline behaviour is tested
on a deterministic ManualClock via the same code path real-time callers
use (submit / poll / drain).
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_serving import (
    build_port_parity,
    cpu_config,
    jax_service,
    launch_log,
    port_service,
    serving_module,
)
from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.serving import (
    AsyncRetrievalService,
    ManualClock,
    RetrievalService,
    replay_open_loop,
)

ServiceConfig = cpu_config

QB = 4
MAX_DELAY_MS = 5.0


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5],
                ids=lambda p: f"p{p}")
def parity_setup(request):
    """(p, data, weights, host, plan, svc) of the port per exponent."""
    return build_port_parity(request.param)


@pytest.fixture(scope="module")
def tiny():
    data = make_dataset(n=512, d=16, seed=21)
    weights = make_weight_set(size=6, d=16, n_subset=3, n_subrange=10,
                              seed=22)
    cfg = PlanConfig(p=2.0, c=3, n=len(data), gamma_n=100.0)
    host = WLSHIndex(data, weights, cfg, tau=500.0, v=4, v_prime=4, seed=23)
    plan = host.export_serving_plan()
    svc = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=3, q_batch=QB, max_delay_ms=MAX_DELAY_MS),
    )
    svc.warmup()
    return data, weights, plan, svc


def _one_group_traffic(data, plan, n, seed=31):
    """n queries all under member weights of the largest group."""
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    members = plan.groups[gi].member_ids
    rng = np.random.default_rng(seed)
    wids = members[rng.integers(0, len(members), n)]
    qpts = data[rng.choice(len(data), n, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return gi, qpts, wids


def test_full_batch_launches_immediately(tiny):
    data, weights, plan, svc = tiny
    gi, qpts, wids = _one_group_traffic(data, plan, QB)
    svc.reset_stats()
    clock = ManualClock()
    asvc = AsyncRetrievalService(svc, clock=clock)
    futs = [asvc.submit(qpts[i], wids[i]) for i in range(QB - 1)]
    assert not any(f.done() for f in futs)  # buffer below q_batch: no launch
    assert asvc.pending_count == QB - 1
    futs.append(asvc.submit(qpts[QB - 1], wids[QB - 1]))
    # the fill-triggering submit launched without any clock advance or poll
    assert all(f.done() for f in futs)
    assert asvc.pending_count == 0
    assert asvc.n_launched_full == 1 and asvc.n_launched_deadline == 0
    st = svc.stats[gi]
    assert st.n_batches == 1 and st.n_queries == QB and st.n_padded == 0
    assert st.occupancy == 1.0


def test_deadline_expiry_launches_partial_batch(tiny):
    data, weights, plan, svc = tiny
    gi, qpts, wids = _one_group_traffic(data, plan, 2)
    svc.reset_stats()
    clock = ManualClock()
    asvc = AsyncRetrievalService(svc, clock=clock)
    futs = [asvc.submit(qpts[i], wids[i]) for i in range(2)]
    assert asvc.next_deadline() == pytest.approx(MAX_DELAY_MS / 1e3)
    assert asvc.poll() == 0  # deadline not reached: nothing launches
    clock.advance(0.8 * MAX_DELAY_MS / 1e3)
    assert asvc.poll() == 0
    assert not any(f.done() for f in futs)
    clock.advance(0.4 * MAX_DELAY_MS / 1e3)  # past the oldest deadline
    assert asvc.poll() == 1
    assert all(f.done() for f in futs)
    assert asvc.n_launched_deadline == 1 and asvc.n_launched_full == 0
    st = svc.stats[gi]
    assert st.n_batches == 1 and st.n_queries == 2
    assert st.n_padded == QB - 2  # partial batch padded to the compiled shape


def test_per_request_deadline_overrides_budget(tiny):
    data, weights, plan, svc = tiny
    gi, qpts, wids = _one_group_traffic(data, plan, 1)
    clock = ManualClock(10.0)
    asvc = AsyncRetrievalService(svc, clock=clock)
    fut = asvc.submit(qpts[0], wids[0], deadline=10.0 + 1e-4)
    assert asvc.next_deadline() == pytest.approx(10.0 + 1e-4)
    clock.advance(2e-4)  # well under max_delay_ms, past the explicit deadline
    assert asvc.poll() == 1
    assert fut.done()


def test_result_pending_raises_until_drain(tiny):
    data, weights, plan, svc = tiny
    gi, qpts, wids = _one_group_traffic(data, plan, 1)
    asvc = AsyncRetrievalService(svc, clock=ManualClock())
    fut = asvc.submit(qpts[0], wids[0])
    with pytest.raises(RuntimeError):
        fut.result()
    assert asvc.drain() == 1
    assert asvc.n_launched_drain == 1
    ans = fut.result()
    assert ans.group_id == gi and ans.ids.shape == (svc.cfg.k,)
    assert asvc.pending_count == 0 and asvc.next_deadline() is None


def test_submit_validation(tiny):
    data, weights, plan, svc = tiny
    asvc = AsyncRetrievalService(svc, clock=ManualClock())
    with pytest.raises(ValueError):
        asvc.submit(data[0], len(weights))  # weight_id out of range
    with pytest.raises(ValueError):
        asvc.submit(data[0][:4], 0)  # wrong query dimensionality
    with pytest.raises(ValueError):
        asvc.submit(data[0], 0, deadline=float("nan"))  # would never expire
    with pytest.raises(ValueError):
        asvc.submit(data[0], 0, deadline=float("inf"))
    assert asvc.pending_count == 0  # rejected submissions left nothing queued
    with pytest.raises(ValueError):
        AsyncRetrievalService(svc, max_delay_ms=-1.0)


def test_failed_launch_restores_pending_buffer(tiny):
    """A device error inside a launch must be atomic: the batch returns to
    its buffer in order, no future is stranded, and a retry succeeds."""
    data, weights, plan, svc = tiny
    gi, qpts, wids = _one_group_traffic(data, plan, 2)
    clock = ManualClock()
    asvc = AsyncRetrievalService(svc, clock=clock)
    futs = [asvc.submit(qpts[i], wids[i]) for i in range(2)]
    real_run_batch = asvc.batcher.run_batch
    asvc.batcher.run_batch = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("injected device failure")
    )
    try:
        clock.advance(1.0)
        with pytest.raises(RuntimeError, match="injected"):
            asvc.poll()
    finally:
        asvc.batcher.run_batch = real_run_batch
    assert asvc.pending_count == 2  # nothing dropped
    assert not any(f.done() for f in futs)
    assert asvc.poll() == 1  # retry after the transient failure succeeds
    assert all(f.done() for f in futs)
    # submission order survived the round trip through the failed launch
    np.testing.assert_array_equal(
        np.stack([f.result().ids for f in futs]),
        svc.query(qpts, wids).ids,
    )


def test_failed_fill_launch_in_submit_withdraws_only_the_new_request(tiny):
    """When the fill-triggering submit itself fails, the caller holds no
    future — their request must be withdrawn (a retry re-submits it) while
    the earlier requests stay queued with live futures."""
    data, weights, plan, svc = tiny
    gi, qpts, wids = _one_group_traffic(data, plan, QB)
    asvc = AsyncRetrievalService(svc, clock=ManualClock())
    futs = [asvc.submit(qpts[i], wids[i]) for i in range(QB - 1)]
    real_run_batch = asvc.batcher.run_batch
    asvc.batcher.run_batch = lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("injected device failure")
    )
    try:
        with pytest.raises(RuntimeError, match="injected"):
            asvc.submit(qpts[QB - 1], wids[QB - 1])
    finally:
        asvc.batcher.run_batch = real_run_batch
    assert asvc.pending_count == QB - 1  # only the failed submit withdrawn
    assert not any(f.done() for f in futs)
    fut = asvc.submit(qpts[QB - 1], wids[QB - 1])  # retry fills the batch
    assert fut.done() and all(f.done() for f in futs)
    np.testing.assert_array_equal(
        np.stack([f.result().ids for f in futs + [fut]]),
        svc.query(qpts, wids).ids,
    )


def test_replay_requires_manual_clock(tiny):
    data, weights, plan, svc = tiny
    asvc = AsyncRetrievalService(svc)  # default time.monotonic clock
    with pytest.raises(TypeError):
        replay_open_loop(asvc, data[:2], [0, 0], [0.0, 1.0])


def _mixed_traffic(data, weights, n, seed):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n)
    qpts = data[rng.choice(len(data), n, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, n))
    return qpts, wids, arrivals


def test_async_matches_sync_bitexact(parity_setup):
    """Identical traffic through both frontends: bit-exact ids / stop /
    n_checked per p in {2, 1, 0.5}, with every wait bounded by the deadline
    budget."""
    p, data, weights, host, plan, svc = parity_setup
    qpts, wids, arrivals = _mixed_traffic(data, weights, 32, seed=37)
    sync = svc.query(qpts, wids)
    asvc = AsyncRetrievalService(svc, max_delay_ms=2.0, clock=ManualClock())
    res, waits = replay_open_loop(asvc, qpts, wids, arrivals)
    np.testing.assert_array_equal(res.ids, sync.ids)
    np.testing.assert_array_equal(res.dists, sync.dists)
    np.testing.assert_array_equal(res.group_ids, sync.group_ids)
    np.testing.assert_array_equal(res.stop_levels, sync.stop_levels)
    np.testing.assert_array_equal(res.n_checked, sync.n_checked)
    assert np.all(waits >= 0) and np.all(waits <= 2.0 / 1e3 + 1e-9)
    assert asvc.n_launched_full + asvc.n_launched_deadline > 0
    assert asvc.n_launched_drain == 0  # replay runs the tail out by deadline


def test_compile_counter_pinned_across_frontends(parity_setup):
    """Layering the async frontend over a warmed sync service must compile
    nothing new: both frontends share one QueryStepCache."""
    p, data, weights, host, plan, svc = parity_setup
    svc.warmup()
    qpts, wids, arrivals = _mixed_traffic(data, weights, 16, seed=39)
    before = svc.step_cache.n_compiled
    svc.query(qpts, wids)
    asvc = AsyncRetrievalService(svc, max_delay_ms=1.0, clock=ManualClock())
    replay_open_loop(asvc, qpts, wids, arrivals)
    assert svc.step_cache.n_compiled == before


def test_open_loop_occupancy_beats_single_submission(tiny):
    """The deadline batcher must lift occupancy over the sync frontend fed
    one request at a time (the serve_bench sweep-2 penalty) on the same
    arrival trace."""
    data, weights, plan, svc = tiny
    qpts, wids, arrivals = _mixed_traffic(data, weights, 48, seed=41)
    svc.reset_stats()
    for qi in range(len(qpts)):  # open-loop sync: one launch per request
        svc.query(qpts[qi : qi + 1], wids[qi : qi + 1])
    occ_sync = svc.mean_occupancy()
    svc.reset_stats()
    asvc = AsyncRetrievalService(svc, max_delay_ms=5.0, clock=ManualClock())
    replay_open_loop(asvc, qpts, wids, arrivals)
    occ_async = svc.mean_occupancy()
    assert occ_sync == pytest.approx(1.0 / QB)  # every sync launch pads QB-1
    assert occ_async > occ_sync


def test_async_launcher_runs():
    """--async end-to-end: open-loop Poisson replay + host-oracle check."""
    from repro_torch.launch.retrieval import main

    out = main([
        "--n", "512", "--d", "16", "--n-weights", "4", "--n-subset", "2",
        "--n-queries", "12", "--k", "3", "--v", "4", "--q-batch", "4",
        "--check", "--async", "--max-delay-ms", "2", "--arrival-rate",
        "1500", "--device", "cpu",
    ])
    assert out["n_check_failures"] == 0
    rep = out["async"]
    assert rep["n_launched_full"] + rep["n_launched_deadline"] >= 1
    # every wait is bounded by the deadline budget
    assert rep["p95_wait_ms"] <= rep["max_delay_ms"] + 1e-6


# --------------------------------------------------------- backpressure


def test_submit_raises_overloaded_at_max_pending(tiny):
    """ServiceConfig.max_pending bounds per-group pending buffers: the
    overflowing submit raises a typed Overloaded (with the observed
    depth) *before* enqueueing, and capacity freed by poll()/drain()
    accepts new submissions again."""
    from repro_torch.serving import Overloaded

    data, weights, plan, svc = tiny
    bounded = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=3, q_batch=8, max_delay_ms=MAX_DELAY_MS,
                          max_pending=2),
    )
    clock = ManualClock()
    asvc = AsyncRetrievalService(bounded, clock=clock)
    gi, qpts, wids = _one_group_traffic(data, plan, 4)
    futs = [asvc.submit(qpts[i], wids[i]) for i in range(2)]
    with pytest.raises(Overloaded) as err:
        asvc.submit(qpts[2], wids[2])
    assert err.value.group_id == gi
    assert err.value.depth == 2 and err.value.max_pending == 2
    # the rejected request was never enqueued and no future was resolved
    assert asvc.pending_count == 2
    assert not any(f.done() for f in futs)
    # deadline expiry drains the buffer; the retry is accepted
    clock.advance(MAX_DELAY_MS / 1e3 + 1e-4)
    assert asvc.poll() == 1
    assert all(f.done() for f in futs)
    fut = asvc.submit(qpts[2], wids[2])
    assert asvc.pending_count == 1
    asvc.drain()
    assert fut.done()


def test_max_pending_transparent_for_fill_launched_traffic(tiny):
    """A cap at q_batch never fires on well-batched traffic: fill
    launches drain the buffer before it can overflow, and answers stay
    bit-exact with the unbounded frontend."""
    data, weights, plan, svc = tiny
    bounded = RetrievalService(
        plan, data,
        cfg=ServiceConfig(k=3, q_batch=QB, max_delay_ms=MAX_DELAY_MS,
                          max_pending=QB),
    )
    qpts, wids, arrivals = _mixed_traffic(data, weights, 24, seed=77)
    ref, _ = replay_open_loop(
        AsyncRetrievalService(svc, clock=ManualClock()),
        qpts, wids, arrivals,
    )
    got, _ = replay_open_loop(
        AsyncRetrievalService(bounded, clock=ManualClock()),
        qpts, wids, arrivals,
    )
    np.testing.assert_array_equal(got.ids, ref.ids)
    np.testing.assert_array_equal(got.stop_levels, ref.stop_levels)


# ------------------------------------------------- the port against JAX


def _replay_logged(svc, qpts, wids, arrivals, max_delay_ms):
    mod = serving_module(svc)
    asvc = mod.AsyncRetrievalService(svc, max_delay_ms=max_delay_ms,
                                     clock=mod.ManualClock())
    log = launch_log(svc.batcher, asvc.clock, qpts)
    res, waits = mod.replay_open_loop(asvc, qpts, wids, arrivals)
    return (res, waits, log, (asvc.n_launched_full, asvc.n_launched_deadline),
            svc.batcher.metrics.snapshot())


@pytest.mark.parametrize("cap", [None, 1], ids=["resident", "paged"])
def test_replay_schedule_and_answers_match_jax(parity_setup, cap):
    """The same plan and ManualClock replay through both packages' async
    frontends, all groups resident and under max_resident_groups=1: the
    same launches (group, rows, tick), launch causes, waits and metrics
    registry (wlsh_state_* event counts included), and the
    same answers: ids, stop and n_checked exact, p = 2 distances to 1e-6
    relative."""
    p, data, weights, host, plan, svc = parity_setup
    qpts, wids, arrivals = _mixed_traffic(data, weights, 32, seed=59)
    kw = dict(k=5, q_batch=QB, max_resident_groups=cap)
    got, got_w, got_log, got_n, got_m = _replay_logged(
        port_service(p, **kw), qpts, wids, arrivals, 2.0)
    want, want_w, want_log, want_n, want_m = _replay_logged(
        jax_service(p, **kw), qpts, wids, arrivals, 2.0)
    assert got_log == want_log
    assert got_n == want_n
    assert got_m == want_m  # every wlsh_group_/state_/query_ series
    np.testing.assert_array_equal(got_w, want_w)
    for f in ("ids", "group_ids", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-6)
