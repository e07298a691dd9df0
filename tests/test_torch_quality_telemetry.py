"""The port's online quality telemetry: shadow-exact recall and alerting.

The reference's ``tests/test_quality_telemetry.py`` (all but its bench
sentinel, which is not ported), run against ``repro_torch.obs`` on the
CPU, each next to the JAX package:

* the deterministic sampler is the same pure function of the query id
  in both packages: rate 0 samples nothing, rate 1 everything, and the
  sampled set is monotone in the rate;
* the same plan, traffic and rate yield the same sampled query ids
  across the port's sync, async and driver-stepped frontends and the
  JAX package's, and the micro-averaged recall estimate equals the JAX
  estimate and an offline ``scan_topk`` recomputation bit for bit, per
  p in {2, 1, 0.5};
* recall sampling changes no served answer;
* a full shadow queue drops (and counts) jobs instead of growing;
* both packages' ``HealthMonitor`` give the same alert streams on the
  same registry movements (multi-window burn rules, gauge streaks,
  edge-triggered events, JSONL export), and the driver's tick summary
  ends with the firing set.

No wall-clock sleeps: replays run on ManualClock and the monitor's
windows are counted in ticks.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_serving import build_port_parity, jax_service, port_service
from repro import obs as jax_obs
from repro_torch.index.streaming import scan_topk
from repro_torch.obs import (
    AlertRule,
    HealthMonitor,
    MetricsRegistry,
    default_rules,
    sample_hash,
    should_sample,
)
from repro_torch.serving import (
    AsyncRetrievalService,
    ManualClock,
    ServiceDriver,
    replay_open_loop,
    replay_with_driver,
)

K = 5
Q_BATCH = 4
RATE = 0.5
PORT_OBS = (MetricsRegistry, AlertRule, HealthMonitor)
JAX_OBS = (jax_obs.MetricsRegistry, jax_obs.AlertRule, jax_obs.HealthMonitor)


def _traffic(data, weights, n_queries, seed=61):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n_queries)
    qpts = data[rng.choice(len(data), n_queries, replace=False)].astype(
        np.float32
    )
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return qpts, wids


def _sampling_service(make, p, **cfg_kw):
    """``port_service`` or ``jax_service`` with recall sampling on."""
    cfg_kw.setdefault("recall_sample_rate", RATE)
    svc = make(p, k=K, q_batch=Q_BATCH, **cfg_kw)
    svc.warmup()
    return svc


def _offline_recall(data, plan, qpts, wids, qids, ids) -> float:
    """Micro-averaged recall of the answers ``ids`` on the queries
    ``qids``, recomputed with ``scan_topk`` over the whole corpus."""
    hits = rel = 0
    all_ids = np.arange(len(data), dtype=np.int64)
    for qi in qids:
        exact, _ = scan_topk(qpts[qi][None],
                             plan.weights[int(wids[qi])][None]
                             .astype(np.float32), all_ids,
                             np.asarray(data, np.float32), plan.p, K)
        exact_set = {int(i) for i in exact[0] if i >= 0}
        served = {int(i) for i in ids[qi] if i >= 0}
        hits += len(served & exact_set)
        rel += len(exact_set)
    return hits / rel if rel else float("nan")


def _alerts(mon) -> list[str]:
    """A monitor's alert events as JSON lines (NaN-safe comparison)."""
    return [json.dumps(a.to_dict()) for a in mon.alerts()]


# ------------------------------------------------------- deterministic sampler


def test_sampler_rate_edges():
    ids = range(1_000)
    for ss in (should_sample, jax_obs.should_sample):
        assert not any(ss(i, 0.0) for i in ids)
        assert not any(ss(i, -0.5) for i in ids)
        assert all(ss(i, 1.0) for i in ids)
        assert all(ss(i, 2.0) for i in ids)


@settings(max_examples=50)
@given(qid=st.integers(min_value=0, max_value=2**62),
       rate=st.floats(min_value=0.0, max_value=1.0, allow_nan=False))
def test_sampler_is_pure_function_of_id(qid, rate):
    assert should_sample(qid, rate) == should_sample(qid, rate)
    assert sample_hash(qid) == sample_hash(qid)
    assert sample_hash(qid) == jax_obs.sample_hash(qid)
    assert should_sample(qid, rate) == jax_obs.should_sample(qid, rate)


@settings(max_examples=50)
@given(lo=st.floats(min_value=0.0, max_value=1.0, allow_nan=False),
       hi=st.floats(min_value=0.0, max_value=1.0, allow_nan=False))
def test_sampled_set_monotone_in_rate(lo, hi):
    lo, hi = min(lo, hi), max(lo, hi)
    ids = range(512)
    at_lo = {i for i in ids if should_sample(i, lo)}
    at_hi = {i for i in ids if should_sample(i, hi)}
    assert at_lo <= at_hi
    assert at_lo == {i for i in ids if jax_obs.should_sample(i, lo)}


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def test_oracle_scan_in_row_chunks_is_bit_exact(p):
    """The shadow oracle's scan runs in row chunks; its distances and
    top-k equal the JAX package's unchunked scan bit for bit."""
    from repro.index.streaming import scan_topk as jax_scan_topk

    rng = np.random.default_rng(91)
    vecs = rng.uniform(0, 1e4, (5_000, 16)).astype(np.float32)
    vecs[4_000] = vecs[17]  # a tie across chunks: the lower row wins
    ids = np.arange(len(vecs), dtype=np.int64) + 7
    qs = (vecs[rng.choice(len(vecs), 64)] + rng.normal(0, 3.0, (64, 16))
          ).astype(np.float32)
    qs[0] = vecs[17]
    ws = rng.uniform(0.5, 2.0, (64, 16)).astype(np.float32)
    got = scan_topk(qs, ws, ids, vecs, p, K)
    want = jax_scan_topk(qs, ws, ids, vecs, p, K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))
    assert list(got[0][0][:2]) == [24, 4_007]


def test_sampler_hits_the_configured_fraction():
    n = 4_096
    for rate in (0.1, 0.3, 0.5, 0.9):
        got = sum(should_sample(i, rate) for i in range(n)) / n
        assert abs(got - rate) < 0.05


# ------------------------------------- frontends: determinism and bit-exactness


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def test_sampling_on_is_bit_exact_and_matches_offline_oracle(p):
    _, data, weights, host, plan, base_svc = build_port_parity(p)
    qpts, wids = _traffic(data, weights, 28)
    ref = base_svc.query(qpts, wids)  # sampling off

    svc = _sampling_service(port_service, p)
    res = svc.query(qpts, wids)
    for f in ("ids", "dists", "stop_levels", "n_checked"):
        assert np.array_equal(getattr(res, f), getattr(ref, f)), f

    est = svc.batcher.recall
    assert est.backlog > 0  # serving only enqueued; nothing executed
    est.drain()
    sampled = sorted(est.executed_ids())
    # the sync tracer assigns ids 0..n-1 in submission order
    assert sampled == [i for i in range(len(qpts))
                       if should_sample(i, RATE)]
    assert est.estimate() == _offline_recall(data, plan, qpts, wids,
                                             sampled, ref.ids)
    s = est.summary()
    assert s["n_sampled"] == s["n_executed"] == len(sampled)
    assert s["n_dropped"] == 0 and s["backlog"] == 0

    jax = _sampling_service(jax_service, p)
    jres = jax.query(qpts, wids)
    np.testing.assert_array_equal(jres.ids, res.ids)
    jest = jax.batcher.recall
    jest.drain()
    assert sorted(jest.executed_ids()) == sampled
    assert jest.estimate() == est.estimate()
    assert jest.summary() == s


def test_sync_async_driver_sample_identical_sets():
    _, data, weights, host, plan, _ = build_port_parity(2.0)
    qpts, wids = _traffic(data, weights, 24)
    arrivals = np.cumsum(
        np.random.default_rng(7).exponential(1 / 2_000.0, len(qpts)))

    sync_svc = _sampling_service(port_service, 2.0)
    sync_res = sync_svc.query(qpts, wids)
    sync_svc.batcher.recall.drain()
    sync_ids = sorted(sync_svc.batcher.recall.executed_ids())
    sync_est = sync_svc.batcher.recall.estimate()

    async_svc = _sampling_service(port_service, 2.0)
    asvc = AsyncRetrievalService(async_svc, clock=ManualClock())
    replay_open_loop(asvc, qpts, wids, arrivals)
    async_svc.batcher.recall.drain()
    assert sorted(async_svc.batcher.recall.executed_ids()) == sync_ids
    assert async_svc.batcher.recall.estimate() == sync_est

    drv_svc = _sampling_service(port_service, 2.0)
    dsvc = AsyncRetrievalService(drv_svc, clock=ManualClock())
    driver = ServiceDriver(dsvc)
    res, _ = replay_with_driver(driver, qpts, wids, arrivals)
    est = drv_svc.batcher.recall
    n_idle_drained = len(est.executed_ids())
    est.drain()
    assert sorted(est.executed_ids()) == sync_ids
    assert est.estimate() == sync_est
    assert n_idle_drained > 0  # idle ticks ran shadow work in the replay
    assert np.array_equal(res.ids, sync_res.ids)
    assert np.array_equal(res.n_checked, sync_res.n_checked)

    # the JAX package's driven replay runs the same shadow work
    jax = _sampling_service(jax_service, 2.0)
    jmod = __import__("repro.serving", fromlist=["ServiceDriver"])
    jdrv = jmod.ServiceDriver(jmod.AsyncRetrievalService(
        jax, clock=jmod.ManualClock()))
    jres, _ = jmod.replay_with_driver(jdrv, qpts, wids, arrivals)
    jest = jax.batcher.recall
    assert len(jest.executed_ids()) == n_idle_drained
    jest.drain()
    assert sorted(jest.executed_ids()) == sync_ids
    assert jest.estimate() == sync_est
    assert np.array_equal(jres.ids, res.ids)


def test_sampled_spans_carry_their_shadow_recall():
    _, data, weights, host, plan, _ = build_port_parity(2.0)
    qpts, wids = _traffic(data, weights, 16)
    out = []
    for make in (port_service, jax_service):
        svc = _sampling_service(make, 2.0)
        svc.query(qpts, wids)
        est = svc.batcher.recall
        est.drain()
        sampled = set(est.executed_ids())
        for span in svc.batcher.tracer.spans():
            if span.query_id in sampled:
                assert 0.0 <= span.recall <= 1.0
            else:
                assert span.recall == -1.0  # not sampled
        out.append([s.recall for s in svc.batcher.tracer.spans()])
    assert out[0] == out[1]


def test_full_shadow_queue_drops_and_counts():
    _, data, weights, host, plan, _ = build_port_parity(2.0)
    qpts, wids = _traffic(data, weights, 24)
    out = []
    for make in (port_service, jax_service):
        svc = _sampling_service(make, 2.0, recall_sample_rate=1.0,
                                recall_shadow_max=4)
        svc.query(qpts, wids)
        est = svc.batcher.recall
        assert est.backlog == 4  # capped, never above shadow_max
        est.drain()
        s = est.summary()
        assert s["n_sampled"] == len(qpts)  # every query hashed in
        assert s["n_executed"] == 4
        assert s["n_dropped"] == len(qpts) - 4
        assert s["n_sampled"] == s["n_executed"] + s["n_dropped"]
        out.append(s)
    assert out[0] == out[1]


def test_recall_sample_rate_implies_obs_and_validates():
    from repro_torch.serving import ServiceConfig

    cfg = ServiceConfig(recall_sample_rate=0.25)
    assert cfg.obs  # sampling keys on tracer query ids
    with pytest.raises(ValueError, match="recall_sample_rate"):
        ServiceConfig(recall_sample_rate=1.5)
    with pytest.raises(ValueError, match="recall_sample_rate"):
        ServiceConfig(recall_sample_rate=float("nan"))
    with pytest.raises(ValueError, match="recall_shadow_max"):
        ServiceConfig(recall_shadow_max=0)
    with pytest.raises(ValueError, match="recall_shadow_slice"):
        ServiceConfig(recall_shadow_slice=0)
    with pytest.raises(ValueError, match="recall_floor"):
        ServiceConfig(recall_floor=-0.1)
    with pytest.raises(ValueError, match="obs_trace_capacity"):
        ServiceConfig(obs_trace_capacity=0)
    assert not ServiceConfig().obs


# ------------------------------------------------------------- health monitor


def _burn_monitor(pkg, threshold=0.25, fast=4, slow=10, min_events=1):
    registry, rule, monitor = pkg
    reg = registry()
    bad = reg.counter("wlsh_bad_total")
    due = reg.counter("wlsh_due_total")
    mon = monitor(reg, [rule(
        name="burn", kind="burn_ratio", threshold=threshold,
        numerator="wlsh_bad_total", denominator="wlsh_due_total",
        fast_window=fast, slow_window=slow, min_events=min_events)])
    return reg, bad, due, mon


def test_burn_rule_needs_both_windows_hot():
    streams = []
    for pkg in (PORT_OBS, JAX_OBS):
        _, bad, due, mon = _burn_monitor(pkg)
        t = 0.0
        for _ in range(10):  # healthy: deadlines due, none missed
            due.inc()
            mon.observe(t := t + 1.0)
        assert mon.firing() == []
        # 2 hot ticks: fast ratio 2/4 > 0.25, slow ratio 2/12 < 0.25
        for _ in range(2):
            bad.inc()
            due.inc()
            mon.observe(t := t + 1.0)
        assert mon.firing() == []  # slow window still healthy
        fired = []
        for _ in range(6):
            bad.inc()
            due.inc()
            fired += mon.observe(t := t + 1.0)
        assert [a.rule for a in mon.firing()] == ["burn"]
        assert len(fired) == 1  # edge-triggered
        assert fired[0].value_fast > 0.25 and fired[0].value > 0.25
        for _ in range(5):  # recovery clears promptly
            due.inc()
            mon.observe(t := t + 1.0)
        assert mon.firing() == []
        reg = mon.metrics
        assert reg.counter("wlsh_alerts_fired_total").total() == 1
        assert reg.counter("wlsh_alerts_cleared_total").total() == 1
        streams.append((_alerts(mon), mon.summary()))
    assert streams[0] == streams[1]


def test_burn_rule_min_events_gate():
    streams = []
    for pkg in (PORT_OBS, JAX_OBS):
        _, bad, due, mon = _burn_monitor(pkg, min_events=4)
        t = 0.0
        bad.inc()
        due.inc()  # ratio 1.0 but only 1 event: unjudgeable
        mon.observe(t := t + 1.0)
        assert mon.firing() == []
        for _ in range(3):
            bad.inc()
            due.inc()
            mon.observe(t := t + 1.0)
        assert [a.rule for a in mon.firing()] == ["burn"]
        streams.append(_alerts(mon))
    assert streams[0] == streams[1]


def test_gauge_rules_streak_and_edges():
    streams = []
    for registry, rule, monitor in (PORT_OBS, JAX_OBS):
        reg = registry()
        g = reg.gauge("wlsh_margin")
        mon = monitor(reg, [rule(
            name="below", kind="gauge_below", threshold=0.0,
            gauge="wlsh_margin", for_ticks=2)])
        t = 0.0
        g.set(0.5, rung="0")
        mon.observe(t := t + 1.0)
        assert mon.firing() == []
        g.set(-0.1, rung="1")  # the worst series decides
        mon.observe(t := t + 1.0)
        assert mon.firing() == []  # streak 1 < for_ticks 2
        mon.observe(t := t + 1.0)
        assert [a.rule for a in mon.firing()] == ["below"]
        g.set(0.2, rung="1")  # one good tick resets the streak
        mon.observe(t := t + 1.0)
        assert mon.firing() == []
        streams.append((_alerts(mon), mon.summary()))
    assert streams[0] == streams[1]


def test_gauge_above_rule_and_export(tmp_path):
    files = []
    for name, (registry, rule, monitor) in (("port", PORT_OBS),
                                            ("jax", JAX_OBS)):
        reg = registry()
        depth = reg.gauge("wlsh_depth")
        mon = monitor(reg, [rule(
            name="sat", kind="gauge_above", threshold=10.0,
            gauge="wlsh_depth", for_ticks=1, severity="warn")])
        depth.set(11.0)
        fired = mon.observe(3.5)
        assert [a.rule for a in fired] == ["sat"]
        assert fired[0].severity == "warn" and fired[0].t_fired == 3.5
        path = tmp_path / f"{name}.jsonl"
        assert mon.export_jsonl(path) == 1
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert lines[0]["rule"] == "sat" and lines[0]["value"] == 11.0
        s = mon.summary()
        assert s["rules"]["sat"]["fired"] == 1
        assert s["rules"]["sat"]["firing"] is True
        files.append(path.read_text())
    assert files[0] == files[1]


def test_rule_validation_and_unique_names():
    for registry, rule, monitor in (PORT_OBS, JAX_OBS):
        with pytest.raises(ValueError, match="kind"):
            rule(name="x", kind="weird", threshold=0.1)
        with pytest.raises(ValueError, match="numerator"):
            rule(name="x", kind="burn_ratio", threshold=0.1)
        with pytest.raises(ValueError, match="fast_window"):
            rule(name="x", kind="burn_ratio", threshold=0.1,
                 numerator="n", fast_window=9, slow_window=3)
        with pytest.raises(ValueError, match="gauge"):
            rule(name="x", kind="gauge_below", threshold=0.1)
        dup = rule(name="dup", kind="gauge_below", threshold=0.0,
                   gauge="g")
        with pytest.raises(ValueError, match="unique"):
            monitor(registry(), [dup, dup])


def test_default_rules_shape():
    rules = default_rules()
    names = {r.name for r in rules}
    assert {"deadline_miss_burn", "tenant_slo_burn",
            "prefetch_waste_burn", "recall_below_bound"} <= names
    assert "queue_saturation" not in names  # needs a saturation point
    with_cap = default_rules(max_pending=100)
    sat = next(r for r in with_cap if r.name == "queue_saturation")
    assert sat.threshold == pytest.approx(90.0)
    HealthMonitor(MetricsRegistry(), with_cap)
    for mine, theirs in ((rules, jax_obs.default_rules()),
                         (with_cap, jax_obs.default_rules(max_pending=100))):
        assert ([dataclasses.asdict(r) for r in mine]
                == [dataclasses.asdict(r) for r in theirs])


def test_driver_surfaces_firing_alerts_in_tick_summary():
    _, data, weights, host, plan, _ = build_port_parity(2.0)
    qpts, wids = _traffic(data, weights, 12)
    arrivals = np.cumsum(
        np.random.default_rng(3).exponential(1 / 2_000.0, len(qpts)))
    out = []
    for make, (_, rule, monitor) in ((port_service, PORT_OBS),
                                     (jax_service, JAX_OBS)):
        svc = _sampling_service(make, 2.0)
        mod = __import__(type(svc).__module__.split(".")[0] + ".serving",
                         fromlist=["ServiceDriver"])
        asvc = mod.AsyncRetrievalService(svc, clock=mod.ManualClock())
        # a rule that fires at once: queue depth above -1 always holds,
        # and the stock rules beside it
        mon = monitor(svc.batcher.metrics, [rule(
            name="always", kind="gauge_above", threshold=-1.0,
            gauge="wlsh_pending_queue_depth", for_ticks=1)])
        driver = mod.ServiceDriver(asvc, health=mon)
        mod.replay_with_driver(driver, qpts, wids, arrivals)
        assert [a.rule for a in mon.firing()] == ["always"]
        summary = driver.tick_summary()
        assert "ALERTS: always" in summary
        out.append((_alerts(mon), mon.summary(), summary))
    assert out[0] == out[1]
