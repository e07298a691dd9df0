"""The port's observability layer: metrics registry, trace spans, profiling.

The reference's ``tests/test_obs.py``, run against ``repro_torch.obs``
on the CPU, each next to the JAX package on the same operations:

* the registry tests drive ``repro_torch.obs.MetricsRegistry`` and the
  JAX package's registry through the same calls and hold both to the
  reference's assertions and to each other (snapshots, Prometheus text,
  diffs);
* the span and tracer tests hold both packages' ``TraceSpan`` /
  ``Tracer`` to the same ring, ledger and JSONL results, and read each
  package's export with the other's loader;
* the serving tests replay the same plan and traffic through both
  packages' services with tracing on, on the same deterministic clock:
  every span (stages and their timestamps, ``stop_level``,
  ``n_checked``, ``budget``, ``budget_capped``, ``cause``, ``rung``,
  tenant) is equal, per p in {2, 1, 0.5};
* turning the obs layer on changes no answer of the port: ids, dists,
  stop levels and n_checked are bit-exact vs the obs-off service on the
  sync, async and paged paths.
"""

from __future__ import annotations

import itertools
import json
import threading

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch_serving import build_port_parity, jax_service, port_service
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import TraceSpan as JaxSpan
from repro.obs import Tracer as JaxTracer
from repro_torch.obs import STAGES, MetricsRegistry, TraceSpan, Tracer
from repro_torch.serving import ServiceDriver

K = 5
Q_BATCH = 4
REGISTRIES = (MetricsRegistry, JaxRegistry)


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5],
                ids=lambda p: f"p{p}")
def parity_setup(request):
    """(p, data, weights, host, plan, svc) of the port per exponent."""
    return build_port_parity(request.param)


def _mixed_queries(data, weights, n_queries, seed=43):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n_queries)
    qpts = data[rng.choice(len(data), n_queries, replace=False)].astype(
        np.float32
    )
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return qpts, wids


class _Tick:
    """A clock that advances one unit at every read: both packages stamp
    the same values only if they read it in the same order."""

    def __init__(self):
        self._n = itertools.count()

    def __call__(self) -> float:
        return float(next(self._n))


def _obs_pair(p, **cfg_kw):
    """The port's and the JAX package's obs-on services on the fixture
    plan, each on its own ``_Tick`` clock."""
    pair = []
    for make in (port_service, jax_service):
        svc = make(p, k=K, q_batch=Q_BATCH, obs=True, **cfg_kw)
        svc.warmup()
        svc.batcher.clock = _Tick()
        pair.append(svc)
    return pair


def _span_dicts(tracer) -> list[dict]:
    return [s.to_dict() for s in tracer.spans()]


def _same_answers(a, b, exact_dists=True):
    for f in ("ids", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    if exact_dists:
        np.testing.assert_array_equal(a.dists, b.dists)
    else:
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-6)


# ------------------------------------------------------------ metrics registry


def test_counter_labels_totals_and_series():
    snaps = []
    for cls in REGISTRIES:
        reg = cls()
        c = reg.counter("wlsh_test_total", "help text")
        c.inc(group=0)
        c.inc(3, group=1)
        c.inc(group=1)
        assert c.value(group=0) == 1
        assert c.value(group=1) == 4
        assert c.value(group=9) == 0  # unseen series reads 0
        assert c.total() == 5
        assert reg.counter("wlsh_test_total") is c  # get-or-create
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


def test_counter_rejects_negative_and_kind_conflicts():
    for cls in REGISTRIES:
        reg = cls()
        reg.counter("wlsh_x_total")
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.counter("wlsh_x_total").inc(-1)
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("wlsh_x_total")


def test_gauge_set_add_and_survives_reset():
    snaps = []
    for cls in REGISTRIES:
        reg = cls()
        g = reg.gauge("wlsh_resident_bytes")
        g.set(100.0)
        g.add(-25.0)  # gauges may decrease
        assert g.value() == 75.0
        reg.counter("wlsh_y_total").inc(7)
        reg.reset("wlsh_")
        assert reg.counter("wlsh_y_total").total() == 0
        assert g.value() == 75.0  # gauges describe state, not activity
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


def test_histogram_percentiles_match_numpy_oracle():
    buckets = tuple(np.linspace(0.05, 1.0, 20))  # width 0.05
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.0, 1.0, 2_000)
    got = []
    for cls in REGISTRIES:
        h = cls().histogram("wlsh_t_seconds", buckets=buckets)
        for x in xs:
            h.observe(float(x))
        assert h.count() == len(xs)
        assert h.sum() == pytest.approx(float(xs.sum()), rel=1e-9)
        row = []
        for q in (0.0, 10.0, 50.0, 95.0, 99.0, 100.0):
            est = h.percentile(q)
            want = float(np.percentile(xs, q))
            assert abs(est - want) <= 0.05 + 1e-9, (q, est, want)
            row.append(est)
        got.append(row)
    assert got[0] == got[1]


@settings(max_examples=50)
@given(
    xs=st.lists(st.floats(min_value=1e-6, max_value=9.0,
                          allow_nan=False), min_size=1, max_size=200),
    qs=st.lists(st.floats(min_value=0.0, max_value=100.0),
                min_size=2, max_size=6),
)
def test_histogram_percentile_bounded_and_monotone(xs, qs):
    got = []
    for cls in REGISTRIES:
        h = cls().histogram(
            "wlsh_p_seconds", buckets=tuple(np.linspace(0.5, 10.0, 20)),
        )
        for x in xs:
            h.observe(x)
        ests = [h.percentile(q) for q in sorted(qs)]
        for est in ests:  # clamped to the observed range
            assert min(xs) - 1e-12 <= est <= max(xs) + 1e-12
        for lo, hi in zip(ests, ests[1:]):  # monotone in q
            assert lo <= hi + 1e-12
        got.append(ests)
    assert got[0] == got[1]


def test_histogram_empty_and_bad_args():
    for cls in REGISTRIES:
        reg = cls()
        h = reg.histogram("wlsh_e_seconds")
        assert np.isnan(h.percentile(50.0))
        with pytest.raises(ValueError, match=r"\[0, 100\]"):
            h.percentile(101.0)
        with pytest.raises(ValueError, match="ascending"):
            reg.histogram("wlsh_bad_seconds", buckets=(2.0, 1.0))


def _parse_exposition(text):
    """``{name: {labelstr_or_'': value}}`` from Prometheus text lines."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        lhs, val = line.rsplit(" ", 1)
        if "{" in lhs:
            name, rest = lhs.split("{", 1)
            key = rest.rstrip("}")
        else:
            name, key = lhs, ""
        out.setdefault(name, {})[key] = float(val)
    return out


def test_text_exposition_parses_back_to_recorded_values():
    texts = []
    for cls in REGISTRIES:
        reg = cls()
        reg.counter("wlsh_q_total", "queries").inc(3, group=0)
        reg.counter("wlsh_q_total").inc(5, group=1)
        reg.gauge("wlsh_res_bytes", "resident").set(42.0)
        h = reg.histogram("wlsh_w_seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v)
        text = reg.to_text()
        assert "# HELP wlsh_q_total queries" in text
        assert "# TYPE wlsh_w_seconds histogram" in text
        parsed = _parse_exposition(text)
        assert parsed["wlsh_q_total"]['group="0"'] == 3
        assert parsed["wlsh_q_total"]['group="1"'] == 5
        assert parsed["wlsh_res_bytes"][""] == 42.0
        bkt = parsed["wlsh_w_seconds_bucket"]
        cum = [bkt['le="0.1"'], bkt['le="1"'], bkt['le="10"'],
               bkt['le="+Inf"']]
        assert cum == [1, 3, 4, 4]  # cumulative, +Inf equals _count
        assert parsed["wlsh_w_seconds_count"][""] == 4
        assert parsed["wlsh_w_seconds_sum"][""] == pytest.approx(6.05)
        texts.append(text)
    assert texts[0] == texts[1]


def _unescape_label(value: str) -> str:
    """Invert Prometheus label-value escaping (\\\\, \\", \\n)."""
    out, i = [], 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            out.append({"\\": "\\", '"': '"', "n": "\n"}[value[i + 1]])
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def test_text_exposition_escapes_hostile_label_values():
    hostile = 'ev"il\\x\nnewline'
    texts = []
    for cls in REGISTRIES:
        reg = cls()
        reg.counter("wlsh_h_total", "hostile").inc(7, tenant=hostile)
        reg.gauge("wlsh_h_gauge").set(1.0, tenant=hostile)
        reg.histogram("wlsh_h_seconds", buckets=(1.0,)).observe(
            0.5, tenant=hostile)
        text = reg.to_text()
        for line in text.splitlines():  # every line still parses
            if line.startswith("#") or not line:
                continue
            float(line.rsplit(" ", 1)[1])
        assert '\ntenant=' not in text.replace("wlsh_h", "")
        assert 'tenant="ev\\"il\\\\x\\nnewline"' in text
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("wlsh_h_total{"))
        quoted = line.split('tenant="', 1)[1].rsplit('"}', 1)[0]
        assert _unescape_label(quoted) == hostile
        assert reg.counter("wlsh_h_total").value(tenant=hostile) == 7
        texts.append(text)
    assert texts[0] == texts[1]


def test_json_snapshot_round_trip_and_diff():
    out = []
    for cls in REGISTRIES:
        reg = cls()
        reg.counter("wlsh_a_total").inc(2, group=0)
        reg.gauge("wlsh_b").set(9.0)
        reg.histogram("wlsh_c_seconds").observe(0.2)
        assert json.loads(reg.to_json()) == reg.snapshot()
        before = reg.snapshot()
        reg.counter("wlsh_a_total").inc(3, group=0)
        reg.counter("wlsh_a_total").inc(group=1)
        reg.gauge("wlsh_b").set(1.0)  # non-counters never appear in a diff
        d = reg.diff(before)
        assert d == {"wlsh_a_total": {"group=0": 3, "group=1": 1}}
        assert reg.diff(reg.snapshot()) == {}
        assert reg.diff(None) == {"wlsh_a_total": {"group=0": 5,
                                                   "group=1": 1}}
        out.append(reg.to_json())
    assert out[0] == out[1]


def test_merge_from_sums_counters():
    for cls in REGISTRIES:
        a, b = cls(), cls()
        a.counter("wlsh_m_total").inc(2, tenant="x")
        b.counter("wlsh_m_total").inc(5, tenant="x")
        b.counter("wlsh_n_total").inc(1)
        a.merge_from(b)
        assert a.counter("wlsh_m_total").value(tenant="x") == 7
        assert a.counter("wlsh_n_total").total() == 1


@pytest.mark.parametrize("cls", REGISTRIES, ids=["port", "jax"])
def test_registry_thread_safety_racing_increments(cls):
    reg = cls()
    c = reg.counter("wlsh_race_total")
    h = reg.histogram("wlsh_race_seconds")
    n_threads, n_incs = 8, 2_000
    stop = threading.Event()

    def writer(tid):
        for i in range(n_incs):
            c.inc(thread=tid % 2)
            h.observe(1e-3 * (i % 7 + 1))

    def reader():
        while not stop.is_set():  # snapshots must never see torn state
            snap = reg.snapshot()
            total = sum(snap["wlsh_race_total"]["series"].values())
            assert 0 <= total <= n_threads * n_incs
            reg.to_text()

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    rt = threading.Thread(target=reader)
    rt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    rt.join()
    assert c.total() == n_threads * n_incs
    assert c.value(thread=0) == c.value(thread=1) == c.total() // 2
    assert h.count() == n_threads * n_incs


# ------------------------------------------------------------------ trace spans


def test_span_rejects_unknown_stage_and_tracks_monotone():
    out = []
    for cls in (TraceSpan, JaxSpan):
        span = cls(0)
        with pytest.raises(ValueError, match="unknown trace stage"):
            span.mark("teleport", 1.0)
        span.mark("submit", 1.0)
        span.mark("launch", 2.0)
        assert span.monotone
        span.mark("resolve", 1.5)  # before launch: out of order
        assert not span.monotone
        span.mark("resolve", 2.0)  # re-marking overwrites
        assert span.monotone
        assert span.duration_s == 1.0
        out.append(span.to_dict())
    assert out[0] == out[1]


@settings(max_examples=50)
@given(
    steps=st.lists(
        st.floats(min_value=-1.0, max_value=1.0, allow_nan=False),
        min_size=2, max_size=len(STAGES),
    )
)
def test_span_monotone_iff_stage_times_sorted(steps):
    times = list(np.cumsum(steps))
    for cls in (TraceSpan, JaxSpan):
        span = cls(0)
        for stage, t in zip(STAGES, times):
            span.mark(stage, t)
        assert span.monotone == (times == sorted(times))


def test_tracer_ring_retention_and_exact_totals():
    for cls in (Tracer, JaxTracer):
        tr = cls(capacity=4)
        for _ in range(10):
            tr.finish(tr.begin())
        assert [s.query_id for s in tr.spans()] == [6, 7, 8, 9]
        assert tr.n_started == tr.n_finished == 10
        with pytest.raises(ValueError, match=">= 1"):
            cls(capacity=0)


def test_tracer_overflow_ledger_invariant():
    snaps = []
    for cls, reg_cls in ((Tracer, MetricsRegistry),
                         (JaxTracer, JaxRegistry)):
        reg = reg_cls()
        tr = cls(capacity=4, metrics=reg)
        open_span = tr.begin()  # stays in flight throughout
        for _ in range(9):
            tr.finish(tr.begin())
        assert (tr.n_started, tr.n_finished, tr.n_dropped,
                tr.n_inflight) == (10, 9, 5, 1)
        assert len(tr.spans()) == 4
        assert tr.n_started == len(tr.spans()) + tr.n_dropped + tr.n_inflight
        assert tr.n_finished == len(tr.spans()) + tr.n_dropped
        assert reg.counter("wlsh_trace_dropped_total").total() == 5
        tr.finish(open_span)
        assert tr.n_inflight == 0
        assert tr.n_dropped == 6
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


def test_jsonl_export_meta_records_drop_accounting(tmp_path):
    files = []
    for name, cls in (("port", Tracer), ("jax", JaxTracer)):
        tr = cls(capacity=2)
        tr.begin()  # in flight at export time
        for _ in range(5):
            tr.finish(tr.begin())
        path = tmp_path / f"{name}.jsonl"
        assert tr.export_jsonl(path) == 2  # retained spans only
        assert cls.load_jsonl_meta(path) == {
            "n_started": 6, "n_finished": 5, "n_dropped": 3,
            "n_inflight": 1, "n_retained": 2, "capacity": 2,
        }
        back = cls.load_jsonl(path)
        assert [b.query_id for b in back] == [s.query_id
                                              for s in tr.spans()]
        files.append(path.read_text())
    assert files[0] == files[1]


def test_jsonl_export_round_trip(tmp_path):
    """Each package's export reads back, through either loader, as the
    spans it wrote."""
    for cls in (Tracer, JaxTracer):
        tr = cls()
        s = tr.begin(weight_id=3, group_id=1, tenant="gold")
        for i, stage in enumerate(STAGES):
            s.mark(stage, 10.0 + i)
        s.rung, s.n_shards, s.cause = 2, 4, "deadline"
        s.stop_level, s.n_checked = 7, 105
        s.budget, s.budget_capped = 105, True
        tr.finish(s)
        tr.finish(tr.begin())  # a second, mostly-default span
        path = tmp_path / "spans.jsonl"
        assert tr.export_jsonl(path) == 2
        for loader in (Tracer, JaxTracer):
            back = loader.load_jsonl(path)
            assert [b.to_dict() for b in back] == _span_dicts(tr)


# ----------------------------------------------------- spans through the stack


def test_sync_service_emits_one_exact_span_per_query(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    port, jax = _obs_pair(p)
    qpts, wids = _mixed_queries(data, weights, 14, seed=51)
    res = port.query(qpts, wids)
    _same_answers(res, jax.query(qpts, wids), exact_dists=False)
    tr = port.batcher.tracer
    spans = tr.spans()
    assert tr.n_started == tr.n_finished == len(qpts)
    assert [s.query_id for s in spans] == list(range(len(qpts)))
    for qi, s in enumerate(spans):
        assert s.monotone
        assert {"submit", "route", "queue", "launch", "merge",
                "resolve"} <= set(s.stages)
        assert s.weight_id == int(wids[qi])
        assert s.group_id == int(res.group_ids[qi])
        assert s.n_checked == int(res.n_checked[qi])  # the step's value
        assert s.stop_level == int(res.stop_levels[qi])
        assert s.budget >= s.n_checked > 0
    assert _span_dicts(tr) == _span_dicts(jax.batcher.tracer)
    # a fresh obs service attributes every step it builds and every launch
    fresh = port_service(p, k=K, q_batch=Q_BATCH, obs=True)
    fresh.batcher.step_cache = type(fresh.batcher.step_cache)()
    fresh.batcher.step_cache.on_compile = (
        lambda c: fresh.batcher.profiler.record_compile(
            str(c.shape_signature())))
    fresh.query(qpts, wids)
    prof = fresh.batcher.profiler.summary()
    assert prof["n_compiles"] == fresh.step_cache.n_compiled >= 1
    n_batches = fresh.batcher.metrics.counter(
        "wlsh_group_batches_total").total()
    assert sum(d["count"] for d in prof["dispatch"].values()) == n_batches


def _async_replay(svc, qpts, wids, seed, **kw):
    from _torch_serving import serving_module

    mod = serving_module(svc)
    asvc = mod.AsyncRetrievalService(svc, max_delay_ms=2.0,
                                     clock=mod.ManualClock(), **kw)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, len(qpts)))
    return mod.replay_open_loop(asvc, qpts, wids, arrivals)


def test_async_service_spans_carry_cause_and_wait_histogram(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    qpts, wids = _mixed_queries(data, weights, 16, seed=52)
    out = []
    for svc in _obs_pair(p):
        res, _ = _async_replay(svc, qpts, wids, 6)
        tr = svc.batcher.tracer
        assert tr.n_started == tr.n_finished == len(qpts)
        for s in tr.spans():
            assert s.monotone
            assert s.cause in ("full", "deadline", "drain")
            assert s.stages["resolve"] >= s.stages["submit"]
        wait_h = svc.batcher.metrics.histogram("wlsh_query_wait_seconds")
        assert wait_h.count() == len(qpts)
        out.append((res, _span_dicts(tr), wait_h.sum()))
    _same_answers(out[0][0], out[1][0], exact_dists=False)
    assert out[0][1] == out[1][1]
    assert out[0][2] == out[1][2]


def test_qos_admitted_spans_mark_admit_and_tenant(parity_setup):
    from repro.serving.qos import QosClass as JaxClass
    from repro.serving.qos import QosScheduler as JaxScheduler
    from repro_torch.serving.qos import QosClass, QosScheduler

    p, data, weights, host, plan, _ = parity_setup
    qpts, wids = _mixed_queries(data, weights, 6, seed=53)
    out = []
    for svc, cls, sched in zip(_obs_pair(p), (QosClass, JaxClass),
                               (QosScheduler, JaxScheduler)):
        from _torch_serving import serving_module

        mod = serving_module(svc)
        qos = sched(classes=[cls("gold", weight=1.0, slo_ms=50.0)])
        asvc = mod.AsyncRetrievalService(svc, max_delay_ms=1.0,
                                         clock=mod.ManualClock(), qos=qos)
        futs = [asvc.submit(qpts[i], wids[i], tenant="gold")
                for i in range(len(qpts))]
        asvc.drain()
        assert all(f.done() for f in futs)
        spans = svc.batcher.tracer.spans()
        assert len(spans) == len(qpts)
        for s in spans:
            assert s.tenant == "gold"
            assert "admit" in s.stages
            assert s.monotone
        out.append(_span_dicts(svc.batcher.tracer))
    assert out[0] == out[1]


def test_paged_spans_record_restores(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    qpts, wids = _mixed_queries(data, weights, 16, seed=54)
    out = []
    for svc in _obs_pair(p, max_resident_groups=1):
        svc.query(qpts, wids)
        spans = svc.batcher.tracer.spans()
        assert len(spans) == len(qpts)
        assert all(s.monotone for s in spans)
        # cap 1 over >= 3 groups: most launches fault their state back in
        restored = [s for s in spans if "restore" in s.stages]
        assert restored
        for s in restored:
            assert s.stages["restore"] <= s.stages["launch"]
        m = svc.batcher.metrics
        assert (m.counter("wlsh_state_restores_total").total()
                + m.counter("wlsh_state_builds_total").total()) > 0
        out.append(_span_dicts(svc.batcher.tracer))
    assert out[0] == out[1]


def test_thread_mode_driver_metrics_stay_exact(parity_setup):
    """The driver thread writes the registry while the main thread
    snapshots; totals come out exact, every query gets its span, and the
    answers equal the JAX package's sync answers."""
    from repro_torch.serving import AsyncRetrievalService

    p, data, weights, host, plan, _ = parity_setup
    svc = port_service(p, k=K, q_batch=Q_BATCH, obs=True,
                       max_resident_groups=1)
    svc.warmup()
    asvc = AsyncRetrievalService(svc.batcher, max_delay_ms=0.5)
    driver = ServiceDriver(asvc, tick_s=0.001)
    driver.start()
    qpts, wids = _mixed_queries(data, weights, 8, seed=55)
    futs = []
    for i in range(len(qpts)):
        futs.append(driver.submit(qpts[i], wids[i]))
        svc.batcher.metrics.snapshot()  # concurrent reads must be safe
        svc.batcher.metrics.to_text()
    driver.stop(drain=True)
    assert all(f.done() for f in futs)
    reg = svc.batcher.metrics
    assert reg.counter("wlsh_group_queries_total").total() == len(qpts)
    tr = svc.batcher.tracer
    assert tr.n_started == tr.n_finished == len(qpts)
    got = np.stack([f.result().ids for f in futs])
    np.testing.assert_array_equal(got, svc.query(qpts, wids).ids)
    want = jax_service(p, k=K, q_batch=Q_BATCH).query(qpts, wids)
    np.testing.assert_array_equal(got, want.ids)


# ------------------------------------------------------------- bit-exactness


def test_obs_on_is_bit_exact_sync_async_paged(parity_setup):
    p, data, weights, host, plan, svc_off = parity_setup
    qpts, wids = _mixed_queries(data, weights, 24, seed=57)
    ref = svc_off.query(qpts, wids)  # the obs-off answers

    def obs_service(**kw):
        svc = port_service(p, k=K, q_batch=Q_BATCH, obs=True, **kw)
        svc.warmup()
        return svc

    _same_answers(obs_service().query(qpts, wids), ref)
    _same_answers(obs_service(max_resident_groups=1).query(qpts, wids), ref)
    res, _ = _async_replay(obs_service(), qpts, wids, 8)
    _same_answers(res, ref)
    # and the JAX package's obs-on service agrees with all of them
    jax = jax_service(p, k=K, q_batch=Q_BATCH, obs=True)
    _same_answers(jax.query(qpts, wids), ref, exact_dists=False)
