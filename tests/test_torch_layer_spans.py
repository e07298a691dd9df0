"""The port's layer spans (``repro_torch.obs.trace.span``), on the CPU.

Every layer boundary of the serving path opens a span named in
``LAYER_SPANS``.  Under ``torch.profiler`` each is a ``record_function``
range: the sync, paged, two-shard, async and driven services emit every
span their path reaches, each inside the span the path nests it in.
With no profiler and ``ServiceConfig.obs`` off no range is entered and
the answers are those of a traced run, bit for bit; with ``obs`` on the
registry counts each span once (``wlsh_layer_calls_total{layer}``) and
times it on the host, on the trace's clock.

The plan is the port's own (n = 1,024, d = 16, |S| = 8), so nothing here
imports the JAX package.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import profile

from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.obs import LAYER_SPANS, MetricsRegistry, span
from repro_torch.serving import (AsyncRetrievalService, RetrievalService,
                                 ServiceConfig, ServiceDriver)
from repro_torch.serving.async_service import ManualClock, replay_open_loop
from repro_torch.serving.scheduler import replay_with_driver

torch.set_num_threads(1)

N, D, K, Q_BATCH = 1024, 16, 5, 4

# the layer span each span opens in (None: outside any layer span)
PARENTS = {
    "wlsh_tick": {None},
    "wlsh_query": {None},
    # the async frontend's ``submit`` routes, and launches a full buffer,
    # outside any tick
    "wlsh_route": {"wlsh_query", None},
    "wlsh_batch": {"wlsh_query", "wlsh_tick", None},
    "wlsh_lease": {"wlsh_batch"},
    "wlsh_encode": {"wlsh_batch"},
    "wlsh_upload": {"wlsh_batch"},
    "wlsh_step": {"wlsh_batch"},
    "wlsh_download": {"wlsh_batch"},
    "wlsh_release": {"wlsh_batch"},
    "wlsh_merge": {"wlsh_batch"},
    "wlsh_offload": {"wlsh_lease", "wlsh_release", "wlsh_tick"},
    # a driver's prefetch restores inside its tick
    "wlsh_restore": {"wlsh_lease", "wlsh_tick"},
    "wlsh_build": {"wlsh_lease", "wlsh_tick"},
    "wlsh_pass1": {"wlsh_step"},
    "wlsh_stop": {"wlsh_step"},
    "wlsh_pass2": {"wlsh_step"},
    "wlsh_topk": {"wlsh_pass2"},
    "wlsh_rerank": {"wlsh_pass2"},
}

ON_EVERY_PATH = {"wlsh_batch", "wlsh_lease", "wlsh_encode", "wlsh_upload",
                 "wlsh_step", "wlsh_pass1", "wlsh_stop", "wlsh_pass2",
                 "wlsh_topk", "wlsh_rerank", "wlsh_download", "wlsh_release",
                 "wlsh_merge"}
SYNC = ON_EVERY_PATH | {"wlsh_query", "wlsh_route"}
PAGED = SYNC | {"wlsh_restore", "wlsh_offload"}
ASYNC = ON_EVERY_PATH | {"wlsh_tick", "wlsh_route"}


@functools.lru_cache(maxsize=None)
def _plan():
    data = make_dataset(n=N, d=D, seed=0)
    weights = make_weight_set(size=8, d=D, n_subset=4, n_subrange=20,
                              seed=1)
    host = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=N), tau=500.0,
                     v=4, v_prime=4, seed=2)
    return data, weights, host.export_serving_plan()


def _queries(n=12, seed=5):
    data, weights, _ = _plan()
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n)
    qpts = data[rng.choice(len(data), n, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    return qpts, wids


def _service(devices=None, **kw):
    data, _, plan = _plan()
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=K, q_batch=Q_BATCH, device="cpu", **kw), devices=devices)
    svc.warmup()
    return svc


def _answers(res):
    return (res.ids, res.dists, res.stop_levels, res.n_checked)


def _path(path, obs=False):
    """(serve, batcher): ``serve()`` answers the fixed queries through
    ``path``'s service, built and warmed up here."""
    qpts, wids = _queries()
    arrivals = np.arange(len(qpts)) * 0.004
    paged = dict(max_resident_groups=1)
    if path in ("sync", "paged", "sharded"):
        svc = _service(devices=("cpu", "cpu") if path == "sharded" else None,
                       obs=obs, **(paged if path == "paged" else {}))
        return (lambda: svc.query(qpts, wids)), svc.batcher
    svc = _service(obs=obs, **(paged if path == "driven" else {}))
    asvc = AsyncRetrievalService(svc.batcher, max_delay_ms=2.0,
                                 clock=ManualClock())
    if path == "async":
        return (lambda: replay_open_loop(
            asvc, qpts, wids, asvc.clock() + arrivals)[0], svc.batcher)
    driver = ServiceDriver(asvc)  # its ticks, over a paged service
    return (lambda: replay_with_driver(
        driver, qpts, wids, asvc.clock() + arrivals)[0], svc.batcher)


def _layer_events(prof):
    """(start, end, name, thread) of every layer span the capture holds."""
    return sorted((e.time_range.start, e.time_range.end, e.name, e.thread)
                  for e in prof.events() if e.name in LAYER_SPANS)


def _parent(events, i):
    """The innermost layer span that holds ``events[i]``, or None."""
    a, b, _, th = events[i]
    best = None
    for j, (a2, b2, name, th2) in enumerate(events):
        if j != i and th2 == th and a2 <= a and b <= b2 and (
                best is None or a2 >= best[0]):
            best = (a2, name)
    return None if best is None else best[1]


@pytest.mark.parametrize("path,want", [
    ("sync", SYNC), ("paged", PAGED), ("sharded", SYNC), ("async", ASYNC),
    ("driven", ASYNC | {"wlsh_restore", "wlsh_offload"})])
def test_every_reached_span_is_emitted_inside_its_parent(path, want):
    serve, _ = _path(path)
    with profile() as prof:
        serve()
    events = _layer_events(prof)
    names = [name for _, _, name, _ in events]
    assert want <= set(names), sorted(want - set(names))
    for i, (_, _, name, _) in enumerate(events):
        assert _parent(events, i) in PARENTS[name], (name, _parent(events, i))
    per_step = names.count("wlsh_pass1") / names.count("wlsh_step")
    assert per_step == (2 if path == "sharded" else 1)
    assert names.count("wlsh_pass2") == names.count("wlsh_pass1")
    if path == "paged":  # host paging shows inside the lease or release
        assert any(_parent(events, i) == "wlsh_lease"
                   for i, n in enumerate(names) if n == "wlsh_restore")
        assert any(_parent(events, i) in ("wlsh_lease", "wlsh_release")
                   for i, n in enumerate(names) if n == "wlsh_offload")


def test_an_untraced_request_enters_no_range(monkeypatch):
    entered = []
    enter = autograd_profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    monkeypatch.setattr(autograd_profiler.record_function, "__enter__",
                        counted)
    for path in ("sync", "paged", "sharded"):
        serve, _ = _path(path)
        plain = serve()
        assert entered == [], path
        with profile():
            traced = serve()
        assert set(entered) >= SYNC, path  # the patch sees the spans
        entered.clear()
        for a, b in zip(_answers(plain), _answers(traced)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("path", ["paged", "async", "driven"])
def test_obs_counts_each_span_once(path):
    serve, batcher = _path(path, obs=True)
    calls = batcher.metrics.counter("wlsh_layer_calls_total")
    seconds = batcher.metrics.counter("wlsh_layer_seconds_total")
    # the warm-up's builds and offloads were counted before the capture
    before = {name: calls.value(layer=name) for name in LAYER_SPANS}
    with profile() as prof:
        serve()
    names = [name for _, _, name, _ in _layer_events(prof)]
    for name in LAYER_SPANS:
        assert calls.value(layer=name) - before[name] == names.count(name), \
            name
        if names.count(name):
            assert seconds.value(layer=name) > 0, name
    # without a capture the registry counts all the same
    step_calls = calls.value(layer="wlsh_step")
    serve()
    assert calls.value(layer="wlsh_step") > step_calls


def test_a_span_and_its_trace_event_share_the_clock(tmp_path):
    metrics = MetricsRegistry()
    with profile() as prof:
        t0 = time.time_ns()
        with span("wlsh_route", metrics):
            with span("wlsh_encode"):  # inherits the registry
                time.sleep(0.02)
        t1 = time.time_ns()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    (ev,) = [e for e in trace["traceEvents"] if e.get("name") == "wlsh_route"
             and e.get("cat") == "user_annotation"]
    start, end = ev["ts"] * 1e3 + base, (ev["ts"] + ev["dur"]) * 1e3 + base
    slack = 2e6  # ns
    assert t0 - slack <= start and end <= t1 + slack
    seconds = metrics.counter("wlsh_layer_seconds_total")
    assert seconds.value(layer="wlsh_route") == pytest.approx(
        ev["dur"] / 1e6, abs=slack / 1e9)
    assert seconds.value(layer="wlsh_encode") >= 0.02
    calls = metrics.counter("wlsh_layer_calls_total")
    assert calls.value(layer="wlsh_route") == 1
    assert calls.value(layer="wlsh_encode") == 1


def test_without_profiler_or_registry_a_span_is_the_shared_null_context():
    assert span("wlsh_step") is span("wlsh_query")
    metrics = MetricsRegistry()
    with span("wlsh_step", metrics):
        pass
    assert metrics.counter("wlsh_layer_calls_total").value(
        layer="wlsh_step") == 1
