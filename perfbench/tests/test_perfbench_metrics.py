"""The arithmetic of the metrics: rates and tails over every request, the
frozen cost copy against the program's, and the trace reduction."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from perfbench import cost, spec, stats
from perfbench.devtrace import WINDOW, TraceView
from perfbench.harness import Record, Run


def _run(latencies, answered_each=64, window_s=2.0, **kw):
    records = [Record(index=i, t_issue=0.0, latency_s=s, restored=False,
                      ok=True) for i, s in enumerate(latencies)]
    fields = dict(cell=None, seed=0, setup_s=50.0, plan_s=40.0, build_s=9.0,
                  window_s=window_s, records=records,
                  queries_answered=answered_each * len(records),
                  memory_peak_bytes=10**10, counters={"n_restores": 3},
                  launches=[])
    fields.update(kw)
    return Run(**fields)


def test_rate_and_tail_run_over_every_request():
    lat = np.linspace(0.010, 0.109, 100)  # 10 ms .. 109 ms
    lat[-1] = 1.0  # one slow request stays in the tail's sample
    run = _run(lat)
    assert spec.reader("qps")(run) == pytest.approx(64 * 100 / 2.0)
    want = 1e3 * np.percentile(lat, 95)
    assert spec.reader("p95_ms")(run) == pytest.approx(want)
    assert spec.reader("restores_per_req")(run) == pytest.approx(0.03)
    assert spec.reader("peak_mem_gb")(run) == pytest.approx(10.0)
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.rate(10, 0.0)


def test_trace_metrics_stay_silent_without_a_trace():
    run = _run([0.01] * 4)
    for name in ("query_roofline_pct", "topk_rerank_ms", "device_idle_pct",
                 "copy_ms"):
        assert spec.reader(name)(run) is None


SHAPES = [  # (n, beta_pad, q, d, L, p): both configurations' groups
    (400_000, 512, 64, 400, 16, 2.0), (400_000, 256, 64, 400, 16, 2.0),
    (400_000, 1024, 64, 400, 20, 1.0)]


@pytest.mark.parametrize("n,beta,q,d,L,p", SHAPES)
def test_the_frozen_cost_copy_equals_the_programs(n, beta, q, d, L, p):
    from repro_torch.kernels import cost as prog
    from repro_torch.launch.roofline import HW as ProgHW

    hw, phw = cost.HW(), ProgHW()
    for f in ("hbm_bw", "f32_flops", "f32_ops", "int32_ops", "sfu_ops"):
        assert getattr(hw, f) == getattr(phw, f)
    tests = q * (beta - 7) * n
    pairs = [
        (cost.fused_query_hist(n, beta, q, d, L, p=p, tests=tests),
         prog.fused_query_hist(n, beta, q, d, L, p=p, tests=tests)),
        (cost.fused_query_scores(n, beta, q, d, p=p),
         prog.fused_query_scores(n, beta, q, d, p=p))]
    for mine, theirs in pairs:
        assert mine.bound(hw) == theirs.bound(phw)
        for f in ("f32_flops", "f32_ops", "int32_ops", "sfu_ops",
                  "bytes_read", "bytes_written"):
            assert getattr(mine, f) == getattr(theirs, f)


@pytest.mark.parametrize("n,beta,q,d,L,p", SHAPES)
def test_eight_byte_ids_add_their_bytes_read(n, beta, q, d, L, p):
    """A configuration that stores 64-bit ids reads 4 more bytes for each
    of the state's and the queries' ids; nothing else moves."""
    tests = q * (beta - 7) * n
    for fn, args in ((cost.fused_query_hist, (n, beta, q, d, L)),
                     (cost.fused_query_scores, (n, beta, q, d))):
        four = fn(*args, p=p, tests=tests)
        eight = fn(*args, p=p, tests=tests, code_bytes=8)
        assert four == fn(*args, p=p, tests=tests, code_bytes=4)
        assert eight.bytes_read - four.bytes_read == 4 * (n * beta + q * beta)
        assert eight == dataclasses.replace(four,
                                            bytes_read=eight.bytes_read)


def test_a_steps_least_time_is_the_sum_of_its_parts():
    launch = dict(n=400_000, beta=512, d=400, q=64, k=10, n_levels=16,
                  vec_bytes=4, code_bytes=4, p=2.0,
                  tests=64 * 480 * 400_000)
    hw = cost.HW()
    parts = (cost.fused_query_hist(400_000, 512, 64, 400, 16,
                                   tests=launch["tests"]),
             cost.fused_query_scores(400_000, 512, 64, 400,
                                     tests=launch["tests"]),
             cost.topk(400_000, 64, 10), cost.rerank(64, 10, 400))
    assert cost.step_least_s(launch) == pytest.approx(
        sum(c.bound(hw)[0] for c in parts))
    # the passes' level tests bound them: about 0.7 ms each
    assert 1.2e-3 < cost.step_least_s(launch) < 1.6e-3


def _ev(name, cat, ts, dur, tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)


def test_the_trace_reduction():
    events = [
        _ev(WINDOW, "user_annotation", 0, 1000),
        _ev("perfbench.query_step", "user_annotation", 100, 800),
        _ev("aten::topk", "cpu_op", 500, 50),
        _ev("fused_query_kernel<0, 3, false, float>", "kernel", 100, 300,
            tid=7),
        _ev("fused_query_kernel<1, 3, false, float>", "kernel", 350, 150,
            tid=7),  # overlaps the first: counted once in busy time
        _ev("topk_kernel", "kernel", 600, 100, tid=7),
        _ev("wlsh_topk", "gpu_user_annotation", 590, 120, tid=7),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 800, 50,
            tid=8),
        _ev("late_kernel", "kernel", 2000, 10, tid=7),  # after the window
    ]
    view = TraceView(events)
    assert view.window_s == pytest.approx(1e-3)
    assert view.busy_s() == pytest.approx((400 + 100 + 50) / 1e6)
    assert view.seconds(cats=("kernel",), ranges=("wlsh_topk",)) == \
        pytest.approx(100e-6)
    assert view.seconds(cats=("gpu_memcpy",), names=("HtoD",)) == \
        pytest.approx(50e-6)
    gaps = dict(view.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((1000 - 550) / 1e6)
    assert gaps["harness > python"] == pytest.approx((100 + 150) / 1e6)
    assert gaps["perfbench.query_step > aten::topk"] == pytest.approx(
        100e-6)
    top = view.top_ops(2)
    assert top[0][0].startswith("fused_query_kernel<0")
    run = _run([0.001], trace=view)
    assert spec.reader("device_idle_pct")(run) == pytest.approx(45.0)
    assert spec.reader("topk_rerank_ms")(run) == pytest.approx(0.1)
    assert spec.reader("copy_ms")(run) == pytest.approx(0.05)
