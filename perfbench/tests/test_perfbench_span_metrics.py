"""The readers of the program's layer spans (``encode_ms``, ``upload_ms``,
``restore_wait_ms``) on synthetic Chrome events: each sums only its own
spans, on the window's thread, clipped to the window, per answered
request, and reads nothing without a trace or from a program without
spans."""

from __future__ import annotations

import pytest

from perfbench import spec
from perfbench.devtrace import WINDOW, TraceView
from perfbench.harness import Record, Run

NAMES = ("encode_ms", "upload_ms", "restore_wait_ms")


def _ev(name, ts, dur, cat="user_annotation", tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)


def _run(events, ok=(True, True, False)):
    records = [Record(index=i, t_issue=0.0, latency_s=0.01, restored=False,
                      ok=o) for i, o in enumerate(ok)]
    return Run(cell=None, seed=0, setup_s=1.0, plan_s=0.5, build_s=0.2,
               window_s=1e-3, records=records, queries_answered=0,
               memory_peak_bytes=0, counters={}, launches=[],
               trace=None if events is None else TraceView(events))


WINDOW_EVENTS = [
    _ev(WINDOW, 0, 1000),
    _ev("wlsh_batch", 50, 900),
    _ev("wlsh_encode", 100, 100),
    _ev("wlsh_encode", 600, 50),
    _ev("wlsh_encode", -50, 70),  # opens before the window: 20 inside
    _ev("wlsh_encode", 1100, 100),  # after the window
    _ev("wlsh_encode", 300, 100, tid=2),  # another thread
    _ev("wlsh_encode", 700, 80, cat="cpu_op"),  # not a range
    _ev("wlsh_encode", 700, 80, cat="gpu_user_annotation", tid=7),
    _ev("perfbench.encode", 90, 120),  # the harness's range
    _ev("wlsh_upload", 200, 60),
    _ev("wlsh_restore", 300, 100),
    _ev("wlsh_offload", 400, 50),
    _ev("wlsh_offload", 420, 10),  # inside another: counted once
    _ev("fused_query_kernel", 260, 200, cat="kernel", tid=7),
]


def test_each_reader_sums_its_own_spans_per_answered_request():
    run = _run(WINDOW_EVENTS)  # two of three requests answered
    read = {name: spec.reader(name)(run) for name in NAMES}
    assert read["encode_ms"] == pytest.approx((100 + 50 + 20) / 1e3 / 2)
    assert read["upload_ms"] == pytest.approx(60 / 1e3 / 2)
    assert read["restore_wait_ms"] == pytest.approx((100 + 50) / 1e3 / 2)


def test_a_window_without_paging_reads_zero_wait():
    events = [e for e in WINDOW_EVENTS
              if e["name"] not in ("wlsh_restore", "wlsh_offload")]
    assert spec.reader("restore_wait_ms")(_run(events)) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_nothing_is_read_without_a_trace_spans_or_answers(name):
    read = spec.reader(name)
    assert read(_run(None)) is None
    # a program that opens no layer spans (only the engine's ranges)
    older = [_ev(WINDOW, 0, 1000), _ev("perfbench.encode", 100, 100),
             _ev("wlsh_topk", 300, 10)]
    assert read(_run(older)) is None
    assert read(_run(WINDOW_EVENTS, ok=(False,))) is None


def test_restore_wait_is_the_paged_cells_alone():
    bench = spec.load()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        names = {m["name"] for m in cell.per_layer}
        assert {"encode_ms", "upload_ms"} <= names
        assert ("restore_wait_ms" in names) == (
            w["name"] == "l2-paged-tenant64")
        moves = {m["name"]: m["moves"] for m in cell.per_layer}
        assert moves["encode_ms"] == moves["upload_ms"] == "qps"
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "restore_wait_ms")
    assert entry["moves"] == "p95_ms" and entry["source"] == "program_span"
