"""The comparison that decides ``correct`` fails what it must fail.

A whole run of a cell at a size the CPU holds, past the harness's look
for a card: the program as configured comes out correct; its control
(the program's own bfloat16 rows) and the program with its timed path
broken underneath come out not correct.  Each fault is planted where the
answer is produced: in the routing, in the engine's step (half of the
batch left unanswered) and in the exact re-rank (an id altered).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from perfbench import check, harness, spec
from perfbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    torch.set_num_threads(1)
    root = tiny.copy_benchmark(tmp_path_factory.mktemp("bench"))
    tiny.add_cell(root)
    tiny.add_cell(root, name="tinypaged", config=dict(
        tiny.CONFIG, service={"max_resident_groups": 1,
                              "offload_evicted": True}))
    bench = spec.load(root)
    return {n: spec.cell(bench, n, root) for n in ("tiny", "tinypaged")}


def _run(cell, seed=2**31 + 5, **overrides):
    return harness.run_cell(cell, seed, 0.3, False, CPU, time.perf_counter(),
                            **overrides)


@pytest.mark.parametrize("name", ["tiny", "tinypaged"])
def test_the_program_as_configured_is_correct(cell, name):
    out = _run(cell[name])
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["detail"]["checked"] > 0
    if name == "tinypaged":  # answers from restored states were checked
        assert out["detail"]["restored_requests_checked"] > 0
        assert out["run"].counters["n_restores"] > 0


@pytest.mark.parametrize("name", ["tiny", "tinypaged"])
def test_the_control_is_not_correct(cell, name):
    out = _run(cell[name], vec_dtype="bfloat16")
    assert not out["correct"]
    assert out["check"]["dist_err_max"]["value"] > \
        out["check"]["dist_err_max"]["limit"]


def _route_to_the_next_group(monkeypatch):
    from repro_torch.serving.batching import Batcher

    orig = Batcher.route

    def route(self, weight_ids):
        return (orig(self, weight_ids) + 1) % self.plan.n_groups

    monkeypatch.setattr(Batcher, "route", route)


def _answer_half_the_batch(monkeypatch):
    from repro_torch.index import engine

    orig = engine.query_step

    def step(*a, **kw):
        vals, idx, stop, chk = orig(*a, **kw)
        half = len(idx) // 2
        vals, idx = vals.clone(), idx.clone()
        vals[half:], idx[half:] = float("inf"), -1
        return vals, idx, stop, chk

    monkeypatch.setattr(engine, "query_step", step)


def _alter_an_id(monkeypatch):
    from repro_torch.index import engine

    orig = engine._rerank

    def rerank(*a, **kw):
        vals, idx = orig(*a, **kw)
        idx = idx.clone()
        idx[:, 0] = torch.where(idx[:, 0] >= 0, (idx[:, 0] + 1) % 1024,
                                idx[:, 0])
        return vals, idx

    monkeypatch.setattr(engine, "_rerank", rerank)


@pytest.mark.parametrize("fault", [_route_to_the_next_group,
                                   _answer_half_the_batch, _alter_an_id])
def test_a_broken_timed_path_is_not_correct(cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(cell["tiny"])
    assert not out["correct"]
    assert out["check"]["answers_off_pct"]["value"] > \
        out["check"]["answers_off_pct"]["limit"]


def test_verdict_needs_every_number_and_every_limit():
    assert check.verdict({"a": 1.0}, {"a": 1.0})[0]
    assert not check.verdict({"a": 1.5}, {"a": 1.0})[0]
    assert not check.verdict({"a": 1.0}, {"a": 1.0, "b": 0.0})[0]
    assert not check.verdict({"a": 1.0, "b": 0.0}, {"a": 1.0})[0]


def test_a_wrong_distance_or_id_out_of_range_reads_infinite():
    class Ref:
        group = np.zeros(1, np.int64)
        stop = np.zeros(1, np.int64)
        n_checked = np.zeros(1, np.int64)
        ids = np.array([[3, 4]])
        dists = np.array([[1.0, 2.0]])

    got = dict(group=Ref.group, stop=Ref.stop, n_checked=Ref.n_checked,
               ids=np.array([[3, 4]]), dists=np.array([[1.0, np.nan]]))
    numbers, _ = check.compare(got, Ref, np.array([[1.0, 2.0]]))
    assert numbers["answers_off_pct"] == 0.0
    assert numbers["dist_err_max"] == np.inf


@pytest.mark.parametrize("name", ["tiny", "tinypaged"])
def test_the_readings_script_reads_both_sides_on_one_plan(cell, name,
                                                          monkeypatch):
    from perfbench import control

    plans = []
    prepare = harness.prepare
    monkeypatch.setattr(harness, "prepare",
                        lambda *a: plans.append(1) or prepare(*a))
    rows = control.readings(cell[name], 2**31 + 21, 0.2,
                            ["program", "control"], CPU)
    assert len(plans) == 1  # both variants on one plan
    assert [(r["workload"], r["variant"]) for r in rows] == [
        (name, "program"), (name, "control")]
    for r in rows:
        ok, _ = check.verdict(r["numbers"], cell[name].limits)
        assert ok == r["correct"] == (r["variant"] == "program")
        assert r["failed"] == 0


def test_the_traced_ranges_skip_what_the_program_lacks():
    import contextlib
    from types import SimpleNamespace

    from torch.profiler import profile

    class Batcher:  # a program whose query encode has moved elsewhere
        def route(self, weight_ids):
            return weight_ids + 1

        @contextlib.contextmanager
        def lease(self, gi):
            yield gi

    get = lambda device, cfg: (lambda *a: "step")  # noqa: E731
    b = Batcher()
    b.step_cache = SimpleNamespace(get=get)
    with profile() as prof, harness._layer_ranges(SimpleNamespace(batcher=b)):
        assert b.route(1) == 2
        with b.lease(3) as state:
            assert state == 3
        assert b.step_cache.get("cpu", None)() == "step"
    names = {e.name for e in prof.events()}
    assert {"perfbench.route", "perfbench.lease",
            "perfbench.query_step"} <= names
    assert "route" not in vars(b) and "lease" not in vars(b)
    assert b.step_cache.get is get  # an instance's own attribute comes back
