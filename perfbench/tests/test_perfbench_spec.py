"""The benchmark is driven by data: every part of a cell is found by name,
and a new cell, mix or metric is new files and entries only."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from perfbench import harness, spec, traffic
from perfbench.tests import tiny

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts_by_name(workload):
    cell = spec.cell(BENCH, workload)
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert cell.config["name"] == entry["config"]
    traffic.validate(cell.traffic)
    assert set(cell.limits) == {"answers_off_pct", "dist_err_max"}
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    for m in cell.per_layer:  # a metric's cells report what it moves
        assert m["moves"] in reported


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_mix_becomes_a_cell_without_editing_a_file(tmp_path):
    root = tiny.copy_benchmark(tmp_path)
    before = _digests(root)
    tiny.add_cell(root, name="added")
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())  # nothing edited
    assert set(after) - set(before)  # only files added
    bench = spec.load(root)
    cell = spec.cell(bench, "added", root)
    assert cell.traffic == tiny.MIX and cell.config["n"] == tiny.CONFIG["n"]
    # the new cell reports every metric that names no cells of its own
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in bench["per_layer"] if "workloads" not in m}


def test_a_new_metric_is_a_reader_file_and_an_entry(tmp_path):
    root = tiny.copy_benchmark(tmp_path)
    (root / "perfbench" / "metrics" / "windows.n.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="windows.n", unit="windows", better="higher",
        source="host_clock", layer="device", moves="qps"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(spec.load(root), "l2-resident-tenant64", root)
    assert "windows.n" in {m["name"] for m in cell.per_layer}
    assert spec.reader("windows.n", root)(None) == 1.0


def test_a_mix_the_generator_does_not_implement_is_refused():
    with pytest.raises(ValueError, match="closed loop"):
        traffic.validate(dict(tiny.MIX, loop="open"))
    with pytest.raises(ValueError, match="not understood"):
        traffic.validate(dict(tiny.MIX, burst=3))
    with pytest.raises(ValueError, match="service"):
        traffic.validate(dict(tiny.MIX, service={"n_shards": 2}))


def test_the_pool_is_the_seeds_and_balanced():
    import numpy as np

    data = np.arange(64 * 16, dtype=np.float32).reshape(64, 16)
    mix = dict(tiny.MIX, pool_requests=24, request_queries=3)
    a = traffic.requests(mix, data, 8, 2**31 + 17)
    b = traffic.requests(mix, data, 8, 2**31 + 17)
    c = traffic.requests(mix, data, 8, 2**31 + 18)
    assert np.array_equal(a.queries, b.queries)
    assert not np.array_equal(a.queries, c.queries)
    ids = a.weight_ids[:, 0]
    assert (a.weight_ids == ids[:, None]).all()  # one id a request
    for blk in ids.reshape(3, 8):  # each block: every id once
        assert sorted(blk) == list(range(8))
    # the order is the mix's: another run seed, the same ids
    assert np.array_equal(a.weight_ids, c.weight_ids)
    d = traffic.requests(dict(mix, order_seed=2), data, 8, 2**31 + 17)
    assert not np.array_equal(a.weight_ids, d.weight_ids)
    assert np.array_equal(a.queries, d.queries)
    e = traffic.requests(dict(mix, weight_mix="per_query"), data, 8, 1)
    assert sorted(e.weight_ids.ravel()) == sorted(list(range(8)) * 9)


def test_the_deployments_serving_knobs_are_the_configurations():
    bench = spec.load()
    for entry in bench["configs"]:
        with open(spec.ROOT / entry["file"]) as fh:
            harness.service_knobs(json.load(fh))
    paged = spec.cell(bench, "l2-paged-tenant64")
    assert harness.service_knobs(paged.config)["offload_evicted"]
    assert not harness.service_knobs(
        spec.cell(bench, "l2-resident-tenant64").config)
    with pytest.raises(ValueError, match="service keys not understood"):
        harness.service_knobs(dict(tiny.CONFIG, service={"n_shards": 2}))


def test_a_configuration_states_the_width_of_its_ids(tmp_path):
    for name in ("l2-resident-tenant64", "l1-resident-tenant64",
                 "l2-paged-tenant64"):  # these three deployments store 32
        assert spec.code_bits(spec.cell(BENCH, name).config) == 32
    assert spec.code_bits(dict(tiny.CONFIG, code_bits=64)) == 64
    for bits in (48, "64", 64.0, None):
        with pytest.raises(ValueError, match="code_bits"):
            spec.code_bits(dict(tiny.CONFIG, code_bits=bits))
    root = tiny.copy_benchmark(tmp_path)
    tiny.add_cell(root, name="wide48", config=dict(tiny.CONFIG, code_bits=48))
    with pytest.raises(ValueError, match="code_bits 48"):
        spec.cell(spec.load(root), "wide48", root)


def test_a_64_bit_configuration_needs_no_harness_edit(tmp_path,
                                                      monkeypatch):
    """The weighted-l0.5 deployment's shape at a tiny size: p = 0.5 with
    64-bit ids, added as files and entries only, loads, hands its width
    to a program that takes it, is answered by the reference at 64 bits,
    and its launches are priced at 8-byte ids."""
    import types

    import torch

    from perfbench.harness import Record
    from perfbench.reference import planner
    from perfbench.reference import search as ref_search
    from repro_torch.core import wlsh

    handed = []

    class Wide(wlsh.WLSHIndex):  # a program that takes the width
        def __init__(self, *a, code_bits=32, **kw):
            handed.append(code_bits)
            super().__init__(*a, **kw)

    monkeypatch.setattr(wlsh, "WLSHIndex", Wide)

    root = tiny.copy_benchmark(tmp_path)
    before = _digests(root)
    tiny.add_cell(root, name="tiny05", config=tiny.CONFIG_L05)
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())  # nothing edited
    cell = spec.cell(spec.load(root), "tiny05", root)
    assert (cell.config["p"], spec.code_bits(cell.config)) == (0.5, 64)

    torch.set_num_threads(1)
    prep = harness.prepare(cell, 2**31 + 41, torch.device("cpu"))
    assert handed == [64]
    records = [Record(index=j, t_issue=0.0, latency_s=0.0, restored=False,
                      ok=True) for j in range(4)]

    def group_config(gi):  # the shapes a service reports for its groups
        g = prep.plan.groups[gi]
        return types.SimpleNamespace(
            n=cell.config["n"], beta=g.beta_group, d=cell.config["d"],
            q_batch=cell.config["q_batch"], k=cell.config["k"],
            n_levels=g.n_levels_max, p=cell.config["p"],
            vec_dtype=cell.config["vec_dtype"])

    svc = types.SimpleNamespace(group_config=group_config)
    shapes = harness.launches(svc, prep, records, cell.config)
    assert shapes and all(s["code_bytes"] == 8 for s in shapes)
    assert all(s["code_bytes"] == 4 for s in harness.launches(
        svc, prep, records, tiny.CONFIG))

    # the check's reference answers it at the width the file states, and
    # reads its own answers at that width as exact
    queries, wids = prep.pool.queries[:4].reshape(-1, cell.config["d"]), \
        prep.pool.weight_ids[:4].ravel()
    ref, fams = planner.plan(prep.weights, cell.config, cell.config["n"],
                             2**31 + 41)
    ans = ref_search.answer(ref, fams, torch.as_tensor(prep.data), queries,
                            wids, cell.config["k"], 64)
    own = dict(group=ans.group, stop=ans.stop, n_checked=ans.n_checked,
               ids=ans.ids, dists=ans.dists)
    widths, answer = [], ref_search.answer

    def spy(*a, **kw):
        widths.append(a[6] if len(a) > 6 else kw["code_bits"])
        return answer(*a, **kw)

    monkeypatch.setattr(ref_search, "answer", spy)
    numbers, detail = harness.reference_check(cell, prep, queries, wids, own,
                                              torch.device("cpu"))
    assert widths == [64]
    assert numbers == {"answers_off_pct": 0.0, "dist_err_max": 0.0}
    assert 0.0 < detail["codes_wrapped_pct"] < 100.0
    assert detail["codes_wrapped_pct"] == pytest.approx(
        100.0 * ans.ids_outside_int32 / ans.ids_counted)
