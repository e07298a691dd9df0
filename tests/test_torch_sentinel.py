"""The port's bench-regression sentinel (``benchmarks_torch.sentinel``).

The sentinel tests of ``tests/test_quality_telemetry.py`` (band
comparison, missing metrics, CLI exit codes) on the port's sentinel, and
its seeded workload on the CPU held to the JAX package's sentinel: the
seeded metrics equal, the other deterministic gated metrics inside the
bands.  Its own file, so that the two workloads (the slowest part) run
beside the rest of the suite.
"""

from __future__ import annotations

import json
import math

import pytest
import torch

import _torch_serving  # noqa: F401  (one torch thread per test process)
from benchmarks import sentinel as ref_sentinel
from benchmarks_torch import sentinel

_BASE = {
    "p50_step_ms": 10.0, "qps": 100.0, "state_hit_rate": 0.8,
    "deadline_miss_rate": 0.0, "observed_recall": 0.9,
    "n_compiled_steps": 4, "n_shadow_dropped": 0,
}

# fixed by the seed: equal across packages and devices
SEEDED = ("observed_recall", "recall_margin_min", "n_shadow_dropped",
          "n_compiled_steps")
# deterministic under the manual clock, gated by the bands
REPLAYED = ("state_hit_rate", "deadline_miss_rate", "mean_occupancy")
WALL = ("p50_step_ms", "p95_step_ms", "qps", "obs_overhead_frac")


def test_sentinel_compare_equal_passes():
    rows = sentinel.compare(dict(_BASE), dict(_BASE))
    assert rows and all(r["ok"] for r in rows)


def test_sentinel_compare_direction_aware():
    # worsening beyond the band fails in the metric's bad direction
    cur = dict(_BASE, observed_recall=0.8)  # higher-better, -0.1
    assert any(not r["ok"] and r["metric"] == "observed_recall"
               for r in sentinel.compare(cur, _BASE))
    cur = dict(_BASE, p50_step_ms=30.0)  # lower-better, 3x baseline
    assert any(not r["ok"] and r["metric"] == "p50_step_ms"
               for r in sentinel.compare(cur, _BASE))
    # improvements never fail, however large
    cur = dict(_BASE, p50_step_ms=0.1, observed_recall=1.0, qps=9_999.0)
    assert all(r["ok"] for r in sentinel.compare(cur, _BASE))
    # small wall-clock noise stays inside the wide band
    cur = dict(_BASE, p50_step_ms=14.0, qps=80.0)
    assert all(r["ok"] for r in sentinel.compare(cur, _BASE))
    assert sentinel.BANDS == ref_sentinel.BANDS


def test_sentinel_compare_missing_metric_is_regression():
    cur = dict(_BASE)
    del cur["observed_recall"]
    rows = sentinel.compare(cur, _BASE)
    row = next(r for r in rows if r["metric"] == "observed_recall")
    assert not row["ok"] and row["current"] is None


def test_sentinel_cli_exit_codes(tmp_path):
    base = tmp_path / "BASELINE.json"
    out = tmp_path / "BENCH.json"
    cur = tmp_path / "current.json"
    cur.write_text(json.dumps({"metrics": _BASE}))
    # no baseline yet: exit 2
    assert sentinel.main(["--from-json", str(cur),
                          "--baseline", str(base),
                          "--out", str(out)]) == 2
    # pin a baseline: exit 0, both artifacts written
    assert sentinel.main(["--from-json", str(cur),
                          "--baseline", str(base),
                          "--out", str(out),
                          "--write-baseline"]) == 0
    assert json.loads(base.read_text())["metrics"] == _BASE
    assert json.loads(out.read_text())["metrics"] == _BASE
    # clean gate: exit 0
    assert sentinel.main(["--from-json", str(cur),
                          "--baseline", str(base),
                          "--out", str(out)]) == 0
    # injected regression: exit 1
    bad = dict(_BASE, n_compiled_steps=5)  # zero-tolerance metric
    worse = tmp_path / "worse.json"
    worse.write_text(json.dumps(bad))  # bare dict form also accepted
    assert sentinel.main(["--from-json", str(worse),
                          "--baseline", str(base),
                          "--out", str(out)]) == 1


def test_sentinel_defaults_to_the_card(tmp_path):
    """``collect()`` and the CLI run on the card unless asked for the CPU;
    without a CUDA device they raise before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sentinel.collect()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sentinel.main(["--out", str(tmp_path / "BENCH.json")])
    assert not (tmp_path / "BENCH.json").exists()


def test_collect_on_cpu_matches_reference(tmp_path):
    """The CLI on the CPU pins a baseline whose seeded metrics equal the
    JAX package's sentinel run, and which gates itself clean."""
    base, out = tmp_path / "BASELINE.json", tmp_path / "BENCH.json"
    assert sentinel.main(["--device", "cpu", "--baseline", str(base),
                          "--out", str(out), "--write-baseline"]) == 0
    pinned = json.loads(base.read_text())
    assert pinned["device"] == "cpu"
    assert pinned["workload"] == ref_sentinel._WL
    got = pinned["metrics"]
    assert json.loads(out.read_text())["metrics"] == got
    want = ref_sentinel.collect()
    assert set(got) == set(want)
    for name in SEEDED:
        assert got[name] == want[name], name
    rows = {r["metric"]: r for r in sentinel.compare(got, want)}
    for name in REPLAYED:
        assert rows[name]["ok"], rows[name]
    for name in WALL:  # two runtimes' wall clocks: checked, not compared
        assert math.isfinite(got[name]), name
    assert got["p50_step_ms"] > 0 and got["qps"] > 0
    assert sentinel.main(["--from-json", str(out), "--baseline", str(base),
                          "--out", str(tmp_path / "again.json")]) == 0
