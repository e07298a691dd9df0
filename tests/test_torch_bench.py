"""The port's paper-table scripts (``benchmarks_torch``) against the JAX
package's (``benchmarks``): the same rows and the same validation results
on the same seeded inputs, at reduced sizes where the CPU grid is slow.

Both packages' ``RESULT_DIR`` point at ``tmp_path``, so no file under
``experiments/`` is written.  Columns that hold a run's own wall time are
left out of the comparison.
"""

from __future__ import annotations

import json

import pytest

import benchmarks.common as ref_common
import benchmarks_torch.common as common
from benchmarks import fig1_query as ref_fig1
from benchmarks import render_tables as ref_render
from benchmarks import table6_space as ref_table6
from benchmarks import table7_alsh_space as ref_table7
from benchmarks import table8_ratio as ref_table8
from benchmarks import table11_relax as ref_table11
from benchmarks_torch import (fig1_query, render_tables, run, table6_space,
                              table7_alsh_space, table8_ratio, table11_relax)


@pytest.fixture(autouse=True)
def result_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULT_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(ref_common, "RESULT_DIR", str(tmp_path / "ref"))
    return tmp_path


def _without(rows, col):
    return [r[:col] + r[col + 1:] for r in rows]


def test_table6_space_matches_reference(result_dirs):
    got, want = table6_space.run(), ref_table6.run()
    assert set(got["results"]) == set(want["results"]) == {"l1", "l2"}
    for key in want["results"]:  # column 5: the partition's seconds
        assert _without(got["results"][key], 5) == _without(
            want["results"][key], 5)
    assert got["validation"] == want["validation"]
    assert (result_dirs / "port" / "table6_space.json").exists()


def test_table11_relax_matches_reference():
    got, want = table11_relax.run(), ref_table11.run()
    assert got == want


def test_table7_alsh_space_matches_reference():
    got, want = table7_alsh_space.run(), ref_table7.run()
    assert got == want
    assert all(c["ok"] for c in got["validation"])


def test_table8_ratio_matches_reference():
    got, want = table8_ratio.run(), ref_table8.run()
    assert got == want
    assert len(got["rows"]) == 4


_SMALL_GRID = {"n": [400, 800], "c": [2, 4], "d": [8, 16], "S": [8, 16]}
_SMALL_DEFAULT = {"d": 8, "n": 800, "c": 3, "n_subrange": 20,
                  "n_subset": 4, "S": 8}


def test_fig1_query_matches_reference(monkeypatch):
    for mod in (fig1_query, ref_fig1):
        monkeypatch.setattr(mod, "GRID", _SMALL_GRID)
        monkeypatch.setattr(mod, "DEFAULT", _SMALL_DEFAULT)
    got = fig1_query.run(params=("n", "c"))
    want = ref_fig1.run(params=("n", "c"))
    assert set(got["results"]) == {"l1", "l2"}
    for key in want["results"]:  # column 5: the setting's seconds
        assert _without(got["results"][key], 5) == _without(
            want["results"][key], 5)
    assert got["validation"] == want["validation"]


def test_render_tables_matches_reference(tmp_path, monkeypatch):
    runs = [
        dict(arch="olmo-1b", shape="decode_32k", mesh="single", status="ok",
             hbm_gb=3.25, fits_hbm=True, compute_s=1.5e-3, memory_s=2e-3,
             collective_s=1e-4, bottleneck="memory", useful_fraction=0.5,
             roofline_fraction=0.125),
        dict(arch="olmo-1b", shape="train_4k", mesh="single", status="ok",
             hbm_gb=40.0, fits_hbm=False, compute_s=2.0, memory_s=1.0,
             collective_s=0.5, bottleneck="compute", useful_fraction=0.75,
             roofline_fraction=0.5),
        dict(arch="moe", shape="long_500k", mesh="multi", status="skipped",
             reason="sequence longer than the model's context window"),
        dict(arch="ssm", shape="prefill_32k", mesh="multi", status="error",
             error="RESOURCE_EXHAUSTED while lowering the step"),
    ]
    for i, r in enumerate(runs):
        (tmp_path / f"run{i}.json").write_text(json.dumps(r))
    for mod in (render_tables, ref_render):
        monkeypatch.setattr(mod, "DRYRUN_DIR", str(tmp_path))
    for mesh in ("single", "multi"):
        got = render_tables.markdown(mesh)
        assert got == ref_render.markdown(mesh)
        assert got.count("\n| ") == 3  # the header and two runs


def test_run_only_writes_under_result_dir(result_dirs, capsys):
    assert run.main(["--only", "table11_relax"]) == 0
    out = capsys.readouterr().out
    assert "# table11_relax" in out and "SUMMARY" in out
    saved = json.loads(
        (result_dirs / "port" / "table11_relax.json").read_text())
    assert saved["rows"] == ref_table11.run()["rows"]
    with pytest.raises(SystemExit):
        run.main(["--only", "kernel_bench"])
