"""The harness on the card at the CPU tests' size: a run and a traced
run come out correct and read every metric of their kind.  Marked
``cuda``; skipped, with its reason, where no card is present."""

from __future__ import annotations

import time

import pytest

from perfbench import harness, spec
from perfbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the harness's device path")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny.copy_benchmark(tmp_path_factory.mktemp("bench"))
    tiny.add_cell(root)
    return spec.cell(spec.load(root), "tiny", root)


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_on_the_card(card, cell, traced):
    out = harness.run_cell(cell, 2**31 + 9, 1.0, traced, card,
                           time.perf_counter())
    assert out["correct"], out["check"]
    run = out["run"]
    assert run.memory_peak_bytes > 0
    entries = cell.per_layer if traced else cell.end_to_end
    got = harness.metrics(run, entries)
    assert set(got) == {m["name"] for m in entries}
    if traced:
        assert 0 < run.trace.busy_s() <= run.trace.window_s
        assert 0 < got["query_roofline_pct"]["value"] <= 100
