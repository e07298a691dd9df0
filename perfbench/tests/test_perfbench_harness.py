"""What the harness hands the program to plan with: today's arguments for a
configuration that states no width of bucket ids, and ``code_bits`` as
well where one does; a program that cannot take the width is refused
before any input is made."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from perfbench import harness, inputs, spec
from perfbench.tests import tiny

BENCH = spec.load()
# the deployments that state no width; a cell added later with its own
# ``code_bits`` is not among them, and needs no edit here
TODAYS = ("l2-resident-tenant64", "l1-resident-tenant64", "l2-paged-tenant64")
CPU = torch.device("cpu")
SEED = 2**31 + 77
_UNSET = object()


def _recorder(calls: list):
    """A stand-in for the program's ``WLSHIndex`` that takes a width and
    records how it was called."""

    class Index:
        def __init__(self, *args, code_bits=_UNSET, **kwargs):
            if code_bits is not _UNSET:
                kwargs["code_bits"] = code_bits
            calls.append((args, kwargs))

        def export_serving_plan(self):
            return "plan"

    return Index


@pytest.fixture
def recorded(monkeypatch):
    """The calls into a recording ``WLSHIndex``, over a corpus of 64 rows
    (the pool and the weight set are the configuration's own)."""
    from repro_torch.core import wlsh

    calls = []
    monkeypatch.setattr(wlsh, "WLSHIndex", _recorder(calls))
    small = np.arange(64 * 400, dtype=np.float32).reshape(64, 400)
    monkeypatch.setattr(inputs, "corpus",
                        lambda n, d, value_range, seed, device: small[:, :d])
    return calls


def _todays_call(cfg: dict, prep: harness.Prepared):
    """The arguments the harness has always planned with."""
    from repro_torch.core.params import PlanConfig

    args = (prep.data, PlanConfig(p=cfg["p"], c=cfg["c"], eps=cfg["eps"],
                                  gamma_n=cfg["gamma_n"], n=cfg["n"]))
    kwargs = dict(tau=cfg["tau"], value_range=cfg["value_range"], v=cfg["v"],
                  v_prime=cfg["v_prime"], seed=inputs.base_seed(SEED))
    return args, kwargs


def _assert_called(calls, cfg, prep, **width):
    assert len(calls) == 1
    args, kwargs = calls[0]
    want_args, want_kwargs = _todays_call(cfg, prep)
    assert len(args) == 3
    assert args[0] is want_args[0] and args[2] == want_args[1]
    assert np.array_equal(args[1], inputs.weight_set(
        cfg["n_weights"], cfg["d"], cfg["n_subset"], cfg["n_subrange"],
        cfg["weight_seed"]))
    assert kwargs == dict(want_kwargs, **width)


@pytest.mark.parametrize("workload", TODAYS)
def test_a_configuration_without_a_width_plans_as_it_always_did(workload,
                                                                recorded):
    cell = spec.cell(BENCH, workload)
    assert "code_bits" not in cell.config
    prep = harness.prepare(cell, SEED, CPU)
    assert prep.plan == "plan"
    _assert_called(recorded, cell.config, prep)


@pytest.mark.parametrize("bits", [64, 32])
def test_a_stated_width_reaches_the_program(bits, recorded, tmp_path):
    root = tiny.copy_benchmark(tmp_path)
    tiny.add_cell(root, name=f"wide{bits}",
                  config=dict(tiny.CONFIG, code_bits=bits))
    cell = spec.cell(spec.load(root), f"wide{bits}", root)
    prep = harness.prepare(cell, SEED, CPU)
    _assert_called(recorded, cell.config, prep, code_bits=bits)


def test_a_program_without_the_keyword_is_refused_by_name():
    class Narrow:  # the signature of a program that keeps 32-bit ids
        def __init__(self, data, weights, cfg, tau, value_range=1.0, v=1,
                     v_prime=1, use_reduction=True, seed=0,
                     materialize=False):
            pass

    assert harness.plan_keywords(tiny.CONFIG, Narrow) == {}
    with pytest.raises(ValueError) as err:
        harness.plan_keywords(tiny.CONFIG_L05, Narrow)
    for word in ("code_bits", "'tiny-l05'",
                 "repro_torch.core.wlsh.WLSHIndex"):
        assert word in str(err.value)


def test_the_real_program_takes_the_width_or_refuses_it_before_any_input(
        tmp_path, monkeypatch):
    """The weighted-l0.5 deployment's shape at a tiny size against the
    program as it stands: a program that takes ``code_bits`` plans it with
    every corpus id whole, as the reference's 64-bit ids; one that does not
    fails in ``prepare`` before a corpus or a plan is made."""
    from perfbench.reference import planner
    from perfbench.reference import search as ref_search
    from repro_torch.core.wlsh import WLSHIndex

    root = tiny.copy_benchmark(tmp_path)
    tiny.add_cell(root, name="tiny05", config=tiny.CONFIG_L05)
    cell = spec.cell(spec.load(root), "tiny05", root)
    made, corpus = [], inputs.corpus
    monkeypatch.setattr(inputs, "corpus",
                        lambda *a: made.append(a) or corpus(*a))
    if "code_bits" in inspect.signature(WLSHIndex).parameters:
        torch.set_num_threads(1)
        prep = harness.prepare(cell, SEED, CPU)
        _, fams = planner.plan(prep.weights, cell.config, cell.config["n"],
                               inputs.base_seed(SEED))
        outside = 0
        for group, fam in zip(prep.plan.groups, fams, strict=True):
            want = ref_search.codes(torch.as_tensor(prep.data), fam, 64)
            assert group.codes.dtype == np.int64
            np.testing.assert_array_equal(group.codes, want.numpy())
            outside += int(((group.codes > 2**31 - 1)
                            | (group.codes < -2**31)).sum())
        assert outside > 0  # ids that a 32-bit store would have wrapped
    else:
        with pytest.raises(ValueError, match=r"code_bits 64, .*"
                           r"repro_torch\.core\.wlsh\.WLSHIndex"):
            harness.prepare(cell, SEED, CPU)
        assert made == []
