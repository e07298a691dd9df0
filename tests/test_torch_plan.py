"""The port's host planner vs the JAX package's: the same plan, bit for bit.

``repro_torch.core`` is a numpy-only copy of the planner (the card's
machine has no JAX).  Its exported ``ServingPlan`` must equal the
reference's field by field, dtypes and bytes included, for p in
{2, 1, 0.5}; and a plan npz written by either package must load in the
other bit-equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import derived as jderived
from repro.core.datagen import make_dataset as jmake_dataset
from repro.core.datagen import make_weight_set as jmake_weight_set
from repro.core.params import PlanConfig as JPlanConfig
from repro.core.serving_plan import ServingPlan as JServingPlan
from repro.core.wlsh import WLSHIndex as JWLSHIndex
from repro_torch.core import derived
from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.core.wlsh import WLSHIndex

_TAU = {2.0: 500.0, 1.0: 1_000.0, 0.5: 2_000.0}


def _plans(p, n=1_024, d=16, n_weights=8, n_subset=4, v=4):
    data = make_dataset(n=n, d=d, seed=41)
    weights = make_weight_set(size=n_weights, d=d, n_subset=n_subset,
                              n_subrange=10, seed=42)
    assert np.array_equal(data, jmake_dataset(n=n, d=d, seed=41))
    assert np.array_equal(weights, jmake_weight_set(
        size=n_weights, d=d, n_subset=n_subset, n_subrange=10, seed=42))
    kw = dict(tau=_TAU[p], v=v, v_prime=v, seed=9)
    port = WLSHIndex(data, weights, PlanConfig(p=p, c=3, n=n), **kw)
    ref = JWLSHIndex(data, weights, JPlanConfig(p=p, c=3, n=n), **kw)
    return port, ref


def _assert_bit_equal(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{where}: dtype {a.dtype} != {b.dtype}"
        assert a.shape == b.shape, f"{where}: shape {a.shape} != {b.shape}"
        assert a.tobytes() == b.tobytes(), f"{where}: bytes differ"
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"


def _assert_plans_equal(got, want):
    for f in dataclasses.fields(want):
        if f.name == "groups":
            continue
        _assert_bit_equal(getattr(got, f.name), getattr(want, f.name),
                          f.name)
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        for f in dataclasses.fields(w):
            _assert_bit_equal(getattr(g, f.name), getattr(w, f.name),
                              f"group {w.group_id}.{f.name}")


def _fields(plan) -> dict:
    out = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    out["groups"] = [{f.name: getattr(g, f.name)
                      for f in dataclasses.fields(g)} for g in plan.groups]
    return out


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_exported_plan_is_bit_equal(p):
    port, ref = _plans(p)
    got, want = port.export_serving_plan(), ref.export_serving_plan()
    assert want.n_groups >= 2
    _assert_plans_equal(got, want)


def test_plan_with_more_weights_is_bit_equal():
    """A 24-weight, d=24 plan (the launcher's default weight-set size)."""
    port, ref = _plans(2.0, n=2_048, d=24, n_weights=24, n_subset=6, v=6)
    _assert_plans_equal(port.export_serving_plan(),
                        ref.export_serving_plan())


@pytest.mark.parametrize("v", [1, 3])
def test_ratio_bounds_round_like_the_reference(v):
    """The ratio reduction runs in float32, as the reference's does."""
    w = make_weight_set(size=12, d=40, n_subset=3, n_subrange=20, seed=5)
    for c in range(3):
        hi, lo = derived.ratio_bounds(w[c], w, v=v, v_prime=v)
        jhi, jlo = jderived.ratio_bounds(w[c], w, v=v, v_prime=v)
        _assert_bit_equal(hi, np.asarray(jhi), "hi")
        _assert_bit_equal(lo, np.asarray(jlo), "lo")


@pytest.mark.parametrize("p", [2.0, 0.5])
def test_npz_crosses_between_packages(p, tmp_path):
    port, ref = _plans(p)
    want = ref.export_serving_plan()
    want.save_npz(tmp_path / "ref.npz")
    loaded = ServingPlan.load_npz(tmp_path / "ref.npz")
    _assert_plans_equal(loaded, want)
    port.export_serving_plan().save_npz(tmp_path / "port.npz")
    _assert_plans_equal(JServingPlan.load_npz(tmp_path / "port.npz"), want)


def test_from_arrays_takes_the_reference_fields():
    _, ref = _plans(1.0)
    want = ref.export_serving_plan()
    _assert_plans_equal(ServingPlan.from_arrays(_fields(want)), want)


def test_plan_without_codes_crosses():
    _, ref = _plans(2.0)
    want = ref.export_serving_plan(include_codes=False)
    got = ServingPlan.from_arrays(_fields(want))
    assert all(g.codes is None for g in got.groups)
    _assert_plans_equal(got, want)


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_search_dense_matches_reference(p):
    port, ref = _plans(p)
    rng = np.random.default_rng(3)
    qs = port.data[rng.choice(port.n, 4, replace=False)] + rng.normal(
        0, 3.0, (4, port.data.shape[1])).astype(np.float32)
    for i, q in enumerate(qs):
        wid = int(i * 2 % len(port.weights))
        got = port.search_dense(q, weight_id=wid, k=5)
        want = ref.search_dense(q, weight_id=wid, k=5)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
        assert got.stats.stop_level == want.stats.stop_level
        assert got.stats.n_checked == want.stats.n_checked
        assert got.stats.n_collisions == want.stats.n_collisions
