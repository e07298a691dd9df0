"""The port's baselines (E2LSH, SL-ALSH, S2-ALSH) against the JAX package's.

Each test of ``tests/test_baselines.py`` runs on the port's modules, and
each also holds the port's outputs bit-equal to the reference's on the
same seeded inputs: the baselines are host numpy in both packages, with
the same operations in the same order.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.core import alsh as ref_alsh
from repro.core import e2lsh as ref_e2lsh
from repro.core.datagen import make_weight_set as ref_make_weight_set
from repro.core.params import PlanConfig as RefPlanConfig
from repro.core.partition import partition as ref_partition
from repro_torch.core.alsh import ALSHIndex, alsh_tables, rho_s2, rho_sl
from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.distances import weighted_lp_np
from repro_torch.core.e2lsh import E2LSH, e2lsh_params
from repro_torch.core.params import PlanConfig
from repro_torch.core.partition import partition


@pytest.fixture(scope="module")
def weights():
    w = make_weight_set(size=16, d=16, n_subset=4, n_subrange=5, seed=1)
    np.testing.assert_array_equal(
        w, ref_make_weight_set(size=16, d=16, n_subset=4, n_subrange=5,
                               seed=1))
    return w


# ------------------------------------------------------------------ E2LSH


def test_e2lsh_params_regime():
    got = e2lsh_params(n=400_000, w=4.0, c=3.0, p=2.0)
    m, L, rho, p1, p2 = got
    assert 0.0 < rho < 1.0
    assert 0 < p2 < p1 < 1
    assert m >= 1 and L >= 1
    # sublinearity: L = n^rho << n
    assert L < 400_000
    assert got == ref_e2lsh.e2lsh_params(n=400_000, w=4.0, c=3.0, p=2.0)


def test_e2lsh_recovers_neighbors():
    data = make_dataset(n=1_200, d=16, seed=3)
    w = np.ones(16)
    cfg = PlanConfig(p=2.0, c=3, n=len(data), gamma_n=100.0)
    idx = E2LSH(data, w, cfg, seed=4, max_tables=24)
    ref = ref_e2lsh.E2LSH(data, w, RefPlanConfig(p=2.0, c=3, n=len(data),
                                                gamma_n=100.0),
                          seed=4, max_tables=24)
    assert (idx.m, idx.L, idx.n_levels) == (ref.m, ref.L, ref.n_levels)
    hits = 0
    rng = np.random.default_rng(5)
    for pid in rng.choice(len(data), 10, replace=False):
        ids, dists, n_checked = idx.query(data[pid], k=1)
        r_ids, r_dists, r_checked = ref.query(data[pid], k=1)
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_array_equal(dists, r_dists)
        assert n_checked == r_checked
        exact = weighted_lp_np(data, data[pid], w, 2.0)
        if ids[0] >= 0 and dists[0] <= cfg.c * np.partition(exact, 1)[0] + 1e-6:
            hits += 1
    assert hits >= 8  # c-NN guarantee holds with constant probability


# ------------------------------------------------------------- SL/S2-ALSH


def test_rho_values_in_unit_interval(weights):
    for R in (500.0, 1000.0):
        r_sl = rho_sl(weights, R=R, c=3.0)
        r_s2 = rho_s2(weights, R=R, c=3.0)
        assert 0.0 < r_sl < 1.0
        assert 0.0 < r_s2 < 1.0
        assert r_sl == ref_alsh.rho_sl(weights, R=R, c=3.0)
        assert r_s2 == ref_alsh.rho_s2(weights, R=R, c=3.0)


def test_rho_decreases_with_c(weights):
    """Paper Table 7: required tables decrease with c."""
    cs = (2.0, 4.0, 6.0)
    rs = [rho_sl(weights, R=1000.0, c=c) for c in cs]
    assert rs[0] >= rs[1] >= rs[2]
    rs2 = [rho_s2(weights, R=1000.0, c=c) for c in cs]
    assert rs2[0] >= rs2[1] >= rs2[2]
    assert rs == [ref_alsh.rho_sl(weights, R=1000.0, c=c) for c in cs]
    assert rs2 == [ref_alsh.rho_s2(weights, R=1000.0, c=c) for c in cs]


def test_alsh_table_count_grows_polynomially(weights):
    rho = rho_sl(weights, R=1000.0, c=3.0)
    l1 = alsh_tables(100_000, rho)
    l2 = alsh_tables(1_600_000, rho)
    assert l2 > l1
    # polynomial growth: l2/l1 ~ 16^rho (way faster than log)
    assert l2 / l1 > np.log(1_600_000) / np.log(100_000)
    assert (l1, l2) == (ref_alsh.alsh_tables(100_000, rho),
                        ref_alsh.alsh_tables(1_600_000, rho))


def test_alsh_query_finds_close_points(weights):
    """The asymmetric MIPS reduction must rank near neighbors first.

    Clustered (SIFT-like) data: on uniform data these methods degrade to
    near-random for adversarial weight vectors (rho ~ 0.98, the paper's
    motivation), so the meaningful check is that they find structure where
    structure exists.  Every answer also equals the reference's.
    """
    rng0 = np.random.default_rng(100)
    centers = rng0.uniform(0, 10_000, (30, 16))
    data = (
        centers[rng0.integers(0, 30, 1_500)]
        + rng0.normal(0, 300, (1_500, 16))
    ).clip(0, 10_000).astype(np.float32)
    cfg = PlanConfig(p=2.0, c=3, n=len(data), gamma_n=100.0)
    rng = np.random.default_rng(7)
    for variant in ("sl", "s2"):
        idx = ALSHIndex(data, cfg, variant=variant, m=16, L=16, seed=8)
        ref = ref_alsh.ALSHIndex(
            data, RefPlanConfig(p=2.0, c=3, n=len(data), gamma_n=100.0),
            variant=variant, m=16, L=16, seed=8)
        np.testing.assert_array_equal(idx.aug, ref.aug)
        np.testing.assert_array_equal(idx.tables.codes, ref.tables.codes)
        ratios = []
        for _ in range(8):
            pid = rng.integers(0, len(data))
            w = weights[rng.integers(0, len(weights))]
            q = data[pid].astype(np.float64) + rng.normal(0, 50.0, 16)
            ids, dists, n_checked = idx.query(q, w, k=5, budget=300)
            r_ids, r_dists, r_checked = ref.query(q, w, k=5, budget=300)
            np.testing.assert_array_equal(ids, r_ids)
            np.testing.assert_array_equal(dists, r_dists)
            assert n_checked == r_checked
            assert n_checked <= 300
            got = ids[ids >= 0]
            exact = np.sort(weighted_lp_np(data, q, w, 2.0))[: got.size]
            mine = np.sort(weighted_lp_np(data[got], q, w, 2.0))
            ratios.append(float(np.mean(mine / np.maximum(exact, 1e-9))))
        ratios = np.asarray(ratios)
        assert np.median(ratios) <= 8.0, f"{variant}: {ratios}"
        assert np.sum(ratios < 2.0) >= 3, f"{variant}: {ratios}"


def test_wlsh_beats_alsh_space_at_paper_scale(weights):
    """Table 1 headline: WLSH tables O(log n) vs ALSH n^rho (l2, c=3)."""
    cfg = PlanConfig(p=2.0, c=3, n=400_000, gamma_n=100.0)
    res = partition(weights, cfg, 10_000.0, tau=500.0, v=4, v_prime=4)
    rho = rho_sl(weights, R=1000.0, c=3.0)
    l_sl = alsh_tables(400_000, rho)
    assert res.beta_total < l_sl
    ref = ref_partition(weights, RefPlanConfig(p=2.0, c=3, n=400_000,
                                               gamma_n=100.0),
                        10_000.0, tau=500.0, v=4, v_prime=4)
    assert res.beta_total == ref.beta_total
