"""The port's paper-faithful host search (``WLSHIndex.search``) and C2LSH.

The search tests of ``tests/test_wlsh.py`` run on the port at l1 and l2
(accuracy guarantee, the faithful loop against the dense oracle, self
queries, I/O accounting, C2LSH degeneration, collision-threshold
reduction), and the port's ``search`` is held bit for bit to the JAX
package's: ids, distances and every ``SearchStats`` field, for p in
{2, 1, 0.5}, at the planned c and at a query-time c override.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from repro.core.c2lsh import C2LSH as JC2LSH
from repro.core.params import PlanConfig as JPlanConfig
from repro.core.wlsh import WLSHIndex as JWLSHIndex
from repro_torch.core.c2lsh import C2LSH
from repro_torch.core.datagen import make_dataset, make_query_set, make_weight_set
from repro_torch.core.distances import weighted_lp_np
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import BLOCK_BYTES, WLSHIndex

_TAU = {2.0: 500.0, 1.0: 1_000.0, 0.5: 2_000.0}


def _overall_ratio(idx, qs, k):
    """Average overall ratio (paper Eq. 16) over a query set."""
    ratios = []
    for q in qs.points:
        for wid in qs.weight_ids:
            res = idx.search(q, weight_id=int(wid), k=k)
            got = res.ids[res.ids >= 0]
            if got.size == 0:
                ratios.append(np.inf)
                continue
            w = idx.weights[int(wid)]
            exact = np.sort(weighted_lp_np(idx.data, q, w, idx.cfg.p))[: got.size]
            mine = np.sort(weighted_lp_np(idx.data[got], q, w, idx.cfg.p))
            ratios.append(float(np.mean(mine / np.maximum(exact, 1e-12))))
    return float(np.mean(ratios))


@pytest.fixture(scope="module", params=[1.0, 2.0], ids=["l1", "l2"])
def built(request):
    p = request.param
    data = make_dataset(n=3_000, d=24, seed=11)
    weights = make_weight_set(size=10, d=24, n_subset=2, n_subrange=10, seed=12)
    cfg = PlanConfig(p=p, c=3, n=len(data), gamma_n=100.0)
    idx = WLSHIndex(data, weights, cfg, tau=_TAU[p], v=6, v_prime=6, seed=3)
    qs = make_query_set(data, weights, n_query_points=8, n_query_weights=3,
                        seed=13)
    return idx, qs


def test_accuracy_guarantee(built):
    """Average overall ratio must be well under the approximation ratio c."""
    idx, qs = built
    ratio = _overall_ratio(idx, qs, k=5)
    assert ratio < idx.cfg.c, f"avg overall ratio {ratio} >= c={idx.cfg.c}"


def test_faithful_vs_dense_same_stop_semantics(built):
    """Both paths implement identical stop conditions -> same stop level and
    n_checked, and the same candidates where the frequent set fits the
    budget."""
    idx, qs = built
    budget = 3 + math.ceil(idx.cfg.gamma_n)
    for q in qs.points[:4]:
        for wid in qs.weight_ids[:2]:
            r1 = idx.search(q, weight_id=int(wid), k=3)
            r2 = idx.search_dense(q, weight_id=int(wid), k=3)
            assert r1.stats.stop_level == r2.stats.stop_level
            assert r1.stats.n_checked == r2.stats.n_checked
            assert np.isnan(r2.stats.io_blocks)
            if r1.stats.n_checked < budget:
                np.testing.assert_array_equal(r1.ids, r2.ids)
            # top-1 distances agree (best candidate is identical)
            if r1.ids[0] >= 0 and r2.ids[0] >= 0:
                np.testing.assert_allclose(
                    r1.dists[0], r2.dists[0], rtol=1e-6
                )


def test_self_query_finds_itself(built):
    """A query that IS a data point must return it at distance ~0."""
    idx, _ = built
    for pid in (0, 100, 999):
        res = idx.search(idx.data[pid], weight_id=0, k=1)
        assert res.ids[0] == pid
        assert res.dists[0] < 1e-6


def test_io_accounting(built):
    idx, qs = built
    res = idx.search(qs.points[0], weight_id=int(qs.weight_ids[0]), k=5)
    st = res.stats
    assert st.io_blocks > 0
    assert st.n_checked <= 5 + int(np.ceil(idx.cfg.gamma * idx.n)) + 5
    assert st.n_collisions >= st.n_checked  # identify >= check
    # identify: 8-byte entries in 4 KB blocks; check: one block a point
    assert st.io_blocks == st.n_collisions / (BLOCK_BYTES / 8) + st.n_checked


@pytest.mark.parametrize("p", [1.0, 2.0], ids=["l1", "l2"])
def test_c2lsh_degeneration(p):
    """WLSH with |S| = 1 is exactly C2LSH (shared plumbing, Eqs. 4-5)."""
    data = make_dataset(n=1_500, d=16, seed=21)
    w = np.ones(16)
    cfg = PlanConfig(p=p, c=3, n=len(data), gamma_n=100.0)
    c2 = C2LSH(data, cfg, weight=w, seed=5)
    wl = WLSHIndex(data, w[None, :], cfg, tau=float("inf"), seed=5)
    assert len(wl.part.groups) == 1
    # identical plans: same beta, mu
    assert c2.part.groups[0].beta_group == wl.part.groups[0].beta_group
    np.testing.assert_allclose(
        c2.part.groups[0].mus, wl.part.groups[0].mus
    )
    q = data[7].astype(np.float32) + 1.5
    r1 = c2.query(q, k=3)
    r2 = wl.search(q, weight_id=0, k=3)
    np.testing.assert_array_equal(r1.ids, r2.ids)


@pytest.mark.parametrize("p", [1.0, 2.0], ids=["l1", "l2"])
def test_collision_threshold_reduction_cuts_io(p):
    """Sec 4.2.1: reduced mu identifies candidates earlier -> fewer blocks."""
    data = make_dataset(n=2_000, d=16, seed=31)
    weights = make_weight_set(size=6, d=16, n_subset=2, n_subrange=10, seed=32)
    cfg = PlanConfig(p=p, c=3, n=len(data), gamma_n=100.0)
    io = {}
    for red in (True, False):
        idx = WLSHIndex(data, weights, cfg, tau=_TAU[p], v=4, v_prime=4,
                        use_reduction=red, seed=7)
        qs = make_query_set(data, weights, n_query_points=6,
                            n_query_weights=2, seed=33)
        costs = [
            idx.search(q, weight_id=int(w), k=3).stats.io_blocks
            for q in qs.points for w in qs.weight_ids
        ]
        io[red] = float(np.mean(costs))
    assert io[True] <= io[False] * 1.25  # reduction must not blow up I/O


# ------------------------------------------------- bit parity with the JAX package


def _assert_same_result(got, want, where):
    assert got.ids.dtype == want.ids.dtype, where
    assert got.ids.tobytes() == want.ids.tobytes(), f"{where}: ids"
    assert got.dists.tobytes() == want.dists.tobytes(), f"{where}: dists"
    for f in dataclasses.fields(want.stats):
        a, b = getattr(got.stats, f.name), getattr(want.stats, f.name)
        assert type(a) is type(b) and a == b, f"{where}: {f.name} {a} != {b}"


@pytest.mark.parametrize("c", [None, 4], ids=["c-plan", "c-4"])
@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_search_matches_reference(p, c):
    n, d = 1_024, 16
    data = make_dataset(n=n, d=d, seed=41)
    weights = make_weight_set(size=8, d=d, n_subset=4, n_subrange=10,
                              seed=42)
    kw = dict(tau=_TAU[p], v=4, v_prime=4, seed=9)
    port = WLSHIndex(data, weights, PlanConfig(p=p, c=3, n=n), **kw)
    ref = JWLSHIndex(data, weights, JPlanConfig(p=p, c=3, n=n), **kw)
    rng = np.random.default_rng(3)
    near = data[rng.choice(n, 5, replace=False)] + rng.normal(0, 3.0, (5, d))
    far = rng.uniform(0, 10_000, (1, d))
    qs = np.concatenate([near, far]).astype(np.float32)
    for i, q in enumerate(qs):
        wid = int(i * 3 % len(weights))
        for k in (1, 5):
            _assert_same_result(
                port.search(q, weight_id=wid, k=k, c=c),
                ref.search(q, weight_id=wid, k=k, c=c),
                f"p={p} c={c} query {i} k={k}")
    for gi, built in port._built.items():
        if built._sorted is not None:
            want = ref._group(gi)
            got_codes, got_ids = built.sorted_tables()
            np.testing.assert_array_equal(got_codes, want.sorted_codes)
            np.testing.assert_array_equal(got_ids, want.sorted_ids)


@pytest.mark.parametrize("p", [2.0, 1.0])
def test_c2lsh_matches_reference(p):
    data = make_dataset(n=1_500, d=16, seed=21)
    w = np.linspace(1.0, 4.0, 16)
    c2 = C2LSH(data, PlanConfig(p=p, c=3, n=len(data)), weight=w, seed=5)
    ref = JC2LSH(data, JPlanConfig(p=p, c=3, n=len(data)), weight=w, seed=5)
    assert c2.beta_total == ref.beta_total
    rng = np.random.default_rng(8)
    for i, pid in enumerate(rng.choice(len(data), 4, replace=False)):
        q = data[pid] + rng.normal(0, 2.0, 16).astype(np.float32)
        _assert_same_result(c2.query(q, k=3), ref.query(q, k=3),
                            f"p={p} query {i}")
