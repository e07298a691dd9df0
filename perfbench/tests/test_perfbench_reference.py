"""The plain reference works out what the program's set-up derives.

Its planner, a frozen copy, gives the program's partition, member
parameters and families at both configurations' widths (the partition
needs no corpus, so this is cheap), and its dense search gives the
program's host oracle's answers at a small size.  Its bucket ids are
held at the width a configuration states: wrapped to int32 at 32, whole
at 64.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import inputs, spec
from perfbench.reference import planner, search
from perfbench.tests import tiny

BENCH = spec.load()
CONFIGS = [spec.cell(BENCH, w["name"]).config for w in BENCH["workloads"]]
CONFIGS = list({c["name"]: c for c in CONFIGS}.values()) + [tiny.CONFIG]


def _program_index(cfg, data, seed):
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex

    weights = inputs.weight_set(cfg["n_weights"], cfg["d"], cfg["n_subset"],
                                cfg["n_subrange"], cfg["weight_seed"])
    index = WLSHIndex(
        data, weights, PlanConfig(p=cfg["p"], c=cfg["c"], eps=cfg["eps"],
                                  gamma_n=cfg["gamma_n"], n=cfg["n"]),
        tau=cfg["tau"], value_range=cfg["value_range"], v=cfg["v"],
        v_prime=cfg["v_prime"], seed=seed)
    return weights, index


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_the_reference_plan_is_the_programs(cfg):
    from repro_torch.core.datagen import make_weight_set
    from repro_torch.core.families import sample_lp_family

    seed = inputs.base_seed(2**31 + 3)
    data = np.zeros((cfg["n"], 1), np.float32)  # the partition reads n only
    weights, index = _program_index(cfg, data, seed)
    np.testing.assert_array_equal(weights, make_weight_set(
        cfg["n_weights"], cfg["d"], n_subset=cfg["n_subset"],
        n_subrange=cfg["n_subrange"], seed=cfg["weight_seed"]))
    ref, fams = planner.plan(weights, cfg, cfg["n"], seed)
    part = index.part
    np.testing.assert_array_equal(ref.group_of, part.group_of)
    np.testing.assert_array_equal(ref.member_slot, part.member_slot)
    for gi, (rg, pg) in enumerate(zip(ref.groups, part.groups)):
        np.testing.assert_array_equal(rg.member_ids, pg.member_ids)
        np.testing.assert_array_equal(rg.betas, pg.betas)
        np.testing.assert_array_equal(rg.mus, index._effective_mus(pg))
        np.testing.assert_array_equal(rg.n_levels, pg.n_levels)
        np.testing.assert_array_equal(rg.r_min, pg.r_min_members)
        assert (rg.beta_group, rg.width) == (pg.beta_group, pg.width)
    for gi in (0, len(ref.groups) - 1):  # the sampled families
        pg = part.groups[gi]
        fam = sample_lp_family(
            d=cfg["d"], beta=pg.beta_group, p=cfg["p"], width=pg.width,
            center_weight=weights[pg.center_id], ratio_cap=pg.ratio_cap,
            c=cfg["c"], seed=seed + 7919 * gi)
        for key in ("proj", "b_int", "b_frac", "center_weight"):
            np.testing.assert_array_equal(fams[gi][key], getattr(fam, key))


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_the_reference_search_is_the_host_oracles(p):
    cfg = dict(tiny.CONFIG, p=p)
    seed = 2**31 + 11
    data = inputs.corpus(cfg["n"], cfg["d"], cfg["value_range"], seed, "cpu")
    weights, index = _program_index(cfg, data, inputs.base_seed(seed))
    rng = np.random.default_rng(0)
    wids = rng.integers(0, len(weights), 12)
    queries = (data[rng.integers(0, len(data), 12)]
               + rng.normal(0, 3.0, (12, cfg["d"]))).astype(np.float32)
    ref, fams = planner.plan(weights, cfg, cfg["n"], inputs.base_seed(seed))
    pts = torch.as_tensor(data)
    got = search.answer(ref, fams, pts, queries, wids, cfg["k"],
                        code_bits=32)  # the host oracle wraps as well
    for i, (q, w) in enumerate(zip(queries, wids)):
        want = index.search_dense(q, int(w), k=cfg["k"])
        assert got.stop[i] == want.stats.stop_level
        assert got.n_checked[i] == want.stats.n_checked
        np.testing.assert_array_equal(got.ids[i], want.ids)
        np.testing.assert_allclose(got.dists[i], want.dists, rtol=1e-12)
    exact = search.distances_of(pts, queries, weights[wids], got.ids, p)
    np.testing.assert_allclose(exact, got.dists, rtol=1e-12)


def _first_level(x, y, c, n_levels):
    """The first level at which ids ``x`` and ``y`` agree under ``// c**j``
    in Python's integers, ``n_levels + 1`` where they never do."""
    return next((j for j in range(n_levels + 1)
                 if x // c**j == y // c**j), n_levels + 1)


def test_the_first_level_is_found_at_the_stored_width():
    """A row at 2**31 + 5 and a query at 2**31 - 3 agree from level 3 on,
    as 64-bit ids say; stored in 32 bits the row wraps negative and never
    meets the query.  A query at -2**31 + 1 never meets the row at 64
    bits, but meets its wrapped id at level 3."""
    c, n_levels, wrap = 3, 22, 1 << 32
    row, queries = (1 << 31) + 5, [(1 << 31) - 3, -(1 << 31) + 1]
    want = {64: [_first_level(row, q, c, n_levels) for q in queries],
            32: [_first_level(row - wrap, q, c, n_levels) for q in queries]}
    assert want == {64: [3, n_levels + 1], 32: [n_levels + 1, 3]}
    for bits, dtype in search.DTYPE.items():
        codes_g = torch.tensor([[row]], dtype=torch.int64).to(dtype)
        qcodes = torch.tensor([[q] for q in queries], dtype=torch.int64)
        lf = search._first_frequent(codes_g, qcodes.to(dtype), 1, 1,
                                    n_levels, c, 1)
        assert lf[:, 0].tolist() == want[bits]


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_ids_at_32_bits_are_the_wrap_of_ids_at_64(p):
    cfg = dict(tiny.CONFIG, p=p)
    seed = 2**31 + 29
    weights = inputs.weight_set(cfg["n_weights"], cfg["d"], cfg["n_subset"],
                                cfg["n_subrange"], cfg["weight_seed"])
    _, fams = planner.plan(weights, cfg, cfg["n"], inputs.base_seed(seed))
    pts = torch.as_tensor(inputs.corpus(cfg["n"], cfg["d"],
                                        cfg["value_range"], seed, "cpu"))
    outside = 0
    for fam in fams:
        wide, narrow = search.codes(pts, fam, 64), search.codes(pts, fam, 32)
        assert (wide.dtype, narrow.dtype) == (torch.int64, torch.int32)
        wrapped = (wide + (1 << 31)) % (1 << 32) - (1 << 31)  # two's compl.
        assert torch.equal(narrow, wrapped.to(torch.int32))
        assert torch.equal(search.codes(pts, fam), narrow)  # 32 by default
        outside += int((wide != wrapped).sum())
    if p == 0.5:  # the heavy tail reaches past int32 even at this size
        assert outside > 0


def test_a_shift_of_every_id_that_the_stored_width_cannot_see():
    """Adding 2**32 to every id changes nothing that 32-bit ids hold, and
    adding 3**20 changes no level's agreement for 64-bit ids (L <= 20),
    though it puts ids past int32: so each width's answers stay put, and
    the corpus and the queries are wrapped alike."""
    cfg = tiny.CONFIG
    seed = 2**31 + 37
    data = inputs.corpus(cfg["n"], cfg["d"], cfg["value_range"], seed, "cpu")
    weights = inputs.weight_set(cfg["n_weights"], cfg["d"], cfg["n_subset"],
                                cfg["n_subrange"], cfg["weight_seed"])
    rng = np.random.default_rng(1)
    wids = rng.integers(0, len(weights), 12)
    queries = (data[rng.integers(0, len(data), 12)]
               + rng.normal(0, 3.0, (12, cfg["d"]))).astype(np.float32)
    ref, fams = planner.plan(weights, cfg, cfg["n"], inputs.base_seed(seed))
    assert max(int(g.n_levels.max()) for g in ref.groups) <= 20
    pts = torch.as_tensor(data)

    def answer(bits, shift):
        moved = [dict(f, b_int=f["b_int"].astype(np.int64) + shift)
                 for f in fams]
        return search.answer(ref, moved, pts, queries, wids, cfg["k"], bits)

    for bits, shift in ((32, 1 << 32), (64, 3**20)):
        base, moved = answer(bits, 0), answer(bits, shift)
        assert base.ids_outside_int32 == 0 < moved.ids_outside_int32
        for f in ("group", "stop", "n_checked", "ids", "dists"):
            np.testing.assert_array_equal(getattr(moved, f), getattr(base, f))
