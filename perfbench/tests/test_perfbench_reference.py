"""The plain reference works out what the program's set-up derives.

Its planner, a frozen copy, gives the program's partition, member
parameters and families at both configurations' widths (the partition
needs no corpus, so this is cheap), and its dense search gives the
program's host oracle's answers at a small size.
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


@pytest.mark.parametrize("p", [2.0, 1.0])
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
    got = search.answer(ref, fams, pts, queries, wids, cfg["k"])
    for i, (q, w) in enumerate(zip(queries, wids)):
        want = index.search_dense(q, int(w), k=cfg["k"])
        assert got.stop[i] == want.stats.stop_level
        assert got.n_checked[i] == want.stats.n_checked
        np.testing.assert_array_equal(got.ids[i], want.ids)
        np.testing.assert_allclose(got.dists[i], want.dists, rtol=1e-12)
    exact = search.distances_of(pts, queries, weights[wids], got.ids, p)
    np.testing.assert_allclose(exact, got.dists, rtol=1e-12)
