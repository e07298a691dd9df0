"""The index's convenience builders (``index.builder.fold_center_weight``,
``build_state``) and ``IndexConfig.gamma`` vs the JAX package.

* ``fold_center_weight`` bit for bit against the JAX package's for
  p in {2, 1, 0.5} families, and against ``GroupServingPlan.folded()``
  (one body).
* ``build_state`` on a one-rank (1, 1) CPU mesh (``launch.dryrun._mesh(
  "one", "cpu")``, in process), on the setup of
  ``tests/test_index_engine.py`` (n = 1,024, d = 16): the family fields and
  vectors bit for bit against JAX's ``build_state``; the codes inside
  ``ref.hash_code_window`` (device-encoded codes are held to the float64
  window, not to JAX's codes) and bit for bit against the port's
  ``make_build_step`` + ``distribute_state``; ``make_query_step`` over the
  state against ``WLSHIndex.search_dense`` (carried over from
  ``test_engine_matches_host_oracle``), and two builds bit-equal
  (``test_build_is_deterministic``).
* ``build_state`` asked for a CUDA mesh without a card raises.
* ``test_budget_derived_from_gamma`` (``tests/test_index_engine.py``),
  carried over to the port's ``IndexConfig``.

The 8-rank gloo run of ``build_state`` is in ``test_torch_index_mesh.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from repro.core.datagen import make_dataset as jmake_dataset
from repro.core.families import sample_lp_family as jsample_lp_family
from repro.index import IndexConfig as JIndexConfig
from repro.index import build_state as jbuild_state
from repro.index import fold_center_weight as jfold_center_weight
from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.distances import radius_bounds
from repro_torch.core.families import sample_lp_family
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.distributed.group_sharding import (distribute_state,
                                                    state_shardings)
from repro_torch.index import (IndexConfig, QueryState, build_state,
                               encode_queries, fold_center_weight,
                               make_build_step, make_query_step)
from repro_torch.kernels import ref

N, D = 1_024, 16
_FAMILY = ("proj", "b_int", "b_frac", "width")


@pytest.fixture(scope="module")
def setup():
    data = make_dataset(n=N, d=D, seed=41)
    np.testing.assert_array_equal(data, jmake_dataset(n=N, d=D, seed=41))
    weights = make_weight_set(size=6, d=D, n_subset=2, n_subrange=10, seed=42)
    cfg = PlanConfig(p=2.0, c=3, n=len(data), gamma_n=100.0)
    host = WLSHIndex(data, weights, cfg, tau=500.0, v=4, v_prime=4, seed=9)
    return data, host


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) mesh over a one-rank "fake" group in this process, taken
    down after the module if it started it (no later test may meet the
    group)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    started = not dist.is_initialized()
    try:
        yield dryrun._mesh("one", "cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _icfg(host, built, k: int = 5, q_batch: int = 4) -> IndexConfig:
    return IndexConfig(n=N, d=D, beta=built.fam.beta, q_batch=q_batch, k=k,
                       c=int(round(host.cfg.c)),
                       n_levels=int(np.max(built.plan.n_levels)),
                       p=host.cfg.p, gamma_n=host.cfg.gamma_n)


def _group(host):
    return host._group(int(host.part.group_of[0]))


@pytest.fixture(scope="module")
def built(setup, mesh):
    data, host = setup
    b = _group(host)
    icfg = _icfg(host, b)
    return icfg, b, build_state(mesh, icfg, data, b.fam)


def _local(x) -> torch.Tensor:
    return x.to_local() if hasattr(x, "to_local") else x


def _np(x) -> np.ndarray:
    return _local(x).numpy()


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_fold_center_weight_matches_jax_and_the_plan(p):
    rng = np.random.default_rng(int(10 * p))
    w = rng.uniform(1.0, 10.0, D)
    r_min, r_max = radius_bounds(w, 100.0, p)
    args = (D, 48, p, r_min, w, r_max / r_min, 3)
    fam = sample_lp_family(*args, seed=5)
    got = fold_center_weight(fam)
    want = jfold_center_weight(jsample_lp_family(*args, seed=5))
    assert sorted(got) == sorted(want) == sorted(_FAMILY)
    for k in _FAMILY:
        g, w_ = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w_.dtype, k
        np.testing.assert_array_equal(g, w_, err_msg=k)
    plan = _plan_for(fam)
    for k, v in plan.folded().items():
        assert np.asarray(v).dtype == np.asarray(got[k]).dtype, k
        np.testing.assert_array_equal(v, got[k], err_msg=k)


def _plan_for(fam):
    from repro_torch.core.serving_plan import GroupServingPlan

    one = np.zeros(1, np.int32)
    return GroupServingPlan(
        group_id=0, center_id=0, beta_group=fam.beta, width=fam.width,
        levels_cap=fam.levels_cap, member_ids=one, beta_members=one,
        mu_members=one, r_min_members=np.ones(1), n_levels_members=one,
        proj=fam.proj, b_int=fam.b_int, b_frac=fam.b_frac,
        center_weight=fam.center_weight, p=fam.p)


def test_build_state_family_and_vectors_match_jax(setup, built):
    data, host = setup
    icfg, b, state = built
    jcfg = JIndexConfig(n=N, d=D, beta=b.fam.beta, q_batch=4, k=5,
                        c=icfg.c, n_levels=icfg.n_levels, p=icfg.p,
                        block_n=256, gamma_n=icfg.gamma_n,
                        vec_dtype="float32", use_pallas=False)
    want = jbuild_state(jax.make_mesh((1, 1), ("data", "model")), jcfg,
                        data, b.fam)
    for k in _FAMILY + ("points",):
        g, w_ = _np(getattr(state, k)), np.asarray(getattr(want, k))
        assert g.dtype == w_.dtype and g.shape == w_.shape, k
        np.testing.assert_array_equal(g, w_, err_msg=k)
    assert state.n_valid == int(want.n_valid) == N
    assert isinstance(state.n_valid, int)
    # the layout state_shardings gives: rows sharded, the family replicated
    sh = state_shardings(state.codes.device_mesh, icfg)
    for k in ("codes", "points") + _FAMILY:
        assert tuple(getattr(state, k).placements) == tuple(
            getattr(sh, k).placements), k


def test_build_state_codes_lie_in_the_float64_window(setup, built):
    data, _ = setup
    _, _, state = built
    x = torch.from_numpy(data.astype(np.float32))
    proj, b_int, b_frac = (_local(getattr(state, k))
                           for k in ("proj", "b_int", "b_frac"))
    lo, hi = ref.hash_code_window(x, proj, b_frac, torch.ones(D), 1.0)
    v = ref.unbias_codes(_local(state.codes), b_int)
    assert int(((v < lo) | (v > hi)).sum()) == 0


def test_build_state_equals_the_hand_assembled_state(setup, mesh, built):
    data, _ = setup
    icfg, b, state = built
    fam = b.fam  # folded by hand, apart from fold_center_weight
    folded = dict(
        proj=torch.from_numpy((fam.proj.astype(np.float64)
                               * fam.center_weight[:, None] / fam.width
                               ).astype(np.float32)),
        b_int=torch.from_numpy(fam.b_int), b_frac=torch.from_numpy(fam.b_frac),
        width=torch.tensor(1.0))
    codes, vecs = make_build_step(mesh, icfg)(
        torch.from_numpy(data.astype(np.float32)), folded["proj"],
        folded["b_int"], folded["b_frac"])
    hand = distribute_state(QueryState(
        codes=codes.full_tensor(), points=vecs.full_tensor(),
        n_valid=len(data), **folded), state_shardings(mesh, icfg))
    for k in ("codes", "points") + _FAMILY:
        a, h = getattr(state, k), getattr(hand, k)
        assert tuple(a.placements) == tuple(h.placements), k
        assert torch.equal(_local(a), _local(h)), k
    assert state.n_valid == hand.n_valid


def _member_queries(host, b, seed: int):
    wids = [int(w) for w in b.plan.member_ids[:4]]
    rng = np.random.default_rng(seed)
    data = host.data
    qpts = data[rng.choice(len(data), len(wids), replace=False)].astype(
        np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    q_weight = np.stack([host.weights[w] for w in wids]).astype(np.float32)
    mus, r_mins, betas, levels = [], [], [], []
    for w in wids:
        _, slot, beta_i, mu_i = host._member_params(w)
        mus.append(mu_i)
        r_mins.append(b.plan.r_min_members[slot])
        betas.append(beta_i)
        levels.append(int(b.plan.n_levels[slot]))
    return wids, qpts, q_weight, dict(
        mu=torch.tensor(mus, dtype=torch.int32),
        r_min=torch.tensor(r_mins, dtype=torch.float32),
        beta_q=torch.tensor(betas, dtype=torch.int32),
        levels_q=torch.tensor(levels, dtype=torch.int32))


def test_engine_over_build_state_matches_host_oracle(setup, mesh, built):
    data, host = setup
    icfg, b, state = built
    wids, qpts, q_weight, meta = _member_queries(host, b, seed=43)
    local = QueryState(**{k: _local(getattr(state, k)) for k in (
        "codes", "points") + _FAMILY}, n_valid=state.n_valid)
    q = torch.from_numpy(qpts)
    dists, ids, stop, n_checked = (_np(o) for o in make_query_step(
        mesh, icfg)(state, q, encode_queries(local, q),
                    torch.from_numpy(q_weight), meta["mu"], meta["r_min"],
                    meta["beta_q"], meta["levels_q"]))
    for qi, wid in enumerate(wids):
        want = host.search_dense(qpts[qi], weight_id=wid, k=icfg.k)
        assert stop[qi] == want.stats.stop_level, qi
        assert n_checked[qi] == want.stats.n_checked, qi
        np.testing.assert_array_equal(ids[qi], want.ids, err_msg=str(qi))
        assert dists[qi][0] <= host.cfg.c * max(want.dists[0], 1e-9) + 1e-6


def test_build_is_deterministic(setup, mesh, built):
    data, _ = setup
    icfg, b, s1 = built
    s2 = build_state(mesh, icfg, data, b.fam)
    for k in ("codes", "points") + _FAMILY:
        assert torch.equal(_local(getattr(s1, k)), _local(getattr(s2, k))), k
    # the device encode against the host planner's float64 codes: rare
    # one-off flips at float32-vs-float64 floor boundaries
    codes = _np(s1.codes)
    assert np.mean(codes != b.codes) < 2e-2
    assert np.max(np.abs(codes.astype(np.int64) - b.codes)) <= 1


def test_build_state_on_a_cuda_mesh_needs_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the chip run holds this path")
    data, host = setup
    b = _group(host)

    class CudaMesh:  # all build_state reads before it raises
        device_type = "cuda"

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_state(CudaMesh(), _icfg(host, b), data, b.fam)


# carried over from tests/test_index_engine.py


def test_budget_derived_from_gamma():
    # paper default: budget = k + ceil(gamma * n) with gamma = gamma_n / n
    cfg = IndexConfig(n=2_000, k=7, gamma_n=100.0)
    assert cfg.gamma == 100.0 / 2_000
    assert cfg.budget == 7 + 100
    cfg = IndexConfig(n=1 << 30, k=10, gamma_n=100.0)
    assert cfg.budget == 110
    # explicit override wins (the practical choice at 1B points)
    cfg = IndexConfig(n=1 << 30, k=10, budget_override=4096)
    assert cfg.budget == 4096
    # engine and host planner agree by construction
    pcfg = PlanConfig(n=4_000, gamma_n=100.0)
    icfg = IndexConfig(n=4_000, k=5, gamma_n=pcfg.gamma_n)
    assert icfg.budget == 5 + int(np.ceil(pcfg.gamma * pcfg.n))
    assert icfg.gamma == JIndexConfig(n=4_000, k=5, gamma_n=100.0).gamma
