"""The port's device-encoded path (plain torch, on the CPU) vs the JAX package.

A plan exported without host codes (``include_codes=False``) is encoded on
the device: the group states by ``build_group_state`` and the queries by
``encode_queries``, both through ``ops.hash_encode`` (the CUDA kernel on the
card, its plain version ``ref.hash_encode_ref`` here).  Float32 codes are
held to the float64 window of ``ref.hash_code_window``: with u the float64
value of ``(x o w) @ A / width + b_frac``, S = sum |x_i w_i A_ij| / width +
|b_frac| and E = 16 * 2**-24 * S, ``code - b_int`` (wrapped to int32) lies
in [floor(u - E), floor(u + E)] clamped to int32, which leaves INT_MAX alone
where u >= 2**31 + E and INT_MIN alone where u < -2**31 - E.

Plans: the test-sized ones, n = 4,096, d = 24, |S| = 8 (``make_weight_set(8,
24, n_subset=4, n_subrange=10, seed=42)``), c = 3, v = v' = 4, tau = 500,
1,000 and 2,000 for p = 2, 1 and 0.5.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.datagen import make_dataset, make_weight_set
from repro.core.params import PlanConfig
from repro.core.wlsh import WLSHIndex
from repro.index import IndexConfig as JIndexConfig
from repro.index import make_query_step
from repro.index.builder import build_group_state as jbuild_group_state
from repro.index.engine import encode_queries as jencode_queries
from repro.kernels import ref as jref
from repro_torch.core.families import sample_lp_family
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.index import (
    IndexConfig,
    QueryStepCache,
    build_group_state,
    encode_queries,
    pad_beta,
    pad_levels,
)
from repro_torch.kernels import ref
from repro_torch.serving import RetrievalService, ServiceConfig

_TAU = {2.0: 500.0, 1.0: 1_000.0, 0.5: 2_000.0}
_N, _D, _Q, _K = 4_096, 24, 4, 5
_CAP = _N + 100  # row capacity above the corpus: encoded zero rows


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_plan(jplan) -> ServingPlan:
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan)}
    fields["groups"] = [{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(g)} for g in jplan.groups]
    return ServingPlan.from_arrays(fields)


@functools.lru_cache(maxsize=None)
def _plan(p: float) -> dict:
    data = make_dataset(n=_N, d=_D, seed=41)
    weights = make_weight_set(size=8, d=_D, n_subset=4, n_subrange=10,
                              seed=42)
    host = WLSHIndex(data, weights, PlanConfig(p=p, c=3, n=_N),
                     tau=_TAU[p], v=4, v_prime=4, seed=9)
    jplan = host.export_serving_plan(include_codes=False)
    assert all(g.codes is None for g in jplan.groups)
    return dict(p=p, data=data, jplan=jplan, plan=_port_plan(jplan))


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def plan(request):
    return _plan(request.param)


def _outside(codes, x, proj, b_int, b_frac, w, width):
    """Entries of ``codes`` outside the float64 window."""
    lo, hi = ref.hash_code_window(_t(x), _t(proj), _t(b_frac), _t(w), width)
    v = ref.unbias_codes(_t(codes), _t(b_int))
    return int(((v < lo) | (v > hi)).sum())


def test_hash_encode_saturates_like_jax():
    """Repair 1: where |u| >= 2**31 + E the plain version equals XLA's
    saturating convert (INT_MAX / INT_MIN, then + b_int wrapping).  The
    p = 0.5 plan's Cauchy-like projections reach |u| ~ 1e11 at d = 24."""
    plan = _plan(0.5)
    x = plan["data"].astype(np.float32)
    n_sat = 0
    for g in plan["plan"].groups:
        f = g.folded()
        ones = np.ones(_D, np.float32)
        got = ref.hash_encode_ref(_t(x), _t(f["proj"]), _t(f["b_int"]),
                                  _t(f["b_frac"]), _t(ones), 1.0).numpy()
        want = np.asarray(jref.hash_encode_ref(x, f["proj"], f["b_int"],
                                               f["b_frac"], ones, 1.0))
        x64, a64 = x.astype(np.float64), f["proj"].astype(np.float64)
        bf = f["b_frac"].astype(np.float64)
        u = x64 @ a64 + bf
        e = 16 * 2.0**-24 * (np.abs(x64) @ np.abs(a64) + np.abs(bf))
        sat = np.abs(u) >= 2.0**31 + e
        n_sat += int(sat.sum())
        np.testing.assert_array_equal(got[sat], want[sat])
        assert _outside(got, x, f["proj"], f["b_int"], f["b_frac"], ones,
                        1.0) == 0
    assert n_sat > 10_000


@pytest.mark.parametrize("d", [24, 400])
def test_hash_encode_is_row_independent(d):
    """Repair 2: a row's codes do not depend on how many rows share the
    call (1-, 4- and 64-row calls against the full one)."""
    rng = np.random.default_rng(d)
    cw = rng.uniform(1, 10, d).astype(np.float32)
    fam = sample_lp_family(d, 64, 1.0, 40.0, cw, 500.0, 3, seed=d)
    x = _t(rng.uniform(0, 10_000, (100, d)).astype(np.float32))
    args = [_t(a) for a in (fam.proj, fam.b_int, fam.b_frac, cw)]
    full = ref.hash_encode_ref(x, *args, fam.width)
    for rows in (1, 4, 64):
        for lo in (0, 3, 100 - rows):
            part = ref.hash_encode_ref(x[lo : lo + rows], *args, fam.width)
            assert torch.equal(part, full[lo : lo + rows]), (rows, lo)


def _group(plan):
    return int(np.argmax([g.n_members for g in plan["plan"].groups]))


def _configs(plan, gi):
    g = plan["plan"].groups[gi]
    kw = dict(n=_CAP, d=_D, beta=pad_beta(g.beta_group), q_batch=_Q, k=_K,
              c=3, n_levels=pad_levels(g.n_levels_max), p=plan["p"],
              gamma_n=plan["plan"].gamma_n, vec_dtype="float32")
    return kw, JIndexConfig(use_pallas=False, block_n=_CAP, **kw)


@pytest.fixture(scope="module")
def jax_state(plan):
    gi = _group(plan)
    kw, jcfg = _configs(plan, gi)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstate = jbuild_group_state(mesh, jcfg, plan["data"],
                                plan["jplan"].groups[gi])
    return dict(gi=gi, kw=kw, jcfg=jcfg, mesh=mesh, jstate=jstate)


def test_device_built_state_matches_jax(plan, jax_state):
    gi, kw, jstate = jax_state["gi"], jax_state["kw"], jax_state["jstate"]
    state = build_group_state(IndexConfig(**kw), plan["data"],
                              plan["plan"].groups[gi], device="cpu")
    for name in ("points", "proj", "b_int", "b_frac"):
        mine = getattr(state, name).numpy()
        theirs = np.asarray(getattr(jstate, name))
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.tobytes() == theirs.tobytes(), name
    assert state.n_valid == int(jstate.n_valid) == _N
    ones = np.ones(_D, np.float32)
    fam = [state.proj.numpy(), state.b_int.numpy(), state.b_frac.numpy()]
    x = state.points.numpy()
    codes = state.codes.numpy()
    assert _outside(codes, x, fam[0], fam[1], fam[2], ones, 1.0) == 0
    assert _outside(np.asarray(jstate.codes), x, *fam, ones, 1.0) == 0
    assert (codes[_N:] == fam[1][None, :]).all()  # encoded zero rows


def _queries(plan, gi):
    g = plan["plan"].groups[gi]
    rng = np.random.default_rng(43)
    wids = np.resize(g.member_ids, _Q)
    qpts = plan["data"][rng.choice(_N, _Q, replace=False)]
    qpts = (qpts + rng.normal(0, 3.0, qpts.shape)).astype(np.float32)
    slots = plan["plan"].member_slot[wids]
    return qpts, dict(
        q_weight=plan["plan"].weights[wids].astype(np.float32),
        mu=g.mu_members[slots].astype(np.int32),
        r_min=g.r_min_members[slots].astype(np.float32),
        beta_q=g.beta_members[slots].astype(np.int32),
        levels_q=g.n_levels_members[slots].astype(np.int32),
    )


@pytest.mark.parametrize("use_kernels", ["on", "off"])
def test_query_step_matches_jax_on_jax_codes(plan, jax_state, use_kernels):
    """The port's step on JAX's device-built codes and JAX's query codes
    gives JAX's stop, n_checked and ids: everything but the encoder."""
    gi, kw, jstate = jax_state["gi"], jax_state["kw"], jax_state["jstate"]
    qpts, rest = _queries(plan, gi)
    codes_q = np.asarray(jencode_queries(jstate, qpts))
    jstep = make_query_step(jax_state["mesh"], jax_state["jcfg"])
    want = [np.asarray(v) for v in jstep(jstate, qpts, codes_q,
                                         *rest.values())]
    cfg = IndexConfig(use_kernels=use_kernels, **kw)
    state = build_group_state(cfg, plan["data"], plan["plan"].groups[gi],
                              device="cpu")
    state = dataclasses.replace(state, codes=_t(jstate.codes))
    step = QueryStepCache().get("cpu", cfg)
    got = [np.asarray(v) for v in step(state, _t(qpts), _t(codes_q),
                                       *(_t(v) for v in rest.values()))]
    np.testing.assert_array_equal(got[2], want[2])  # stop
    np.testing.assert_array_equal(got[3], want[3])  # n_checked
    np.testing.assert_array_equal(got[1], want[1])  # ids
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("q_batch", [1, 4])
def test_service_without_codes_finds_itself(plan, q_batch):
    """Counterpart of the JAX service's device-encoding test: a corpus row
    asked as a query is its own rank-0 answer, because its query codes
    equal its stored codes bit for bit."""
    svc = RetrievalService(plan["plan"], plan["data"], cfg=ServiceConfig(
        k=_K, q_batch=q_batch, device="cpu"))
    rows = np.arange(0, _N, 331)
    wids = np.random.default_rng(13).integers(0, 8, len(rows))
    res = svc.query(plan["data"][rows].astype(np.float32), wids)
    np.testing.assert_array_equal(res.ids[:, 0], rows)
    assert np.all(res.dists[:, 0] < 1e-3)
    for gi in np.unique(res.group_ids):
        with svc.state_cache.lease(int(gi)) as st:
            assert torch.equal(encode_queries(st, plan["data"][rows]),
                               st.codes[rows])
