"""The port's query step vs the JAX package's ``make_query_step``.

One table group of a plan exported by the reference planner, its state
built by both packages from the plan's host codes at a row capacity above
the corpus (a dead tail the step must mask), and the same host-encoded
query batch through both steps.  ``stop``, ``n_checked`` and ids must be
equal; distances agree to rtol 1e-6 after the exact float32 re-rank (the
two packages sum the d coordinates in different orders).
"""

from __future__ import annotations

import dataclasses

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
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.index import (
    IndexConfig,
    QueryStepCache,
    build_group_state,
    pad_beta,
    pad_cols,
    pad_levels,
)
from repro_torch.index.engine import _topk_rows

_TAU = {2.0: 500.0, 1.0: 1_000.0, 0.5: 2_000.0}
_N, _D, _Q, _K = 1_024, 16, 4, 5
_CAP = _N + 128  # row capacity above the corpus: a dead tail


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def group(request):
    p = request.param
    data = make_dataset(n=_N, d=_D, seed=41)
    weights = make_weight_set(size=8, d=_D, n_subset=4, n_subrange=10,
                              seed=42)
    host = WLSHIndex(data, weights, PlanConfig(p=p, c=3, n=_N),
                     tau=_TAU[p], v=4, v_prime=4, seed=9)
    jplan = host.export_serving_plan()
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan)}
    fields["groups"] = [{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(g)} for g in jplan.groups]
    plan = ServingPlan.from_arrays(fields)
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    g = plan.groups[gi]
    kw = dict(n=_CAP, d=_D, beta=pad_beta(g.beta_group), q_batch=_Q, k=_K,
              c=3, n_levels=pad_levels(g.n_levels_max), p=p,
              gamma_n=plan.gamma_n, vec_dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jcfg = JIndexConfig(use_pallas=False, block_n=128, **kw)
    jstate = jbuild_group_state(mesh, jcfg, data, jplan.groups[gi])
    jstep = make_query_step(mesh, jcfg)

    rng = np.random.default_rng(43)
    wids = np.resize(g.member_ids, _Q)
    qpts = data[rng.choice(_N, _Q, replace=False)]
    qpts = (qpts + rng.normal(0, 3.0, qpts.shape)).astype(np.float32)
    slots = plan.member_slot[wids]
    inputs = dict(
        queries=qpts,
        codes_q=pad_cols(g.encode_host(qpts), kw["beta"]).astype(np.int32),
        q_weight=plan.weights[wids].astype(np.float32),
        mu=g.mu_members[slots].astype(np.int32),
        r_min=g.r_min_members[slots].astype(np.float32),
        beta_q=g.beta_members[slots].astype(np.int32),
        levels_q=g.n_levels_members[slots].astype(np.int32),
    )
    want = [np.asarray(x) for x in jstep(jstate, *inputs.values())]
    return dict(p=p, data=data, plan=plan, gi=gi, kw=kw, inputs=inputs,
                want=want, host=host, wids=wids)


def _port_step(group, use_kernels):
    cfg = IndexConfig(use_kernels=use_kernels, **group["kw"])
    state = build_group_state(cfg, group["data"],
                              group["plan"].groups[group["gi"]],
                              device="cpu")
    assert state.n_valid == _N and state.codes.shape[0] == _CAP
    step = QueryStepCache().get("cpu", cfg)
    out = step(state, *(torch.from_numpy(v) for v in group["inputs"].values()))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("use_kernels", ["on", "off"])
def test_query_step_matches_jax(group, use_kernels):
    dists, ids, stop, chk = _port_step(group, use_kernels)
    jd, ji, js, jc = group["want"]
    np.testing.assert_array_equal(stop, js)
    np.testing.assert_array_equal(chk, jc)
    np.testing.assert_array_equal(ids, ji)
    np.testing.assert_allclose(dists, jd, rtol=1e-6)
    assert (ids >= 0).any()


@pytest.mark.parametrize("shards", [1, 4])
def test_fused_step_equals_the_unfused_oracle(group, shards):
    """The fused-plain step (one scan: pass 1 keeps each (query, row)'s
    level and distance, pass 2 masks them) answers as the unfused oracle,
    which scans twice, bit for bit: on one device and as a device list of
    ``shards`` shards, each shard's carry on its device."""
    want = _port_step(group, "off")
    cfg = IndexConfig(use_kernels="on", n_shards=shards, **group["kw"])
    g = group["plan"].groups[group["gi"]]
    state = build_group_state(cfg, group["data"], g,
                              ("cpu",) * shards if shards > 1 else "cpu")
    got = QueryStepCache().get("cpu", cfg)(
        state, *(torch.from_numpy(v) for v in group["inputs"].values()))
    for name, a, b in zip(("dists", "ids", "stop", "n_checked"), got, want):
        a = np.asarray(a)
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)


def test_query_step_matches_search_dense(group):
    dists, ids, stop, chk = _port_step(group, "on")
    for qi, wid in enumerate(group["wids"]):
        want = group["host"].search_dense(group["inputs"]["queries"][qi],
                                          weight_id=int(wid), k=_K)
        assert stop[qi] == want.stats.stop_level
        assert chk[qi] == want.stats.n_checked
        np.testing.assert_array_equal(ids[qi], want.ids.astype(np.int32))


def test_state_bytes_match_the_config_and_the_reference(group):
    cfg = IndexConfig(**group["kw"])
    state = build_group_state(cfg, group["data"],
                              group["plan"].groups[group["gi"]],
                              device="cpu")
    assert cfg.state_nbytes == state.nbytes + 4  # + the n_valid scalar
    jcfg = JIndexConfig(use_pallas=False, **group["kw"])
    assert cfg.state_nbytes == jcfg.state_nbytes
    assert (state.codes[_N:] == np.iinfo(np.int32).max // 2).all()
    assert (state.points[_N:] == 0).all()


def test_step_cache_counts_distinct_configs():
    cache = QueryStepCache()
    a = IndexConfig(n=64, d=4, beta=32)
    b = IndexConfig(n=64, d=4, beta=64)
    assert cache.get("cpu", a) is cache.get("cpu", a)
    cache.get("cpu", dataclasses.replace(a))
    cache.get("cpu", b)
    assert cache.n_compiled == 2 and len(cache) == 2


def test_topk_breaks_ties_toward_the_lower_row():
    inf = float("inf")
    scores = torch.tensor([[3.0, 1.0, 1.0, inf, 0.5, 1.0],
                           [inf, inf, 2.0, inf, inf, inf]])
    vals, ids = _topk_rows(scores, 4)
    assert ids.tolist() == [[4, 1, 2, 5], [2, -1, -1, -1]]
    assert vals[1, 1:].isinf().all()
    vals, ids = _topk_rows(scores[:, :2], 3)  # fewer rows than k
    assert ids.tolist() == [[1, 0, -1], [-1, -1, -1]]


def test_unsupported_options_raise():
    """A sharded config needs a sharded state (an unsharded one raises);
    bfloat16 storage is served (a state built and queried), and any
    other vector dtype still raises."""
    from repro_torch.index import query_step

    cfg = IndexConfig(n=8, d=2, beta=32, n_shards=2)
    with pytest.raises(ValueError, match="needs a ShardedQueryState"):
        query_step(None, *([None] * 7), cfg=cfg)
    for bad in ("float16", "int8"):
        with pytest.raises(NotImplementedError):
            query_step(None, *([None] * 7),
                       cfg=IndexConfig(n=8, d=2, beta=32, vec_dtype=bad))
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.index import build_group_state, pad_beta

    data = make_dataset(n=128, d=8, seed=3)
    weights = make_weight_set(size=4, d=8, n_subset=2, n_subrange=10, seed=4)
    plan = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=128),
                     tau=500.0, v=4, v_prime=4,
                     seed=5).export_serving_plan()
    g = plan.groups[0]
    bf16 = IndexConfig(n=128, d=8, beta=pad_beta(g.beta_group), q_batch=2,
                       k=3, n_levels=16, vec_dtype="bfloat16")
    state = build_group_state(bf16, data, g, device="cpu")
    assert state.points.dtype == torch.bfloat16
    q = torch.from_numpy(data[:2])
    codes = torch.from_numpy(np.ascontiguousarray(
        np.pad(g.encode_host(data[:2]), ((0, 0), (0, bf16.beta
                                                  - g.beta_group))),
        np.int32))
    w = torch.from_numpy(plan.weights[g.member_ids[:1]].repeat(2, 0))
    d, ids, stop, chk = query_step(
        state, q, codes, w.float(),
        torch.tensor([g.mu_members[0]] * 2, dtype=torch.int32),
        torch.tensor([g.r_min_members[0]] * 2, dtype=torch.float32),
        torch.tensor([g.beta_members[0]] * 2, dtype=torch.int32),
        torch.tensor([g.n_levels_members[0]] * 2, dtype=torch.int32),
        cfg=bf16)
    assert ids[:, 0].tolist() == [0, 1]  # each row finds itself
    with pytest.raises(NotImplementedError):
        build_group_state(dataclasses.replace(bf16, vec_dtype="float16"),
                          data, g, device="cpu")
