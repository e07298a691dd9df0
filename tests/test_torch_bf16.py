"""bfloat16 vector storage in the port vs the JAX package.

The same plan (``conftest.build_parity_service``'s, carried over), the
same data and queries go through both packages with
``vec_dtype="bfloat16"``, per p in {2, 1, 0.5}:

* every group state's stored bits equal the JAX build's
  (``points.astype(bfloat16)``, round to nearest even) and a host
  round-to-nearest-even of the float32 rows; the codes are the float32
  codes; ``IndexConfig.state_nbytes`` prices the built state;
* stop levels, n_checked and ids equal the JAX ``RetrievalService``'s on
  the fused and the unfused route, distances to rtol 1e-6;
* offload -> restore keeps the bfloat16 bytes, and a paged service
  answers as the unpaged one;
* a compaction into a bfloat16 state equals a fresh JAX union build
  (``build_group_state(extra_points=, extra_codes=)``);
* rows that differ in float32 but round to the same bfloat16 row tie,
  and the tie goes to the lower row, as ``lax.top_k`` breaks it.

numpy has no bfloat16: the JAX package's ``ml_dtypes`` arrays are read
through ``.view(np.uint16)`` and the port's tensors through
``.view(torch.int16)``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_serving import (build_port_parity, jax_service, port_plan,
                            port_service)
from conftest import build_parity_service
from repro.index.builder import build_group_state as jax_build
from repro.index.builder import seal_segment as jax_seal
from repro_torch.index.builder import (StatePager, build_group_state,
                                       offload_state, restore_state)

K = 5
BF16 = dict(k=K, q_batch=4, vec_dtype="bfloat16")


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5],
                ids=lambda p: f"p{p}")
def parity_setup(request):
    """(p, data, weights, host, plan, svc) of the port per exponent."""
    return build_port_parity(request.param)


def _queries(data, weights, n, seed=71):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, len(weights), n)
    q = data[rng.choice(len(data), n, replace=False)]
    return (q + rng.normal(0, 3.0, q.shape)).astype(np.float32), wids


def _bits(t) -> np.ndarray:
    """uint16 bits of a bfloat16 torch tensor or ml_dtypes array."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _rne_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even (finite values)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _assert_answers(got, want):
    for f in ("ids", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-6)


def test_stored_bits_codes_and_nbytes_equal_jax(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    psvc = port_service(p, **BF16)
    jsvc = jax_service(p, **BF16)
    for gi in range(plan.n_groups):
        cfg = psvc.group_config(gi)
        got = build_group_state(cfg, data, plan.groups[gi], device="cpu")
        want = jax_build(jsvc.mesh, jsvc.batcher.group_config(gi), data,
                         build_parity_service(p)[4].groups[gi])
        assert got.points.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got.points), _bits(want.points))
        np.testing.assert_array_equal(_bits(got.points)[: plan.n],
                                      _rne_bits(data))
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        # the JAX state also keeps n_valid on the device (4 bytes)
        assert got.nbytes + 4 == cfg.state_nbytes
    psvc.warmup()
    assert psvc.resident_bytes == sum(
        psvc.group_config(gi).state_nbytes for gi in range(plan.n_groups))


@pytest.mark.parametrize("route", ["on", "off"])
def test_service_matches_jax_service(parity_setup, route):
    p, data, weights, host, plan, f32 = parity_setup
    qpts, wids = _queries(data, weights, 24)
    got = port_service(p, use_kernels=route, **BF16).query(qpts, wids)
    want = jax_service(p, use_pallas="auto" if route == "on" else "off",
                       **BF16).query(qpts, wids)
    _assert_answers(got, want)
    # the codes come from the float32 rows: the candidate sets are the
    # float32 service's except where a rounded distance moves a level
    ref = f32.query(qpts, wids)
    assert np.mean(got.stop_levels == ref.stop_levels) >= 0.9


def test_offload_restore_keeps_the_bf16_bytes(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    svc = port_service(p, **BF16)
    with svc.state_cache.lease(0) as st:
        host_copy = offload_state(st)
        assert host_copy.points.dtype == torch.bfloat16
        back = restore_state(host_copy, "cpu")
        pager = StatePager("cpu")
        pager.adopt(0, st)
        paged = pager.restore(0, pager.offload(st))
        for other in (back, paged):
            assert other.n_valid == st.n_valid
            for name in ("codes", "points", "proj", "b_int", "b_frac",
                         "width"):
                a, b = getattr(other, name), getattr(st, name)
                assert a.dtype == b.dtype and torch.equal(a, b), name
    qpts, wids = _queries(data, weights, 16, seed=72)
    want = svc.query(qpts, wids)
    small = port_service(p, max_resident_groups=1, **BF16)
    small.warmup()  # every state built, all but the last offloaded
    got = small.query(qpts, wids)
    assert small.cache_summary()["n_restores"] > 0
    for f in ("ids", "dists", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_compaction_into_bf16_state_equals_jax_union_build(parity_setup):
    p, data, weights, host, plan, _ = parity_setup
    reserve = 16
    svc = port_service(p, delta_reserve_rows=reserve, delta_seal_rows=4,
                       **BF16)
    jsvc = jax_service(p, delta_reserve_rows=reserve, **BF16)
    jplan = build_parity_service(p)[4]
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    wid = int(plan.groups[gi].member_ids[0])
    rng = np.random.default_rng(73)
    # fresh rows past the corpus range, with float32 bits bfloat16 drops
    vecs = (data[rng.choice(plan.n, 9)] + 10_000.0
            + rng.uniform(0, 1, (9, plan.d))).astype(np.float32)
    pids = [svc.insert(v, wid) for v in vecs]
    assert svc.compact() == len(vecs)
    with svc.state_cache.lease(gi) as got:
        jcfg = jsvc.batcher.group_config(gi)
        want = jax_build(jsvc.mesh, jcfg, data, jplan.groups[gi],
                         extra_points=vecs,
                         extra_codes=jax_seal(jcfg, jplan.groups[gi], vecs))
        assert got.n_valid == int(want.n_valid) == plan.n + len(vecs)
        np.testing.assert_array_equal(_bits(got.points), _bits(want.points))
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        assert not np.array_equal(
            got.points[plan.n: plan.n + len(vecs)].float().numpy(), vecs)
    res = svc.query(vecs, [wid] * len(vecs))  # through the kernels' path
    np.testing.assert_array_equal(res.ids[:, 0], pids)


def _paired_rows(seed: int, n_pairs: int, d: int) -> np.ndarray:
    """Rows 2i and 2i+1 differ in float32 (one ulp) but round to the same
    bfloat16 row (2i is bfloat16-exact)."""
    from repro.core.datagen import make_dataset

    base = make_dataset(n=n_pairs, d=d, seed=seed)
    exact = torch.from_numpy(base).to(torch.bfloat16).float().numpy()
    up = np.nextafter(exact, np.float32(np.inf))
    out = np.empty((2 * n_pairs, d), np.float32)
    out[0::2], out[1::2] = exact, up
    return out


@pytest.mark.parametrize("p,tau", [(2.0, 500.0), (1.0, 1_000.0),
                                   (0.5, 2_000.0)], ids=["p2.0", "p1.0",
                                                         "p0.5"])
def test_bf16_ties_break_toward_the_lower_row(p, tau):
    """Paired rows tie under bfloat16 storage: both packages rank the
    lower row first, and return the same ids."""
    from repro.core.datagen import make_weight_set
    from repro.core.params import PlanConfig
    from repro.core.wlsh import WLSHIndex
    from repro.serving import RetrievalService as JaxService
    from repro.serving import ServiceConfig as JaxConfig
    from repro_torch.serving import RetrievalService, ServiceConfig

    data = _paired_rows(81, 256, 16)
    weights = make_weight_set(size=4, d=16, n_subset=2, n_subrange=10,
                              seed=82)
    jplan = WLSHIndex(data, weights, PlanConfig(p=p, c=3, n=len(data),
                                                gamma_n=100.0),
                      tau=tau, v=4, v_prime=4, seed=83).export_serving_plan()
    rng = np.random.default_rng(84)
    src = 2 * rng.choice(256, 12, replace=False)
    qpts = (data[src] + rng.normal(0, 0.5, (12, 16))).astype(np.float32)
    wids = rng.integers(0, len(weights), 12)
    got = RetrievalService(port_plan(jplan), data, cfg=ServiceConfig(
        device="cpu", **BF16)).query(qpts, wids)
    want = JaxService(jplan, data, cfg=JaxConfig(**BF16)).query(qpts, wids)
    _assert_answers(got, want)
    ties = 0
    for q in range(len(qpts)):
        ids, d = list(got.ids[q]), got.dists[q]
        for r in range(K - 1):
            if ids[r] >= 0 and ids[r] % 2 == 0 and ids[r + 1] == ids[r] + 1:
                assert d[r] == d[r + 1]  # one bfloat16 row: a tie
                ties += 1
        for r, i in enumerate(ids):  # an odd row never precedes its twin
            if i >= 0 and i % 2 == 1 and i - 1 in ids:
                assert ids.index(i - 1) < r
    assert ties > 0
    # stored as float32 the twins differ, so neither package ties them
    f32 = RetrievalService(port_plan(jplan), data, cfg=ServiceConfig(
        device="cpu", **dict(BF16, vec_dtype="float32"))).query(qpts, wids)
    assert not np.array_equal(f32.dists, got.dists)
