"""The port's synchronous service vs the JAX service and the host oracle.

The same ``ServingPlan`` (exported by the reference planner, carried over
with ``ServingPlan.from_arrays``) and the same mixed (query, weight_id)
stream go through ``repro_torch``'s ``RetrievalService(device="cpu")`` at
q_batch 1 and 4, the JAX ``RetrievalService`` and
``WLSHIndex.search_dense``: ids, stop levels and n_checked must be equal.
Also here: the port's ``merge_topk`` (always exactly k columns) and the
sync CLI on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from conftest import build_parity_service

from _hyp import HAVE_HYPOTHESIS, given, settings, st
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.launch import retrieval as launch
from repro_torch.serving import RetrievalService, ServiceConfig, merge_topk
from repro_torch.serving.batching import coalesce, pad_take

_N_Q = 24


def _port_plan(jplan) -> ServingPlan:
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan)}
    fields["groups"] = [{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(g)} for g in jplan.groups]
    return ServingPlan.from_arrays(fields)


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def parity(request):
    p, data, weights, host, jplan, jsvc = build_parity_service(request.param)
    rng = np.random.default_rng(11)
    wids = rng.integers(0, len(weights), _N_Q)
    qpts = data[rng.choice(len(data), _N_Q, replace=False)]
    qpts = (qpts + rng.normal(0, 3.0, qpts.shape)).astype(np.float32)
    want = jsvc.query(qpts, wids)
    return dict(data=data, host=host, plan=_port_plan(jplan), wids=wids,
                qpts=qpts, want=want, k=jsvc.cfg.k)


@pytest.mark.parametrize("q_batch", [1, 4])
def test_service_matches_jax_service(parity, q_batch):
    svc = RetrievalService(parity["plan"], parity["data"], cfg=ServiceConfig(
        k=parity["k"], q_batch=q_batch, device="cpu"))
    got = svc.query(parity["qpts"], parity["wids"])
    want = parity["want"]
    np.testing.assert_array_equal(got.group_ids, want.group_ids)
    np.testing.assert_array_equal(got.stop_levels, want.stop_levels)
    np.testing.assert_array_equal(got.n_checked, want.n_checked)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-6)
    summary = svc.stats_summary()
    assert sum(s["n_queries"] for s in summary.values()) == _N_Q
    assert svc.step_cache.n_compiled <= parity["plan"].n_groups


@pytest.mark.parametrize("use_kernels", ["on", "off"])
def test_service_matches_search_dense(parity, use_kernels):
    svc = RetrievalService(parity["plan"], parity["data"], cfg=ServiceConfig(
        k=parity["k"], q_batch=4, device="cpu", use_kernels=use_kernels))
    svc.warmup()
    assert svc.state_cache.n_resident == parity["plan"].n_groups
    got = svc.query(parity["qpts"], parity["wids"])
    for qi, wid in enumerate(parity["wids"]):
        want = parity["host"].search_dense(parity["qpts"][qi],
                                           weight_id=int(wid), k=parity["k"])
        assert got.stop_levels[qi] == want.stats.stop_level
        assert got.n_checked[qi] == want.stats.n_checked
        np.testing.assert_array_equal(got.ids[qi], want.ids.astype(np.int32))


def test_service_rejects_bad_input(parity):
    svc = RetrievalService(parity["plan"], parity["data"],
                           cfg=ServiceConfig(k=3, device="cpu"))
    with pytest.raises(ValueError):
        svc.query(parity["qpts"][:2], [0])
    with pytest.raises(ValueError):
        svc.query(parity["qpts"][:1], [len(parity["plan"].weights)])


def test_service_config_validates():
    with pytest.raises(ValueError):
        ServiceConfig(k=0)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        ServiceConfig(n_shards=0)
    assert ServiceConfig(n_shards=2).n_shards == 2  # sharding is served
    assert ServiceConfig(vec_dtype="bfloat16").vec_dtype == "bfloat16"
    for bad in ("float16", "int8"):
        with pytest.raises(NotImplementedError):
            ServiceConfig(vec_dtype=bad)
    assert ServiceConfig(use_kernels=False).use_kernels == "off"
    assert ServiceConfig(use_kernels=True).use_kernels == "on"
    with pytest.raises(ValueError):
        ServiceConfig(use_kernels="auto")


def test_coalesce_and_pad_take():
    plans = coalesce(np.array([2, 0, 2, 2, 0]), 2)
    assert [(bp.group_id, bp.rows.tolist()) for bp in plans] == [
        (0, [1, 4]), (2, [0, 2]), (2, [3])]
    assert pad_take(3, 5).tolist() == [0, 1, 2, 0, 1]


# ------------------------------------------------------------- merge_topk


def test_merge_topk_pads_to_k_when_inputs_are_short():
    """The falsifying example (k=3, nothing indexed, nothing extra)."""
    empty_i = np.full((1, 1), -1, np.int64)
    empty_d = np.full((1, 1), np.inf, np.float32)
    ids, d = merge_topk(empty_i, empty_d, empty_i, empty_d, 3, drop={1_000})
    assert ids.shape == (1, 3) and d.shape == (1, 3)
    assert ids.tolist() == [[-1, -1, -1]] and np.isinf(d).all()
    ids, d = merge_topk(np.zeros((2, 0)), np.zeros((2, 0)), [[7], [8]],
                        [[1.5], [2.5]], 2)
    assert ids.tolist() == [[7, -1], [8, -1]]


def test_merge_topk_passthrough_is_bit_exact():
    ids = np.array([[4, 9, -1]], np.int32)
    d = np.array([[1.5, 2.5, np.inf]], np.float32)
    empty = np.full((1, 0), -1, np.int64)
    got_i, got_d = merge_topk(ids, d, empty, np.zeros((1, 0), np.float32), 3)
    np.testing.assert_array_equal(got_i, ids)
    assert got_d.tobytes() == d.tobytes()


def _merge_case_check(case):
    k, a_d, b_d, n_drop = case
    ka = max(len(a_d), 1)
    ids_a = np.full((1, ka), -1, np.int64)
    d_a = np.full((1, ka), np.inf, np.float32)
    ids_a[0, :len(a_d)] = np.arange(len(a_d))
    d_a[0, :len(a_d)] = a_d
    kb = max(len(b_d), 1)
    ids_b = np.full((1, kb), -1, np.int64)
    d_b = np.full((1, kb), np.inf, np.float32)
    ids_b[0, :len(b_d)] = 1_000 + np.arange(len(b_d))
    d_b[0, :len(b_d)] = b_d
    drop = set(range(0, n_drop)) | {1_000}
    out_ids, out_d = merge_topk(ids_a, d_a, ids_b, d_b, k, drop=drop)
    assert out_ids.shape == (1, k) and out_d.shape == (1, k)
    finite = out_d[0][np.isfinite(out_d[0])]
    assert np.all(np.diff(finite) >= 0)
    valid = out_ids[0][out_ids[0] >= 0]
    assert len(set(valid.tolist())) == len(valid)
    assert not (set(valid.tolist()) & drop)
    assert np.all(out_ids[0][np.isinf(out_d[0])] == -1)
    pool = {int(i): float(d) for i, d in zip(ids_a[0], d_a[0]) if i >= 0}
    pool.update({int(i): float(d) for i, d in zip(ids_b[0], d_b[0])
                 if i >= 0})
    best = sorted(d for i, d in pool.items() if i not in drop)[:k]
    assert list(np.sort(finite)) == pytest.approx(best)


@pytest.mark.parametrize("case", [
    (3, [], [], 0),
    (2, [1.0, 2.0, 3.0], [0.5], 1),
    (6, [4.0], [1.0, 1.0], 0),
])
def test_merge_topk_invariants_examples(case):
    _merge_case_check(case)


if HAVE_HYPOTHESIS:
    from hypothesis import example

    @st.composite
    def _merge_case(draw):
        k = draw(st.integers(1, 6))
        na, nb = draw(st.integers(0, 8)), draw(st.integers(0, 6))
        fl = st.floats(0, 100, allow_nan=False, width=32)
        a_d = sorted(draw(st.lists(fl, min_size=na, max_size=na)))
        b_d = sorted(draw(st.lists(fl, min_size=nb, max_size=nb)))
        return k, a_d, b_d, draw(st.integers(0, 4))

    @given(_merge_case())
    @settings(max_examples=60, deadline=None)
    @example(case=(3, [], [], 0))
    def test_merge_topk_invariants_property(case):
        _merge_case_check(case)


# ------------------------------------------------------------------ launch


def test_cli_check_on_cpu(capsys):
    out = launch.run(launch.parse_args([
        "--n", "512", "--d", "16", "--n-weights", "4", "--n-subset", "2",
        "--n-queries", "8", "--k", "3", "--v", "4", "--q-batch", "4",
        "--device", "cpu", "--check"]))
    assert out["n_check_failures"] == 0
    assert out["n_self_misses"] is None
    assert "check vs search_dense: 8/8 exact" in capsys.readouterr().out


def test_cli_check_without_host_codes_on_cpu(capsys):
    """A plan exported without host codes: the device encode serves it and
    --check requires every source row to find itself."""
    out = launch.run(launch.parse_args([
        "--n", "512", "--d", "16", "--n-weights", "4", "--n-subset", "2",
        "--n-queries", "8", "--k", "3", "--v", "4", "--q-batch", "4",
        "--device", "cpu", "--check"]), include_codes=False)
    assert out["n_self_misses"] == 0
    assert "check self-queries on device codes: 8/8 rank 0" in (
        capsys.readouterr().out)
