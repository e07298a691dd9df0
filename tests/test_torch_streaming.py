"""The port's streaming inserts, deletes, compaction and purge on the CPU.

The reference's ``tests/test_streaming.py``, run against ``repro_torch``
on the CPU over the fixture plan, and held to the JAX package:

* before any compaction (the JAX paths that run under the installed
  jax), every answer equals the JAX ``RetrievalService``'s after the
  same inserts and deletes: ids, stop levels and n_checked exactly,
  distances to rtol 1e-6 (the engine tests' tolerance) and the delta
  scan's distances bit for bit; ``scan_topk`` equals the reference's
  bit for bit;
* after compaction and purge, the port's states equal (``torch.equal``)
  its own fresh build over the union or surviving corpus, and its
  answers equal a fresh JAX ``build_group_state(extra_points=,
  extra_codes=, base_rows=)`` served by the JAX query step: ids, stop
  and n_checked exactly, distances to rtol 1e-6, for p in {2, 1, 0.5}.
  The JAX package's own compaction path (``append_to_state``) is never
  the reference: it raises under the installed jax;
* a state leased before an append answers as before after it (the
  append writes rows that state treats as dead);
* the pager reuses a group's host buffers after a compaction replaced
  its state, and a plan without host codes seals through the device
  encode (the plain ``hash_encode`` here), equal to a fresh device build.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from conftest import build_parity_service
from _torch_serving import build_port_parity, cpu_config, jax_service, port_plan
from repro.core.wlsh import WLSHIndex
from repro.index.builder import build_group_state as jax_build
from repro.index.builder import seal_segment as jax_seal
from repro.index.streaming import scan_topk as jax_scan_topk
from repro_torch.core.serving_plan import ServingPlan
from repro_torch.index.builder import build_group_state, seal_segment
from repro_torch.index.streaming import (
    DeltaSegment,
    exact_weighted_lp,
    scan_topk,
)
from repro_torch.launch import retrieval as launch
from repro_torch.serving import (
    AsyncRetrievalService,
    ManualClock,
    RetrievalService,
    merge_topk,
    replay_open_loop,
)

K = 5


def _streaming_service(plan, data, *, cap=None, reserve=64, seal_rows=8,
                       q_batch=4, auto=None, offload=True):
    svc = RetrievalService(
        plan, data,
        cfg=cpu_config(
            k=K, q_batch=q_batch, max_resident_groups=cap,
            delta_seal_rows=seal_rows, delta_reserve_rows=reserve,
            auto_compact_segments=auto, offload_evicted=offload,
        ),
    )
    svc.warmup()
    svc.reset_stats()
    return svc


def _jax_streaming(p, *, reserve=64, seal_rows=8, q_batch=4):
    """The JAX service the pre-compaction answers are held to."""
    return jax_service(p, k=K, q_batch=q_batch, delta_seal_rows=seal_rows,
                       delta_reserve_rows=reserve)


@pytest.fixture(scope="module")
def setup():
    # the p=2 fixture plan carried over to the port; each test builds its
    # own services over it
    return build_port_parity(2.0)[1:]


@pytest.fixture(scope="module", params=[2.0, 1.0, 0.5],
                ids=lambda p: f"p{p}")
def parity_setup(request):
    """(p, data, weights, host, plan, svc) of the port per exponent."""
    return build_port_parity(request.param)


def _far_vector(data, i, tag):
    """A fresh insert guaranteed distinct from (and far from) the corpus."""
    return (data[i % len(data)] + 50_000.0 + 13.0 * tag).astype(np.float32)


def _widest(plan) -> int:
    return int(np.argmax([g.n_members for g in plan.groups]))


def _assert_matches(got, want, scanned_from=None):
    """Port answers vs the JAX package's: ids, stop and n_checked exact,
    distances to rtol 1e-6; hits of the exact delta scan (ids at or past
    ``scanned_from``, the first id still pending) bit for bit."""
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.stop_levels, want.stop_levels)
    np.testing.assert_array_equal(got.n_checked, want.n_checked)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-6)
    if scanned_from is None:
        return
    delta = np.asarray(got.ids) >= scanned_from
    np.testing.assert_array_equal(
        np.asarray(got.dists)[delta].view(np.uint32),
        np.asarray(want.dists)[delta].view(np.uint32))


def _both(svcs, fn):
    """Apply the same write or query to the port and the JAX service."""
    return [fn(s) for s in svcs]


def _jax_union(p, data, plan, reserve, queries, wids, *, base_rows=None,
               extras=None):
    """JAX answers over fresh builds of every group's surviving corpus.

    ``extras[gi] = (ids, vectors)`` are the group's streamed rows after
    its base rows (``base_rows``, None = all); each group state is a JAX
    ``build_group_state`` over them (host codes via the JAX
    ``seal_segment``) served by the JAX query step, and state rows are
    mapped to global ids.
    """
    extras = extras or {}
    jsvc = jax_service(p, k=K, q_batch=4, delta_reserve_rows=reserve)
    _, _, _, _, jplan, _ = build_parity_service(p)
    base_ids = (np.arange(plan.n, dtype=np.int64) if base_rows is None
                else np.asarray(base_rows, np.int64))
    id_maps = {}
    for gi in range(plan.n_groups):
        ids, vecs = extras.get(gi, (np.empty(0, np.int64),
                                    np.empty((0, plan.d), np.float32)))
        jcfg = jsvc.batcher.group_config(gi)
        codes = jax_seal(jcfg, jplan.groups[gi], vecs) if len(ids) else None
        state = jax_build(jsvc.mesh, jcfg, data, jplan.groups[gi],
                          extra_points=vecs if len(ids) else None,
                          extra_codes=codes, base_rows=base_rows)
        jsvc.batcher.state_cache.replace(gi, state)
        id_maps[gi] = np.concatenate([base_ids, np.asarray(ids, np.int64)])
    res = jsvc.query(queries, wids)
    ids = np.asarray(res.ids).astype(np.int64)
    for q in range(len(ids)):
        live = ids[q] >= 0
        ids[q, live] = id_maps[int(res.group_ids[q])][ids[q, live]]
    return dataclasses.replace(res, ids=ids.astype(np.int32))


def _port_fresh_state(svc, gi, data, vecs, base_rows=None):
    cfg = svc.group_config(gi)
    g = svc.plan.groups[gi]
    # a device-encoded build encodes the extra rows with the rest
    codes = (seal_segment(cfg, g, vecs)
             if len(vecs) and g.codes is not None else None)
    return build_group_state(cfg, data, g, device="cpu",
                             extra_points=vecs if len(vecs) else None,
                             extra_codes=codes, base_rows=base_rows)


def _assert_state_equal(got, want):
    assert got.n_valid == want.n_valid
    for name in ("codes", "points", "proj", "b_int", "b_frac", "width"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ------------------------------------------------------- pre-compaction reads


def test_insert_visible_immediately_and_tenant_scoped(setup):
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data)
    jsvc = _jax_streaming(2.0)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    v = _far_vector(data, 3, tag=1)
    pid, jpid = _both((svc, jsvc), lambda s: s.insert(v, w_in))
    assert pid == jpid == plan.n  # ids continue from the corpus epoch
    res, jres = _both((svc, jsvc), lambda s: s.query(v[None], [w_in]))
    assert res.ids[0][0] == pid and res.dists[0][0] == 0.0
    _assert_matches(res, jres, plan.n)
    # inserts are tenant-scoped: a weight routed to a *different* group
    # does not see the row
    other = int(np.where(plan.group_of != gi)[0][0])
    res_other, jres_other = _both(
        (svc, jsvc), lambda s: s.query(v[None], [other]))
    assert pid not in res_other.ids[0]
    _assert_matches(res_other, jres_other, plan.n)
    # and the indexed hits behind the delta hit are unperturbed
    base, jbase = _both((svc, jsvc), lambda s: s.query(
        data[5][None].astype(np.float32), [w_in]))
    assert pid not in base.ids[0][:1] or base.dists[0][0] == 0.0
    _assert_matches(base, jbase, plan.n)
    assert svc.delta_summary() == jsvc.delta_summary()


def test_deleted_ids_never_appear(setup):
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data)
    jsvc = _jax_streaming(2.0)
    q = data[11].astype(np.float32)
    wid = 0
    before = svc.query(q[None], [wid])
    victim = int(before.ids[0][0])
    _both((svc, jsvc), lambda s: s.delete(victim))
    after, jafter = _both((svc, jsvc), lambda s: s.query(q[None], [wid]))
    assert victim not in after.ids[0]
    _assert_matches(after, jafter, plan.n)
    # backfill keeps the remaining candidates sorted with no duplicates
    valid = after.ids[0][after.ids[0] >= 0]
    assert len(set(valid.tolist())) == len(valid)
    d = after.dists[0]
    assert np.all(np.diff(d[np.isfinite(d)]) >= 0)
    # deleting an unknown id is rejected
    with pytest.raises(ValueError):
        svc.delete(10**9)
    assert svc.delta_summary() == jsvc.delta_summary()


@st.composite
def _insert_case(draw):
    base = draw(st.integers(0, 1_023))
    tag = draw(st.integers(0, 500))
    wid = draw(st.integers(0, 7))
    deleted = draw(st.booleans())
    return base, tag, wid, deleted


_property_cache: dict = {}


def _property_services(plan, data):
    # one shared pair of services across hypothesis examples: a large seal
    # threshold keeps every insert in the open memtable (the "unsealed"
    # regime)
    if "svcs" not in _property_cache:
        _property_cache["svcs"] = (
            _streaming_service(plan, data, seal_rows=10_000, reserve=0),
            _jax_streaming(2.0, seal_rows=10_000, reserve=0),
        )
    return _property_cache["svcs"]


@given(_insert_case())
@settings(max_examples=30, deadline=None)
def test_unsealed_insert_is_always_recalled_property(case):
    """Queries whose true nearest neighbor is an unsealed insert always
    return it (exact delta scan); once deleted it never appears, and
    every answer equals the JAX service's after the same writes.  State
    accumulates across examples: recall must survive a growing memtable
    and tombstone set."""
    base, tag, wid, deleted = case
    data, weights, host, plan, _ = build_port_parity(2.0)[1:]
    svcs = _property_services(plan, data)
    # an all-dims serial offset keeps every insert unique under any
    # member weight, so no distance-0 tie resolves to an earlier example
    _property_cache["serial"] = _property_cache.get("serial", 0) + 1
    v = _far_vector(data, base, tag) + np.float32(
        997.0 * _property_cache["serial"]
    )
    pid, jpid = _both(svcs, lambda s: s.insert(v, wid))
    assert pid == jpid
    if deleted:
        _both(svcs, lambda s: s.delete(pid))
    res, jres = _both(svcs, lambda s: s.query(v[None], [wid]))
    _assert_matches(res, jres, plan.n)
    if deleted:
        assert pid not in res.ids[0]
    else:
        assert res.ids[0][0] == pid and res.dists[0][0] == 0.0


# ------------------------------------------------------- seal / compact flow


def test_seal_and_auto_compact_lifecycle(setup):
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=4, auto=1)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    vecs = np.stack([_far_vector(data, j, 7) for j in range(4)])
    pids = [svc.insert(v, w_in) for v in vecs]
    d = svc.delta_summary()
    assert d["n_seals"] == 1 and d["n_compactions"] == 1
    assert d["n_rows_compacted"] == 4 and d["n_pending"] == 0
    assert d["plan_version"] == 1
    assert d["corpus_epoch"] == plan.n + 4
    # versioned invalidation: exactly the compacted group, nobody else
    assert svc.state_cache.version_of(gi) == 1
    assert all(
        svc.state_cache.version_of(g) == 0
        for g in range(plan.n_groups) if g != gi
    )
    assert svc.cache_summary()["n_invalidations"] == 1
    assert svc.stats[gi].n_state_invalidations == 1
    # compacted rows now served by the kernels' path, as a fresh JAX
    # build over the union corpus serves them
    res = svc.query(vecs, [w_in] * 4)
    np.testing.assert_array_equal(res.ids[:, 0], pids)
    assert np.all(res.dists[:, 0] == 0.0)
    want = _jax_union(2.0, data, plan, 64, vecs, [w_in] * 4,
                      extras={gi: (pids, vecs)})
    _assert_matches(res, want)


def test_compaction_never_recompiles(setup):
    """QueryStepCache counters pinned across seal/compact."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=4)
    signatures = {
        svc.group_config(gi).shape_signature()
        for gi in range(plan.n_groups)
    }
    assert svc.step_cache.n_compiled == len(signatures)
    w_in = int(plan.groups[0].member_ids[0])
    for j in range(9):  # 2 seals + a partial memtable
        svc.insert(_far_vector(data, j, 3), w_in)
    assert svc.delta_summary()["n_seals"] == 2
    assert svc.step_cache.n_compiled == len(signatures)
    assert svc.compact() == 9
    assert svc.step_cache.n_compiled == len(signatures)
    rng = np.random.default_rng(3)
    wids = rng.integers(0, len(weights), 8)
    qpts = data[rng.choice(len(data), 8, replace=False)].astype(np.float32)
    svc.query(qpts, wids)  # post-compaction traffic over every group
    assert svc.step_cache.n_compiled == len(signatures)


def test_capacity_exhaustion_is_explicit(setup):
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, reserve=4, seal_rows=2)
    jsvc = _jax_streaming(2.0, reserve=4, seal_rows=2)
    w_in = int(plan.groups[0].member_ids[0])
    pids = [svc.insert(_far_vector(data, j, 9), w_in) for j in range(6)]
    assert [jsvc.insert(_far_vector(data, j, 9), w_in)
            for j in range(6)] == pids
    # the background (non-strict) path skips the over-capacity group...
    assert svc.batcher.delta.compact_sealed() == 0
    assert jsvc.batcher.delta.compact_sealed() == 0
    # ...while the explicit path names the fix
    for s in (svc, jsvc):
        with pytest.raises(ValueError, match="delta_reserve_rows"):
            s.compact()
    # rows keep serving from the exact scan regardless
    q = _far_vector(data, 2, 9)[None]
    res, jres = _both((svc, jsvc), lambda s: s.query(q, [w_in]))
    assert res.ids[0][0] == pids[2]
    _assert_matches(res, jres, plan.n)
    assert svc.delta_summary() == jsvc.delta_summary()


def test_cold_rebuild_includes_compacted_rows(setup):
    """Discard-mode paging must rebuild a compacted group from its union
    corpus: eviction can never drop streamed rows."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, cap=1, offload=False,
                             seal_rows=4, reserve=64)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    vecs = np.stack([_far_vector(data, j, 5) for j in range(4)])
    pids = [svc.insert(v, w_in) for v in vecs]
    assert svc.compact() == 4  # flush the sealed 4-row segment
    assert svc.delta_summary()["n_rows_compacted"] == 4
    # evict the compacted group by touching every other group
    for other in range(plan.n_groups):
        if other != gi:
            wo = int(plan.groups[other].member_ids[0])
            svc.query(data[1][None].astype(np.float32), [wo])
    assert not svc.state_cache.is_resident(gi)
    res = svc.query(vecs[1][None], [w_in])
    assert res.ids[0][0] == pids[1] and res.dists[0][0] == 0.0
    with svc.state_cache.lease(gi) as got:
        _assert_state_equal(got, _port_fresh_state(svc, gi, data, vecs))


# -------------------------------------------------- post-compaction parity


def _union_host(host: WLSHIndex, union: np.ndarray,
                weights: np.ndarray) -> WLSHIndex:
    """Fresh host index over the union corpus with the same family seeds
    and the served partition pinned (only the tables are rebuilt)."""
    cfg2 = dataclasses.replace(host.cfg, n=len(union))
    host2 = WLSHIndex(union, weights, cfg2, tau=host.tau,
                      value_range=host.value_range, v=host.v,
                      v_prime=host.v_prime, seed=host.seed)
    host2.part = host.part
    host2._built = {}
    return host2


def test_post_compaction_parity_vs_fresh_union_build(parity_setup):
    """insert -> seal -> compact answers like search_dense on a fresh
    union-corpus index (ids, stop, n_checked), like a port service and a
    JAX build freshly made over the union, per p in {2, 1, 0.5}, sync and
    async, paged and unpaged."""
    p, data, weights, host, plan, _ = parity_setup
    gi = _widest(plan)
    members = plan.groups[gi].member_ids
    m = 24
    rng = np.random.default_rng(71)
    extra = (
        data[rng.choice(len(data), m, replace=False)]
        + rng.normal(0, 3.0, (m, plan.d))
    ).astype(np.float32)
    ins_wids = members[rng.integers(0, len(members), m)]

    svc = _streaming_service(plan, data, reserve=64, seal_rows=8)
    pids = [svc.insert(extra[j], int(ins_wids[j])) for j in range(m)]
    assert pids == list(range(plan.n, plan.n + m))
    assert svc.compact() == m
    assert svc.delta_summary()["n_pending"] == 0

    union = np.concatenate([data, extra])
    host2 = _union_host(host, union, weights)

    # mixed queries under the compacted group's member weights: near base
    # points and near the streamed inserts
    nq = 24
    wids = members[rng.integers(0, len(members), nq)]
    qpts = union[rng.choice(len(union), nq, replace=False)].astype(
        np.float32
    )
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)

    res = svc.query(qpts, wids)
    for qi in range(nq):
        want = host2.search_dense(qpts[qi], weight_id=int(wids[qi]), k=K)
        np.testing.assert_array_equal(
            res.ids[qi], want.ids.astype(np.int32),
            err_msg=f"post-compaction ids mismatch at query {qi} (p={p})",
        )
        assert int(res.stop_levels[qi]) == want.stats.stop_level
        assert int(res.n_checked[qi]) == want.stats.n_checked

    # a port service freshly built over the union plan answers identically
    plan2 = port_plan(host2.export_serving_plan())
    res_f = RetrievalService(
        plan2, union, cfg=cpu_config(k=K, q_batch=4)).query(qpts, wids)
    for f in ("ids", "dists", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(res, f), getattr(res_f, f))
    # and so does a fresh JAX build over the union corpus
    want = _jax_union(p, data, plan, 64, qpts, wids,
                      extras={gi: (pids, extra)})
    _assert_matches(res, want)

    # paged (cap=1) streaming service, sync chunks + async replay
    paged = _streaming_service(plan, data, cap=1, reserve=64, seal_rows=8)
    for j in range(m):
        paged.insert(extra[j], int(ins_wids[j]))
    paged.compact()
    chunks = [paged.query(qpts[lo:lo + 4], wids[lo:lo + 4])
              for lo in range(0, nq, 4)]
    for f in ("ids", "dists", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(r, f) for r in chunks]), getattr(res, f))

    arrivals = np.cumsum(rng.exponential(1 / 2_000.0, nq))
    asvc = AsyncRetrievalService(paged.batcher, max_delay_ms=2.0,
                                 clock=ManualClock())
    res_a, _ = replay_open_loop(asvc, qpts, wids, arrivals)
    np.testing.assert_array_equal(res_a.ids, res.ids)
    np.testing.assert_array_equal(res_a.stop_levels, res.stop_levels)
    np.testing.assert_array_equal(res_a.n_checked, res.n_checked)


def test_compacted_state_bit_equals_fresh_union_state(parity_setup):
    """The compacted state itself (codes, vectors, n_valid) equals a fresh
    ``build_group_state`` over the union corpus at the same capacity, the
    port's and the JAX package's."""
    p, data, weights, host, plan, _ = parity_setup
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    m = 12
    rng = np.random.default_rng(5)
    extra = (
        data[rng.choice(len(data), m, replace=False)]
        + rng.normal(0, 3.0, (m, plan.d))
    ).astype(np.float32)
    svc = _streaming_service(plan, data, reserve=32, seal_rows=4)
    for j in range(m):
        svc.insert(extra[j], w_in)
    svc.compact()

    fresh = _port_fresh_state(svc, gi, data, extra)
    jsvc = jax_service(p, k=K, q_batch=4, delta_reserve_rows=32)
    _, _, _, _, jplan, _ = build_parity_service(p)
    jcfg = jsvc.batcher.group_config(gi)
    jfresh = jax_build(jsvc.mesh, jcfg, data, jplan.groups[gi],
                       extra_points=extra,
                       extra_codes=jax_seal(jcfg, jplan.groups[gi], extra))
    with svc.state_cache.lease(gi) as got:
        assert got.n_valid == plan.n + m == int(jfresh.n_valid)
        _assert_state_equal(got, fresh)
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(jfresh.codes))
        np.testing.assert_array_equal(
            got.points.numpy(), np.asarray(jfresh.points, np.float32))


def test_old_state_answers_unchanged_after_append(parity_setup):
    """The append writes in place, past the old state's ``n_valid``: a
    state leased before a compaction answers, after it, exactly as it did
    before (and the new state finds the appended rows)."""
    p, data, weights, host, plan, _ = parity_setup
    gi = _widest(plan)
    members = plan.groups[gi].member_ids
    rng = np.random.default_rng(23)
    extra = (data[rng.choice(len(data), 8, replace=False)]
             + 0.5).astype(np.float32)
    svc = _streaming_service(plan, data, reserve=16, seal_rows=8)
    b = svc.batcher
    wids = members[rng.integers(0, len(members), 4)]
    queries = np.concatenate([extra[:2], data[:2]]).astype(np.float32)

    def answer(state):
        cfg = b.group_config(gi)
        g = plan.groups[gi]
        slots = plan.member_slot[wids]

        def t(x, dt):
            return torch.from_numpy(np.ascontiguousarray(x, dt))

        out = b.step_cache.get(b.device, cfg)(
            state, t(queries, np.float32), b._encode(
                gi, cfg, state, queries, np.arange(4)),
            t(plan.weights[wids], np.float32), t(g.mu_members[slots], np.int32),
            t(g.r_min_members[slots], np.float32),
            t(g.beta_members[slots], np.int32),
            t(g.n_levels_members[slots], np.int32))
        return [o.clone() for o in out]

    with svc.state_cache.lease(gi) as old:
        before = answer(old)
    for v, w in zip(extra, members[rng.integers(0, len(members), 8)]):
        svc.insert(v, int(w))
    assert svc.compact() == 8
    with svc.state_cache.lease(gi) as new:
        assert new.codes is old.codes and new.n_valid == old.n_valid + 8
        after_new = answer(new)
    after_old = answer(old)
    for a, c in zip(before, after_old):
        assert torch.equal(a, c)
    # rows 0..1 ask for appended rows: the new state finds them
    assert after_new[1][:2, 0].tolist() == [plan.n, plan.n + 1]
    assert not torch.equal(after_new[1], before[1])


# ------------------------------------------------------------ tombstone purge


def test_purge_drops_tombstones_and_reclaims_capacity(setup):
    """compact(purge=True): tombstoned rows (base and inserted, compacted
    and pending) leave the states, their n_valid capacity is reclaimed,
    the tombstone set is cleared, and no query step is added."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=4, reserve=64)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    vecs = [_far_vector(data, j, 21) for j in range(8)]
    pids = [svc.insert(v, w_in) for v in vecs]
    svc.compact()  # absorb them, then tombstone a few
    q = data[11].astype(np.float32)
    victim_base = int(svc.query(q[None], [0]).ids[0][0])
    svc.delete(victim_base)
    svc.delete(pids[2])
    evecs = [_far_vector(data, j, 23) for j in range(3)]
    extra = [svc.insert(v, w_in) for v in evecs]
    svc.delete(extra[1])  # a still-pending insert, tombstoned
    n_compiled0 = svc.step_cache.n_compiled
    with svc.state_cache.lease(gi) as st_:
        nv_before = st_.n_valid

    absorbed = svc.compact(purge=True)
    assert absorbed == 2  # the two surviving pending inserts

    d = svc.delta_summary()
    assert d["n_tombstones"] == 0  # the set is cleared...
    assert d["n_purges"] == 1 and d["n_rows_purged"] >= 3
    assert d["n_base_live"] == plan.n - 1
    assert d["n_pending"] == 0
    assert svc.step_cache.n_compiled == n_compiled0
    with svc.state_cache.lease(gi) as st_:
        # 8 compacted - 1 purged + 2 surviving pending - 1 purged base
        assert st_.n_valid == nv_before - 1 - 1 + 2
        keep = [j for j in range(8) if j != 2]
        surv = np.stack([vecs[j] for j in keep] + [evecs[0], evecs[2]])
        base_rows = np.setdiff1d(np.arange(plan.n), [victim_base])
        _assert_state_equal(
            st_, _port_fresh_state(svc, gi, data, surv, base_rows))
    # ...and deleted rows are *gone*, not filtered: every group rebuilt
    assert svc.cache_summary()["n_invalidations"] >= plan.n_groups
    r = svc.query(q[None], [0])
    assert victim_base not in r.ids[0]
    want = _jax_union(2.0, data, plan, 64, q[None], [0], base_rows=base_rows,
                      extras={gi: ([pids[j] for j in keep]
                                   + [extra[0], extra[2]], surv)})
    _assert_matches(r, want)
    for j, pid in enumerate(pids):
        r = svc.query(vecs[j][None], [w_in])
        if j == 2:
            assert pid not in r.ids[0]
        else:
            assert r.ids[0][0] == pid and r.dists[0][0] == 0.0
    assert svc.query(evecs[0][None], [w_in]).ids[0][0] == extra[0]
    assert extra[1] not in svc.query(evecs[1][None], [w_in]).ids[0]
    # plan lineage: the purge bumps the version, and the epoch covers
    # every minted id, including the tombstoned pending insert that was
    # dropped instead of absorbed, so a resumed service never reuses one
    assert svc.plan.version >= 2 and svc.plan.corpus_epoch == plan.n + 11
    # a per-group purge is rejected (tombstones are global)
    with pytest.raises(ValueError, match="purge"):
        svc.compact(group=gi, purge=True)


def test_purge_survives_eviction_and_continues_streaming(setup):
    """Post-purge cold rebuilds (discard-mode paging) reproduce the purged
    corpus, never resurrecting dropped rows, and later inserts and
    compactions keep working against the purged base."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, cap=1, offload=False,
                             seal_rows=4, reserve=64)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    v0 = _far_vector(data, 0, 27)
    pid = svc.insert(v0, w_in)
    q = data[11].astype(np.float32)
    victim_base = int(svc.query(q[None], [0]).ids[0][0])
    svc.delete(victim_base)
    svc.compact(purge=True)
    # page the purged group out by touching every other group
    for other in range(plan.n_groups):
        if other != gi:
            wo = int(plan.groups[other].member_ids[0])
            svc.query(data[1][None].astype(np.float32), [wo])
    assert not svc.state_cache.is_resident(gi)
    r = svc.query(v0[None], [w_in])
    assert r.ids[0][0] == pid and r.dists[0][0] == 0.0
    assert victim_base not in svc.query(q[None], [0]).ids[0]
    # streaming continues on the purged base: insert -> compact -> exact
    v1 = _far_vector(data, 1, 29)
    pid2 = svc.insert(v1, w_in)
    assert svc.compact() == 1
    r = svc.query(v1[None], [w_in])
    assert r.ids[0][0] == pid2 and r.dists[0][0] == 0.0
    base_rows = np.setdiff1d(np.arange(plan.n), [victim_base])
    with svc.state_cache.lease(gi) as got:
        _assert_state_equal(got, _port_fresh_state(
            svc, gi, data, np.stack([v0, v1]), base_rows))


def test_failed_purge_commits_nothing(setup):
    """The purge is transactional: a capacity overflow raises the same
    explicit delta_reserve_rows error as ordinary compaction *before* any
    state is replaced; tombstones, logs and answers are unchanged, and
    equal the JAX service's after the same writes."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=2, reserve=4)
    jsvc = _jax_streaming(2.0, seal_rows=2, reserve=4)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    pids = [svc.insert(_far_vector(data, j, 31), w_in) for j in range(6)]
    for j in range(6):
        jsvc.insert(_far_vector(data, j, 31), w_in)
    for s in (svc, jsvc):
        s.delete(0)  # a base tombstone so the purge can't degrade
        with pytest.raises(ValueError, match="delta_reserve_rows"):
            s.compact(purge=True)
    d = svc.delta_summary()
    assert d == jsvc.delta_summary()
    assert d["n_purges"] == 0 and d["n_tombstones"] == 1
    assert d["n_base_live"] == plan.n
    assert svc.cache_summary()["n_invalidations"] == 0  # nothing committed
    q = _far_vector(data, 2, 31)[None]
    r, jr = _both((svc, jsvc), lambda s: s.query(q, [w_in]))
    assert r.ids[0][0] == pids[2]  # rows keep serving from the exact scan
    _assert_matches(r, jr, plan.n)


def test_purge_without_tombstones_degrades_to_compact(setup):
    """With nothing to drop, purge=True does not rebuild every group: it
    delegates to the ordinary append-based full compact."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=2, reserve=16)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    svc.insert(_far_vector(data, 0, 33), w_in)
    svc.insert(_far_vector(data, 1, 33), w_in)
    assert svc.compact(purge=True) == 2
    d = svc.delta_summary()
    assert d["n_purges"] == 0  # no sweep happened...
    assert d["n_compactions"] == 1  # ...just the ordinary compaction
    assert svc.cache_summary()["n_invalidations"] == 1  # one group touched


def test_identity_purge_rebuilds_only_affected_groups(setup):
    """With the base corpus untouched, a purge rebuilds only groups that
    actually drop a row; everyone else keeps their cached state (sealed
    backlogs take the ordinary append path)."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=4, reserve=64)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    other = int(np.argmin(
        [g.n_members if g2 != gi else 10**9
         for g2, g in enumerate(plan.groups)]
    ))
    w_other = int(plan.groups[other].member_ids[0])
    pids = [svc.insert(_far_vector(data, j, 41), w_in) for j in range(4)]
    svc.compact(gi)
    pid_other = svc.insert(_far_vector(data, 0, 43), w_other)
    svc.delete(pids[1])  # only group gi drops a row
    inval0 = {g: svc.stats[g].n_state_invalidations
              for g in range(plan.n_groups)}
    svc.compact(purge=True)
    # gi rebuilt (one invalidation); `other` only absorbed its sealed row
    # (ordinary append compaction); every untouched group: zero churn
    for g in range(plan.n_groups):
        delta = svc.stats[g].n_state_invalidations - inval0[g]
        assert delta == (1 if g in (gi, other) else 0), (g, delta)
    assert svc.delta_summary()["n_tombstones"] == 0
    assert pids[1] not in svc.query(
        _far_vector(data, 1, 41)[None], [w_in]
    ).ids[0]
    assert svc.query(
        _far_vector(data, 0, 43)[None], [w_other]
    ).ids[0][0] == pid_other
    # ...and this survives an earlier base-dropping purge: the next purge
    # compares against the *current* surviving base, so a single-group
    # insert tombstone again touches only that group
    victim_base = int(svc.query(
        data[11][None].astype(np.float32), [0]
    ).ids[0][0])
    svc.delete(victim_base)
    svc.compact(purge=True)  # drops a base row: every group rebuilds
    pid3 = svc.insert(_far_vector(data, 5, 47), w_in)
    svc.compact(gi)
    svc.delete(pid3)
    inval1 = {g: svc.stats[g].n_state_invalidations
              for g in range(plan.n_groups)}
    svc.compact(purge=True)
    for g in range(plan.n_groups):
        delta = svc.stats[g].n_state_invalidations - inval1[g]
        assert delta == (1 if g == gi else 0), (g, delta)


def test_purged_state_bit_equals_fresh_surviving_build(parity_setup):
    """The purged state (codes, vectors, n_valid) equals a fresh
    ``build_group_state`` over the surviving corpus (live base rows +
    surviving inserts), and its answers equal a fresh JAX build's, per p
    in {2, 1, 0.5}."""
    p, data, weights, host, plan, _ = parity_setup
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    m = 12
    rng = np.random.default_rng(13)
    extra = (
        data[rng.choice(len(data), m, replace=False)]
        + rng.normal(0, 3.0, (m, plan.d))
    ).astype(np.float32)
    svc = _streaming_service(plan, data, reserve=32, seal_rows=4)
    pids = [svc.insert(extra[j], w_in) for j in range(m)]
    svc.compact()
    drop_base = [3, 77]
    drop_ins = [1, 6]
    for b in drop_base:
        svc.delete(b)
    for j in drop_ins:
        svc.delete(pids[j])
    svc.compact(purge=True)

    surv_base = np.setdiff1d(np.arange(plan.n, dtype=np.int64), drop_base)
    keep = [j for j in range(m) if j not in drop_ins]
    fresh = _port_fresh_state(svc, gi, data, extra[keep], surv_base)
    with svc.state_cache.lease(gi) as got:
        assert got.n_valid == plan.n - len(drop_base) + len(keep)
        _assert_state_equal(got, fresh)
    # surviving rows answer exactly through the kernels' path, as a fresh
    # JAX build over the survivors answers
    members = plan.groups[gi].member_ids
    wids = members[rng.integers(0, len(members), m)]
    res = svc.query(extra, wids)
    for j in keep:
        assert res.ids[j][0] == pids[j] and res.dists[j][0] == 0.0
    for j in drop_ins:
        assert pids[j] not in res.ids[j]
    want = _jax_union(p, data, plan, 32, extra, wids, base_rows=surv_base,
                      extras={gi: ([pids[j] for j in keep], extra[keep])})
    _assert_matches(res, want)


# --------------------------------------------------------- plan versioning


def test_plan_version_round_trips_npz(tmp_path, setup):
    from repro.core.serving_plan import ServingPlan as JaxPlan

    data, weights, host, plan, _ = setup
    assert plan.version == 0 and plan.corpus_epoch == plan.n
    bumped = plan.bumped(40)
    assert bumped.version == 1 and bumped.corpus_epoch == plan.n + 40
    path = str(tmp_path / "plan_v.npz")
    bumped.save_npz(path)
    for loaded in (ServingPlan.load_npz(path), JaxPlan.load_npz(path)):
        assert loaded.version == 1
        assert loaded.corpus_epoch == plan.n + 40


def test_compaction_advances_the_served_plan(setup):
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, seal_rows=4, auto=1)
    w_in = int(plan.groups[0].member_ids[0])
    for j in range(8):
        svc.insert(_far_vector(data, j, 11), w_in)
    assert svc.plan.version == 2  # two auto-compactions
    assert svc.plan.corpus_epoch == plan.n + 8
    # a service resumed from the advanced plan continues the id space
    svc2 = _streaming_service(svc.plan, data)
    pid = svc2.insert(_far_vector(data, 0, 12), w_in)
    assert pid == plan.n + 8


# ------------------------------------------------- pager and codeless plans


def test_pager_reuses_host_buffers_after_compaction(setup):
    """A compaction replaces the group's state; the Batcher adopts it into
    the pager, so the next offload writes the group's existing host
    buffers (no second set) and the restore serves the appended rows."""
    data, weights, host, plan, _ = setup
    svc = _streaming_service(plan, data, cap=1, seal_rows=4, reserve=16)
    gi = _widest(plan)
    w_in = int(plan.groups[gi].member_ids[0])
    other = (gi + 1) % plan.n_groups
    w_other = int(plan.groups[other].member_ids[0])
    pager = svc.batcher.pager
    svc.query(data[:1].astype(np.float32), [w_other])  # gi offloaded
    svc.query(data[:1].astype(np.float32), [w_in])  # gi restored
    ptrs = [t.data_ptr() for t in (pager._groups[gi].host.codes,
                                   pager._groups[gi].host.points)]
    pinned = pager.pinned_bytes
    vecs = np.stack([_far_vector(data, j, 51) for j in range(4)])
    pids = [svc.insert(v, w_in) for v in vecs]
    assert svc.compact() == 4
    svc.query(data[:1].astype(np.float32), [w_other])  # evicts gi again
    assert not svc.state_cache.is_resident(gi)
    host_copy = pager._groups[gi].host
    assert [t.data_ptr() for t in (host_copy.codes, host_copy.points)] == ptrs
    assert pager.pinned_bytes == pinned
    np.testing.assert_array_equal(host_copy.points[plan.n:plan.n + 4], vecs)
    res = svc.query(vecs, [w_in] * 4)  # restored with the appended rows
    np.testing.assert_array_equal(res.ids[:, 0], pids)


def test_codeless_plan_seals_through_the_device_encode(setup):
    """A plan without host codes seals through ``encode_queries`` (the
    ``hash_encode`` kernel on the card, its plain version here): the
    sealed codes equal the plain encode of the rows, and the compacted
    state equals a fresh device build over the union corpus."""
    from repro_torch.index.engine import encode_queries
    from repro_torch.kernels import ref

    data, weights, host, plan, _ = setup
    plan_nc = port_plan(host.export_serving_plan(include_codes=False))
    svc = _streaming_service(plan_nc, data, seal_rows=4, reserve=16)
    gi = _widest(plan_nc)
    w_in = int(plan_nc.groups[gi].member_ids[0])
    vecs = (data[[5, 50, 500, 1000]] + 0.25).astype(np.float32)
    pids = [svc.insert(v, w_in) for v in vecs]
    sealed = svc.batcher.delta._groups[gi].sealed[0]
    with svc.state_cache.lease(gi) as st_:
        plain = ref.hash_encode_ref(torch.from_numpy(vecs), st_.proj,
                                    st_.b_int, st_.b_frac,
                                    torch.ones(plan.d), 1.0)
        np.testing.assert_array_equal(sealed.codes, plain.numpy())
        np.testing.assert_array_equal(
            sealed.codes, encode_queries(st_, vecs).numpy())
    assert svc.compact() == 4
    with svc.state_cache.lease(gi) as got:
        _assert_state_equal(got, _port_fresh_state(svc, gi, data, vecs))
    res = svc.query(vecs, [w_in] * 4)
    np.testing.assert_array_equal(res.ids[:, 0], pids)
    assert np.all(res.dists[:, 0] == 0.0)


# ------------------------------------------------- hot-path micro-structure


def test_memtable_vectors_cached_no_recopy():
    """The stacked delta matrix is built once per write epoch: repeated
    reads return the *same* array object, writes invalidate, and the
    shared array is read-only."""
    seg = DeltaSegment(4)
    empty = seg.vectors
    assert empty.shape == (0, 4) and seg.vectors is empty
    seg.append(10, np.arange(4, dtype=np.float32))
    seg.append(11, np.arange(4, dtype=np.float32) + 1)
    v1 = seg.vectors
    assert v1 is seg.vectors  # identity: no copy on the read path
    assert not v1.flags.writeable  # shared across reads, so frozen
    np.testing.assert_array_equal(v1[1], np.arange(4, dtype=np.float32) + 1)
    seg.append(12, np.arange(4, dtype=np.float32) + 2)
    v2 = seg.vectors
    assert v2 is not v1 and v2.shape == (3, 4)  # append invalidates
    ids, vecs = seg.drain()
    assert vecs is v2 and ids.tolist() == [10, 11, 12]
    assert seg.vectors is not v2 and seg.vectors.shape == (0, 4)


def _scan_topk_reference(queries, q_weights, ids, vectors, p, k):
    """A full (Q, m) stable argsort of the exact distances."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    nq = len(queries)
    out_ids = np.full((nq, k), -1, np.int64)
    out_d = np.full((nq, k), np.inf, np.float32)
    m = len(ids)
    if m == 0:
        return out_ids, out_d
    dists = exact_weighted_lp(queries, vectors, q_weights, p)
    take = min(k, m)
    order = np.argsort(dists, axis=1, kind="stable")[:, :take]
    out_ids[:, :take] = np.asarray(ids, np.int64)[order]
    out_d[:, :take] = np.take_along_axis(dists, order, axis=1)
    return out_ids, out_d


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("m,k", [(0, 5), (3, 5), (64, 5), (64, 64), (7, 7)])
def test_scan_topk_bit_identical_to_stable_argsort(p, m, k):
    """The argpartition path returns ids *and* dists bit-identical to a
    full stable argsort and to the JAX package's ``scan_topk``, including
    insertion-order tie-breaks from duplicated rows."""
    rng = np.random.default_rng(97)
    d = 6
    vecs = rng.normal(0, 5, (max(m, 1), d)).astype(np.float32)[:m]
    if m >= 8:
        vecs[5] = vecs[1]  # exact duplicates: distance ties every query
        vecs[7] = vecs[1]
        vecs[6] = vecs[2]
    ids = rng.permutation(10 * max(m, 1))[:m].astype(np.int64)
    q = rng.normal(0, 5, (4, d)).astype(np.float32)
    q[2] = vecs[0] if m else 0.0  # a zero-distance hit
    w = rng.uniform(0.25, 2.0, (4, d)).astype(np.float32)
    got_i, got_d = scan_topk(q, w, ids, vecs, p, k)
    for want_i, want_d in (_scan_topk_reference(q, w, ids, vecs, p, k),
                           jax_scan_topk(q, w, ids, vecs, p, k)):
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(
            got_d.view(np.uint32), want_d.view(np.uint32)
        )


# ------------------------------------------------------- merge_topk helper


@st.composite
def _merge_case(draw):
    k = draw(st.integers(1, 6))
    na = draw(st.integers(0, 8))
    nb = draw(st.integers(0, 6))
    a_d = sorted(draw(st.lists(
        st.floats(0, 100, allow_nan=False, width=32),
        min_size=na, max_size=na,
    )))
    b_d = sorted(draw(st.lists(
        st.floats(0, 100, allow_nan=False, width=32),
        min_size=nb, max_size=nb,
    )))
    n_drop = draw(st.integers(0, 4))
    return k, a_d, b_d, n_drop


@given(_merge_case())
@settings(max_examples=100, deadline=None)
def test_merge_topk_invariants_property(case):
    """Sorted output of exactly k columns, no dropped/duplicated/invented
    candidate, tombstones filtered with backfill, missing slots -1/inf at
    the tail (the reference fails the short-input case; the port holds)."""
    k, a_d, b_d, n_drop = case
    ka = max(len(a_d), 1)
    ids_a = np.full((1, ka), -1, np.int64)
    d_a = np.full((1, ka), np.inf, np.float32)
    ids_a[0, :len(a_d)] = np.arange(len(a_d))  # indexed ids 0..
    d_a[0, :len(a_d)] = a_d
    kb = max(len(b_d), 1)
    ids_b = np.full((1, kb), -1, np.int64)
    d_b = np.full((1, kb), np.inf, np.float32)
    ids_b[0, :len(b_d)] = 1_000 + np.arange(len(b_d))  # disjoint delta ids
    d_b[0, :len(b_d)] = b_d
    drop = set(range(0, n_drop)) | {1_000}  # tombstone some of each
    out_ids, out_d = merge_topk(ids_a, d_a, ids_b, d_b, k, drop=drop)
    assert out_ids.shape == (1, k) and out_d.shape == (1, k)
    finite = out_d[0][np.isfinite(out_d[0])]
    assert np.all(np.diff(finite) >= 0)  # sorted ascending
    valid = out_ids[0][out_ids[0] >= 0]
    assert len(set(valid.tolist())) == len(valid)  # no duplicates
    assert not (set(valid.tolist()) & drop)  # tombstones never surface
    # every surfaced id existed in an input with its own distance
    pool = {int(i): float(d) for i, d in zip(ids_a[0], d_a[0]) if i >= 0}
    pool.update(
        {int(i): float(d) for i, d in zip(ids_b[0], d_b[0]) if i >= 0}
    )
    for i, d in zip(out_ids[0], out_d[0]):
        if i >= 0:
            assert pool[int(i)] == pytest.approx(float(d))
    # survivors are exactly the k best non-dropped candidates
    best = sorted(
        (d for i, d in pool.items() if i not in drop)
    )[:k]
    assert list(np.sort(finite)) == pytest.approx(best)


def test_merge_topk_passthrough_is_bit_exact():
    ids = np.array([[4, 9, -1]], np.int32)
    d = np.array([[1.5, 2.5, np.inf]], np.float32)
    empty_i = np.full((1, 0), -1, np.int64)
    empty_d = np.full((1, 0), np.inf, np.float32)
    out_ids, out_d = merge_topk(ids, d, empty_i, empty_d, 3)
    np.testing.assert_array_equal(out_ids, ids)
    np.testing.assert_array_equal(out_d, d)
    # distance ties prefer the indexed operand
    tie_i = np.array([[77]], np.int64)
    tie_d = np.array([[1.5]], np.float32)
    out_ids, _ = merge_topk(ids, d, tie_i, tie_d, 3)
    assert out_ids[0].tolist() == [4, 77, 9]


# ------------------------------------------------------------------ launcher


def test_cli_mixed_replay_checks_streaming(capsys):
    """The launcher's mixed read/write replay on the CPU: every insert's
    self-query is exact before and after the full compaction."""
    out = launch.run(launch.parse_args([
        "--n", "1024", "--d", "16", "--n-weights", "8", "--n-subset", "4",
        "--n-queries", "24", "--k", "5", "--q-batch", "4", "--v", "4",
        "--device", "cpu", "--insert-rate", "0.25", "--delta-seal-rows",
        "8", "--check"]))
    n = out["n_inserts"]
    assert n > 0 and out["n_check_failures"] == 0
    assert (f"check[streaming]: {2 * n}/{2 * n} insert self-queries exact "
            f"(pre + post compaction of {n} rows)") in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch.parse_args(["--async", "--qos", "--insert-rate", "0.1"])
