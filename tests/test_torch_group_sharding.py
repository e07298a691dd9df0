"""The port's sharded group states: one group's rows across devices.

The counterpart of ``tests/test_group_sharding.py`` on the CPU, where
every shard is the CPU device and the kernels' plain versions run:
range math, device-count checks, per-shard byte pricing, sharded search
bit for bit equal to the unsharded port (ids, distance bits, stop levels,
n_checked) for p in {2, 1, 0.5} (sync, paged, async, unfused), per-shard
paging, the per-host build, the strict capacity rule, sharded compaction
and purge against a fresh sharded union build, the merges' tie order and
the launcher's ``--shards``.  ``test_sharded_service_matches_jax`` holds
the port to the JAX package's sharded service, run in a child process
under ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the main
process keeps its one CPU device), on the same 1003-row ragged corpus:
integers exact, distances to rtol 1e-6, and the same trace spans.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_serving import port_plan
from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.distributed import group_sharding as gs
from repro_torch.index.builder import (
    StatePager,
    append_to_state,
    build_group_state,
    seal_segment,
)
from repro_torch.index.config import IndexConfig, pad_beta
from repro_torch.launch import retrieval as launch
from repro_torch.serving import (
    AsyncRetrievalService,
    Batcher,
    ManualClock,
    RetrievalService,
    ServiceConfig,
    replay_open_loop,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N, _D, _NQ, _K = 1003, 16, 12, 3
_RESERVE = 5  # capacity 1008 = 2 * 504 = 8 * 126: ragged live tail
_FIELDS = ("ids", "dists", "stop_levels", "n_checked")

_plans: dict = {}


def _fixture(p: float, codes: bool = True):
    """(data, plan, qpts, wids) of the 1003-row corpus for exponent p."""
    key = (p, codes)
    if key not in _plans:
        data = make_dataset(n=_N, d=_D, seed=41)
        weights = make_weight_set(size=8, d=_D, n_subset=4, n_subrange=10,
                                  seed=42)
        host = WLSHIndex(data, weights,
                         PlanConfig(p=p, c=3, n=_N, gamma_n=100.0),
                         tau=500.0, v=4, v_prime=4, seed=9)
        plan = host.export_serving_plan(include_codes=codes)
        rng = np.random.default_rng(43)
        wids = rng.integers(0, len(weights), _NQ)
        qpts = data[rng.choice(_N, _NQ, replace=False)].astype(np.float32)
        qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
        _plans[key] = (data, plan, qpts, wids, host)
    return _plans[key]


def _svc(plan, data, shards, **kw):
    kw.setdefault("delta_reserve_rows", _RESERVE)
    return RetrievalService(plan, data, cfg=ServiceConfig(
        k=_K, q_batch=4, n_shards=shards, device="cpu", **kw))


def _assert_same(a, b, what):
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if f == "dists":  # distances compared by their bits
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {f}")


def _shards(state):
    return state.shards if isinstance(state, gs.ShardedQueryState) else (
        state,)


def _assert_equal_states(a, b):
    assert a.n_valid == b.n_valid
    for x, y in zip(_shards(a), _shards(b), strict=True):
        assert x.n_valid == y.n_valid
        for f in ("codes", "points", "proj", "b_int", "b_frac", "width"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


# ------------------------------------------------------- range and devices


def test_host_row_ranges_cover_capacity_evenly():
    assert gs.host_row_ranges(1008, 8) == [
        (s * 126, (s + 1) * 126) for s in range(8)]
    assert gs.host_row_ranges(64, 1) == [(0, 64)]
    with pytest.raises(ValueError, match="does not divide"):
        gs.host_row_ranges(1003, 8)
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        gs.host_row_ranges(64, 0)


def test_serving_devices_validates_device_count(monkeypatch):
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        gs.serving_devices(0, "cpu")
    assert gs.serving_devices(3, "cpu") == (torch.device("cpu"),) * 3
    # more shards than visible cards raise, naming the explicit recipe;
    # nothing falls back to fewer shards or to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert gs.serving_devices(1) == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match=r"devices=\('cuda:0',\) \* 2"):
        gs.serving_devices(2)
    data, plan, *_ = _fixture(2.0)
    with pytest.raises(ValueError, match="exceeds the 1 visible"):
        Batcher(plan, data, ServiceConfig(n_shards=4))


def test_explicit_devices_win_over_the_config():
    data, plan, qpts, wids, _ = _fixture(2.0)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=_K, q_batch=4, device="cpu", delta_reserve_rows=_RESERVE),
        devices=("cpu",) * 3)
    assert svc.devices == (torch.device("cpu"),) * 3
    assert svc.batcher.n_shards == 3
    assert svc.batcher.row_capacity() % 3 == 0
    assert svc.group_config(0).n_shards == 3
    _assert_same(svc.query(qpts, wids), _svc(plan, data, 1).query(
        qpts, wids), "devices=('cpu',) * 3")


def test_state_nbytes_prices_the_per_device_slice():
    one = IndexConfig(n=1 << 20, d=32, beta=64, n_shards=1,
                      vec_dtype="bfloat16")
    eight = IndexConfig(n=1 << 20, d=32, beta=64, n_shards=8,
                        vec_dtype="bfloat16")
    # family (proj + b_int/b_frac + width) + n_valid stay replicated;
    # the row arrays (codes i32 + bf16 vectors) scale 1/8 per device
    family_and_scalars = 32 * 64 * 4 + 64 * (4 + 4) + 4 + 4
    rows_one = one.state_nbytes - family_and_scalars
    rows_eight = eight.state_nbytes - family_and_scalars
    assert rows_one == (1 << 20) * (64 * 4 + 32 * 2)
    assert rows_eight == rows_one // 8
    # shard count is part of the step's identity
    assert one.shape_signature() != eight.shape_signature()
    assert one != eight


def test_shards_on_one_device_are_priced_together():
    """Four slices on one device cost that device the whole state: a byte
    budget that fits one unsharded state keeps one sharded state resident,
    not four, and ``resident_bytes`` counts every slice."""
    data, plan, qpts, wids, _ = _fixture(2.0)
    one = _svc(plan, data, 1)
    per_state = one.group_config(0).state_nbytes
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=_K, q_batch=4, device="cpu", delta_reserve_rows=_RESERVE,
        device_budget_bytes=per_state + per_state // 2),
        devices=("cpu",) * 4)
    sliced = svc.group_config(0).state_nbytes
    assert sliced < per_state // 3
    assert svc.batcher.state_nbytes(0) == 4 * sliced
    gids = np.unique(svc.batcher.route(wids))
    assert len(gids) > 1
    _assert_same(svc.query(qpts, wids), one.query(qpts, wids),
                 "devices=('cpu',) * 4 under a one-state budget")
    assert svc.state_cache.n_resident == 1
    for gi in map(int, gids):
        with svc.state_cache.lease(gi) as st:
            assert svc.state_cache.n_resident == 1
            assert svc.resident_bytes == svc.batcher.state_nbytes(gi)
            # every slice's tensors, plus the n_valid scalar a slice
            assert st.nbytes + 4 * 4 == svc.resident_bytes


def test_row_capacity_rounds_up_to_a_shard_multiple():
    data, plan, *_ = _fixture(2.0)
    assert _svc(plan, data, 8, delta_reserve_rows=0).batcher.row_capacity(
    ) == 1008
    assert _svc(plan, data, 1, delta_reserve_rows=0).batcher.row_capacity(
    ) == _N
    svc = _svc(plan, data, 8)
    with svc.state_cache.lease(0) as st:
        assert st.n_shards == 8 and st.rows_per_shard == 126
        # the eight slices share the CPU device: priced together there
        assert st.nbytes == 8 * (svc.group_config(0).state_nbytes - 4)
        assert st.offsets == tuple(126 * s for s in range(8))
        # the ragged tail: the last shard holds 121 live rows of its 126
        assert [sh.n_valid for sh in st.shards] == [126] * 7 + [121]


def test_strict_sharding_refuses_a_non_dividing_capacity():
    data, plan, *_ = _fixture(2.0)
    cfg = IndexConfig(n=_N, d=_D, beta=plan.groups[0].beta_group,
                      n_shards=8)
    with pytest.raises(ValueError, match="does not divide 8 shards"):
        build_group_state(cfg, data, plan.groups[0], "cpu")
    cfg3 = IndexConfig(n=1003 + 2, d=_D, beta=plan.groups[0].beta_group,
                       n_shards=2)
    with pytest.raises(ValueError, match="does not divide 2 shards"):
        build_group_state(cfg3, data, plan.groups[0], "cpu")


# ------------------------------------------------------------- merges


def test_merge_shard_topk_breaks_ties_by_gather_position():
    inf = float("inf")
    vals = [torch.tensor([[1.0, 2.0, inf]]), torch.tensor([[1.0, 1.5, 2.0]])]
    # shard 0's ids are not ascending: ties must keep gather order
    idx = [torch.tensor([[9, 3, -1]], dtype=torch.int32),
           torch.tensor([[4, 7, 8]], dtype=torch.int32)]
    v, i = gs.merge_shard_topk(vals, idx, 4, torch.device("cpu"))
    assert v.tolist() == [[1.0, 1.0, 1.5, 2.0]]
    assert i.tolist() == [[9, 4, 7, 3]]
    v, i = gs.merge_shard_topk([torch.full((1, 2), inf)] * 2,
                               [torch.full((1, 2), -1, dtype=torch.int32)]
                               * 2, 2, torch.device("cpu"))
    assert i.tolist() == [[-1, -1]] and torch.isinf(v).all()


def test_merge_histograms_add_exactly():
    rng = np.random.default_rng(0)
    hs = [torch.from_numpy(rng.integers(0, 1000, (5, 7)).astype(np.int32))
          for _ in range(4)]
    f, g = gs.merge_histograms(hs, hs[::-1], torch.device("cpu"))
    assert torch.equal(f, sum(hs)) and torch.equal(g, sum(hs))
    assert f.dtype == torch.int32


# ------------------------------------------------------------- search


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def test_sharded_search_bit_exact_with_unsharded(p):
    """Shards in {2, 8} answer bit for bit as one device does (sync,
    paged at one resident group, async) on the ragged 1003-row corpus;
    the unsharded answers agree with the host oracle."""
    data, plan, qpts, wids, host = _fixture(p)
    base = _svc(plan, data, 1).query(qpts, wids)
    for qi in range(_NQ):
        want = host.search_dense(qpts[qi], weight_id=int(wids[qi]), k=_K)
        np.testing.assert_array_equal(base.ids[qi],
                                      want.ids.astype(np.int32))
        assert int(base.stop_levels[qi]) == want.stats.stop_level
        assert int(base.n_checked[qi]) == want.stats.n_checked
    for shards in (2, 8):
        _assert_same(_svc(plan, data, shards).query(qpts, wids), base,
                     f"sync shards={shards}")
        paged = _svc(plan, data, shards, max_resident_groups=1)
        chunks = [paged.query(qpts[lo:lo + 4], wids[lo:lo + 4])
                  for lo in range(0, _NQ, 4)]
        for f in _FIELDS:
            np.testing.assert_array_equal(
                np.concatenate([getattr(c, f) for c in chunks]),
                getattr(base, f), err_msg=f"paged shards={shards}: {f}")
        assert paged.cache_summary()["n_restores"] > 0
        arrivals = np.cumsum(np.random.default_rng(5).exponential(
            1 / 2000.0, _NQ))
        asvc = AsyncRetrievalService(paged.batcher, max_delay_ms=2.0,
                                     clock=ManualClock())
        res_a, _ = replay_open_loop(asvc, qpts, wids, arrivals)
        _assert_same(res_a, base, f"async shards={shards}")


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5], ids=lambda p: f"p{p}")
def test_sharded_unfused_and_device_encoded_bit_exact(p):
    """The unfused route masks by the global row and a plan without host
    codes encodes each shard on its device: both bit for bit as one
    device."""
    data, plan, qpts, wids, _ = _fixture(p)
    base = _svc(plan, data, 1, use_kernels="off").query(qpts, wids)
    _assert_same(_svc(plan, data, 8, use_kernels="off").query(qpts, wids),
                 base, "unfused shards=8")
    data, plan, qpts, wids, _ = _fixture(p, codes=False)
    base = _svc(plan, data, 1).query(qpts, wids)
    _assert_same(_svc(plan, data, 2).query(qpts, wids), base,
                 "device-encoded shards=2")


def test_sharded_offload_restore_roundtrip_per_shard():
    """Evicting a sharded state keeps one host chunk per shard; restoring
    it gives the same bytes shard by shard, and the pager reuses the
    group's buffers on the next offload."""
    data, plan, qpts, wids, _ = _fixture(2.0)
    svc = _svc(plan, data, 8)
    gi = int(svc.batcher.route(wids)[0])
    with svc.state_cache.lease(gi) as st:
        host = gs.offload_state_sharded(st)
        assert len(host.shards) == 8
        assert all(sh.codes.shape[0] == sh.points.shape[0] == 126
                   for sh in host.shards)
        restored = gs.restore_state_sharded(host, svc.devices)
        _assert_equal_states(restored, st)
        assert torch.equal(torch.cat([sh.codes for sh in host.shards]),
                           torch.cat([sh.codes for sh in st.shards]))
        pager = StatePager(svc.devices)
        pager.adopt(gi, st)
        first = pager.offload(st)
        again = pager.offload(st)
    assert isinstance(again, gs.HostShardedState)
    assert all(a.codes.data_ptr() == b.codes.data_ptr()
               for a, b in zip(first.shards, again.shards))
    assert pager.pinned_bytes == sum(
        t.numel() * t.element_size() for sh in again.shards
        for t in (sh.codes, sh.points, sh.proj, sh.b_int, sh.b_frac,
                  sh.width))
    back = pager.restore(gi, again)
    _assert_equal_states(back, restored)
    assert back.offsets == tuple(126 * s for s in range(8))


@pytest.mark.parametrize("codes", [True, False],
                         ids=["host-codes", "device-encode"])
def test_per_host_build_matches_materialized_build(codes):
    """``points_loader`` builds shard by shard from row ranges, equal to
    the materialized build, and the loader never sees more than one
    shard's live rows."""
    data, plan, *_ = _fixture(2.0, codes=codes)
    svc = _svc(plan, data, 8)
    cfg, gplan = svc.group_config(0), plan.groups[0]
    whole = build_group_state(cfg, data, gplan, svc.devices)
    calls = []

    def loader(lo, hi):
        calls.append((lo, hi))
        return data[lo:hi]

    hosted = build_group_state(cfg, None, gplan, svc.devices,
                               points_loader=loader, n_points=_N)
    assert calls == [(s * 126, min((s + 1) * 126, _N)) for s in range(8)]
    _assert_equal_states(hosted, whole)
    # and the sharded build equals the unsharded build's row slices
    one = build_group_state(dataclasses.replace(cfg, n_shards=1), data,
                            gplan, "cpu")
    for sh, off in zip(whole.shards, whole.offsets):
        assert torch.equal(sh.codes, one.codes[off:off + 126])
        assert torch.equal(sh.points, one.points[off:off + 126])
    with pytest.raises(ValueError, match="not both"):
        build_group_state(cfg, data, gplan, svc.devices,
                          points_loader=loader, n_points=_N)
    with pytest.raises(ValueError, match="requires n_points"):
        build_group_state(cfg, None, gplan, svc.devices,
                          points_loader=loader)


# ------------------------------------------------------------ streaming


def test_append_to_state_splits_at_slice_boundaries():
    data, plan, *_ = _fixture(2.0)
    gplan = plan.groups[0]
    cfg = IndexConfig(n=1040, d=_D, beta=pad_beta(gplan.beta_group),
                      n_shards=4)
    devs = gs.serving_devices(4, "cpu")
    st = build_group_state(cfg, data, gplan, devs, base_rows=np.arange(250))
    rows = data[250:800]
    codes = seal_segment(cfg, gplan, rows)
    out = append_to_state(st, codes, rows)  # crosses 260, 520 and 780
    assert [sh.n_valid for sh in out.shards] == [260, 260, 260, 20]
    assert out.n_valid == 800
    _assert_equal_states(out, build_group_state(cfg, data, gplan, devs,
                                                base_rows=np.arange(800)))
    with pytest.raises(ValueError, match="exceeds row capacity 1040"):
        append_to_state(out, codes, rows)


@pytest.mark.parametrize("codes", [True, False],
                         ids=["host-codes", "device-encode"])
def test_sharded_compaction_and_purge_match_fresh_sharded_build(codes):
    """Inserts compacted into sharded states equal a fresh sharded union
    build (the port's own build: the JAX package's append raises under
    jax 0.9), a purge equals a fresh build over the survivors, and the
    answers equal the unsharded service's at every step."""
    data, plan, qpts, wids, _ = _fixture(2.0, codes=codes)
    rng = np.random.default_rng(44)
    ins = (data[rng.choice(_N, 40, replace=False)]
           + rng.normal(0, 3.0, (40, _D))).astype(np.float32)
    ins_w = rng.integers(0, len(plan.weights), 40)
    asks = (np.r_[qpts, ins], np.r_[wids, ins_w])
    out = {}
    for shards in (1, 8):
        svc = _svc(plan, data, shards, delta_reserve_rows=61,
                   delta_seal_rows=8, max_resident_groups=2)
        pids = [svc.insert(v, int(w)) for v, w in zip(ins, ins_w)]
        pending = svc.query(*asks)
        assert svc.compact() == 40
        compacted = svc.query(*asks)
        b = svc.batcher
        for gi in range(plan.n_groups):
            sel = np.where(plan.group_of[ins_w] == gi)[0]
            cfg, g = b.group_config(gi), plan.groups[gi]
            fresh = build_group_state(
                cfg, data, g, b.devices, extra_points=ins[sel],
                extra_codes=seal_segment(cfg, g, ins[sel]) if codes
                else None)
            with b.lease(gi) as st:
                _assert_equal_states(st, fresh)
        gone = pids[:5] + [int(compacted.ids[0, 0])]
        for pid in gone:
            svc.delete(pid)
        svc.compact(purge=True)
        purged = svc.query(*asks)
        assert not np.isin(purged.ids, gone).any()
        out[shards] = (pending, compacted, purged)
    for a, b_, what in zip(out[8], out[1], ("pending", "compacted",
                                            "purged")):
        _assert_same(a, b_, f"{what} shards=8")


# ------------------------------------------------------- against JAX


_JAX_CHILD = """
    import itertools, json, sys
    import numpy as np, jax
    from repro.core.datagen import make_dataset, make_weight_set
    from repro.core.params import PlanConfig
    from repro.core.wlsh import WLSHIndex
    from repro.serving import RetrievalService, ServiceConfig

    assert jax.device_count() == 8
    data = make_dataset(n=1003, d=16, seed=41)
    weights = make_weight_set(size=8, d=16, n_subset=4, n_subrange=10,
                              seed=42)
    host = WLSHIndex(data, weights,
                     PlanConfig(p=2.0, c=3, n=len(data), gamma_n=100.0),
                     tau=500.0, v=4, v_prime=4, seed=9)
    plan = host.export_serving_plan()
    rng = np.random.default_rng(43)
    wids = rng.integers(0, len(weights), 12)
    qpts = data[rng.choice(len(data), 12, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    out = {}
    spans = {}
    for shards in (2, 8):
        svc = RetrievalService(plan, data, cfg=ServiceConfig(
            k=3, q_batch=4, block_n=63, delta_reserve_rows=5,
            n_shards=shards, obs=True))
        assert svc.mesh.size == shards
        svc.warmup()
        tick = itertools.count()
        svc.batcher.clock = lambda: float(next(tick))
        res = svc.query(qpts, wids)
        for f in ("ids", "dists", "stop_levels", "n_checked", "group_ids"):
            out[f"{f}_{shards}"] = np.asarray(getattr(res, f))
        spans[shards] = [s.to_dict() for s in svc.batcher.tracer.spans()]
    np.savez(sys.argv[1], **out)
    with open(sys.argv[2], "w") as fh:
        json.dump(spans, fh)
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The JAX package's sharded answers and spans at S in {2, 8}."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    npz, spans = tmp / "answers.npz", tmp / "spans.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_CHILD), str(npz),
         str(spans)], capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(spans) as fh:
        return dict(np.load(npz)), {int(k): v for k, v in
                                    json.load(fh).items()}


def _jax_plan():
    from repro.core.datagen import make_dataset as jmake
    from repro.core.datagen import make_weight_set as jweights
    from repro.core.params import PlanConfig as JaxPlanConfig
    from repro.core.wlsh import WLSHIndex as JaxIndex

    data = jmake(n=_N, d=_D, seed=41)
    weights = jweights(size=8, d=_D, n_subset=4, n_subrange=10, seed=42)
    host = JaxIndex(data, weights,
                    JaxPlanConfig(p=2.0, c=3, n=_N, gamma_n=100.0),
                    tau=500.0, v=4, v_prime=4, seed=9)
    return data, port_plan(host.export_serving_plan())


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_service_matches_jax(jax_sharded, shards):
    """The port at S shards against the JAX package at S shards: ids,
    stop levels, n_checked and groups equal, distances to rtol 1e-6,
    and the trace spans (n_shards included) equal on a tick clock."""
    want, want_spans = jax_sharded
    data, plan = _jax_plan()
    rng = np.random.default_rng(43)  # the child's queries
    wids = rng.integers(0, len(plan.weights), _NQ)
    qpts = data[rng.choice(_N, _NQ, replace=False)].astype(np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    svc = _svc(plan, data, shards, obs=True)
    svc.warmup()
    tick = itertools.count()
    svc.batcher.clock = lambda: float(next(tick))
    got = svc.query(qpts, wids)
    for f in ("ids", "stop_levels", "n_checked", "group_ids"):
        np.testing.assert_array_equal(getattr(got, f),
                                      want[f"{f}_{shards}"], err_msg=f)
    np.testing.assert_allclose(got.dists, want[f"dists_{shards}"],
                               rtol=1e-6)
    spans = [s.to_dict() for s in svc.batcher.tracer.spans()]
    assert all(s["n_shards"] == shards for s in spans)
    assert spans == want_spans[shards]
    _assert_same(got, _svc(plan, data, 1).query(qpts, wids),
                 f"port shards={shards} vs port unsharded")


# ------------------------------------------------------------ launcher


def test_cli_shards_on_cpu(capsys):
    out = launch.run(launch.parse_args([
        "--n", "512", "--d", "16", "--n-weights", "4", "--n-subset", "2",
        "--n-queries", "8", "--k", "3", "--v", "4", "--q-batch", "4",
        "--device", "cpu", "--shards", "2", "--check"]))
    assert out["n_check_failures"] == 0
    text = capsys.readouterr().out
    assert "sharding: 2 shards over devices ['cpu', 'cpu'] (256 rows/shard" \
        in text
    assert "check vs search_dense: 8/8 exact" in text
