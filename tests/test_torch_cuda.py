"""CUDA kernels on the card (marker ``cuda``; skipped without a device).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The fixture builds every ``kernels/csrc/*.cu`` with nvcc.  Each kernel is
held to its plain torch version on the same CUDA tensors: histograms,
first-frequent levels and the +inf mask exactly, hash codes exactly (the
kernel sums in the plain version's order) and within the float64 window,
finite scores to rtol 1e-5 (or the p = 2 atol of the norms expansion).
bfloat16 rows are held the same way, and to the float32 kernels on
the widened rows bit for bit.  The serving path's single scan (the keep
pass, then the mask on its carry) is held to the two-pass kernels bit
for bit.  ``chip_smoke.py`` repeats this at the main path's shapes.  The paging
tests hold an evict/restore round trip bit for bit, a prefetched restore
followed at once by a launch on another stream to the unpaged answers,
and the thread-mode ``ServiceDriver`` under a one-group budget.  The
streaming tests hold a plan without host codes' seals to the plain
``hash_encode`` and its compacted state to a fresh device build, a
compaction issued right after a prefetched restore (on a second
stream) to a fresh union build and to an unpaged service, and a
replaced state's offload to the group's existing pinned buffers.  The
bench sentinel's workload on the card is held to its CPU run's seeded
metrics.  ``index.builder.build_state`` on a one-rank NCCL mesh launches
``hash_encode`` once and gives the plain version's codes.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from repro_torch.kernels import _cuda, fused_query, ops, ref
from repro_torch.kernels.freq_level import freq_level
from repro_torch.kernels.hash_encode import hash_encode
from repro_torch.kernels.weighted_lp import weighted_lp

from _torch_inputs import (assert_scores_close, make_edge_inputs,
                           make_pass_inputs)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda.build()
    return torch.device("cuda")


def _tensors(shape, seed, dev):
    n, d, beta, q, c, L, *codes = shape
    make = make_edge_inputs if codes == ["edge"] else make_pass_inputs
    arrs = make(n, d, beta, q, c, L, seed)
    names = ("cp", "cq", "pts", "qs", "qw", "mu", "beta_q", "r_min", "stop")
    return {k: torch.from_numpy(a).to(dev) for k, a in zip(names, arrs)}


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("shape", [(1000, 24, 40, 11, 3, 8),
                                   (333, 70, 100, 3, 2, 12),
                                   # IndexConfig's L = 24, Q ragged against
                                   # the 8-query block, and codes at the
                                   # digit-word test's edges
                                   (1000, 24, 64, 17, 2, 24),
                                   (1000, 24, 64, 33, 3, 24),
                                   (1000, 24, 64, 19, 2, 24, "edge"),
                                   (1000, 24, 64, 19, 3, 24, "edge")],
                         ids=str)
def test_kernels_match_plain_versions(dev, p, shape):
    n, _, _, _, c, L = shape[:6]
    t = _tensors(shape, 1, dev)
    args = [t[k] for k in ("cp", "pts", "cq", "qs", "qw", "mu", "beta_q")]
    kw = dict(boff=5, n_valid=n - 50, c=c, n_levels=L, p=p)
    row_ok = (5 + torch.arange(n, device=dev)) < n - 50
    fused_query.reset_launch_counts()
    hf, hg = fused_query.fused_query_hist(*args, t["r_min"], **kw)
    sc = fused_query.fused_query_scores(*args, t["stop"], **kw)
    torch.cuda.synchronize()
    assert fused_query.launch_counts == {"fused_query_hist": 1,
                                         "fused_query_scores": 1,
                                         "fused_query_keep": 0,
                                         "fused_query_mask": 0}
    rf, rg = ref.fused_query_hist_ref(*args, t["r_min"], row_ok, c=c,
                                      n_levels=L, p=p)
    rs = ref.fused_query_scores_ref(*args, t["stop"], row_ok, c=c,
                                    n_levels=L, p=p)
    assert torch.equal(hf, rf)
    assert torch.equal(hg, rg)
    assert_scores_close(sc.cpu().numpy(), rs.cpu().numpy(),
                        t["qs"].cpu().numpy(), t["qw"].cpu().numpy(),
                        t["pts"].cpu().numpy(), p)


@pytest.mark.parametrize("vec", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("shape", [(1001, 24, 40, 11, 2, 8),
                                   # c = 3 at L = 16 and at L = 20: the
                                   # narrow and the wide digit words
                                   (1003, 24, 64, 17, 3, 16),
                                   (998, 70, 64, 19, 3, 20),
                                   (1000, 24, 48, 9, 5, 10),
                                   (1000, 24, 64, 19, 3, 24, "edge")],
                         ids=str)
def test_keep_and_mask_equal_the_two_pass_kernels(dev, p, vec, shape):
    """The serving path's single scan on the card: the keep pass's
    histograms equal a ``fused_query_hist`` launch's, and the mask on its
    carry gives a ``fused_query_scores`` launch's scores bit for bit, on a
    shard at row offset 5 with a dead tail; its levels equal the plain
    version's, one launch of each kernel."""
    n, _, _, _, c, L = shape[:6]
    t = _tensors(shape, 4, dev)
    args = [t["cp"], t["pts"].to(vec), t["cq"], t["qs"], t["qw"], t["mu"],
            t["beta_q"]]
    kw = dict(boff=5, n_valid=n - 50, c=c, n_levels=L, p=p)
    hf, hg = fused_query.fused_query_hist(*args, t["r_min"], **kw)
    sc = fused_query.fused_query_scores(*args, t["stop"], **kw)
    fused_query.reset_launch_counts()
    kf, kg, lf, dist = fused_query.fused_query_keep(*args, t["r_min"], **kw)
    fused_query.fused_query_mask(lf, t["stop"], dist)
    torch.cuda.synchronize()
    assert fused_query.launch_counts == {"fused_query_hist": 0,
                                         "fused_query_scores": 0,
                                         "fused_query_keep": 1,
                                         "fused_query_mask": 1}
    assert torch.equal(kf, hf) and torch.equal(kg, hg)
    assert torch.equal(dist.view(torch.int32), sc.view(torch.int32))
    row_ok = (5 + torch.arange(n, device=dev)) < n - 50
    _, _, plain_lf, _ = ref.fused_query_keep_ref(*args, t["r_min"], row_ok,
                                                 c=c, n_levels=L, p=p)
    assert torch.equal(lf, plain_lf)
    assert bool((lf[:, n - 55:] == L + 2).all())


def test_mask_on_rows_of_any_length(dev):
    """The mask's 16-byte path (rows a multiple of 4 long, aligned) and
    its one-cell path (any other row, or a carry off the alignment) give
    the plain version's distances bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(6)
    for q, b, off in ((3, 4096, 0), (5, 1001, 0), (7, 402, 0), (2, 400, 1)):
        lf = torch.randint(0, 20, (q * b + off,), generator=g,
                           dtype=torch.uint8).to(dev)[off:].view(q, b)
        dist = torch.rand((q * b + off,), generator=g).to(dev)
        dist = dist[off:].view(q, b)
        stop = torch.randint(0, 20, (q,), generator=g,
                             dtype=torch.int32).to(dev)
        want = dist.clone()
        ref.fused_query_mask_ref(lf, stop, want)
        fused_query.fused_query_mask(lf, stop, dist)
        torch.cuda.synchronize()
        assert torch.equal(dist.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("shape", [(1000, 24, 40, 11, 3, 8),
                                   (1000, 70, 64, 17, 2, 24),
                                   (1000, 24, 64, 19, 3, 24, "edge")],
                         ids=str)
def test_bf16_kernels_match_plain_versions(dev, p, shape):
    """Both fused kernels on bfloat16 rows: equal to their plain versions
    on the same rows (the rules above), and bit for bit to the float32
    kernels on the rows widened (widening is exact, and nothing after
    the load changes)."""
    n, _, _, _, c, L = shape[:6]
    t = _tensors(shape, 3, dev)
    bf = t["pts"].to(torch.bfloat16)
    wide = bf.float()
    kw = dict(boff=5, n_valid=n - 50, c=c, n_levels=L, p=p)
    row_ok = (5 + torch.arange(n, device=dev)) < n - 50
    out = {}
    for name, pts in (("bf16", bf), ("wide", wide)):
        args = [t["cp"], pts, t["cq"], t["qs"], t["qw"], t["mu"],
                t["beta_q"]]
        out[name] = (*fused_query.fused_query_hist(*args, t["r_min"], **kw),
                     fused_query.fused_query_scores(*args, t["stop"], **kw))
    args = [t["cp"], bf, t["cq"], t["qs"], t["qw"], t["mu"], t["beta_q"]]
    rf, rg = ref.fused_query_hist_ref(*args, t["r_min"], row_ok, c=c,
                                      n_levels=L, p=p)
    rs = ref.fused_query_scores_ref(*args, t["stop"], row_ok, c=c,
                                    n_levels=L, p=p)
    torch.cuda.synchronize()
    for a, b in zip(out["bf16"], out["wide"]):
        assert torch.equal(a, b)
    hf, hg, sc = out["bf16"]
    assert torch.equal(hf, rf)
    assert torch.equal(hg, rg)
    assert_scores_close(sc.cpu().numpy(), rs.cpu().numpy(),
                        t["qs"].cpu().numpy(), t["qw"].cpu().numpy(),
                        wide.cpu().numpy(), p)


def test_bf16_service_on_the_card_matches_the_cpu(dev):
    """bfloat16 storage: the same states, stop levels, n_checked and ids
    on the card as on the CPU, and no float32 copy of a state's rows."""
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.serving import RetrievalService, ServiceConfig

    data = make_dataset(n=4096, d=64, seed=13)
    weights = make_weight_set(size=8, d=64, n_subset=4, n_subrange=10,
                              seed=14)
    plan = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=4096),
                     tau=500.0, v=4, v_prime=4, seed=15).export_serving_plan()
    rng = np.random.default_rng(16)
    wids = rng.integers(0, 8, 32)
    qs = (data[rng.choice(4096, 32)] + rng.normal(0, 3, (32, 64))).astype(
        np.float32)
    svcs = [RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=8, vec_dtype="bfloat16", device=d))
        for d in ("cuda", "cpu")]
    out = [s.query(qs, wids) for s in svcs]
    for f in ("ids", "stop_levels", "n_checked"):
        np.testing.assert_array_equal(getattr(out[0], f), getattr(out[1], f))
    np.testing.assert_allclose(out[0].dists, out[1].dists, rtol=1e-6)
    with svcs[0].state_cache.lease(0) as st, \
            svcs[1].state_cache.lease(0) as st_cpu:
        assert st.points.dtype == torch.bfloat16
        assert torch.equal(st.points.cpu(), st_cpu.points)
        n, d = st.points.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    svcs[0].query(qs, wids)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < n * d * 4


def test_wrappers_check_their_inputs(dev):
    t = _tensors((300, 8, 16, 2, 3, 6), 2, dev)
    args = [t[k] for k in ("cp", "pts", "cq", "qs", "qw", "mu", "beta_q")]
    kw = dict(boff=0, n_valid=300, c=3, n_levels=6, p=2.0)
    with pytest.raises(TypeError):
        fused_query.fused_query_hist(args[0].float(), *args[1:],
                                     t["r_min"], **kw)
    with pytest.raises(ValueError):
        fused_query.fused_query_scores(*args[:6], args[6][:1], t["stop"],
                                       **kw)
    with pytest.raises(ValueError):
        fused_query.fused_query_scores(args[0].t().contiguous().t(),
                                       *args[1:], t["stop"], **kw)
    with pytest.raises(ValueError):
        fused_query.fused_query_hist(*args[:-1], args[-1].cpu(),
                                     t["r_min"], **kw)
    with pytest.raises(TypeError):  # float32 or bfloat16 rows only
        fused_query.fused_query_hist(args[0], args[1].half(), *args[2:],
                                     t["r_min"], **kw)
    _, _, lf, dist = fused_query.fused_query_keep(*args, t["r_min"], **kw)
    with pytest.raises(TypeError):  # the levels are bytes
        fused_query.fused_query_mask(lf.int(), t["stop"], dist)
    with pytest.raises(ValueError):
        fused_query.fused_query_mask(lf[:1], t["stop"], dist)
    with pytest.raises(ValueError, match="255"):
        fused_query.fused_query_keep(*args, t["r_min"], **dict(
            kw, n_levels=254))


def test_service_on_the_card_matches_the_cpu(dev):
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.serving import RetrievalService, ServiceConfig

    data = make_dataset(n=2048, d=24, seed=3)
    weights = make_weight_set(size=8, d=24, n_subset=4, n_subrange=10,
                              seed=4)
    plan = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=2048),
                     tau=500.0, v=4, v_prime=4, seed=5).export_serving_plan()
    rng = np.random.default_rng(6)
    wids = rng.integers(0, 8, 32)
    qs = (data[rng.choice(2048, 32)] + rng.normal(0, 3, (32, 24))).astype(
        np.float32)
    out = [RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=8, device=d)).query(qs, wids) for d in ("cuda", "cpu")]
    np.testing.assert_array_equal(out[0].ids, out[1].ids)
    np.testing.assert_array_equal(out[0].stop_levels, out[1].stop_levels)
    np.testing.assert_array_equal(out[0].n_checked, out[1].n_checked)
    np.testing.assert_allclose(out[0].dists, out[1].dists, rtol=1e-6)


def _family(p, d, beta, seed, dev):
    from repro_torch.core.families import sample_lp_family

    rng = np.random.default_rng(seed)
    cw = rng.uniform(1, 10, d).astype(np.float32)
    fam = sample_lp_family(d, beta, p, 40.0, cw, 500.0, 3, seed=seed)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        cw, fam.proj, fam.b_int, fam.b_frac)], fam.width


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("n,d,beta", [(333, 70, 100), (64, 400, 64),
                                      # across the kernel's 128 x 64 block,
                                      # 32-dim slab and 8-dim run edges
                                      (1, 33, 65), (129, 397, 449),
                                      (1000, 31, 513)])
def test_hash_encode_matches_plain_version(dev, p, n, d, beta):
    (w, proj, b_int, b_frac), width = _family(p, d, beta, 3, dev)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 10_000, (n, d)).astype(np.float32)).to(dev)
    _cuda.reset_launch_counts()
    got = hash_encode(x, w, proj, b_int, b_frac, width)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["hash_encode"] == 1
    want = ref.hash_encode_ref(x, proj, b_int, b_frac, w, width)
    assert torch.equal(got, want)
    lo, hi = ref.hash_code_window(x, proj, b_frac, w, width)
    v = ref.unbias_codes(got, b_int)
    assert bool(((v >= lo) & (v <= hi)).all())
    for rows in (1, 7, 64):  # a row's codes do not depend on its batch
        assert torch.equal(hash_encode(x[:rows].contiguous(), w, proj,
                                       b_int, b_frac, width), got[:rows])


@pytest.mark.parametrize("c", [2, 3, 4])
def test_freq_level_matches_plain_version(dev, c):
    t = _tensors((1000, 8, 40, 11, c, 8), 5, dev)
    _cuda.reset_launch_counts()
    got = freq_level(t["cp"], t["cq"], t["mu"], t["beta_q"], c=c,
                     n_levels=8)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["freq_level"] == 1
    want = ref.freq_level_ref(t["cp"], t["cq"], t["mu"], c, 8, t["beta_q"])
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 4


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("L", [8, 16, 24])
@pytest.mark.parametrize("codes", ["seeded", "edge"])
def test_freq_level_word_tests_match_plain_version(dev, c, L, codes):
    """The digit-word matcher (narrow, and wide for c = 3 at L = 24) with Q
    ragged against the 8-query block and n against the 128-row tile."""
    shape = (1000, 8, 64, 61, c, L) + (("edge",) if codes == "edge" else ())
    t = _tensors(shape, 7 + L, dev)
    args = (t["cp"], t["cq"], t["mu"])
    _cuda.reset_launch_counts()
    got = freq_level(*args, t["beta_q"], c=c, n_levels=L)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["freq_level"] == 1
    assert torch.equal(got, ref.freq_level_ref(*args, c, L, t["beta_q"]))
    assert torch.equal(got, ref.freq_level_words_ref(*args, c, L,
                                                     t["beta_q"]))
    assert len(torch.unique(got)) > 4


@pytest.mark.parametrize("p", [1.0, 0.5, 1.5])
@pytest.mark.parametrize("n,d,q", [(777, 70, 9), (1001, 397, 61)])
def test_weighted_lp_matches_plain_version(dev, p, n, d, q):
    t = _tensors((n, d, 8, q, 3, 4), 6, dev)
    w = t["qw"][0].contiguous()
    _cuda.reset_launch_counts()
    got = weighted_lp(t["qs"], t["pts"], w, p)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["weighted_lp"] == 1
    want = ref.weighted_lp_ref(t["qs"], t["pts"], w, p)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    ops.weighted_lp_dist(t["qs"], t["pts"], w, 2.0)  # the expansion
    assert _cuda.launch_counts()["weighted_lp"] == 1
    with pytest.raises(ValueError):
        weighted_lp(t["qs"], t["pts"], w, 2.0)


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_weighted_lp_single_terms_equal_plain_version(dev, p):
    """At d = 1 a distance is one term, |t| for p = 1 and sqrt(|t|)**2 for
    p = 0.5, so the kernel must give the plain version's bits: for p = 0.5
    its branch-free square root must be sqrtf's (PyTorch's pow(x, 0.5) is
    its sqrt kernel).  Magnitudes span the float32 range, with zeros,
    subnormals and infinities among the terms."""
    rng = np.random.default_rng(8)
    n, q = 4099, 61

    def spread(shape):
        scale = 2.0 ** rng.integers(-149, 127, shape)
        return (rng.uniform(1, 2, shape) * scale
                * rng.choice([-1.0, 1.0], shape)).astype(np.float32)

    qs, pts = spread((q, 1)), spread((n, 1))
    pts[:q] = qs  # t = 0
    for w in (spread((1,)), np.float32([3e-39]), np.float32([7.5])):
        args = [torch.from_numpy(a).to(dev) for a in (qs, pts, np.abs(w))]
        _cuda.reset_launch_counts()
        got = weighted_lp(*args, p)
        torch.cuda.synchronize()
        assert _cuda.launch_counts()["weighted_lp"] == 1
        want = ref.weighted_lp_ref(*args, p)
        assert not torch.isnan(want).any()
        assert torch.equal(got, want)


def test_new_wrappers_check_their_inputs(dev):
    t = _tensors((300, 8, 16, 2, 3, 6), 2, dev)
    (w, proj, b_int, b_frac), width = _family(1.0, 8, 16, 2, dev)
    with pytest.raises(TypeError):
        hash_encode(t["pts"], w, proj, b_int.float(), b_frac, width)
    with pytest.raises(ValueError):
        hash_encode(t["pts"], w[:4], proj, b_int, b_frac, width)
    with pytest.raises(ValueError):
        hash_encode(t["pts"], w.cpu(), proj, b_int, b_frac, width)
    with pytest.raises(TypeError):
        freq_level(t["cp"].float(), t["cq"], t["mu"], t["beta_q"], c=3,
                   n_levels=6)
    with pytest.raises(ValueError):
        freq_level(t["cp"], t["cq"], t["mu"][:1], t["beta_q"], c=3,
                   n_levels=6)
    with pytest.raises(ValueError):
        weighted_lp(t["qs"], t["pts"].t().contiguous().t(), t["qw"][0], 1.0)
    with pytest.raises(ValueError):
        weighted_lp(t["qs"], t["pts"], t["qw"][0].cpu(), 1.0)


@pytest.mark.parametrize("p,tau", [(2.0, 500.0), (0.5, 2_000.0)])
def test_service_without_host_codes_finds_itself(dev, p, tau):
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.serving import RetrievalService, ServiceConfig

    data = make_dataset(n=2048, d=24, seed=3)
    weights = make_weight_set(size=8, d=24, n_subset=4, n_subrange=10,
                              seed=4)
    plan = WLSHIndex(data, weights, PlanConfig(p=p, c=3, n=2048), tau=tau,
                     v=4, v_prime=4, seed=5).export_serving_plan(
                         include_codes=False)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(k=5, q_batch=8))
    rows = np.arange(0, 2048, 97)
    wids = np.random.default_rng(6).integers(0, 8, len(rows))
    _cuda.reset_launch_counts()
    res = svc.query(data[rows], wids)
    np.testing.assert_array_equal(res.ids[:, 0], rows)
    assert np.all(res.dists[:, 0] < 1e-3)
    assert _cuda.launch_counts()["hash_encode"] > 0


# ------------------------------------------------------- paging on the card


def _paging_plan(n, d, seed):
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex

    data = make_dataset(n=n, d=d, seed=seed)
    weights = make_weight_set(size=8, d=d, n_subset=4, n_subrange=10,
                              seed=seed + 1)
    plan = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=n), tau=500.0,
                     v=4, v_prime=4, seed=seed + 2).export_serving_plan()
    return data, plan


def _queries(data, n_weights, nq, seed):
    rng = np.random.default_rng(seed)
    wids = rng.integers(0, n_weights, nq)
    qs = data[rng.choice(len(data), nq, replace=False)]
    return (qs + rng.normal(0, 3, qs.shape)).astype(np.float32), wids


def test_offload_restore_round_trip_is_bit_exact(dev):
    """Evict -> restore through the pager twice: every QueryState field
    equal bit for bit, host copies pinned, the group's buffers reused,
    and each copy's device time reported once it is done."""
    from repro_torch.index.builder import StatePager
    from repro_torch.serving import RetrievalService, ServiceConfig

    data, plan = _paging_plan(4096, 24, 11)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(k=5, q_batch=8))
    with svc.state_cache.lease(1) as st:
        pager = StatePager(dev)
        pager.adopt(1, st)
        host = pager.offload(st)
        ptrs = [t.data_ptr() for t in (host.codes, host.points, host.proj)]
        assert all(t.is_pinned() for t in (host.codes, host.points,
                                           host.proj, host.b_int,
                                           host.b_frac, host.width))
        for _ in range(2):
            back = pager.restore(1, host)
            pager.ready(1, back)
            for name in ("codes", "points", "proj", "b_int", "b_frac",
                         "width"):
                a, b = getattr(back, name), getattr(st, name)
                assert a.device == b.device and a.dtype == b.dtype
                assert torch.equal(a, b), name
            assert back.n_valid == st.n_valid
            host = pager.offload(back)
            assert [t.data_ptr() for t in (host.codes, host.points,
                                           host.proj)] == ptrs
    torch.cuda.synchronize()
    timings = pager.restore_timings()
    assert len(timings) == 2
    assert all(nb == st.nbytes and s > 0 for nb, s in timings)
    assert pager.restore_timings() == []


def test_prefetched_restore_then_launch_on_another_stream(dev):
    """A prefetch restores a state on the copy stream and a launch on a
    different stream follows at once: its answers equal the unpaged
    service's on every repeat (the launch stream waits on the copy's
    event, and the restored tensors are recorded on it)."""
    from repro_torch.serving import RetrievalService, ServiceConfig

    data, plan = _paging_plan(65_536, 64, 21)
    qs, wids = _queries(data, 8, 64, 22)
    gids = plan.group_of[wids]
    full = RetrievalService(plan, data, cfg=ServiceConfig(k=5, q_batch=8))
    want = full.query(qs, wids)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=8, max_resident_groups=1))
    svc.warmup()
    cache, side = svc.state_cache, torch.cuda.Stream(dev)
    order = np.unique(gids)
    for rep in range(24):
        gi = int(order[rep % len(order)])
        rows = np.where(gids == gi)[0][:8]
        assert cache.prefetch(gi)  # evicts the other group, uploads gi
        with torch.cuda.stream(side):
            ids, dists, stop, chk = svc.batcher.run_batch(
                gi, qs[rows], wids[rows])
        np.testing.assert_array_equal(ids, want.ids[rows])
        np.testing.assert_array_equal(dists, want.dists[rows])
        np.testing.assert_array_equal(stop, want.stop_levels[rows])
        np.testing.assert_array_equal(chk, want.n_checked[rows])
    assert cache.stats.n_restore_overlapped == 24


def test_driver_thread_mode_under_one_group_budget(dev):
    """ServiceDriver in thread mode, on the real clock, over a service
    that keeps one group state on the card: every future resolves with
    the unpaged service's answer, and prefetches overlap restores."""
    from repro_torch.serving import (AsyncRetrievalService, RetrievalService,
                                     ServiceConfig, ServiceDriver)

    data, plan = _paging_plan(16_384, 32, 31)
    qs, wids = _queries(data, 8, 48, 32)
    want = RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=4)).query(qs, wids)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=4, max_resident_groups=1))
    svc.warmup()
    asvc = AsyncRetrievalService(svc, max_delay_ms=2.0)
    driver = ServiceDriver(asvc, tick_s=0.001).start()
    futs = []
    for i in range(len(qs)):
        futs.append(driver.submit(qs[i], wids[i]))
        time.sleep(0.002)
    t_end = time.monotonic() + 60.0
    while not all(f.done() for f in futs) and time.monotonic() < t_end:
        time.sleep(0.005)
    driver.stop(drain=True)
    assert all(f.done() for f in futs)
    got = np.stack([f.result().ids for f in futs])
    np.testing.assert_array_equal(got, want.ids)
    np.testing.assert_array_equal(
        np.array([f.result().n_checked for f in futs]), want.n_checked)
    assert svc.state_cache.stats.n_restores > 0


# ------------------------------------------------------ streaming on the card


def _far(data, rows, tag):
    return (data[rows] + 50_000.0 + 13.0 * tag).astype(np.float32)


def test_codeless_seal_equals_plain_encode_and_fresh_build(dev):
    """On a plan without host codes a seal hashes its rows with the
    ``hash_encode`` kernel on the group's state: the codes equal the
    plain version on the card bit for bit, and the compacted state
    equals a fresh device build over the union corpus."""
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.index.builder import build_group_state
    from repro_torch.serving import RetrievalService, ServiceConfig

    data = make_dataset(n=4096, d=64, seed=41)
    weights = make_weight_set(size=8, d=64, n_subset=4, n_subrange=10,
                              seed=42)
    plan = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=4096),
                     tau=500.0, v=4, v_prime=4, seed=43).export_serving_plan(
                         include_codes=False)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=8, delta_seal_rows=16, delta_reserve_rows=100))
    svc.warmup()
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    w_in = int(plan.groups[gi].member_ids[0])
    vecs = _far(data, np.arange(0, 4096, 128), 1)  # 32 rows: 2 seals
    _cuda.reset_launch_counts()
    pids = [svc.insert(v, w_in) for v in vecs]
    assert _cuda.launch_counts()["hash_encode"] == 2
    ones = torch.ones(plan.d, device=dev)
    with svc.state_cache.lease(gi) as st:
        for seg in svc.batcher.delta._groups[gi].sealed:
            plain = ref.hash_encode_ref(torch.tensor(seg.vectors, device=dev),
                                        st.proj, st.b_int, st.b_frac, ones,
                                        1.0)
            np.testing.assert_array_equal(seg.codes, plain.cpu().numpy())
    assert svc.compact() == 32
    fresh = build_group_state(svc.group_config(gi), data, plan.groups[gi],
                              extra_points=vecs)
    with svc.state_cache.lease(gi) as st:
        assert st.n_valid == fresh.n_valid == 4096 + 32
        assert torch.equal(st.codes, fresh.codes)
        assert torch.equal(st.points, fresh.points)
    res = svc.query(vecs, [w_in] * 32)
    np.testing.assert_array_equal(res.ids[:, 0], pids)


def test_compaction_right_after_prefetched_restore(dev):
    """A prefetch restores a group on the copy stream and a compaction of
    that group follows at once on a second stream, then a launch on the
    default stream: the compacted state equals a fresh union build and
    the answers equal an unpaged streaming service's, 24 times over (the
    compaction waits on the copy's event, the launch on the write's)."""
    from repro_torch.index.builder import build_group_state, seal_segment
    from repro_torch.serving import RetrievalService, ServiceConfig

    data, plan = _paging_plan(65_536, 64, 21)
    qs, wids = _queries(data, 8, 64, 22)
    gids = plan.group_of[wids]
    cfg = dict(k=5, q_batch=8, delta_seal_rows=4, delta_reserve_rows=256)
    full = RetrievalService(plan, data, cfg=ServiceConfig(**cfg))
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        max_resident_groups=1, **cfg))
    svc.warmup()
    cache, side = svc.state_cache, torch.cuda.Stream(dev)
    order = np.unique(gids)
    streamed: dict = {int(g): [] for g in order}
    for rep in range(24):
        gi = int(order[rep % len(order)])
        w_in = int(plan.groups[gi].member_ids[0])
        vecs = _far(data, np.arange(4) + 4 * rep, rep)
        streamed[gi].append(vecs)
        for s in (full, svc):
            for v in vecs:
                s.insert(v, w_in)  # seals at 4 rows (host codes)
        full.compact(gi)
        assert cache.prefetch(gi)  # evicts the other group, uploads gi
        with torch.cuda.stream(side):
            assert svc.compact(gi) == 4
        rows = np.where(gids == gi)[0][:4]
        q = np.concatenate([qs[rows], vecs])
        w = np.concatenate([wids[rows], [w_in] * 4])
        got, want = svc.query(q, w), full.query(q, w)
        for f in ("ids", "dists", "stop_levels", "n_checked"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        extra = np.concatenate(streamed[gi])
        gcfg = svc.group_config(gi)
        fresh = build_group_state(
            gcfg, data, plan.groups[gi], extra_points=extra,
            extra_codes=seal_segment(gcfg, plan.groups[gi], extra))
        with svc.batcher.lease(gi) as st:
            assert st.n_valid == fresh.n_valid
            assert torch.equal(st.codes, fresh.codes)
            assert torch.equal(st.points, fresh.points)
    assert cache.stats.n_restores >= 24


def test_replaced_state_reuses_pinned_buffers(dev):
    """After a compaction replaced a group's state, an evict/restore cycle
    writes the group's existing pinned buffers (``pinned_bytes``
    unchanged) and the restored state serves the appended rows."""
    from repro_torch.serving import RetrievalService, ServiceConfig

    data, plan = _paging_plan(16_384, 32, 31)
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=4, max_resident_groups=1, delta_seal_rows=8,
        delta_reserve_rows=64))
    svc.warmup()
    gi = int(np.argmax([g.n_members for g in plan.groups]))
    other = (gi + 1) % plan.n_groups
    w_in = int(plan.groups[gi].member_ids[0])
    w_other = int(plan.groups[other].member_ids[0])
    pager = svc.batcher.pager
    q0 = data[:1].astype(np.float32)
    svc.query(q0, [w_other])  # gi offloaded to its pinned buffers
    svc.query(q0, [w_in])  # and restored
    host = pager._groups[gi].host
    ptrs = [t.data_ptr() for t in (host.codes, host.points)]
    pinned = pager.pinned_bytes
    vecs = _far(data, np.arange(8), 3)
    pids = [svc.insert(v, w_in) for v in vecs]
    assert svc.compact() == 8
    svc.query(q0, [w_other])  # evicts the compacted state
    host = pager._groups[gi].host
    assert host.codes.is_pinned()
    assert [t.data_ptr() for t in (host.codes, host.points)] == ptrs
    assert pager.pinned_bytes == pinned
    res = svc.query(vecs, [w_in] * 8)  # restored, appended rows served
    np.testing.assert_array_equal(res.ids[:, 0], pids)
    assert np.all(res.dists[:, 0] == 0.0)


# ------------------------------------------------------- shards on the card


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
def test_fused_passes_on_the_last_shard(dev, p):
    """Both fused passes on the last of 4 row shards (boff = 750) with
    n_valid = 900 inside it: equal to their plain versions on the shard,
    and bit for bit to the same rows' columns of a whole-state launch."""
    n, s = 1000, 4
    t = _tensors((n, 24, 64, 17, 3, 24), 7, dev)
    off, n_valid = n - n // s, 900
    args = [t[k] for k in ("cp", "pts", "cq", "qs", "qw", "mu", "beta_q")]
    shard = [a[off:].contiguous() if k < 2 else a for k, a in
             enumerate(args)]
    kw = dict(n_valid=n_valid, c=3, n_levels=24, p=p)
    hf, hg = fused_query.fused_query_hist(*shard, t["r_min"], boff=off, **kw)
    sc = fused_query.fused_query_scores(*shard, t["stop"], boff=off, **kw)
    whole = fused_query.fused_query_scores(*args, t["stop"], boff=0, **kw)
    row_ok = (off + torch.arange(n - off, device=dev)) < n_valid
    rf, rg = ref.fused_query_hist_ref(*shard, t["r_min"], row_ok, c=3,
                                      n_levels=24, p=p)
    rs = ref.fused_query_scores_ref(*shard, t["stop"], row_ok, c=3,
                                    n_levels=24, p=p)
    torch.cuda.synchronize()
    assert torch.equal(hf, rf) and torch.equal(hg, rg)
    assert int(hf[:, -1].sum()) == (n - n_valid) * hf.shape[0]  # dead bin
    assert torch.equal(sc, whole[:, off:])
    assert bool(torch.isinf(sc[:, n_valid - off:]).all())
    assert_scores_close(sc.cpu().numpy(), rs.cpu().numpy(),
                        t["qs"].cpu().numpy(), t["qw"].cpu().numpy(),
                        shard[1].cpu().numpy(), p)


def test_per_shard_device_encode_equals_whole_encode(dev):
    """A plan without host codes built in 4 shards on one card: each
    shard's codes and vectors are the whole-state build's rows."""
    import dataclasses

    from repro_torch.index import IndexConfig, build_group_state, pad_beta

    data, plan = _paging_plan(4093, 24, 13)
    plan = dataclasses.replace(plan, groups=[
        dataclasses.replace(g, codes=None) for g in plan.groups])
    g = plan.groups[0]
    cfg = IndexConfig(n=4100, d=24, beta=pad_beta(g.beta_group), n_shards=4)
    _cuda.reset_launch_counts()
    sharded = build_group_state(cfg, data, g, ("cuda:0",) * 4)
    assert _cuda.launch_counts()["hash_encode"] == 4
    whole = build_group_state(dataclasses.replace(cfg, n_shards=1), data, g,
                              dev)
    assert [sh.n_valid for sh in sharded.shards] == [1025, 1025, 1025, 1018]
    for sh, off in zip(sharded.shards, sharded.offsets):
        assert torch.equal(sh.codes, whole.codes[off:off + 1025])
        assert torch.equal(sh.points, whole.points[off:off + 1025])


def test_sharded_service_on_the_card_matches_unsharded(dev):
    """Four shards on one card (devices named explicitly): answers bit
    for bit the unsharded service's, unpaged and paged at one resident
    group, with the keep pass and the mask launched once a shard a
    batch, and no second scan."""
    from repro_torch.serving import RetrievalService, ServiceConfig

    data, plan = _paging_plan(4093, 24, 17)
    qs, wids = _queries(data, 8, 40, 18)
    base = RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=8, delta_reserve_rows=7)).query(qs, wids)
    for kw in ({}, dict(max_resident_groups=1)):
        svc = RetrievalService(plan, data, cfg=ServiceConfig(
            k=5, q_batch=8, delta_reserve_rows=7, **kw),
            devices=("cuda:0",) * 4)
        svc.warmup()
        _cuda.reset_launch_counts()
        res = svc.query(qs, wids)
        n_batches = sum(s["n_batches"] for s in svc.stats_summary().values())
        launches = _cuda.launch_counts()
        assert launches["fused_query_keep"] == 4 * n_batches
        assert launches["fused_query_mask"] == 4 * n_batches
        assert launches["fused_query_hist"] == 0
        assert launches["fused_query_scores"] == 0
        for f in ("ids", "stop_levels", "n_checked"):
            np.testing.assert_array_equal(getattr(res, f), getattr(base, f))
        np.testing.assert_array_equal(res.dists.view(np.uint32),
                                      base.dists.view(np.uint32))


def test_sentinel_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The bench sentinel's seeded workload on the card (fused kernels)
    gives the CPU run's seeded metrics, and launches the keep pass and
    the mask once a step and no other kernel."""
    from benchmarks_torch import sentinel
    from repro_torch.index import engine

    steps = [0]
    step = engine.query_step

    def counted(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    monkeypatch.setattr(engine, "query_step", counted)
    _cuda.reset_launch_counts()
    got = sentinel.collect(device="cuda")
    launches = _cuda.launch_counts()
    n_steps = steps[0]
    want = sentinel.collect(device="cpu")
    for name in ("observed_recall", "recall_margin_min", "n_shadow_dropped",
                 "n_compiled_steps"):
        assert got[name] == want[name], name
    assert n_steps > 0
    assert launches["fused_query_keep"] == n_steps
    assert launches["fused_query_mask"] == n_steps
    assert launches["fused_query_hist"] == launches["fused_query_scores"] == 0
    assert launches["hash_encode"] == launches["freq_level"] == 0
    assert launches["weighted_lp"] == 0


def test_build_state_on_a_card_mesh_launches_hash_encode(dev):
    """``build_state`` on a (1, 1) mesh of a one-rank NCCL group: one
    ``hash_encode`` launch, codes equal to the plain version on the card
    (and the kernel within the float64 window), vectors and the folded
    family as given, every field on the card."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.families import sample_lp_family
    from repro_torch.index import IndexConfig, build_state, fold_center_weight

    rng = np.random.default_rng(21)
    n, d, beta = 3000, 37, 96
    w = rng.uniform(1.0, 10.0, d)
    fam = sample_lp_family(d, beta, 2.0, 1.0, w, 50.0, 3, seed=22)
    points = rng.uniform(0.0, 1000.0, (n, d)).astype(np.float32)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        _cuda.reset_launch_counts()
        state = build_state(mesh, IndexConfig(n=n, d=d, beta=beta), points,
                            fam)
        torch.cuda.synchronize()
        assert _cuda.launch_counts()["hash_encode"] == 1
        local = {f: getattr(state, f).to_local() for f in (
            "codes", "points", "proj", "b_int", "b_frac", "width")}
    finally:
        dist.destroy_process_group()
    assert all(t.device.type == "cuda" for t in local.values())
    folded = fold_center_weight(fam)
    for k in ("proj", "b_int", "b_frac", "width"):
        assert torch.equal(local[k].cpu(), torch.as_tensor(folded[k])), k
    x = torch.from_numpy(points).to(dev)
    assert torch.equal(local["points"], x)
    ones = torch.ones(d, device=dev)
    want = ref.hash_encode_ref(x, local["proj"], local["b_int"],
                               local["b_frac"], ones, 1.0)
    assert torch.equal(local["codes"], want)
    lo, hi = ref.hash_code_window(x, local["proj"], local["b_frac"], ones,
                                  1.0)
    v = ref.unbias_codes(local["codes"], local["b_int"])
    assert int(((v < lo) | (v > hi)).sum()) == 0
    assert state.n_valid == n
