"""The port's fused query passes (plain torch, on the CPU) vs the JAX package.

The same seeded numpy inputs go through ``repro_torch.kernels.ops.
fused_query_block`` (which, for CPU tensors, takes the plain torch version of
each CUDA kernel) and through ``repro.kernels.ops.fused_query_block`` twice:
the Pallas kernel body in interpret mode, and the ``use_pallas=False``
composite.  Histograms and the +inf stop mask must be exact; finite scores
agree to rtol 1e-5 (p != 2) or, for the p = 2 norms expansion, to
atol = 1e-6 * sqrt(qw2 + onorm): the expansion's float32 cancellation makes
the absolute error scale with the norms, not with the distance.
``ref.count_level_ref`` (no kernel) is held bit for bit to the JAX
package's and to the numpy form of its ``test_count_level_matches_numpy``.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _cuda, fused_query, ops, platform, ref

from _torch_inputs import assert_scores_close, make_pass_inputs

_PS = [2.0, 1.0, 0.5]
# (n, d, beta, Q, c, L): ragged against the Pallas block (bn=128) and the
# CUDA kernel's 128-row blocks
_SHAPES = [(200, 24, 40, 5, 3, 8), (97, 16, 24, 3, 2, 6)]


def _port(args, stop, **kw):
    cp, cq, pts, qs, qw, mu, beta_q, r_min = (torch.from_numpy(a)
                                              for a in args)
    st = None if stop is None else torch.from_numpy(stop)
    out = ops.fused_query_block(cp, pts, cq, qs, qw, mu, r_min, beta_q,
                                stop=st, **kw)
    if stop is None:
        return tuple(np.asarray(h) for h in out)
    return np.asarray(out)


def _jax(args, stop, route, **kw):
    cp, cq, pts, qs, qw, mu, beta_q, r_min = args
    flags = (dict(use_pallas="interpret", bn=128) if route == "interpret"
             else dict(use_pallas=False))
    out = jops.fused_query_block(cp, pts, cq, qs, qw, mu, r_min, beta_q,
                                 stop=stop, **kw, **flags)
    if stop is None:
        return tuple(np.asarray(h) for h in out)
    return np.asarray(out)


def _inputs(shape, seed):
    n, d, beta, q, c, L = shape
    cp, cq, pts, qs, qw, mu, beta_q, r_min, stop = make_pass_inputs(
        n, d, beta, q, c, L, seed)
    return (cp, cq, pts, qs, qw, mu, beta_q, r_min), stop


@pytest.mark.parametrize("route", ["interpret", "composite"])
@pytest.mark.parametrize("shape", _SHAPES, ids=str)
@pytest.mark.parametrize("p", _PS)
def test_pass1_histograms_match_jax(p, shape, route):
    n, _, _, _, c, L = shape
    args, _ = _inputs(shape, seed=1)
    kw = dict(boff=40, n_valid=40 + n - 17, c=c, n_levels=L, p=p)
    hf, hg = _port(args, None, **kw)
    jf, jg = _jax(args, None, route, **kw)
    assert hf.shape == (args[1].shape[0], L + 2)
    np.testing.assert_array_equal(hf, jf)
    np.testing.assert_array_equal(hg, jg)
    assert hf[:, : L + 1].sum() > 0 and hf[:, L + 1].sum() > 0


@pytest.mark.parametrize("route", ["interpret", "composite"])
@pytest.mark.parametrize("shape", _SHAPES, ids=str)
@pytest.mark.parametrize("p", _PS)
def test_pass2_scores_match_jax(p, shape, route):
    n, _, _, _, c, L = shape
    args, stop = _inputs(shape, seed=2)
    kw = dict(boff=0, n_valid=n - 11, c=c, n_levels=L, p=p)
    got = _port(args, stop, **kw)
    want = _jax(args, stop, route, **kw)
    assert np.isfinite(got).any() and np.isinf(got).any()
    assert_scores_close(got, want, args[3], args[4], args[2], p)


@pytest.mark.parametrize("shape", _SHAPES, ids=str)
def test_freq_level_matches_jax(shape):
    n, _, beta, q, c, L = shape
    (cp, cq, _, _, _, mu, beta_q, _), _ = _inputs(shape, seed=3)
    got = ref.freq_level_ref(torch.from_numpy(cp), torch.from_numpy(cq),
                             torch.from_numpy(mu), c, L,
                             torch.from_numpy(beta_q))
    want = jref.freq_level_ref(cp, cq, mu, c, L, beta_q)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(np.unique(np.asarray(got))) > L // 2


def test_freq_level_row_chunking_is_invisible(monkeypatch):
    """Results do not depend on how the plain version chunks the rows."""
    args, _ = _inputs(_SHAPES[0], seed=4)
    cp, cq, mu, beta_q = (torch.from_numpy(args[i]) for i in (0, 1, 5, 6))
    whole = ref.freq_level_ref(cp, cq, mu, 3, 8, beta_q)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 7 * cq.shape[0] * cq.shape[1])
    chunked = ref.freq_level_ref(cp, cq, mu, 3, 8, beta_q)
    assert torch.equal(whole, chunked)


def _count_codes(seed: int):
    """Codes across zero (floor division must round toward minus
    infinity) and wide enough for level 3 to merge buckets."""
    rng = np.random.default_rng(seed)
    cp = rng.integers(-500, 500, (100, 20)).astype(np.int32)
    cq = rng.integers(-500, 500, (6, 20)).astype(np.int32)
    cp[:6] = cq  # rows that collide at every level
    return cp, cq


@pytest.mark.parametrize("level", [0, 1, 3])
@pytest.mark.parametrize("c", [2, 3])
def test_count_level_matches_jax_and_numpy(c, level):
    cp, cq = _count_codes(seed=5 + c)
    got = ref.count_level_ref(torch.from_numpy(cp), torch.from_numpy(cq),
                              c=c, level=level)
    assert got.dtype == torch.int32 and got.shape == (6, 100)
    want = np.asarray(jref.count_level_ref(cp, cq, c=c, level=level))
    np.testing.assert_array_equal(got.numpy(), want)
    # the numpy form of the JAX package's test_count_level_matches_numpy
    l = c**level
    np.testing.assert_array_equal(
        got.numpy(), ((cq[:, None, :] // l) == (cp[None, :, :] // l)).sum(-1))
    assert got.numpy()[np.arange(6), np.arange(6)].tolist() == [20] * 6


def test_count_level_row_chunking_is_invisible(monkeypatch):
    cp, cq = (torch.from_numpy(a) for a in _count_codes(seed=9))
    whole = ref.count_level_ref(cp, cq, c=3, level=1)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 7 * cq.shape[0] * cq.shape[1])
    assert torch.equal(whole, ref.count_level_ref(cp, cq, c=3, level=1))


@pytest.mark.parametrize("p", _PS)
def test_weighted_lp_matches_jax(p):
    rng = np.random.default_rng(5)
    qs = rng.uniform(0, 100, (4, 12)).astype(np.float32)
    pts = rng.uniform(0, 100, (30, 12)).astype(np.float32)
    w = rng.uniform(1, 5, 12).astype(np.float32)
    got = np.asarray(ops.weighted_lp_dist(torch.from_numpy(qs),
                                          torch.from_numpy(pts),
                                          torch.from_numpy(w), p))
    want = np.asarray(jref.weighted_lp_ref(qs, pts, w, p))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("p", _PS)
def test_hash_encode_matches_jax(p):
    """The port's plain version, JAX's hash_encode_ref and JAX's Pallas
    kernel (interpret mode) all lie in the float64 window: with u the
    float64 value of (x o w) @ A / width + b_frac and E = 16 * 2**-24 *
    (sum |x_i w_i A_ij| / width + |b_frac|), code - b_int in [floor(u - E),
    floor(u + E)] clamped to int32 (only INT_MAX where u >= 2**31 + E)."""
    from repro_torch.core.families import sample_lp_family

    rng = np.random.default_rng(8)
    d, beta = 24, 64
    pts = rng.uniform(0, 10_000, (300, d)).astype(np.float32)
    cw = rng.uniform(1, 10, d).astype(np.float32)
    fam = sample_lp_family(d, beta, p, 40.0, cw, 500.0, 3, seed=9)
    args = (pts, fam.proj, fam.b_int, fam.b_frac, cw)
    got = np.asarray(ref.hash_encode_ref(*(torch.from_numpy(a) for a in args),
                                         fam.width))
    assert got.dtype == np.int32
    lo, hi = ref.hash_code_window(*(torch.from_numpy(a) for a in (
        pts, fam.proj, fam.b_frac, cw)), fam.width)
    for codes in (got,
                  np.asarray(jref.hash_encode_ref(*args, fam.width)),
                  np.asarray(jops.hash_encode(pts, cw, fam.proj, fam.b_int,
                                              fam.b_frac, fam.width,
                                              use_pallas="interpret"))):
        v = ref.unbias_codes(torch.from_numpy(np.array(codes)),
                             torch.from_numpy(fam.b_int))
        assert bool(((v >= lo) & (v <= hi)).all())


def _round_f32(v: Fraction) -> float:
    """``v`` rounded to float32, to nearest with ties to even, exactly."""
    if v == 0:
        return 0.0
    m = abs(v)
    e = m.numerator.bit_length() - m.denominator.bit_length()
    if Fraction(2) ** e > m:
        e -= 1  # 2**e <= m < 2**(e + 1)
    quantum = Fraction(2) ** (max(e, -126) - 23)  # subnormals: 2**-149
    return math.copysign(float(round(m / quantum) * quantum), v)


def _fma_exact(x, a, c) -> float:
    return _round_f32(Fraction(float(x)) * Fraction(float(a))
                      + Fraction(float(c)))


def _fma_triples(kind: str, rng):
    def f32(n, lo, hi):
        return (rng.standard_normal(n) * 2.0 ** rng.integers(lo, hi, n)
                ).astype(np.float32)

    if kind == "double_rounding":  # RN to float64, then to float32, is off
        one = np.float32(1 + 2.0**-12)
        return (np.array([one]), np.array([one]),
                np.array([2.0**-80], np.float32))
    n = 2_000
    x, a = f32(n, -30, 30), f32(n, -30, 30)
    if kind == "random":
        return x, a, f32(n, -70, 70)
    # cancelling: c within a few float32 ulps of -(x * a)
    c = (-(x.astype(np.float64) * a)).astype(np.float32)
    steps = rng.integers(-3, 4, n)
    toward = np.where(steps > 0, np.inf, -np.inf).astype(np.float32)
    for _ in range(3):
        c = np.where(np.abs(steps) > 0, np.nextafter(c, toward), c)
        steps = steps - np.sign(steps)
    return x, a, c


@pytest.mark.parametrize("kind", ["random", "cancelling", "double_rounding"])
def test_fma_f32_rounds_once(kind):
    """ref.fma_f32 equals x * a + c taken exactly (fractions.Fraction) and
    rounded once to float32 with ties to even, as the card's FMA."""
    x, a, c = _fma_triples(kind, np.random.default_rng(21))
    got = ref.fma_f32(*(torch.from_numpy(v) for v in (x, a, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(x, a, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    if kind == "double_rounding":
        assert got[0] == np.float32(1 + 2.0**-11 + 2.0**-23)
        assert np.float32(np.float64(x[0]) * np.float64(a[0])
                          + np.float64(c[0])) != got[0]


@pytest.mark.parametrize("p", _PS)
def test_hash_encode_ref_takes_the_fma_order(p):
    """One row at d = 37 (a ragged last run and tile) summed by a scalar
    loop in the kernel's order, each FMA exact and rounded once, equals
    hash_encode_ref's row bit for bit: at the family's width, and at a
    power-of-two width that puts the largest |u| near 2**30, so the codes
    carry the sums' last bits."""
    from repro_torch.core.families import sample_lp_family

    d, beta = 37, 16
    rng = np.random.default_rng(22)
    x = rng.uniform(0, 10_000, (1, d)).astype(np.float32)
    cw = rng.uniform(1, 10, d).astype(np.float32)
    fam = sample_lp_family(d, beta, p, 40.0, cw, 500.0, 3, seed=23)
    xw = x[0] * cw  # float32, rounded once
    sums = []
    for j in range(beta):
        acc = np.float32(0)
        for t0 in range(0, d, 32):
            tile = np.float32(0)
            for r0 in range(t0, min(d, t0 + 32), 8):
                run = np.float32(0)
                for i in range(r0, min(d, r0 + 8)):
                    run = np.float32(_fma_exact(xw[i], fam.proj[i, j], run))
                tile = np.float32(tile + run)
            acc = np.float32(acc + tile)
        sums.append(acc)
    top = max(abs(float(v)) for v in sums)
    for width in (fam.width, 2.0 ** (math.ceil(math.log2(top)) - 30)):
        got = ref.hash_encode_ref(*(torch.from_numpy(v) for v in (
            x, fam.proj, fam.b_int, fam.b_frac, cw)), width).numpy()[0]
        w32 = np.float32(width)
        for j, acc in enumerate(sums):
            u = np.float32(np.float32(acc / w32) + fam.b_frac[j])
            v = (2**31 - 1 if u >= 2.0**31 else -(2**31)
                 if u < -(2.0**31) else math.floor(u))
            want = (v + int(fam.b_int[j]) + 2**31) % 2**32 - 2**31
            assert got[j] == want, (width, j)


@pytest.mark.parametrize("c", [2, 3])
def test_ops_freq_level_matches_jax_kernel(c):
    """ops.freq_level on the CPU equals the Pallas kernel (interpret mode)
    exactly, at n not a multiple of its 256-row block."""
    n, beta, q, L = 300, 40, 5, 8
    cp, cq, _, _, _, mu, beta_q, _, _ = make_pass_inputs(n, 8, beta, q, c,
                                                         L, seed=10)
    got = ops.freq_level(torch.from_numpy(cp), torch.from_numpy(cq),
                         torch.from_numpy(mu), c, L, torch.from_numpy(beta_q))
    want = jops.freq_level(cp, cq, mu, c, L, beta_q, use_pallas="interpret")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(np.unique(np.asarray(got))) > L // 2


@pytest.mark.parametrize("p", [1.0, 0.5, 1.5])
def test_ops_weighted_lp_matches_jax_kernel(p):
    """ops.weighted_lp_dist on the CPU is within rtol 1e-5 of the Pallas
    kernel (interpret mode, bn=128, bd=64; ragged n and d)."""
    rng = np.random.default_rng(11)
    qs = rng.uniform(0, 1000, (5, 100)).astype(np.float32)
    pts = rng.uniform(0, 1000, (300, 100)).astype(np.float32)
    w = rng.uniform(1, 10, 100).astype(np.float32)
    got = ops.weighted_lp_dist(*(torch.from_numpy(a) for a in (qs, pts, w)),
                               p)
    want = jops.weighted_lp_dist(qs, pts, w, p, use_pallas="interpret",
                                 bn=128, bd=64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=0)


def test_cpu_ops_launch_no_kernel():
    """On CPU tensors every op runs its plain version and counts nothing."""
    (cp, cq, pts, qs, qw, mu, beta_q, _), _ = _inputs(_SHAPES[1], seed=12)
    t = {k: torch.from_numpy(v) for k, v in dict(
        cp=cp, cq=cq, pts=pts, qs=qs, qw=qw, mu=mu, beta_q=beta_q).items()}
    _cuda.reset_launch_counts()
    ops.freq_level(t["cp"], t["cq"], t["mu"], 2, 6, t["beta_q"])
    for p in _PS:
        ops.weighted_lp_dist(t["qs"], t["pts"], t["qw"][0], p)
    q = len(t["qw"])
    ops.hash_encode(t["pts"], t["qw"][0], t["qw"].T, torch.zeros(
        q, dtype=torch.int32), torch.zeros(q), 1.0)
    assert set(_cuda.launch_counts()) == {
        "fused_query_hist", "fused_query_scores", "fused_query_keep",
        "fused_query_mask", "hash_encode", "freq_level", "weighted_lp"}
    assert not any(_cuda.launch_counts().values())


def test_scalar_broadcast_and_default_beta():
    """Scalar mu/r_min/stop and beta_q=None broadcast like arrays."""
    (cp, cq, pts, qs, qw, *_), _ = _inputs(_SHAPES[1], seed=6)
    q, beta = cq.shape
    t = [torch.from_numpy(a) for a in (cp, pts, cq, qs, qw)]
    kw = dict(boff=0, n_valid=len(cp), c=2, n_levels=6, p=1.0)
    a = ops.fused_query_block(*t, 3, 50.0, None, **kw)
    b = ops.fused_query_block(*t, torch.full((q,), 3, dtype=torch.int32),
                              torch.full((q,), 50.0), torch.full(
                                  (q,), beta, dtype=torch.int32), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    """On CPU tensors a wrapper runs ref.py and launches no kernel."""
    args, stop = _inputs(_SHAPES[0], seed=7)
    cp, cq, pts, qs, qw, mu, beta_q, r_min = (torch.from_numpy(a)
                                              for a in args)
    fused_query.reset_launch_counts()
    kw = dict(boff=0, n_valid=150, c=3, n_levels=8, p=2.0)
    hf, hg = fused_query.fused_query_hist(cp, pts, cq, qs, qw, mu, beta_q,
                                          r_min, **kw)
    row_ok = torch.arange(len(cp)) < 150
    rf, rg = ref.fused_query_hist_ref(cp, pts, cq, qs, qw, mu, beta_q, r_min,
                                      row_ok, c=3, n_levels=8, p=2.0)
    assert torch.equal(hf, rf) and torch.equal(hg, rg)
    assert hf.shape == (len(cq), 8 + 3)
    assert int(hf[:, 8 + 2].sum()) == (len(cp) - 150) * len(cq)
    assert fused_query.launch_counts == {"fused_query_hist": 0,
                                         "fused_query_scores": 0,
                                         "fused_query_keep": 0,
                                         "fused_query_mask": 0}


# (n, d, beta, Q, c, L) of the single scan: c in {2, 3, 5}, and c = 3 at
# L = 16 and at L = 20 (the kernel's narrow and wide digit words)
_KEEP_SHAPES = [(200, 24, 40, 5, 2, 8), (200, 24, 40, 5, 3, 16),
                (170, 16, 48, 9, 3, 20), (150, 16, 24, 3, 5, 6)]


@pytest.mark.parametrize("vec", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("p", _PS)
@pytest.mark.parametrize("shape", _KEEP_SHAPES, ids=str)
def test_keep_and_mask_equal_the_two_passes(shape, p, vec):
    """Pass 1's keep form then the mask, on a shard at row offset 40 with
    a dead tail: histograms equal ``fused_query_hist_ref``'s, the masked
    distances ``fused_query_scores_ref``'s bit for bit, dead rows at level
    L+2 and +inf before the mask."""
    n, _, _, q, c, L = shape
    args, stop = _inputs(shape, seed=21)
    cp, cq, pts, qs, qw, mu, beta_q, r_min = (torch.from_numpy(a)
                                              for a in args)
    pts = pts.to(vec)
    stop = torch.from_numpy(stop)
    boff, n_valid = 40, 40 + n - 30
    kw = dict(boff=boff, n_valid=n_valid, c=c, n_levels=L, p=p)
    fused_query.reset_launch_counts()
    hf, hg, lf, dist = fused_query.fused_query_keep(
        cp, pts, cq, qs, qw, mu, beta_q, r_min, **kw)
    assert lf.dtype == torch.uint8 and lf.shape == (q, n)
    assert dist.dtype == torch.float32 and dist.shape == (q, n)
    assert bool((lf[:, n - 30:] == L + 2).all())
    assert bool(torch.isinf(dist[:, n - 30:]).all())
    fused_query.fused_query_mask(lf, stop, dist)
    assert not any(fused_query.launch_counts.values())
    row_ok = (boff + torch.arange(n)) < n_valid
    plain = dict(c=c, n_levels=L, p=p)
    rf, rg = ref.fused_query_hist_ref(cp, pts, cq, qs, qw, mu, beta_q,
                                      r_min, row_ok, **plain)
    rs = ref.fused_query_scores_ref(cp, pts, cq, qs, qw, mu, beta_q, stop,
                                    row_ok, **plain)
    assert torch.equal(hf, rf) and torch.equal(hg, rg)
    assert torch.equal(dist.view(torch.int32), rs.view(torch.int32))
    assert bool(torch.isfinite(dist).any()) and bool(torch.isinf(dist).any())


@pytest.mark.parametrize("p", _PS)
def test_ops_keep_and_mask_equal_the_block_passes(p):
    """``ops.fused_query_keep`` / ``ops.fused_query_mask`` with scalar
    per-query arguments give ``ops.fused_query_block``'s two passes: the
    histograms equal, the scores bit for bit."""
    (cp, cq, pts, qs, qw, *_), stop = _inputs(_SHAPES[0], seed=22)
    t = [torch.from_numpy(a) for a in (cp, pts, cq, qs, qw)]
    kw = dict(boff=0, n_valid=len(cp) - 9, c=3, n_levels=8, p=p)
    hf, hg, (lf, dist) = ops.fused_query_keep(*t, 3, 50.0, None, **kw)
    want_f, want_g = ops.fused_query_block(*t, 3, 50.0, None, **kw)
    assert torch.equal(hf, want_f) and torch.equal(hg, want_g)
    st = torch.from_numpy(stop)
    got = ops.fused_query_mask(lf, st, dist)
    assert got is dist
    want = ops.fused_query_block(*t, 3, 50.0, None, stop=st, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_keep_refuses_levels_past_a_byte():
    """L + 2 > 255 cannot be stored as a byte: the wrapper raises."""
    (cp, cq, pts, qs, qw, mu, beta_q, r_min), _ = _inputs(_SHAPES[1],
                                                          seed=23)
    t = [torch.from_numpy(a) for a in (cp, pts, cq, qs, qw, mu, beta_q,
                                        r_min)]
    kw = dict(boff=0, n_valid=len(cp), c=2, p=1.0)
    for n_levels in (254, 300):
        with pytest.raises(ValueError, match="255"):
            fused_query.fused_query_keep(*t, n_levels=n_levels, **kw)


@pytest.mark.parametrize("knob,device,label", [
    ("on", "cpu", "fused-plain"),
    (True, "cpu", "fused-plain"),
    ("on", "cuda", "fused-cuda"),
    ("off", "cuda", "unfused"),
    (False, "cpu", "unfused"),
])
def test_platform_resolves_per_device(knob, device, label):
    assert platform.resolve(knob, device).label == label


def test_platform_describes_the_unfused_route_on_the_card():
    line = platform.describe("off", "cuda")
    assert "freq_level" in line and "CUDA" in line
    assert "freq_level" not in platform.describe("on", "cuda")
    assert "plain torch" in platform.describe("off", "cpu")


def test_platform_rejects_unknown_knob():
    with pytest.raises(ValueError):
        platform.normalize("interpret")
