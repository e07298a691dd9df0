"""The fused kernel's digit-word level test, held on the CPU.

The CUDA kernel (``csrc/level_match.cuh``, ``count_agreements_words``)
finds the first level j at which floor(a / c^j) == floor(b / c^j) from
the highest differing base-c digit of two codes; it cannot run here, so
its method has a plain torch twin (``ref.digit_words``,
``ref.first_agreeing_level``, ``ref.freq_level_words_ref``).  The twin is
held to the reference's level-by-level floor division for c in {2, 3}
over depths around the words' sign digits (20 for c = 3, 31 for c = 2),
on pairs at the int32 extremes and pairs that differ by +-c^k; and its
first frequent levels to ``ref.freq_level_ref`` and to the JAX package's
``_lf_and_dist`` (through the Pallas kernel in interpret mode and the
composite).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

from _hyp import given, settings, st
from _torch_inputs import EDGE_CODES, make_edge_inputs, make_pass_inputs

_I32 = (-(2**31), 2**31 - 1)
_DEPTHS = [0, 8, 15, 16, 17, 19, 20, 21, 24, 31, 40]  # 17: the wide test


def _by_division(a, b, c: int, n_levels: int):
    """First j <= n_levels with a // c^j == b // c^j (floor), else L+1."""
    a, b = a.long(), b.long()
    out = torch.full(a.shape, n_levels + 1, dtype=torch.int64)
    for j in range(n_levels + 1):
        out = torch.where((a == b) & (out == n_levels + 1), j, out)
        a = torch.div(a, c, rounding_mode="floor")
        b = torch.div(b, c, rounding_mode="floor")
    return out


def _pairs(c: int, seed: int):
    """Random int32 pairs, pairs that differ by +-c^k, and every pair of
    edge codes and their +-1 neighbours."""
    rng = np.random.default_rng(seed)
    a = rng.integers(_I32[0], _I32[1] + 1, 20_000)
    b = rng.integers(_I32[0], _I32[1] + 1, 20_000)
    kmax = 21 if c == 3 else 31
    k = rng.integers(0, kmax, 20_000)
    step = rng.choice([-2, -1, 1, 2], 20_000) * np.power(np.int64(c), k)
    edge = np.array(EDGE_CODES, np.int64)
    edge = np.unique(np.clip(np.concatenate([edge - 1, edge, edge + 1]),
                             *_I32))
    ea, eb = np.meshgrid(edge, edge)
    ek = np.power(np.int64(c), np.arange(kmax))
    sa, sk = np.meshgrid(edge, np.concatenate([ek, -ek]))
    aa = np.concatenate([a, a, ea.ravel(), sa.ravel()])
    bb = np.concatenate([b, np.clip(a + step, *_I32), eb.ravel(),
                         np.clip(sa + sk, *_I32).ravel()])
    return (torch.from_numpy(aa.astype(np.int32)),
            torch.from_numpy(bb.astype(np.int32)))


@pytest.mark.parametrize("n_levels", _DEPTHS)
@pytest.mark.parametrize("c", [2, 3])
def test_first_agreeing_level_matches_floor_division(c, n_levels):
    a, b = _pairs(c, seed=c * 100 + n_levels)
    wa, wb = (ref.digit_words(v, c, n_levels) for v in (a, b))
    got = ref.first_agreeing_level(wa, wb, c, n_levels)
    np.testing.assert_array_equal(got.numpy(),
                                  _by_division(a, b, c, n_levels).numpy())
    assert len(torch.unique(got)) > min(n_levels, 20) // 2
    # the dead word agrees with no code at any level
    dead = torch.full_like(wa, ref.dead_word(c, n_levels))
    assert bool((ref.first_agreeing_level(wa, dead, c, n_levels)
                 == n_levels + 1).all())


@pytest.mark.parametrize("c", [2, 3])
@settings(max_examples=300, deadline=None)
@given(a=st.integers(*_I32), b=st.integers(*_I32),
       n_levels=st.integers(0, 40))
def test_first_agreeing_level_property(c, a, b, n_levels):
    ta, tb = (torch.tensor([v], dtype=torch.int32) for v in (a, b))
    got = ref.first_agreeing_level(ref.digit_words(ta, c, n_levels),
                                   ref.digit_words(tb, c, n_levels), c,
                                   n_levels)
    assert int(got) == int(_by_division(ta, tb, c, n_levels))


@pytest.mark.parametrize("n_levels", [16, 17])
def test_digit_words_hold_base_3_digits(n_levels):
    """c = 3 words hold the base-3 digits of code + 3^20: digits 0..15 in
    the low half, 2 bits each; digits 16..20 in the high half, as their
    value (L <= 16) or 2 bits each (the wide test, L > 16)."""
    a = torch.tensor(list(EDGE_CODES) + [12345, -98765], dtype=torch.int32)
    words = ref.digit_words(a, 3, n_levels)
    for code, w in zip(a.tolist(), words.tolist()):
        v = code + 3**20
        assert 0 <= v < 3**21
        digits = [v // 3**i % 3 for i in range(21)]
        low = sum(d << (2 * i) for i, d in enumerate(digits[:16]))
        high = (sum(d << (2 * i) for i, d in enumerate(digits[16:]))
                if n_levels > 16 else v // 3**16)
        assert w == low | high << 32


# (n, d, beta, Q, c, L, codes): the kernel tests' shapes, IndexConfig's
# L = 24 for both c, and codes at the word test's edges
_SHAPES = [(200, 24, 40, 5, 3, 8, "pass"), (97, 16, 24, 3, 2, 6, "pass"),
           (150, 8, 48, 7, 2, 24, "pass"), (150, 8, 48, 7, 3, 24, "pass"),
           (150, 8, 48, 7, 2, 24, "edge"), (150, 8, 48, 7, 3, 24, "edge")]


def _inputs(shape, seed):
    n, d, beta, q, c, L, codes = shape
    make = make_edge_inputs if codes == "edge" else make_pass_inputs
    return make(n, d, beta, q, c, L, seed)


@pytest.mark.parametrize("shape", _SHAPES, ids=str)
def test_freq_level_words_matches_freq_level_ref(shape):
    _, _, _, _, c, L, _ = shape
    cp, cq, _, _, _, mu, beta_q, _, _ = (torch.from_numpy(a)
                                         for a in _inputs(shape, seed=7))
    got = ref.freq_level_words_ref(cp, cq, mu, c, L, beta_q)
    want = ref.freq_level_ref(cp, cq, mu, c, L, beta_q)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 2


@pytest.mark.parametrize("route", ["interpret", "composite"])
@pytest.mark.parametrize("shape", _SHAPES, ids=str)
def test_word_levels_match_jax(shape, route):
    """Histograms of the twin's first frequent levels equal the JAX
    package's pass-1 hist_f, whose levels come from ``_lf_and_dist``."""
    n, _, _, _, c, L, _ = shape
    cp, cq, pts, qs, qw, mu, beta_q, r_min, _ = _inputs(shape, seed=8)
    boff, n_valid = 3, n - 9
    flags = (dict(use_pallas="interpret", bn=128) if route == "interpret"
             else dict(use_pallas=False))
    jf, _ = jops.fused_query_block(cp, pts, cq, qs, qw, mu, r_min, beta_q,
                                   boff=boff, n_valid=n_valid, c=c,
                                   n_levels=L, p=2.0, **flags)
    lf = ref.freq_level_words_ref(torch.from_numpy(cp), torch.from_numpy(cq),
                                  torch.from_numpy(mu), c, L,
                                  torch.from_numpy(beta_q))
    live = (boff + torch.arange(n)) < n_valid
    got = ref.level_hist(lf[:, live], L + 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf))
