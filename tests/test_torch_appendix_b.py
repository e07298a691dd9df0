"""The Appendix B families and distances of the port (numpy) vs the JAX
package's, and the Theorem 1(3) angular bounds.

* ``sample_hamming_family`` / ``hamming_codes_np`` and
  ``sample_angular_family`` / ``angular_codes_np``: the same seeded draws,
  bit for bit, at several (d, beta, seed), on float and integer points.
* ``weighted_hamming_np`` bit for bit; ``weighted_angular_np`` and
  ``angular_bounds`` exactly equal (the same float64 numpy expressions).
* Carried over against the port's functions: ``test_weighted_hamming``
  and ``test_weighted_angular_range`` (``tests/test_distances.py``) and
  the hypothesis property ``test_theorem1_angular_bounds``
  (``tests/test_derived.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
from _hyp import given, st

from repro.core import derived as jderived
from repro.core import distances as jdist
from repro.core import families as jfam
from repro_torch.core.derived import angular_bounds
from repro_torch.core.distances import (weighted_angular_np,
                                        weighted_hamming_np)
from repro_torch.core.families import (angular_codes_np, hamming_codes_np,
                                       sample_angular_family,
                                       sample_hamming_family)

# (d, beta, seed)
_DRAWS = [(8, 16, 0), (24, 64, 7), (3, 5, 123)]


def _points(d: int, seed: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed + 1000)
    if kind == "int":
        return rng.integers(0, 10_001, (40, d))
    return rng.normal(0.0, 50.0, (40, d))


def _weight(d: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 2000).uniform(1.0, 10.0, d)


def _same(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("d,beta,seed", _DRAWS)
def test_hamming_family_and_codes_match_jax(d, beta, seed, kind):
    w = _weight(d, seed)
    ks = sample_hamming_family(d, beta, w, seed=seed)
    _same(ks, jfam.sample_hamming_family(d, beta, w, seed=seed))
    assert ks.min() >= 0 and ks.max() < d
    x = _points(d, seed, kind)
    _same(hamming_codes_np(x, ks, w), jfam.hamming_codes_np(x, ks, w))


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("d,beta,seed", _DRAWS)
def test_angular_family_and_codes_match_jax(d, beta, seed, kind):
    us = sample_angular_family(d, beta, seed=seed)
    _same(us, jfam.sample_angular_family(d, beta, seed=seed))
    w = _weight(d, seed)
    x = _points(d, seed, kind)
    codes = angular_codes_np(x, us, w)
    _same(codes, jfam.angular_codes_np(x, us, w))
    assert codes.dtype == np.int8 and set(np.unique(codes)) <= {0, 1}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_distances_match_jax(seed):
    rng = np.random.default_rng(seed)
    d = 12
    w = rng.uniform(1.0, 10.0, d)
    bx = rng.integers(0, 2, (30, d))
    by = rng.integers(0, 2, (30, d))
    _same(weighted_hamming_np(bx, by, w), jdist.weighted_hamming_np(bx, by, w))
    x = rng.normal(0.0, 5.0, (30, d))
    y = rng.normal(0.0, 5.0, (30, d))
    y[0] = 0.0  # a zero vector takes the 1e-300 floor of the denominator
    y[1] = x[1]
    _same(weighted_angular_np(x, y, w), jdist.weighted_angular_np(x, y, w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_angular_bounds_match_jax(seed):
    rng = np.random.default_rng(seed)
    d = 10
    W, Wp = rng.uniform(1.0, 10.0, d), rng.uniform(1.0, 10.0, d)
    for R in (0.05, 0.3, 1.0):
        for c in (1.5, 2.0, 3.0):
            assert angular_bounds(W, Wp, R, c) == jderived.angular_bounds(
                W, Wp, R, c)


# carried over from tests/test_distances.py


def test_weighted_hamming():
    x = np.array([0, 1, 1, 0])
    y = np.array([0, 0, 1, 1])
    w = np.array([5.0, 2.0, 3.0, 7.0])
    assert weighted_hamming_np(x, y, w) == pytest.approx(9.0)


def test_weighted_angular_range():
    rng = np.random.default_rng(1)
    x = rng.normal(size=16)
    w = rng.uniform(1, 10, 16)
    assert weighted_angular_np(x, x, w) == pytest.approx(0.0, abs=1e-6)
    assert weighted_angular_np(x, -x, w) == pytest.approx(np.pi, abs=1e-6)


# carried over from tests/test_derived.py


@st.composite
def _pair_weights_points(draw):
    d = draw(st.integers(2, 16))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    W = rng.uniform(1.0, 10.0, d)
    Wp = rng.uniform(1.0, 10.0, d)
    x = rng.uniform(0, 1000.0, d)
    y = rng.uniform(0, 1000.0, d)
    return W, Wp, x, y


@given(_pair_weights_points())
def test_theorem1_angular_bounds(pack):
    W, Wp, x, y = pack
    R = float(weighted_angular_np(x, y, Wp))
    if R < 1e-6 or R > np.pi - 1e-6:
        return
    d_w = float(weighted_angular_np(x, y, W))
    r_up, _ = angular_bounds(W, Wp, R, c=2.0)
    assert d_w <= r_up + 1e-7
    # lower bound at cR: use cR = the actual distance (R' := R/c)
    _, cr_down = angular_bounds(W, Wp, R / 2.0, c=2.0)
    assert d_w >= cr_down - 1e-7
