"""Synthetic data / weight-vector-set / query-set generators (paper Sec 5.1.1).

* Data sets: integer points uniform in [0, value_range]^d  (Table 3).
* Weight vector sets: union of ``n_subset`` equal-size subsets.  [1, 10] is
  split into ``n_subrange`` equal-width subranges; each subset picks one
  subrange per dimension uniformly at random and then draws its vectors'
  coordinates uniformly inside the chosen subrange (Table 5).
* Query sets: Cartesian product of ``n_query_points`` points removed from
  the data set with ``n_query_weights`` weight vectors from S.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["make_dataset", "make_weight_set", "make_query_set", "QuerySet"]


def make_dataset(
    n: int, d: int, value_range: float = 10_000.0, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, int(value_range) + 1, size=(n, d)).astype(np.float32)


def make_weight_set(
    size: int,
    d: int,
    n_subset: int = 200,
    n_subrange: int = 20,
    lo: float = 1.0,
    hi: float = 10.0,
    seed: int = 1,
) -> np.ndarray:
    """Weight vector set S per the paper's generator.

    ``n_subset == size`` and ``n_subrange == 1`` reduces to uniformly random
    weight vectors on [lo, hi]^d (used by Table 8 / Table 11).
    """
    if size % n_subset != 0:
        n_subset = max(1, min(n_subset, size))
    per = max(1, size // n_subset)
    rng = np.random.default_rng(seed)
    edges = np.linspace(lo, hi, n_subrange + 1)
    out = np.empty((n_subset * per, d), dtype=np.float64)
    for s in range(n_subset):
        sub = rng.integers(0, n_subrange, size=d)
        lo_d, hi_d = edges[sub], edges[sub + 1]
        out[s * per : (s + 1) * per] = rng.uniform(lo_d, hi_d, size=(per, d))
    return out[:size]


@dataclasses.dataclass
class QuerySet:
    points: np.ndarray  # (nq, d) query points (removed from data)
    weights: np.ndarray  # (nw, d) query weight vectors (subset of S)
    weight_ids: np.ndarray  # (nw,) indices into S
    data: np.ndarray  # data set with query points removed


def make_query_set(
    data: np.ndarray,
    weight_set: np.ndarray,
    n_query_points: int = 50,
    n_query_weights: int = 10,
    seed: int = 2,
) -> QuerySet:
    rng = np.random.default_rng(seed)
    qi = rng.choice(len(data), size=min(n_query_points, len(data)), replace=False)
    wi = rng.choice(
        len(weight_set), size=min(n_query_weights, len(weight_set)), replace=False
    )
    mask = np.ones(len(data), dtype=bool)
    mask[qi] = False
    return QuerySet(
        points=data[qi].copy(),
        weights=weight_set[wi].copy(),
        weight_ids=wi,
        data=data[mask],
    )
