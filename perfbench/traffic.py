"""The one traffic generator: a mix file's parameters -> a request pool.

A mix (``perfbench/traffic/<name>.json``) states:

* ``loop``: ``"closed"``, the only kind so far: ``clients`` callers that
  each send their next request when the previous one is answered;
* ``clients``: 1 (one caller; more need a driver of several threads);
* ``request_queries``: queries in one request;
* ``weight_mix``: ``"per_request"`` (all queries of a request under one
  weight id, a tenant's batch) or ``"per_query"`` (each query its own);
* ``weight_order``: ``"balanced"``: the ids come in blocks, each a
  permutation of every id of S, so that each id and group gets the same
  share of the requests;
* ``order_seed``: the seed of those permutations.  It is the mix's, not
  the run's: under a residency budget the order decides which requests
  restore a state, so every run seed sends the same sequence of ids,
  with its own queries;
* ``query_noise_std``: a query is a corpus row plus N(0, std) noise in
  every dimension;
* ``pool_requests``: requests drawn; the window cycles through them;
* ``check_requests``: answered requests compared with the reference.

The deployment's serving knobs (residency budget, host offload) are the
configuration's, not the mix's.

Unknown keys and values are refused, so a mix that needs new code fails
at once instead of running as something else.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .inputs import base_seed

KEYS = {"loop", "clients", "request_queries", "weight_mix", "weight_order",
        "order_seed", "query_noise_std", "pool_requests", "check_requests"}


@dataclasses.dataclass
class Pool:
    """``pool_requests`` requests: each one's queries, weight ids and the
    corpus rows its queries were drawn from."""

    queries: np.ndarray  # (P, R, d) float32
    weight_ids: np.ndarray  # (P, R) int64
    rows: np.ndarray  # (P, R) int64

    def __len__(self) -> int:
        return len(self.queries)


def validate(mix: dict) -> dict:
    """``mix`` with its values checked; raises ValueError on anything the
    generator does not implement."""
    extra = set(mix) - KEYS
    if extra:
        raise ValueError(f"traffic keys not understood: {sorted(extra)}")
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError("only a closed loop with one client is implemented")
    if mix.get("weight_mix") not in ("per_request", "per_query"):
        raise ValueError(f"weight_mix {mix.get('weight_mix')!r}")
    if mix.get("weight_order") != "balanced":
        raise ValueError(f"weight_order {mix.get('weight_order')!r}")
    if int(mix.get("order_seed", -1)) < 0:
        raise ValueError("order_seed must be a whole number >= 0")
    for key in ("request_queries", "pool_requests", "check_requests"):
        if int(mix.get(key, 0)) < 1:
            raise ValueError(f"{key} must be >= 1")
    if float(mix.get("query_noise_std", -1)) < 0:
        raise ValueError("query_noise_std must be >= 0")
    return mix


def _balanced_ids(rng, n_weights: int, count: int) -> np.ndarray:
    blocks = -(-count // n_weights)
    return np.concatenate([rng.permutation(n_weights)
                           for _ in range(blocks)])[:count]


def requests(mix: dict, data: np.ndarray, n_weights: int, seed: int) -> Pool:
    """The request pool of ``mix`` over the corpus ``data`` for ``seed``."""
    validate(mix)
    order = np.random.default_rng(int(mix["order_seed"]))
    rng = np.random.default_rng([base_seed(seed), 1])
    p, r = int(mix["pool_requests"]), int(mix["request_queries"])
    if mix["weight_mix"] == "per_request":
        wids = np.repeat(_balanced_ids(order, n_weights, p)[:, None], r, 1)
    else:
        wids = _balanced_ids(order, n_weights, p * r).reshape(p, r)
    rows = rng.integers(0, len(data), size=(p, r))
    noise = rng.normal(0.0, float(mix["query_noise_std"]),
                       size=(p, r, data.shape[1]))
    queries = (data[rows] + noise).astype(np.float32)
    return Pool(queries=queries, weight_ids=wids.astype(np.int64), rows=rows)
