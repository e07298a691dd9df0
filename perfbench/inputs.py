"""Inputs of a run, made by the benchmark from ``--seed``.

* the corpus: integer points uniform in [0, value_range]^d (the paper's
  Table 3 data), drawn on the device by a seeded ``torch.Generator`` in
  one call and handed to the program and the reference alike;
* the weight set S: the paper's generator (Sec. 5.1.1, Table 5) under
  the configuration's own ``weight_seed``: S is what the deployment's
  tenants query with, so it is fixed for a configuration, and with it
  the partition into table groups and every group's shape;
* the traffic: a pool of requests drawn by ``traffic.requests``.

``base_seed`` maps any whole number onto the non-negative 63-bit seeds
both generators take.
"""

from __future__ import annotations

import numpy as np


def base_seed(seed: int) -> int:
    """The run's seed as a non-negative integer below 2**63."""
    return int(seed) % (1 << 63)


def corpus(n: int, d: int, value_range: float, seed: int, device):
    """(n, d) float32 host array of integers uniform in [0, value_range]."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(base_seed(seed))
    pts = torch.randint(0, int(value_range) + 1, (n, d), generator=gen,
                        device=device, dtype=torch.int32)
    return pts.to(torch.float32).cpu().numpy()


def weight_set(size: int, d: int, n_subset: int, n_subrange: int,
               seed: int, lo: float = 1.0, hi: float = 10.0) -> np.ndarray:
    """The paper's weight vector set: ``n_subset`` equal subsets, each
    drawing its vectors uniformly inside one of ``n_subrange`` equal
    subranges of [lo, hi] chosen per dimension."""
    if size % n_subset:
        raise ValueError(f"|S| = {size} is not a multiple of n_subset = "
                         f"{n_subset}")
    per = size // n_subset
    rng = np.random.default_rng(seed)
    edges = np.linspace(lo, hi, n_subrange + 1)
    out = np.empty((size, d), dtype=np.float64)
    for s in range(n_subset):
        sub = rng.integers(0, n_subrange, size=d)
        out[s * per:(s + 1) * per] = rng.uniform(edges[sub], edges[sub + 1],
                                                 size=(per, d))
    return out
