"""Quickstart: build a WLSH index over synthetic data and answer weighted
k-NN queries with accuracy/space/IO reporting.

    PYTHONPATH=src python examples/quickstart_torch.py

The PyTorch port's copy of the JAX package's example: the planner and
the host search are numpy in both packages, so it prints the same lines.

Mirrors the paper's core loop: weight-vector set -> Partition() (greedy
weighted set cover over derived-family candidates) -> per-group hash tables
-> (c,k)-WNN queries with collision counting + virtual rehashing.
"""

import numpy as np

from repro_torch.core.datagen import make_dataset, make_query_set, make_weight_set
from repro_torch.core.distances import weighted_lp_np
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex


def main():
    n, d, n_weights, k = 8_000, 32, 24, 10
    p = 1.0  # fractional/l1 support is the paper's headline: try p=0.5 too

    print(f"data: n={n} d={d}, weight set |S|={n_weights}, l_{p} distance")
    data = make_dataset(n=n, d=d, seed=0)
    weights = make_weight_set(size=n_weights, d=d, n_subset=4,
                              n_subrange=10, seed=1)

    cfg = PlanConfig(p=p, c=3, n=n, gamma_n=100.0)
    idx = WLSHIndex(
        data, weights, cfg,
        tau=1_000.0,            # paper Sec 5.1.3 (l1)
        v=d // 4, v_prime=d // 4,  # bound relaxation, v = v' = d/4
        use_reduction=True,     # collision-threshold reduction
        seed=2,
    )
    naive_tables = int(
        sum(idx.part.groups[int(g)].betas[int(s)]
            for g, s in zip(idx.part.group_of, idx.part.member_slot))
    )
    print(f"partition: {len(idx.part.groups)} table groups, "
          f"{idx.beta_total} tables total "
          f"(naive one-group-per-weight would need ~{naive_tables})")

    qs = make_query_set(data, weights, n_query_points=10, n_query_weights=4,
                        seed=3)
    ratios, ios = [], []
    for q in qs.points:
        for wid in qs.weight_ids:
            res = idx.search(q, weight_id=int(wid), k=k)
            got = res.ids[res.ids >= 0]
            w = idx.weights[int(wid)]
            exact = np.sort(weighted_lp_np(idx.data, q, w, p))[: got.size]
            mine = np.sort(weighted_lp_np(idx.data[got], q, w, p))
            ratios.append(np.mean(mine / np.maximum(exact, 1e-12)))
            ios.append(res.stats.io_blocks)
    print(f"queries: {len(ratios)}  "
          f"avg overall ratio {np.mean(ratios):.4f} (guarantee: <= c={cfg.c})  "
          f"avg I/O {np.mean(ios):.1f} blocks")
    assert np.mean(ratios) < cfg.c


if __name__ == "__main__":
    main()
