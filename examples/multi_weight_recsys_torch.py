"""The paper's motivating scenario (Sec. 1): a personalized recommender.

Products are points, user preferences are weight vectors.  When user u
(preference W_u) shows interest in product o, recommend the (c,k)-WNN of o
under D_{W_u}.  This example contrasts:

  * naive:  one C2LSH table group per user          (space: sum of betas)
  * WLSH:   Partition() + derived families share groups across users

and verifies both answer with ratio <= c while WLSH uses a fraction of the
tables.

    PYTHONPATH=src python examples/multi_weight_recsys_torch.py

The PyTorch port's copy of the JAX package's example: the planner and
the host search are numpy in both packages, so it prints the same lines.
"""

import numpy as np

from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.distances import weighted_lp_np
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex


def main():
    n_products, d, n_users, k = 6_000, 24, 32, 5
    p = 2.0

    products = make_dataset(n=n_products, d=d, seed=0)
    # user taste clusters: 4 segments x 8 users
    prefs = make_weight_set(size=n_users, d=d, n_subset=4, n_subrange=10,
                            seed=1)
    cfg = PlanConfig(p=p, c=3, n=n_products, gamma_n=100.0)

    wlsh = WLSHIndex(products, prefs, cfg, tau=500.0, v=d // 4,
                     v_prime=d // 4, seed=2)
    naive_tables = 0
    for u in range(n_users):
        solo = WLSHIndex(products, prefs[u : u + 1], cfg, tau=float("inf"),
                         v=d // 4, v_prime=d // 4, seed=2)
        naive_tables += solo.beta_total
    print(f"{n_users} users, {n_products} products")
    print(f"naive per-user tables : {naive_tables}")
    print(f"WLSH shared tables    : {wlsh.beta_total} "
          f"({len(wlsh.part.groups)} groups, "
          f"{naive_tables / wlsh.beta_total:.1f}x saving)")

    rng = np.random.default_rng(3)
    ratios = []
    for u in rng.choice(n_users, 8, replace=False):
        o = products[rng.integers(0, n_products)]
        res = wlsh.search(o, weight_id=int(u), k=k)
        got = res.ids[res.ids >= 0]
        exact = np.sort(weighted_lp_np(products, o, prefs[u], p))[: got.size]
        mine = np.sort(weighted_lp_np(products[got], o, prefs[u], p))
        # +eps on both sides: the query IS a product, so exact[0] == 0
        r = float(np.mean((mine + 1e-9) / (exact + 1e-9)))
        ratios.append(r)
        names = ", ".join(str(i) for i in got[:k])
        print(f"  user {u:2d}: recommend products [{names}]  ratio {r:.3f}")
    print(f"avg overall ratio {np.mean(ratios):.4f} (<= c={cfg.c})")
    assert np.mean(ratios) < cfg.c
    assert wlsh.beta_total < naive_tables


if __name__ == "__main__":
    main()
