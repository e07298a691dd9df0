"""Paper Fig. 1 (and Figs. 2-7): WLSH query efficiency (I/O cost) and
accuracy (average overall ratio) as each parameter varies, l1 + l2,
k in {10, 100 -> scaled 5, 20}, with collision-threshold reduction on/off.

Runs the faithful host search (the I/O-metered path) on CPU-scaled data.
Validation targets (Sec. 5.3.1): I/O up with n, down with c, ~flat in the
weight-set params; ratio well below c everywhere; reduction cuts I/O.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.datagen import make_dataset, make_query_set, make_weight_set
from repro_torch.core.distances import weighted_lp_np
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex

from .common import DEFAULT, GRID, TAU, Timer, print_table, save

_K = (5, 20)  # paper: (10, 100), scaled with n


def _one_setting(p, d, n, c, n_subrange, n_subset, S, k, reduction,
                 n_qp=6, n_qw=3, seed=0):
    raw = make_dataset(n=n, d=d, seed=seed + 1)
    weights = make_weight_set(size=S, d=d, n_subset=n_subset,
                              n_subrange=n_subrange, seed=seed + 2)
    # paper protocol: query points are removed from the data set, THEN the
    # index is built (otherwise exact-NN distance is 0 for the point itself)
    qs = make_query_set(raw, weights, n_query_points=n_qp,
                        n_query_weights=n_qw, seed=seed + 3)
    data = qs.data
    cfg = PlanConfig(p=p, c=c, n=len(data), gamma_n=100.0)
    idx = WLSHIndex(data, weights, cfg, tau=TAU[p], v=max(1, d // 4),
                    v_prime=max(1, d // 4), use_reduction=reduction,
                    seed=seed)
    ios, ratios = [], []
    for q in qs.points:
        for wid in qs.weight_ids:
            res = idx.search(q, weight_id=int(wid), k=k)
            ios.append(res.stats.io_blocks)
            got = res.ids[res.ids >= 0]
            if got.size:
                w = idx.weights[int(wid)]
                exact = np.sort(weighted_lp_np(idx.data, q, w, p))[: got.size]
                mine = np.sort(weighted_lp_np(idx.data[got], q, w, p))
                ratios.append(
                    float(np.mean(mine / np.maximum(exact, 1e-12)))
                )
    return float(np.mean(ios)), float(np.mean(ratios)) if ratios else np.inf


def run(full: bool = False, p_values=(1.0, 2.0), reduction: bool = True,
        params=("n", "c", "d", "S")) -> dict:
    del full  # data-pass benchmark: always CPU-scaled
    out: dict = {"reduction": reduction, "results": {}}
    for p in p_values:
        rows = []
        for param in params:
            for val in GRID[param]:
                kw = dict(DEFAULT)
                kw[param] = val
                for k in _K:
                    with Timer() as t:
                        io, ratio = _one_setting(
                            p, kw["d"], kw["n"], kw["c"], kw["n_subrange"],
                            kw["n_subset"], kw["S"], k, reduction,
                        )
                    rows.append([param, val, k, round(io, 1),
                                 round(ratio, 4), round(t.seconds, 1)])
        out["results"][f"l{int(p)}"] = rows
        print_table(
            f"Fig 1 — WLSH query I/O + ratio, l_{int(p)}"
            f" (reduction={reduction})",
            ["param", "value", "k", "io_blocks", "avg_ratio", "sec"],
            rows,
        )
    _validate(out)
    save(f"fig1_query_red{int(reduction)}", out)
    return out


def _validate(out):
    checks = []
    for key, rows in out["results"].items():
        c_val = int(key[1])  # noqa: F841
        byp = lambda param, k: [  # noqa: E731
            (r[1], r[3], r[4]) for r in rows if r[0] == param and r[2] == k
        ]
        for k in _K:
            n_io = [x[1] for x in byp("n", k)]
            checks.append((f"{key} k={k} io up with n",
                           n_io[-1] > n_io[0]))
            c_io = [x[1] for x in byp("c", k)]
            checks.append((f"{key} k={k} io down with c",
                           c_io[-1] < c_io[0] * 1.1))
            ratios = [r[4] for r in rows if r[2] == k and np.isfinite(r[4])]
            # ratio << c=3 at defaults; allow some slack at c=6 cells
            checks.append((f"{key} k={k} mean ratio < 2",
                           float(np.mean(ratios)) < 2.0))
    out["validation"] = [
        {"check": n, "ok": bool(ok)} for n, ok in checks
    ]
    print("\nvalidation:")
    for c in out["validation"]:
        print(f"  [{'ok' if c['ok'] else 'FAIL'}] {c['check']}")


if __name__ == "__main__":
    run()
