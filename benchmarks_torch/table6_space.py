"""Paper Table 6: WLSH space consumption (total hash tables beta_S) as each
of {d, n, c, #Subrange, #Subset, |S|} varies, with and without bound
relaxation.  Planning-only — no data pass — so ``--full`` reproduces the
paper's exact parameter grid.

Validation targets (paper Sec. 5.2.1): beta_S grows with n, |S|, #Subset;
shrinks with c, #Subrange; bound relaxation cuts it by ~an order of
magnitude; l1 needs more tables than l2.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.datagen import make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.partition import partition

from .common import (DEFAULT, DEFAULT_FULL, GRID, GRID_FULL, TAU,
                     VALUE_RANGE, Timer, print_table, save)


def beta_total(p, d, n, c, n_subrange, n_subset, S, relaxed, seed=0):
    weights = make_weight_set(size=S, d=d, n_subset=n_subset,
                              n_subrange=n_subrange, seed=seed)
    cfg = PlanConfig(p=p, c=c, n=n, gamma_n=100.0)
    v = max(1, d // 4) if relaxed else 1  # paper: v = v' = d/4
    res = partition(weights, cfg, VALUE_RANGE, tau=TAU[p], v=v, v_prime=v)
    return res.beta_total, len(res.groups)


def run(full: bool = False, p_values=(1.0, 2.0)) -> dict:
    grid = GRID_FULL if full else GRID
    base = DEFAULT_FULL if full else DEFAULT
    out: dict = {"full": full, "results": {}}
    for p in p_values:
        rows = []
        for param, values in grid.items():
            for val in values:
                kw = dict(base)
                kw[param] = val
                for relaxed in (False, True):
                    with Timer() as t:
                        bt, ng = beta_total(
                            p, kw["d"], kw["n"], kw["c"], kw["n_subrange"],
                            kw["n_subset"], kw["S"], relaxed,
                        )
                    rows.append([param, val, relaxed, bt, ng,
                                 round(t.seconds, 2)])
        out["results"][f"l{int(p)}"] = rows
        print_table(
            f"Table 6 — WLSH space, l_{int(p)} distance",
            ["param", "value", "relaxed", "beta_S", "groups", "sec"],
            rows,
        )
    _validate(out)
    save("table6_space", out)
    return out


def _validate(out: dict):
    """Assert the paper's monotone trends hold on our reproduction."""
    checks = []
    for key, rows in out["results"].items():
        get = lambda param, relaxed: {  # noqa: E731
            r[1]: r[3] for r in rows if r[0] == param and r[2] == relaxed
        }
        for relaxed in (False, True):
            n_curve = get("n", relaxed)
            checks.append((f"{key} beta up with n (rel={relaxed})",
                           _mostly_increasing(list(n_curve.values()))))
            c_curve = get("c", relaxed)
            checks.append((f"{key} beta down with c (rel={relaxed})",
                           _mostly_increasing(list(c_curve.values())[::-1])))
            s_curve = get("S", relaxed)
            checks.append((f"{key} beta up with |S| (rel={relaxed})",
                           _mostly_increasing(list(s_curve.values()))))
        # relaxation wins by a wide margin at defaults
        strict = {(r[0], r[1]): r[3] for r in rows if not r[2]}
        relax = {(r[0], r[1]): r[3] for r in rows if r[2]}
        shared = set(strict) & set(relax)
        gains = [strict[k] / max(relax[k], 1) for k in shared]
        checks.append((f"{key} relaxation median gain > 1.5x",
                       float(np.median(gains)) > 1.5))
    out["validation"] = [
        {"check": name, "ok": bool(ok)} for name, ok in checks
    ]
    print("\nvalidation:")
    for c in out["validation"]:
        print(f"  [{'ok' if c['ok'] else 'FAIL'}] {c['check']}")


def _mostly_increasing(xs) -> bool:
    xs = list(xs)
    ups = sum(1 for a, b in zip(xs, xs[1:]) if b >= a * 0.98)
    return ups >= len(xs) - 2


if __name__ == "__main__":
    import sys

    run(full="--full" in sys.argv)
