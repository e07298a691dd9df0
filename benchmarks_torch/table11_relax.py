"""Paper Table 11 / Appendix F.1: necessity of bound relaxation.

beta_S vs beta_S^br over c in {5,7,9,11,13} with uniformly random weight
vectors: without relaxation the table count decays slowly in c and stays
huge; with relaxation it collapses once c >= 7.  Planning-only.
"""

from __future__ import annotations

from repro_torch.core.datagen import make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.partition import partition

from .common import DEFAULT, VALUE_RANGE, print_table, save

_C = (5, 7, 9, 11, 13)


def run(full: bool = False, p_values=(1.0, 2.0)):
    d, S = DEFAULT["d"], DEFAULT["S"]
    n = 400_000  # planning-only: paper-scale n
    weights = make_weight_set(size=S, d=d, n_subset=S, n_subrange=1, seed=61)
    rows = []
    for p in p_values:
        for c in _C:
            cfg = PlanConfig(p=p, c=c, n=n, gamma_n=100.0)
            strict = partition(weights, cfg, VALUE_RANGE, tau=float("inf"),
                               v=1, v_prime=1)
            relaxed = partition(weights, cfg, VALUE_RANGE, tau=float("inf"),
                                v=max(1, d // 4), v_prime=max(1, d // 4))
            rows.append([f"l{int(p)}", c, strict.beta_total,
                         relaxed.beta_total])
    print_table("Table 11 — bound relaxation necessity",
                ["dist", "c", "beta_S", "beta_S^br"], rows)

    by_p = {}
    for dist, c, b, br in rows:
        by_p.setdefault(dist, []).append((c, b, br))
    checks = []
    for dist, series in by_p.items():
        b_last = series[-1][1]
        br_at7 = [br for c, _, br in series if c >= 7]
        checks.append((f"{dist}: strict beta still large at c=13",
                       b_last > 10 * max(br_at7[0], 1)))
        checks.append((f"{dist}: relaxed beta acceptable for c >= 7",
                       all(br <= series[0][2] for br in br_at7)))
        checks.append((f"{dist}: relaxed <= strict everywhere",
                       all(br <= b for _, b, br in series)))
    out = {"rows": rows,
           "validation": [{"check": n_, "ok": bool(ok)} for n_, ok in checks]}
    print("\nvalidation:")
    for c in out["validation"]:
        print(f"  [{'ok' if c['ok'] else 'FAIL'}] {c['check']}")
    save("table11_relax", out)
    return out


if __name__ == "__main__":
    run()
