"""Paper Table 7: SL-ALSH / S2-ALSH space (L = n^rho tables at R = 1000).

Planning-only (Eqs. 17-18 numeric minimization); runs at paper scale.
Validation: L grows polynomially with n, shrinks with c, and is much less
sensitive to the weight-set parameters than WLSH's beta_S — the paper's
"ALSH space is data-sensitive, WLSH space is weight-set-sensitive" claim.
"""

from __future__ import annotations

from repro_torch.core.alsh import alsh_tables, rho_s2, rho_sl
from repro_torch.core.datagen import make_weight_set

from .common import DEFAULT_FULL, GRID_FULL, print_table, save

_R = 1_000.0


def run(full: bool = True) -> dict:
    # Table 7 is pure planning math -> always paper scale; weight-set d is
    # capped so the |S| x d generation stays light.
    grid = dict(GRID_FULL)
    base = dict(DEFAULT_FULL)
    base["S"] = 1_000
    rows = []
    for param, values in grid.items():
        if param == "c":
            for c in values:
                W = make_weight_set(base["S"], base["d"],
                                    base["n_subset"], base["n_subrange"])
                rows.append([param, c,
                             alsh_tables(base["n"], rho_sl(W, _R, c)),
                             alsh_tables(base["n"], rho_s2(W, _R, c))])
        elif param == "n":
            W = make_weight_set(base["S"], base["d"], base["n_subset"],
                                base["n_subrange"])
            r_sl, r_s2 = rho_sl(W, _R, base["c"]), rho_s2(W, _R, base["c"])
            for n in values:
                rows.append([param, n, alsh_tables(n, r_sl),
                             alsh_tables(n, r_s2)])
        else:
            for val in values:
                kw = dict(base)
                kw[param] = val
                W = make_weight_set(kw["S"], kw["d"], kw["n_subset"],
                                    kw["n_subrange"])
                rows.append([param, val,
                             alsh_tables(kw["n"], rho_sl(W, _R, kw["c"])),
                             alsh_tables(kw["n"], rho_s2(W, _R, kw["c"]))])
    print_table("Table 7 — SL/S2-ALSH space (R=1000)",
                ["param", "value", "L_SL", "L_S2"], rows)

    # validation
    n_curve = [r[2] for r in rows if r[0] == "n"]
    c_curve = [r[2] for r in rows if r[0] == "c"]
    s_vals = [r[2] for r in rows if r[0] == "S"]
    checks = [
        ("L grows with n", all(b > a for a, b in zip(n_curve, n_curve[1:]))),
        ("L shrinks with c", all(b <= a for a, b in zip(c_curve, c_curve[1:]))),
        ("L insensitive to |S| (<15% spread)",
         (max(s_vals) - min(s_vals)) / max(s_vals) < 0.15),
        ("polynomial n-growth (L(16x n) / L(n) >> 16^0.5)",
         n_curve[-1] / n_curve[0] > 4.0),
    ]
    out = {"rows": rows,
           "validation": [{"check": n, "ok": bool(ok)} for n, ok in checks]}
    print("\nvalidation:")
    for c in out["validation"]:
        print(f"  [{'ok' if c['ok'] else 'FAIL'}] {c['check']}")
    save("table7_alsh_space", out)
    return out


if __name__ == "__main__":
    run()
