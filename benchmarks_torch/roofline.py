"""Roofline summary: aggregates the port's dry-run cells
(``experiments/dryrun_torch/*.json``, written by
``python -m repro_torch.launch.dryrun``) into one table, one row per arch x
shape x mesh, as the JAX package's ``benchmarks/roofline.py`` does for its
own cells.

    PYTHONPATH=src python -m benchmarks_torch.roofline
"""

from __future__ import annotations

import glob
import json
import os

from .common import print_table, save

DRYRUN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments", "dryrun_torch",
)


def load_cells(mesh: str | None = None) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if mesh and r.get("mesh") != mesh:
            continue
        cells.append(r)
    return cells


def run(full: bool = False, mesh: str | None = None):
    del full
    cells = load_cells(mesh)
    rows, n_ok, n_skip, n_err = [], 0, 0, 0
    for r in cells:
        tag = f"{r.get('arch','?')}/{r.get('shape','?')}/{r.get('mesh','?')}"
        if r["status"] == "skipped":
            n_skip += 1
            rows.append([tag, "SKIP", "-", "-", "-", "-", "-", "-",
                         r["reason"][:40]])
            continue
        if r["status"] == "error":
            n_err += 1
            rows.append([tag, "ERR", "-", "-", "-", "-", "-", "-",
                         r["error"][:40]])
            continue
        n_ok += 1
        rows.append([
            tag, "ok", r["hbm_gb"],
            f"{r['compute_s']:.2e}", f"{r['memory_s']:.2e}",
            f"{r['collective_s']:.2e}", r["bottleneck"],
            round(r["useful_fraction"], 3),
            f"roofline_frac={r['roofline_fraction']:.3f}",
        ])
    print_table(
        "Roofline terms per (arch x shape x mesh)",
        ["cell", "st", "GB/chip", "compute_s", "memory_s", "collective_s",
         "bound", "useful", "note"],
        rows,
    )
    fits = [r for r in cells if r["status"] == "ok"]
    bad_fit = [f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in fits
               if not r.get("fits_hbm", False)]
    print(f"\ncells: {n_ok} ok, {n_skip} skipped, {n_err} error; "
          f"{len(bad_fit)} over HBM: {bad_fit}")
    out = {"rows": rows, "ok": n_ok, "skipped": n_skip, "errors": n_err,
           "over_hbm": bad_fit}
    save("roofline_summary", out)
    return out


if __name__ == "__main__":
    run()
