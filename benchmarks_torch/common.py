"""Shared benchmark plumbing of the port's paper-table scripts: CPU-scaled
parameter grids mirroring the paper's Tables 3/5, timing helpers, result
persistence, table printing (the same grids and formats as the JAX
package's ``benchmarks/common.py``).

The paper's grids (d up to 1.6k, n up to 1.6m, |S| up to 9k) are scaled by
SCALE (default 1/100) so the full suite runs in minutes on one CPU core;
``--full`` restores paper-scale for the planning-only benchmarks (space
tables need no data pass, so they run at paper scale regardless).
Results go to ``experiments/bench_torch/``; ``save`` reads ``RESULT_DIR``
when it is called, so a caller may point it elsewhere.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

RESULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "experiments", "bench_torch",
)

# paper defaults (Sec. 5.1): eps=0.01, gamma=100/n, c=3, tau=1000 (l1)/500 (l2)
TAU = {1.0: 1_000.0, 2.0: 500.0}
VALUE_RANGE = 10_000.0

# CPU-scaled grids (underlined defaults of Tables 3/5 marked by position 2)
GRID = {
    "d": [16, 24, 32, 48, 64],
    "n": [1_000, 2_000, 4_000, 8_000, 16_000],
    "c": [2, 3, 4, 5, 6],
    "n_subrange": [5, 10, 20, 50, 100],
    "n_subset": [2, 4, 6, 10, 16],
    "S": [8, 16, 24, 32, 48],
}
DEFAULT = {"d": 24, "n": 4_000, "c": 3, "n_subrange": 20, "n_subset": 6,
           "S": 24}

# paper-scale grids for planning-only tables (no data pass involved)
GRID_FULL = {
    "d": [100, 200, 400, 800, 1_600],
    "n": [100_000, 200_000, 400_000, 800_000, 1_600_000],
    "c": [2, 3, 4, 5, 6],
    "n_subrange": [5, 10, 20, 50, 100],
    "n_subset": [50, 100, 200, 500, 1_000],
    "S": [1_000, 3_000, 5_000, 7_000, 9_000],
}
DEFAULT_FULL = {"d": 400, "n": 400_000, "c": 3, "n_subrange": 20,
                "n_subset": 200, "S": 5_000}


def save(name: str, payload: dict) -> str:
    os.makedirs(RESULT_DIR, exist_ok=True)
    path = os.path.join(RESULT_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=_np_default)
    return path


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0


def print_table(title: str, header: list[str], rows: list[list]):
    print(f"\n== {title} ==")
    widths = [
        max(len(str(h)), max((len(_fmt(r[i])) for r in rows), default=0))
        for i, h in enumerate(header)
    ]
    print("  ".join(str(h).ljust(w) for h, w in zip(header, widths)))
    for r in rows:
        print("  ".join(_fmt(v).ljust(w) for v, w in zip(r, widths)))


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0 or (1e-3 < abs(v) < 1e6):
            return f"{v:,.3f}".rstrip("0").rstrip(".")
        return f"{v:.3e}"
    if isinstance(v, (int, np.integer)):
        return f"{v:,}"
    return str(v)
