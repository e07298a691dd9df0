"""Paper-table entry point of the port: one module per paper table/figure.

    PYTHONPATH=src python -m benchmarks_torch.run           # CPU-scaled suite
    PYTHONPATH=src python -m benchmarks_torch.run --full    # paper-scale planning
    PYTHONPATH=src python -m benchmarks_torch.run --only table8_ratio

Each module prints its table, asserts the paper's qualitative claims as
validation checks, and persists JSON to experiments/bench_torch/.  All of
them are host numpy (planner, host search, baselines); the card's speed is
measured by ``chip_smoke.py``, not here.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

from . import (fig1_query, table6_space, table7_alsh_space, table8_ratio,
               table11_relax)

MODULES = {
    "table6_space": table6_space,
    "table7_alsh_space": table7_alsh_space,
    "table8_ratio": table8_ratio,
    "fig1_query": fig1_query,
    "table11_relax": table11_relax,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale grids for planning-only benchmarks")
    ap.add_argument("--only", default=None, choices=list(MODULES))
    args = ap.parse_args(argv)

    names = [args.only] if args.only else list(MODULES)
    failures, validation_failures = [], []
    for name in names:
        print(f"\n{'=' * 72}\n# {name}\n{'=' * 72}", flush=True)
        t0 = time.time()
        try:
            out = MODULES[name].run(full=args.full)
            bad = [c["check"] for c in (out or {}).get("validation", [])
                   if not c["ok"]]
            validation_failures += [f"{name}: {b}" for b in bad]
        except Exception:  # noqa: BLE001 — per-benchmark isolation
            traceback.print_exc()
            failures.append(name)
        print(f"[{name} done in {time.time() - t0:.1f}s]", flush=True)

    print(f"\n{'=' * 72}\nSUMMARY")
    print(f"  benchmarks run: {len(names)}, crashed: {failures or 'none'}")
    if validation_failures:
        print("  validation failures (paper-claim checks):")
        for v in validation_failures:
            print(f"    - {v}")
    else:
        print("  all paper-claim validation checks passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
