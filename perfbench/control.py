"""Readings for the check's limits: the program and its control, seed by
seed, in one process.

    python3 perfbench/control.py --workload <cell> --seeds <n>[,<n>...] \
        --seconds <s> [--variants program,control]

For each seed the inputs and the plan are made once, and each variant is
one ``harness.run_cell`` on them: the benchmark's own run, with its
service, window, sample and comparison, at the cell's own load for
``--seconds``.  It prints one JSON line a seed and variant: the compared
numbers.  ``program`` is the program as the configuration states it;
``control`` is the program with its own lower-precision path switched on
(bfloat16 rows, the nearest precision below the configuration's
float32), which has to come out not correct.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if not __package__:  # run as a script: imports start at the checkout
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness, spec  # noqa: E402

VARIANTS = {"program": {}, "control": {"vec_dtype": "bfloat16"}}


def readings(cell, seed: int, seconds: float, variants, device):
    """One dict per variant for ``seed``, the variants on one plan."""
    prep = harness.prepare(cell, seed, device)
    out = []
    for variant in variants:
        res = harness.run_cell(cell, seed, seconds, False, device,
                               time.perf_counter(), prep=prep,
                               **VARIANTS[variant])
        run = res["run"]
        out.append(dict(seed=seed, workload=cell.name, variant=variant,
                        correct=res["correct"],
                        numbers={k: v["value"]
                                 for k, v in res["check"].items()},
                        detail=res["detail"], failed=res["failed"],
                        qps=run.queries_answered / run.window_s,
                        plan_s=prep.plan_s, build_s=run.build_s))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--variants", default="program,control")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    variants = args.variants.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(cell, seed, args.seconds, variants,
                            torch.device("cuda", 0)):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
