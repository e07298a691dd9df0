"""The benchmark's one command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  With
``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics read from a ``torch.profiler``
trace of the window.  The numbers the check compared, each beside its
limit, are the last lines on standard error and the last key of the
result line, which is the last line on standard output.  Exit codes:
0 a result was printed; 2 no card, too few cards, or no program in the
checkout; 3 JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from the process's start

import os  # noqa: E402

# numpy's OpenBLAS pool, fixed before numpy loads.  The program's host
# encode is one small float64 product a request; with a thread on every
# core of the host it waits on a late thread now and then, and that wait,
# not the card, set the window's tail (PERF.md, section 2).
BLAS_THREADS = 4
os.environ["OPENBLAS_NUM_THREADS"] = str(BLAS_THREADS)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if not __package__:  # run as a script: imports start at the checkout
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench import harness, spec  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _device_info(torch, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}


def result_line(out: dict, metrics: dict, device: dict) -> dict:
    """The result's JSON object; the compared numbers come last."""
    run = out["run"]
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(10),
                             "idle_gaps": run.trace.idle_gaps(10)}
    line["check"] = out["check"]
    return line


def check_lines(out: dict) -> list:
    lines = [f"check detail: {json.dumps(out['detail'])}"]
    lines += [f"check {name}: {v['value']!r} (limit {v['limit']!r})"
              for name, v in out["check"].items()]
    lines.append(f"check correct: {out['correct']} (failed requests "
                 f"{out['failed']} of {out['attempted']})")
    return lines


def main(argv=None) -> int:
    args = _args(argv)
    if not (spec.ROOT / "src" / "repro_torch").is_dir():
        print("no src/repro_torch in this checkout: nothing to run",
              file=sys.stderr)
        return 2
    harness.prepare_environment()
    import torch

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           dev, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    run = out["run"]
    entries = cell.per_layer if args.trace else cell.end_to_end
    line = result_line(out, harness.metrics(run, entries),
                       _device_info(torch, run.memory_peak_bytes))
    for text in check_lines(out):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
