"""The bench sentinel's step latency in one process as the process ages.

``chip_smoke.py`` runs the sentinel beside legs that open
``torch.profiler`` sessions; the sentinel's baseline is pinned in a fresh
process.  This script runs the sentinel's workload on the card four times
at each stage of one process, so the two conditions can be compared on
the same machine:

  fresh; after ``import torch.profiler``; after a CUDA-only profiler
  session; after a CPU + CUDA session; after ``chip_smoke``'s ``lm``
  leg; then with ``gc.freeze()`` and with the collector off.

Each stage prints one ``drift`` line: p50 and p95 step ms and the
collector's passes of every run, and the objects it tracks.  Run it from
the repository root on a CUDA card:

    PYTHONPATH=src python -m benchmarks_torch.sentinel_drift
"""

from __future__ import annotations

import gc

RUNS = 4  # sentinel runs a stage


def _stage(label: str, collect, smi: str) -> None:
    rows = []
    for _ in range(RUNS):
        g0 = sum(s["collections"] for s in gc.get_stats())
        m = collect(device="cuda")
        g1 = sum(s["collections"] for s in gc.get_stats())
        rows.append((round(m["p50_step_ms"], 3), round(m["p95_step_ms"], 3),
                     g1 - g0))
    print(f"drift {label}: (p50 ms, p95 ms, gc passes) {rows}; gc objects "
          f"{len(gc.get_objects())} [{smi}]", flush=True)


def main() -> int:
    import torch

    import chip_smoke

    from .sentinel import collect

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = chip_smoke.phase_device(torch)
    chip_smoke.phase_build()
    _stage("fresh", collect, smi)
    import torch.profiler
    _stage("after importing torch.profiler", collect, smi)
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device=dev)
    for label, acts in (("CUDA-only", [ProfilerActivity.CUDA]),
                        ("CPU + CUDA", [ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])):
        with profile(activities=acts):
            for _ in range(10):
                x @ x
            torch.cuda.synchronize()
        gc.collect()
        _stage(f"after a {label} profiler session", collect, smi)
    chip_smoke.phase_lm(torch, dev, smi)
    chip_smoke._release(torch)
    _stage("after the lm leg", collect, smi)
    gc.freeze()
    _stage("gc.freeze()", collect, smi)
    gc.disable()
    _stage("collector off", collect, smi)
    gc.enable()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
