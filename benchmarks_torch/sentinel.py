"""Bench-regression sentinel of the port: fresh serving metrics vs a
pinned baseline.

A CI gate, not a table benchmark: ``collect()`` runs one small
driver-stepped serving workload (open-loop trace, tight paging budget,
predictive prefetch, shadow-exact recall sampling at rate 1.0) through
the port's serving stack with the fused kernels on, and condenses it to
a flat metric dict; ``compare()`` checks every metric against the
committed baseline under a per-metric tolerance band; the CLI exits
nonzero on any regression so a lane can require it.  The workload, the
bands and the metrics are the JAX package's (``benchmarks/sentinel.py``),
so the seeded metrics equal that sentinel's.

Band semantics: each metric declares the direction that counts as a
regression (``lower`` = bigger is worse, ``higher`` = smaller is worse)
and a tolerance — wall-clock metrics (step latency, q/s) get wide
relative bands because machines vary, deterministic metrics
(compiled-step count, shadow drops, observed recall) get tight or zero
bands because the workload is fully seeded.  Improvements never fail.
``obs_overhead_frac`` (the obs-on / obs-off p50 step ratio) rides along
in the artifact as an informational metric but is not gated: a ratio of
two noisy p50s on a smoke-sized workload pages on hardware weather.

The workload runs on the card (``--device cuda``, the default; without a
CUDA device it raises) unless ``--device cpu`` asks for the plain torch
versions of the kernels.  Every run writes a machine-readable artifact
(default ``experiments/bench_torch/BENCH_serve.json``) that names the
device it ran on (``nvidia-smi``'s name and power limit on the card);
``--write-baseline`` pins the current metrics, with that device, as
``experiments/bench_torch/BASELINE.json``.

    PYTHONPATH=src python -m benchmarks_torch.sentinel                # gate
    PYTHONPATH=src python -m benchmarks_torch.sentinel --device cpu
    PYTHONPATH=src python -m benchmarks_torch.sentinel --write-baseline
    PYTHONPATH=src python -m benchmarks_torch.sentinel --from-json m.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.kernels.platform import resolve_device
from repro_torch.serving.async_service import (AsyncRetrievalService,
                                               ManualClock)
from repro_torch.serving.qos import DegradeStep
from repro_torch.serving.retrieval import RetrievalService, ServiceConfig
from repro_torch.serving.scheduler import (
    DeadlinePrefetch,
    ServiceDriver,
    replay_with_driver,
)

from .common import TAU, print_table

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(_ROOT, "experiments", "bench_torch",
                                "BASELINE.json")
DEFAULT_OUT = os.path.join(_ROOT, "experiments", "bench_torch",
                           "BENCH_serve.json")

# one band per gated metric: the direction that is a regression, plus a
# relative and/or absolute tolerance applied to the baseline value.
# wall metrics are wide (CI hardware noise); seeded metrics are tight.
BANDS: dict[str, dict] = {
    "p50_step_ms":        {"direction": "lower", "rel_tol": 1.0},
    "p95_step_ms":        {"direction": "lower", "rel_tol": 1.5},
    "qps":                {"direction": "higher", "rel_tol": 0.6},
    "state_hit_rate":     {"direction": "higher", "abs_tol": 0.05},
    "deadline_miss_rate": {"direction": "lower", "abs_tol": 0.05},
    "mean_occupancy":     {"direction": "higher", "abs_tol": 0.05},
    "observed_recall":    {"direction": "higher", "abs_tol": 0.02},
    "recall_margin_min":  {"direction": "higher", "abs_tol": 0.02},
    "n_compiled_steps":   {"direction": "lower", "abs_tol": 0.0},
    "n_shadow_dropped":   {"direction": "lower", "abs_tol": 0.0},
}

# sentinel workload: small enough for a CI smoke lane, big enough to
# exercise paging, prefetch, deadlines and the shadow-recall path
_WL = dict(n=2_048, d=16, n_weights=8, n_subset=4, n_queries=96,
           arrival_rate=2_000.0, seed=5)


def _timed_replay(svc, qpts, wids, arrivals):
    """Drive one replay; returns (per-launch step seconds, wall seconds)."""
    asvc = AsyncRetrievalService(svc, max_delay_ms=2.0,
                                 clock=ManualClock())
    driver = ServiceDriver(asvc, prefetch=DeadlinePrefetch())
    launch_times = []
    seen = [0]
    real_step = driver.step

    def timed_step():
        t0 = time.perf_counter()
        out = real_step()
        dt = time.perf_counter() - t0
        if driver.stats.n_launches > seen[0]:
            launch_times.append(dt)
            seen[0] = driver.stats.n_launches
        return out

    driver.step = timed_step
    t0 = time.perf_counter()
    replay_with_driver(driver, qpts, wids, arrivals)
    wall = time.perf_counter() - t0
    return launch_times, wall, driver


def device_name(device: str = "cuda") -> str:
    """What ran the workload: ``nvidia-smi``'s name and power limit of
    the card (as ``name, power.limit``), or ``"cpu"``."""
    if resolve_device(device).type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def collect(device: str = "cuda") -> dict:
    """Run the sentinel workload on ``device``; returns the flat
    gated-metric dict.

    Fully seeded: the same code produces the same deterministic metrics
    (compiled steps, recall, drops) on every run and on either device;
    only the wall-clock numbers move with the hardware.  Raises without
    a CUDA device unless ``device="cpu"``.
    """
    resolve_device(device)
    w = _WL
    data = make_dataset(n=w["n"], d=w["d"], seed=w["seed"])
    weights = make_weight_set(size=w["n_weights"], d=w["d"],
                              n_subset=w["n_subset"], n_subrange=10,
                              seed=w["seed"] + 1)
    pcfg = PlanConfig(p=2.0, c=3, n=w["n"], gamma_n=100.0)
    host = WLSHIndex(data, weights, pcfg, tau=TAU[2.0], v=4, v_prime=4,
                     seed=w["seed"] + 2)
    plan = host.export_serving_plan()
    cap = max(1, int(np.ceil(0.5 * plan.n_groups)))
    ladder = (DegradeStep(c=4, k=3, cost=0.5, recall_bound=0.3),)

    rng = np.random.default_rng(w["seed"] + 3)
    wids = rng.integers(0, w["n_weights"], w["n_queries"])
    qpts = data[rng.choice(w["n"], w["n_queries"], replace=False)].astype(
        np.float32)
    qpts += rng.normal(0, 3.0, qpts.shape).astype(np.float32)
    arrivals = np.cumsum(
        rng.exponential(1.0 / w["arrival_rate"], w["n_queries"]))

    def _service(obs_on: bool):
        svc = RetrievalService(plan, data, cfg=ServiceConfig(
            k=5, q_batch=8, use_kernels="on",
            max_resident_groups=cap, degrade_ladder=ladder,
            recall_sample_rate=1.0 if obs_on else 0.0,
            recall_floor=0.25, obs=obs_on, device=device))
        svc.warmup()
        svc.reset_stats()
        return svc

    # obs-off pass first: prices the bare step so the on-pass overhead
    # fraction is measurable on the same machine in the same process
    off_svc = _service(False)
    off_times, _, _ = _timed_replay(off_svc, qpts, wids, arrivals)

    svc = _service(True)
    times, wall, driver = _timed_replay(svc, qpts, wids, arrivals)
    est = svc.batcher.recall
    est.drain()
    rsum = est.summary()
    margin = svc.batcher.metrics.gauge(
        "wlsh_recall_bound_margin",
        "observed recall minus the rung's planned recall bound")
    margins = list(margin.series().values())
    cs = svc.state_cache.stats
    p50_on = float(np.percentile(times, 50))
    p50_off = float(np.percentile(off_times, 50))
    return {
        "p50_step_ms": 1e3 * p50_on,
        "p95_step_ms": 1e3 * float(np.percentile(times, 95)),
        "qps": w["n_queries"] / wall,
        "obs_overhead_frac": p50_on / p50_off - 1.0,
        "state_hit_rate": float(cs.hit_rate),
        "deadline_miss_rate": float(driver.stats.deadline_miss_rate),
        "mean_occupancy": float(svc.mean_occupancy()),
        "observed_recall": float(est.estimate()),
        "recall_margin_min": float(min(margins)),
        "n_compiled_steps": int(svc.step_cache.n_compiled),
        "n_shadow_dropped": int(rsum["n_dropped"]),
    }


def compare(current: dict, baseline: dict,
            bands: dict | None = None) -> list[dict]:
    """Judge ``current`` against ``baseline`` under the tolerance bands.

    Returns one row per banded baseline metric: the values, the
    computed pass limit, and ``ok``.  A metric present in the baseline
    but missing from the current run is a regression (it disappeared);
    a metric new in the current run is ignored (no baseline to judge
    against — pin a fresh baseline to start gating it).
    """
    bands = BANDS if bands is None else bands
    rows = []
    for name, band in bands.items():
        if name not in baseline:
            continue
        base = float(baseline[name])
        tol = (band.get("abs_tol", 0.0)
               + band.get("rel_tol", 0.0) * abs(base))
        if band["direction"] == "lower":  # bigger is worse
            limit = base + tol
            cur = current.get(name)
            ok = cur is not None and float(cur) <= limit
        else:  # smaller is worse
            limit = base - tol
            cur = current.get(name)
            ok = cur is not None and float(cur) >= limit
        rows.append({
            "metric": name,
            "current": None if cur is None else float(cur),
            "baseline": base,
            "limit": limit,
            "direction": band["direction"],
            "ok": bool(ok),
        })
    return rows


def _load_metrics(path: str) -> dict:
    """Read a metric dict from JSON (bare, or under a ``metrics`` key)."""
    with open(path) as fh:
        payload = json.load(fh)
    return payload.get("metrics", payload)


def main(argv=None) -> int:
    """CLI gate: 0 = within bands, 1 = regression, 2 = no baseline."""
    ap = argparse.ArgumentParser(
        description="serving bench-regression sentinel")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    metavar="PATH",
                    help="pinned baseline metrics (JSON) to gate against")
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="PATH",
                    help="write the machine-readable run artifact here")
    ap.add_argument("--from-json", default=None, metavar="PATH",
                    help="judge pre-collected metrics from PATH instead "
                         "of running the sentinel workload")
    ap.add_argument("--write-baseline", action="store_true",
                    help="pin the current metrics as the new baseline "
                         "and exit 0 (no gating)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run the workload on the card (default; raises "
                         "without one) or on the CPU")
    args = ap.parse_args(argv)

    if args.from_json:
        current, device = _load_metrics(args.from_json), None
    else:
        current, device = collect(args.device), device_name(args.device)
    artifact = {
        "metrics": current,
        "workload": _WL,
        "device": device,
        "bands": BANDS,
        "baseline_path": os.path.relpath(args.baseline, _ROOT),
        "t_collected": time.time(),
    }
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    print(f"sentinel: metrics -> {args.out}")

    if args.write_baseline:
        os.makedirs(os.path.dirname(args.baseline), exist_ok=True)
        with open(args.baseline, "w") as fh:
            json.dump({"metrics": current,
                       "workload": _WL,
                       "device": device,
                       "t_pinned": time.time()}, fh, indent=1)
        print(f"sentinel: baseline pinned -> {args.baseline}")
        return 0

    if not os.path.exists(args.baseline):
        print(f"sentinel: no baseline at {args.baseline} — run with "
              f"--write-baseline to pin one")
        return 2
    rows = compare(current, _load_metrics(args.baseline))
    print_table(
        "bench-regression sentinel vs "
        f"{os.path.relpath(args.baseline, _ROOT)}",
        ["metric", "current", "baseline", "limit", "worse when", "ok"],
        [[r["metric"],
          "MISSING" if r["current"] is None else r["current"],
          r["baseline"], r["limit"], r["direction"],
          "PASS" if r["ok"] else "FAIL"] for r in rows],
    )
    bad = [r for r in rows if not r["ok"]]
    if bad:
        print(f"sentinel: {len(bad)} regression(s): "
              + ", ".join(r["metric"] for r in bad))
        return 1
    print(f"sentinel: {len(rows)} metrics within bands")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
