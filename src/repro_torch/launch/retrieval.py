"""Retrieval-service launcher, synchronous path: plan -> build -> serve.

End-to-end driver on synthetic data (paper Sec. 5.1 generators), on the
card by default:

    PYTHONPATH=src python -m repro_torch.launch.retrieval \
        --n 4096 --d 24 --n-weights 24 --n-queries 96 --k 5 --check

Steps:
  1. plan   — WLSHIndex partitions the weight set into table groups
              (Algorithm 1) and exports a serializable ServingPlan
  2. build  — RetrievalService materializes every group's state on the
              device; groups whose padded shapes coincide share one step
  3. serve  — the mixed (query, weight_id) stream arrives in one call and
              is routed, coalesced, padded and answered in submission
              order (Algorithm 2)
  4. report — per-group occupancy / stop-level / n_checked stats and
              throughput; ``--check`` cross-validates every answer against
              the host oracle WLSHIndex.search_dense

``--device cpu`` runs the plain torch versions of the kernels on the host.
``--use-kernels off`` runs the unfused stages (on the card: the
freq_level kernel, then torch distances and histograms).  ``--plan-out``
persists the ServingPlan npz (the JAX package's layout).

``run(args, include_codes=False)`` serves a plan exported without host
codes: the card encodes data and queries itself (the hash_encode kernel).
Its candidate sets then come from float32 codes, not the host oracle's
float64 ones, so ``--check`` reports how many answers equal search_dense
and requires instead that every query's source row, asked without noise,
is its own rank-0 answer.  ``run`` returns the search_dense mismatches as
``n_check_failures`` and, for such a plan, the source rows that missed
themselves as ``n_self_misses`` (None otherwise).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.datagen import make_dataset, make_weight_set
from ..core.params import PlanConfig
from ..core.wlsh import WLSHIndex
from ..kernels import platform as kernel_platform
from ..serving.retrieval import RetrievalService, ServiceConfig

__all__ = ["main", "parse_args", "run"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(args, *, include_codes: bool = True) -> dict:
    """Plan, build, serve and report; returns the run's numbers.

    ``include_codes=False`` exports the plan without host codes, so the
    device encodes data and queries.
    """
    device = kernel_platform.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)

    # ---- plan ---------------------------------------------------------------
    t0 = time.time()
    data = make_dataset(n=args.n, d=args.d, value_range=args.value_range,
                        seed=args.seed)
    weights = make_weight_set(size=args.n_weights, d=args.d,
                              n_subset=args.n_subset,
                              n_subrange=args.n_subrange, seed=args.seed + 1)
    pcfg = PlanConfig(p=args.p, c=args.c, n=args.n, gamma_n=args.gamma_n)
    host = WLSHIndex(data, weights, pcfg, tau=args.tau, v=args.v,
                     v_prime=args.v, value_range=args.value_range,
                     seed=args.seed + 2)
    plan = host.export_serving_plan(include_codes=include_codes)
    t_plan = time.time() - t0
    print(f"plan: |S|={args.n_weights} -> {plan.n_groups} groups, "
          f"{plan.beta_total} tables "
          f"(betas {[g.beta_group for g in plan.groups]}) in {t_plan:.1f}s")
    if args.plan_out:
        plan.save_npz(args.plan_out)
        print(f"plan saved to {args.plan_out}")

    # ---- build --------------------------------------------------------------
    t0 = time.time()
    scfg = ServiceConfig(k=args.k, q_batch=args.q_batch,
                         use_kernels=args.use_kernels, device=str(device))
    svc = RetrievalService(plan, data, cfg=scfg)
    svc.warmup()
    _sync(device)
    t_build = time.time() - t0
    print(f"build: {plan.n_groups} group states "
          f"({svc.resident_bytes / 2**20:.1f} MiB on {device}), "
          f"{svc.step_cache.n_compiled} query steps "
          f"(shape sharing {plan.n_groups}/{svc.step_cache.n_compiled}) "
          f"in {t_build:.1f}s")
    print(f"kernels: {kernel_platform.describe(scfg.use_kernels, device)} "
          f"(--use-kernels {args.use_kernels})")

    # ---- serve --------------------------------------------------------------
    wids = rng.integers(0, args.n_weights, size=args.n_queries)
    src = rng.choice(args.n, args.n_queries, replace=False)
    qpts = data[src].astype(np.float32)
    qpts = qpts + rng.normal(0, args.q_noise, qpts.shape).astype(np.float32)
    t0 = time.time()
    res = svc.query(qpts, wids)
    _sync(device)
    t_serve = time.time() - t0
    print(f"serve: {args.n_queries} queries over "
          f"{len(np.unique(res.group_ids))} active groups in "
          f"{t_serve:.2f}s ({args.n_queries / t_serve:.1f} q/s)")

    # ---- report -------------------------------------------------------------
    print("per-group serving stats:")
    for gi, s in sorted(svc.stats_summary().items()):
        print(f"  group {gi}: {s['n_queries']} queries / {s['n_batches']} "
              f"batches, occupancy {s['occupancy']:.2f}, "
              f"mean stop level {s['mean_stop_level']:.1f}, "
              f"mean checked {s['mean_n_checked']:.0f}")
    n_bad, n_self_miss = 0, None
    if args.check:
        for qi in range(args.n_queries):
            want = host.search_dense(qpts[qi], weight_id=int(wids[qi]),
                                     k=args.k)
            ok = np.array_equal(res.ids[qi], want.ids.astype(np.int32))
            ok &= int(res.stop_levels[qi]) == want.stats.stop_level
            n_bad += not ok
        print(f"check vs search_dense: {args.n_queries - n_bad}"
              f"/{args.n_queries} exact")
        if include_codes:
            assert n_bad == 0, f"{n_bad} queries disagree with the host oracle"
        else:
            own = svc.query(data[src].astype(np.float32), wids)
            n_self_miss = int(np.sum((own.ids[:, 0] != src)
                                     | ~(own.dists[:, 0] < 1e-3)))
            print(f"check self-queries on device codes: "
                  f"{args.n_queries - n_self_miss}/{args.n_queries} rank 0")
            assert n_self_miss == 0, (
                f"{n_self_miss} source rows miss themselves")
    return {
        "n_groups": plan.n_groups,
        "beta_total": plan.beta_total,
        "n_steps": svc.step_cache.n_compiled,
        "t_plan": t_plan,
        "t_build": t_build,
        "t_serve": t_serve,
        "qps": args.n_queries / t_serve,
        "stats": svc.stats_summary(),
        "n_check_failures": n_bad,
        "n_self_misses": n_self_miss,
    }


def parse_args(argv=None):
    """The launcher's command line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4_096)
    ap.add_argument("--d", type=int, default=24)
    ap.add_argument("--n-weights", type=int, default=24)
    ap.add_argument("--n-subset", type=int, default=6)
    ap.add_argument("--n-subrange", type=int, default=10)
    ap.add_argument("--n-queries", type=int, default=96)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--q-batch", type=int, default=8)
    ap.add_argument("--c", type=int, default=3)
    ap.add_argument("--p", type=float, default=2.0)
    ap.add_argument("--tau", type=float, default=500.0)
    ap.add_argument("--v", type=int, default=6)
    ap.add_argument("--gamma-n", type=float, default=100.0)
    ap.add_argument("--value-range", type=float, default=10_000.0)
    ap.add_argument("--q-noise", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu (plain torch versions of the kernels)")
    ap.add_argument("--use-kernels", choices=["on", "off"], default="on",
                    help="on: fused passes (CUDA kernels on the card); "
                         "off: the unfused stage-by-stage oracle")
    ap.add_argument("--plan-out", default=None,
                    help="save the ServingPlan npz here")
    ap.add_argument("--check", action="store_true",
                    help="cross-validate every answer against search_dense")
    return ap.parse_args(argv)


def main(argv=None):
    """Entry point: ``python -m repro_torch.launch.retrieval``."""
    run(parse_args(argv))


if __name__ == "__main__":
    main()
