"""Retrieval-service launcher: plan -> build -> serve -> report.

End-to-end driver on synthetic data (paper Sec. 5.1 generators), on the
card by default:

    PYTHONPATH=src python -m repro_torch.launch.retrieval \
        --n 4096 --d 24 --n-weights 24 --n-queries 96 --k 5 --check

Steps:
  1. plan   — WLSHIndex partitions the weight set into table groups
              (Algorithm 1) and exports a serializable ServingPlan
  2. build  — RetrievalService materializes every group's state on the
              device; groups whose padded shapes coincide share one step.
              ``--max-resident-groups`` / ``--device-budget`` page the
              states through a budgeted LRU cache (host offload/restore)
              instead of keeping every group resident
  3. serve  — sync (default): the mixed (query, weight_id) stream arrives
              in one call and is routed, coalesced, padded and answered in
              submission order (Algorithm 2).
              ``--async``: the same stream is replayed open-loop — each
              request submitted alone at a Poisson arrival time
              (``--arrival-rate`` q/s of virtual traffic) into the
              deadline-aware AsyncRetrievalService, which launches a batch
              when it fills or when the oldest request has waited
              ``--max-delay-ms``.  ``--driver`` steps the replay through
              the real-time ServiceDriver (deadline-miss accounting,
              cost-aware eviction); ``--prefetch`` additionally issues
              predictive state prefetches from the pending-deadline
              schedule, so restores overlap launches.  ``--qos`` tags each
              request with a ``--tenants`` class (admission control,
              weighted-fair dequeue under ``--qos-capacity``, and the
              ``--degrade-ladder`` for degradable tenants under overload).
              Answers are bit-exact across all of these, except a
              degraded tenant's, which are served at the relaxed (c, k).
              ``--insert-rate`` turns that share of the op stream into
              streaming inserts (fresh rows past the corpus range), sealed
              every ``--delta-seal-rows`` rows and compacted into
              ``--delta-reserve-rows`` of reserved state capacity
  4. report — per-group occupancy / stop-level / n_checked stats and
              throughput (plus queue-wait percentiles, launch causes and
              the driver, QoS and state-cache reports where they apply);
              ``--check`` cross-validates every answer against the host
              oracle WLSHIndex.search_dense (with ``--insert-rate``: every
              insert's self-query, before and after a full compaction).
              ``--trace-out`` / ``--metrics-out`` / ``--profile-dir``
              switch the observability layer on (bit-exact either way):
              per-query trace spans to JSONL, the metrics registry as
              Prometheus text or JSON (with each layer span's host
              seconds and calls, ``wlsh_layer_seconds_total`` /
              ``wlsh_layer_calls_total{layer}``), and per-signature step
              and dispatch-time attribution plus a torch.profiler capture
              (a Chrome trace, the serving path's ``wlsh_*`` layer spans
              among its ranges) of the serve phase.
              ``--recall-sample-rate`` shadow-samples live queries for
              exact-oracle recall estimation; ``--health`` prints the
              per-rung observed-recall and alert report and
              ``--alerts-out`` exports the SLO burn-rate alert events
              fired on driver ticks

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
import re
import time

import numpy as np
import torch

from ..core.datagen import make_dataset, make_weight_set
from ..core.params import PlanConfig
from ..core.wlsh import WLSHIndex
from ..kernels import platform as kernel_platform
from ..obs import HealthMonitor, default_rules
from ..serving.async_service import (
    AsyncRetrievalService,
    ManualClock,
    replay_open_loop,
)
from ..serving.qos import DegradeStep, QosClass, QosScheduler
from ..serving.retrieval import RetrievalService, ServiceConfig
from ..serving.scheduler import (
    DeadlinePrefetch,
    ServiceDriver,
    replay_with_driver,
)

__all__ = ["main", "parse_args", "parse_bytes", "parse_ladder",
           "parse_tenants", "run"]

_UNITS = {"": 1, "B": 1, "KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
          "TB": 1 << 40,
          # IEC suffixes are the same binary multiples this parser always
          # meant ("512MiB" == "512MB" == 512 * 2**20)
          "KIB": 1 << 10, "MIB": 1 << 20, "GIB": 1 << 30, "TIB": 1 << 40}


def parse_bytes(text: str) -> int:
    """Parse a byte budget like ``"512MB"``, ``"2GiB"`` or a plain int.

    Suffixes are case-insensitive (``512mb``, ``2gb``) and both the
    conventional (KB/MB/GB/TB) and IEC (KiB/MiB/GiB/TiB) spellings name
    the binary multiples.  Zero or negative budgets are rejected with an
    explicit message (a budget under one byte cannot hold any state).
    """
    m = re.fullmatch(r"\s*(-?\d+(?:\.\d+)?)\s*([A-Za-z]*)\s*", text)
    if m is None:
        raise argparse.ArgumentTypeError(
            f"can't parse byte size {text!r} (use e.g. 1073741824, 512MB, "
            f"512MiB, 2gb)"
        )
    unit = m.group(2).upper()
    if unit not in _UNITS:
        raise argparse.ArgumentTypeError(
            f"unknown byte-size unit {m.group(2)!r} in {text!r} (use "
            f"B, KB/MB/GB/TB or KiB/MiB/GiB/TiB, any case)"
        )
    value = float(m.group(1))
    if value <= 0:
        raise argparse.ArgumentTypeError(
            f"byte budget must be positive, got {text!r}"
        )
    if unit == "" and "." in m.group(1):  # "1.5" meaning 1.5GB, probably
        raise argparse.ArgumentTypeError(
            f"fractional byte size {text!r} has no unit — missing a "
            f"KB/MB/GB suffix?"
        )
    nbytes = int(value * _UNITS[unit])
    if nbytes < 1:  # "0.0001KB", ...
        raise argparse.ArgumentTypeError(
            f"byte size {text!r} is under 1 byte"
        )
    return nbytes


def parse_tenants(text: str) -> list[QosClass]:
    """Parse a ``--tenants`` spec into ``QosClass``es.

    Spec: ``;``-separated tenants, each ``name:key=val,key=val,...``
    with keys ``weight``, ``rate``, ``burst``, ``slo_ms`` (floats) and
    ``degradable`` (bare flag or ``=true``/``=false``), e.g.::

        gold:weight=4,slo_ms=20;bronze:slo_ms=100,degradable
    """
    classes: list[QosClass] = []
    for part in filter(None, (s.strip() for s in text.split(";"))):
        name, _, body = part.partition(":")
        kwargs: dict = {}
        for item in filter(None, (s.strip() for s in body.split(","))):
            key, eq, val = item.partition("=")
            key = key.strip()
            if key == "degradable":
                kwargs[key] = (not eq) or val.strip().lower() in (
                    "1", "true", "yes"
                )
            elif key in ("weight", "rate", "burst", "slo_ms"):
                kwargs[key] = float(val)
            else:
                raise argparse.ArgumentTypeError(
                    f"unknown tenant key {key!r} in {part!r} (use weight, "
                    f"rate, burst, slo_ms, degradable)"
                )
        classes.append(QosClass(name.strip(), **kwargs))
    if not classes:
        raise argparse.ArgumentTypeError(f"empty --tenants spec {text!r}")
    return classes


def parse_ladder(text: str) -> tuple[DegradeStep, ...]:
    """Parse a ``--degrade-ladder`` spec into ``DegradeStep``s.

    Spec: ``,``-separated rungs, each ``c:k`` or ``c:k:cost``, strictest
    first, e.g. ``4:3:0.5,5:2:0.25``.
    """
    steps = []
    for part in filter(None, (s.strip() for s in text.split(","))):
        bits = part.split(":")
        if len(bits) not in (2, 3):
            raise argparse.ArgumentTypeError(
                f"can't parse ladder rung {part!r} (use c:k or c:k:cost)"
            )
        steps.append(DegradeStep(
            c=int(bits[0]), k=int(bits[1]),
            cost=float(bits[2]) if len(bits) == 3 else 1.0,
        ))
    if not steps:
        raise argparse.ArgumentTypeError(f"empty --degrade-ladder {text!r}")
    return tuple(steps)


def _make_qos(args, ladder) -> QosScheduler:
    """A QosScheduler over the CLI tenant classes and ladder."""
    return QosScheduler(
        classes=args.tenants,
        ladder=ladder,
        capacity_per_tick=args.qos_capacity,
    )


def _print_qos_report(qos: QosScheduler) -> None:
    """Per-tenant QoS report: admission, SLO misses, degradation."""
    s = qos.summary()
    print(f"qos: {s['n_degrade_steps']} degrade / "
          f"{s['n_restore_steps']} restore ladder steps")
    for name, t in sorted(s["tenants"].items()):
        miss = (f"{t['slo_miss_rate']:.2f}" if t["n_resolved"] else "n/a")
        print(f"  tenant {name}: {t['n_admitted']} admitted "
              f"({t['n_rate_limited']} rate-limited), slo-miss {miss}, "
              f"mean wait {1e3 * t['mean_wait_s']:.2f} ms, "
              f"{t['n_degraded']} degraded answers (rung {t['rung']})")


def _make_driver(args, asvc) -> ServiceDriver | None:
    """A ServiceDriver over ``asvc`` per the CLI flags (None = undriven).

    ``--alerts-out`` / ``--health`` attach a ``HealthMonitor`` with the
    stock SLO rule set; the driver evaluates it once per tick.
    """
    if not args.driver:
        return None
    health = None
    if args.alerts_out or args.health:
        health = HealthMonitor(asvc.batcher.metrics, default_rules())
    return ServiceDriver(
        asvc,
        prefetch=DeadlinePrefetch() if args.prefetch else None,
        health=health,
    )


def _print_driver_report(driver: ServiceDriver) -> None:
    """One-line scheduler report: ticks, launches, misses, prefetches."""
    d = driver.stats
    miss = (f"{d.deadline_miss_rate:.2f}"
            if d.n_deadlines_due else "n/a")
    print(f"driver: {d.n_ticks} ticks -> {d.n_launches} launches, "
          f"deadline-miss rate {miss} "
          f"({d.n_deadline_misses}/{d.n_deadlines_due}), "
          f"{d.n_prefetches_issued} prefetches issued, "
          f"{d.n_idle_compactions} idle compactions")
    # the registry-diff heartbeat a live deployment would log per tick
    print(driver.tick_summary())


def _print_cache_report(cache: dict) -> None:
    """State-cache report: residency, utilization, paging + prefetch work."""
    util = (f", budget {cache['budget_utilization']:.0%} used"
            if cache["device_budget_bytes"] else "")
    print(f"state cache: {cache['n_resident']}/{cache['n_groups']} "
          f"resident ({cache['resident_bytes'] / 2**20:.1f} MiB{util}), "
          f"hit rate {cache['hit_rate']:.2f}, "
          f"{cache['n_evictions']} evictions, "
          f"{cache['n_restores']} restores, "
          f"{cache['n_builds']} rebuilds, "
          f"{cache['n_prefetches']} prefetches "
          f"({cache['n_restore_overlapped']} overlapped restores, "
          f"{cache['n_prefetch_wasted']} wasted)")




def _finish_obs(args, svc) -> dict | None:
    """Stop profiling and export the observability artifacts.

    Runs after the serve phase: stops any running ``torch.profiler``
    capture (its Chrome trace lands in ``--profile-dir``), exports trace
    spans (``--trace-out``, JSONL), the metrics registry
    (``--metrics-out``: ``.json`` = JSON snapshot, anything else =
    Prometheus text exposition) and prints the per-signature step and
    dispatch attribution.  Returns the obs report dict (None with
    observability off).
    """
    if not svc.cfg.obs:
        return None
    b = svc.batcher
    out: dict = {}
    if b.profiler is not None and b.profiler.stop_trace():
        print(f"obs: profiler trace -> {b.profiler.trace_paths[-1]}")
    if b.tracer is not None:
        out["n_spans_started"] = b.tracer.n_started
        out["n_spans_finished"] = b.tracer.n_finished
        if args.trace_out:
            n = b.tracer.export_jsonl(args.trace_out)
            print(f"obs: {n} trace spans -> {args.trace_out} "
                  f"({b.tracer.n_started} started / "
                  f"{b.tracer.n_finished} finished)")
    if args.metrics_out:
        text = (b.metrics.to_json()
                if args.metrics_out.endswith(".json")
                else b.metrics.to_text())
        with open(args.metrics_out, "w") as fh:
            fh.write(text)
        print(f"obs: metrics -> {args.metrics_out}")
    if b.profiler is not None:
        prof = b.profiler.summary()
        out["profile"] = prof
        print(f"obs: {prof['n_compiles']} step compiles attributed; "
              f"dispatch by shape signature:")
        for sig, row in prof["dispatch"].items():
            print(f"  {sig}: {row['count']} launches, "
                  f"mean {1e3 * row['mean_s']:.2f} ms")
    return out


def _finish_health(args, svc, driver=None) -> dict | None:
    """Drain the shadow queue and report quality telemetry + alerts.

    Runs after the serve phase: finishes any queued shadow-exact recall
    jobs (off-path work a driver drains on idle ticks; the remainder is
    executed here), prints the ``--health`` report, exports the alert
    event log (``--alerts-out``, JSONL) and returns the health report
    dict (None when neither recall sampling nor alerting is on).
    """
    est = svc.batcher.recall
    health = driver.health if driver is not None else None
    if est is None and health is None:
        return None
    out: dict = {}
    if est is not None:
        est.drain()
        s = est.summary()
        out["recall"] = s
        if args.health:
            print(f"health: recall sample rate {s['sample_rate']:.2f} "
                  f"-> {s['n_sampled']} sampled, {s['n_executed']} "
                  f"shadow-checked, {s['n_dropped']} dropped")
            for rung in sorted(s["observed"], key=int):
                obs_r = s["observed"][rung]
                bound = s["bound"][rung]
                print(f"  rung {rung}: observed recall {obs_r:.3f} "
                      f"(bound {bound:.3f}, "
                      f"margin {obs_r - bound:+.3f})")
    if health is not None:
        hs = health.summary()
        out["alerts"] = hs
        if args.health:
            n_fired = sum(r["fired"] for r in hs["rules"].values())
            n_cleared = sum(r["cleared"] for r in hs["rules"].values())
            firing = ",".join(hs["firing"]) or "none"
            print(f"health: alerts over {hs['tick']} ticks: {n_fired} "
                  f"fired / {n_cleared} cleared; firing now: {firing}")
        if args.alerts_out:
            n = health.export_jsonl(args.alerts_out)
            print(f"obs: {n} alert events -> {args.alerts_out}")
    return out


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
    reserve = args.delta_reserve_rows
    if reserve is None:  # headroom for every op turning out to be an insert
        reserve = args.n_queries if args.insert_rate > 0 else 0
    ladder = args.degrade_ladder if args.qos else ()
    obs = bool(args.trace_out or args.metrics_out or args.profile_dir
               or args.recall_sample_rate > 0 or args.health
               or args.alerts_out)
    scfg = ServiceConfig(k=args.k, q_batch=args.q_batch,
                         max_delay_ms=args.max_delay_ms,
                         max_resident_groups=args.max_resident_groups,
                         device_budget_bytes=args.device_budget,
                         delta_seal_rows=args.delta_seal_rows,
                         delta_reserve_rows=reserve,
                         use_kernels=args.use_kernels,
                         degrade_ladder=ladder, obs=obs,
                         recall_sample_rate=args.recall_sample_rate,
                         n_shards=args.shards, device=str(device))
    svc = RetrievalService(plan, data, cfg=scfg)
    if obs and args.profile_dir:
        svc.batcher.profiler.profile_dir = args.profile_dir
        svc.batcher.profiler.start_trace()
    svc.warmup()
    _sync(device)
    t_build = time.time() - t0
    cache0 = svc.cache_summary()
    print(f"build: {plan.n_groups} group states "
          f"({cache0['n_resident']} resident, "
          f"{cache0['resident_bytes'] / 2**20:.1f} MiB on {device}), "
          f"{svc.step_cache.n_compiled} query steps "
          f"(shape sharing {plan.n_groups}/{svc.step_cache.n_compiled}) "
          f"in {t_build:.1f}s")
    if args.shards > 1:
        n_loc = svc.batcher.row_capacity() // args.shards
        print(f"sharding: {args.shards} shards over devices "
              f"{[str(d) for d in svc.devices]} ({n_loc} rows/shard, "
              f"exactly merged top-k)")
    print(f"kernels: {kernel_platform.describe(scfg.use_kernels, device)} "
          f"(--use-kernels {args.use_kernels})")
    svc.reset_stats()  # serve-phase cache counters exclude warmup churn

    # ---- serve --------------------------------------------------------------
    wids = rng.integers(0, args.n_weights, size=args.n_queries)
    src = rng.choice(args.n, args.n_queries, replace=False)
    qpts = data[src].astype(np.float32)
    qpts = qpts + rng.normal(0, args.q_noise, qpts.shape).astype(np.float32)
    async_report = None
    driver = None
    if args.insert_rate > 0:
        return _serve_mixed(args, svc, plan, rng, qpts, wids, device,
                            t_plan=t_plan, t_build=t_build)
    if args.use_async:
        arrivals = np.cumsum(
            rng.exponential(1.0 / args.arrival_rate, args.n_queries)
        )
        qos = _make_qos(args, ladder) if args.qos else None
        tenants = None
        if qos is not None:
            names = [c.name for c in args.tenants]
            tenants = [str(t) for t in rng.choice(names, args.n_queries)]
        asvc = AsyncRetrievalService(svc, clock=ManualClock(), qos=qos)
        driver = _make_driver(args, asvc)
        t0 = time.time()
        if driver is not None:
            res, waits = replay_with_driver(driver, qpts, wids, arrivals,
                                            tenants=tenants)
        else:
            res, waits = replay_open_loop(asvc, qpts, wids, arrivals,
                                          tenants=tenants)
        _sync(device)
        t_serve = time.time() - t0
        wait_ms = 1e3 * waits if len(waits) else np.array([np.nan])
        async_report = {
            "arrival_rate": args.arrival_rate,
            "max_delay_ms": args.max_delay_ms,
            "mean_wait_ms": float(wait_ms.mean()),
            "p95_wait_ms": float(np.percentile(wait_ms, 95)),
            "n_launched_full": asvc.n_launched_full,
            "n_launched_deadline": asvc.n_launched_deadline,
            "driver": driver.stats.summary() if driver is not None else None,
            "qos": qos.summary() if qos is not None else None,
        }
        print(f"serve[async]: {args.n_queries} queries at "
              f"{args.arrival_rate:.0f} q/s open-loop, deadline "
              f"{args.max_delay_ms} ms -> {len(np.unique(res.group_ids))} "
              f"active groups, {asvc.n_launched_full} full / "
              f"{asvc.n_launched_deadline} deadline launches, wait "
              f"mean {wait_ms.mean():.2f} ms / p95 "
              f"{np.percentile(wait_ms, 95):.2f} ms "
              f"({args.n_queries / t_serve:.1f} q/s compute)")
        if driver is not None:
            _print_driver_report(driver)
        if qos is not None:
            _print_qos_report(qos)
    else:
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
    cache = svc.cache_summary()
    if (args.max_resident_groups is not None
            or args.device_budget is not None or args.driver):
        _print_cache_report(cache)
    obs_report = _finish_obs(args, svc)
    health_report = _finish_health(args, svc, driver)

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
        "cache": cache,
        "n_check_failures": n_bad,
        "async": async_report,
        "obs": obs_report,
        "health": health_report,
        "n_self_misses": n_self_miss,
    }


def _serve_mixed(args, svc, plan, rng, qpts, wids, device, t_plan, t_build):
    """Mixed read/write replay: a share of the op stream is inserts.

    Each op is an insert with probability ``--insert-rate``; inserted
    vectors are fresh (offset past the corpus range) so recall on them is
    checkable.  Sync mode serves op by op; ``--async`` replays the same
    schedule open-loop at ``--arrival-rate`` with writes applied at their
    arrival instants.  ``--check`` verifies pre-compaction recall (every
    insert answers its own self-query through the exact delta scan),
    then compacts and verifies that the kernels' path over the appended
    rows returns the same ids, with the query-step count unchanged
    across the run.
    """
    n_ops = args.n_queries
    is_insert = rng.random(n_ops) < args.insert_rate
    ins_vecs = qpts + (
        args.value_range + 7.0 * np.arange(n_ops)[:, None]
    ).astype(np.float32)
    inserted = []  # (pid, vector, weight_id)
    n_steps0 = svc.step_cache.n_compiled
    driver = None
    t0 = time.time()
    if args.use_async:
        asvc = AsyncRetrievalService(svc, clock=ManualClock())
        driver = _make_driver(args, asvc)
        tick = asvc.poll if driver is None else driver.step
        arrivals = np.cumsum(
            rng.exponential(1.0 / args.arrival_rate, n_ops)
        )
        for i in range(n_ops):
            while True:  # fire deadlines expiring before this arrival
                nd = asvc.next_deadline()
                if nd is None or nd > arrivals[i]:
                    break
                asvc.clock.advance_to(nd)
                tick()
            asvc.clock.advance_to(arrivals[i])
            if driver is not None:
                # arrival tick: gives prefetch its lead time (never
                # launches: due deadlines were fired above), exactly
                # like replay_with_driver
                driver.step()
            if is_insert[i]:
                pid = asvc.insert(ins_vecs[i], int(wids[i]))
                inserted.append((pid, ins_vecs[i], int(wids[i])))
            else:
                asvc.submit(qpts[i], wids[i])
        while asvc.pending_count:
            asvc.clock.advance_to(asvc.next_deadline())
            tick()
        if driver is not None:
            _print_driver_report(driver)
    else:
        for i in range(n_ops):
            if is_insert[i]:
                pid = svc.insert(ins_vecs[i], int(wids[i]))
                inserted.append((pid, ins_vecs[i], int(wids[i])))
            else:
                svc.query(qpts[i : i + 1], wids[i : i + 1])
    _sync(device)
    t_serve = time.time() - t0
    n_writes = len(inserted)
    # a low rate can sample zero inserts: no write ever happened, so the
    # delta index was never created and the summary is empty
    delta = svc.delta_summary() or dict(
        n_seals=0, n_compactions=0, n_pending=0
    )
    print(f"serve[mixed{'/async' if args.use_async else ''}]: "
          f"{n_ops - n_writes} queries + {n_writes} inserts "
          f"(write mix {args.insert_rate:.0%}) in {t_serve:.2f}s "
          f"({n_ops / t_serve:.1f} ops/s); delta: {delta['n_seals']} seals, "
          f"{delta['n_compactions']} compactions, {delta['n_pending']} "
          f"rows pending")

    n_bad = 0
    if args.check and inserted:
        for pid, v, w in inserted:  # pre-compaction: exact delta scan
            n_bad += pid not in svc.query(v[None], [w]).ids[0]
        absorbed = svc.compact()
        for pid, v, w in inserted:  # post-compaction: the kernels' path
            n_bad += pid not in svc.query(v[None], [w]).ids[0]
        new_steps = svc.step_cache.n_compiled - n_steps0
        n_bad += new_steps  # streaming must never need a new query step
        print(f"check[streaming]: {2 * len(inserted) - n_bad}"
              f"/{2 * len(inserted)} insert self-queries exact "
              f"(pre + post compaction of {absorbed} rows), "
              f"{new_steps} new query steps")
        assert n_bad == 0, f"{n_bad} streaming checks failed"
    obs_report = _finish_obs(args, svc)
    health_report = _finish_health(args, svc, driver)
    return {
        "n_groups": plan.n_groups,
        "beta_total": plan.beta_total,
        "n_steps": svc.step_cache.n_compiled,
        "t_plan": t_plan,
        "t_build": t_build,
        "t_serve": t_serve,
        "qps": n_ops / t_serve,
        "n_inserts": n_writes,
        "stats": svc.stats_summary(),
        "cache": svc.cache_summary(),
        "delta": svc.delta_summary(),
        "n_check_failures": n_bad,
        "async": None,
        "driver": driver.stats.summary() if driver is not None else None,
        "obs": obs_report,
        "health": health_report,
        "n_self_misses": None,
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
    ap.add_argument("--shards", type=int, default=1,
                    help="shard every group state's rows across this many "
                         "devices (cuda:0 .. cuda:N-1, or N CPU devices "
                         "with --device cpu): per-shard passes, exact "
                         "merges, answers bit-identical at any shard count")
    ap.add_argument("--use-kernels", choices=["on", "off"], default="on",
                    help="on: fused passes (CUDA kernels on the card); "
                         "off: the unfused stage-by-stage oracle")
    ap.add_argument("--plan-out", default=None,
                    help="save the ServingPlan npz here")
    ap.add_argument("--check", action="store_true",
                    help="cross-validate every answer against search_dense")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the deadline-aware async frontend: "
                         "requests are replayed open-loop at --arrival-rate "
                         "and a batch launches when it fills or its oldest "
                         "request has waited --max-delay-ms")
    ap.add_argument("--driver", action="store_true",
                    help="step the --async replay through the real-time "
                         "ServiceDriver (deadline-miss accounting, "
                         "cost-aware eviction)")
    ap.add_argument("--prefetch", action="store_true",
                    help="with --driver: predictively prefetch group "
                         "states from the pending-deadline schedule so "
                         "restores overlap launches")
    ap.add_argument("--qos", action="store_true",
                    help="multi-tenant QoS for the --async replay: each "
                         "request is tagged with a --tenants class, "
                         "admission-controlled, dequeued weighted-fair, "
                         "and degradable tenants step down the "
                         "--degrade-ladder under sustained overload")
    ap.add_argument("--tenants", type=parse_tenants,
                    default="gold:weight=4,slo_ms=20;"
                            "bronze:slo_ms=100,degradable",
                    help="tenant classes for --qos: ';'-separated "
                         "name:key=val,... specs (keys: weight, rate, "
                         "burst, slo_ms, degradable)")
    ap.add_argument("--degrade-ladder", type=parse_ladder,
                    default="4:3:0.5",
                    help="with --qos: pre-planned (c, k) relaxation "
                         "rungs, strictest first, as c:k[:cost] entries "
                         "joined by ','")
    ap.add_argument("--qos-capacity", type=float, default=1.0,
                    help="with --qos: launch-cost budget per scheduler "
                         "tick for the weighted-fair dequeue")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="async deadline budget: a partial batch launches "
                         "once its oldest request has waited this long")
    ap.add_argument("--arrival-rate", type=float, default=2_000.0,
                    help="open-loop Poisson arrival rate (queries/s of "
                         "virtual traffic) for --async replay")
    ap.add_argument("--insert-rate", type=float, default=0.0,
                    help="mixed read/write replay: share of the op stream "
                         "that are streaming inserts (0..1); with --check, "
                         "verifies insert recall before and after "
                         "compaction")
    ap.add_argument("--delta-seal-rows", type=int, default=32,
                    help="streaming: seal a group's open delta memtable "
                         "into a hashed segment at this row count")
    ap.add_argument("--delta-reserve-rows", type=int, default=None,
                    help="row capacity reserved per group state for "
                         "compacted inserts (default: --n-queries when "
                         "--insert-rate > 0, else 0)")
    ap.add_argument("--max-resident-groups", type=int, default=None,
                    help="page group states: keep at most this many device-"
                         "resident (LRU eviction + host offload/restore)")
    ap.add_argument("--device-budget", type=parse_bytes, default=None,
                    metavar="BYTES",
                    help="page group states under this device byte budget "
                         "(accepts 512MB / 2GB / plain bytes)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="observability: export one JSONL trace span per "
                         "served query to PATH (stage timestamps on the "
                         "service clock + WLSH cost counters); implies "
                         "the obs layer on")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="observability: write the unified metrics "
                         "registry to PATH after serving (.json = JSON "
                         "snapshot, anything else = Prometheus text "
                         "exposition), with the host seconds and calls "
                         "of each layer span (wlsh_layer_seconds_total, "
                         "wlsh_layer_calls_total{layer}); implies the obs "
                         "layer on")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="observability: per-shape-signature step and "
                         "dispatch-time attribution, plus a torch.profiler "
                         "capture of warmup and serve exported to DIR as "
                         "a Chrome trace, whose ranges name the serving "
                         "path's layers (obs.trace.LAYER_SPANS: "
                         "wlsh_query, wlsh_batch, wlsh_lease, wlsh_encode, "
                         "wlsh_upload, wlsh_step, wlsh_download, ...); "
                         "implies the obs layer on")
    ap.add_argument("--recall-sample-rate", type=float, default=0.0,
                    metavar="RATE",
                    help="quality telemetry: shadow-sample this fraction "
                         "of live queries (deterministic hash of the "
                         "query id) and re-rank their served answers "
                         "against the exact host oracle off the serving "
                         "path; answers stay bit-exact; implies the obs "
                         "layer on")
    ap.add_argument("--alerts-out", default=None, metavar="PATH",
                    help="with --driver: attach the stock SLO burn-rate "
                         "alert rules (deadline misses, tenant SLO, "
                         "prefetch waste, recall-below-bound) to the "
                         "driver ticks and export the alert events to "
                         "PATH as JSONL")
    ap.add_argument("--health", action="store_true",
                    help="print the quality-telemetry report after "
                         "serving: per-rung observed recall vs its "
                         "ladder bound, shadow-queue accounting, and "
                         "(with --driver) the alert-rule summary")
    args = ap.parse_args(argv)
    if not 0.0 <= args.insert_rate <= 1.0:
        ap.error(f"--insert-rate must be in [0, 1], got {args.insert_rate}")
    if not 0.0 <= args.recall_sample_rate <= 1.0:
        ap.error(f"--recall-sample-rate must be in [0, 1], got "
                 f"{args.recall_sample_rate}")
    if args.alerts_out and not args.driver:
        ap.error("--alerts-out needs the tick-driven alert evaluation; "
                 "add --driver (and --async)")
    if args.driver and not args.use_async:
        ap.error("--driver drives the async frontend; add --async")
    if args.prefetch and not args.driver:
        ap.error("--prefetch is a ServiceDriver feature; add --driver")
    if args.qos and not args.use_async:
        ap.error("--qos shapes the async frontend's traffic; add --async")
    if args.qos and args.insert_rate > 0:
        ap.error("--qos is not wired into the mixed read/write replay; "
                 "drop --insert-rate")
    if args.qos and args.check:
        ap.error("--check validates strict answers; a degraded QoS tenant "
                 "may legitimately differ — drop one of the two")
    return args


def main(argv=None):
    """Entry point: ``python -m repro_torch.launch.retrieval``."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
