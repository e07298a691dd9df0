"""One run of one cell: set-up, the timed window, the check, the metrics.

The system under test is the PyTorch and CUDA port (``repro_torch``),
driven through its public serving path:

1. set-up: the corpus, the weight set and the request pool from the
   seed (``inputs``, ``traffic``); the plan through
   ``WLSHIndex(...).export_serving_plan()``; a ``RetrievalService`` with
   every group state built and one request per group served, so that
   every step, kernel and paging buffer the window uses exists;
2. the window: one client sends the pool's requests in turn through
   ``RetrievalService.query`` (routing, coalescing, ``Batcher.run_batch``
   with its lease, paging and upload, both fused passes, top-k, re-rank,
   download, merge) until ``seconds`` have passed; each request's
   latency is the host clock from its issue to its answers on the host;
3. the check: a sample of the window's answers, drawn from the seed,
   against the plain reference (``reference``), run after the program's
   state is freed and the peak memory read.

With ``trace`` the window runs under ``torch.profiler``, and the
harness opens a range around each call it makes into a layer of the
program, so that ``devtrace.TraceView`` can say what the host was doing
while the device idled.  This module imports the program only inside
functions, and only from ``src/`` of the checkout it runs in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from . import check as check_mod
from . import inputs, spec
from . import traffic as traffic_mod
from .reference import planner as ref_planner
from .reference import search as ref_search
from .devtrace import WINDOW, TraceView

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SERVICE_KEYS = {"max_resident_groups", "device_budget_bytes",
                "offload_evicted"}


def prepare_environment(root: Path = spec.ROOT) -> None:
    """Fix the build caches inside the checkout and put its ``src/`` on
    the path.  The port builds its kernels into ``build/`` of the
    checkout by itself; PyTorch's and Triton's caches go beside it."""
    cache = root / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Record:
    """One request of the window."""

    index: int  # position in the pool
    t_issue: float  # seconds after the window opened
    latency_s: float  # issue to answers on the host
    restored: bool  # a state was restored to serve it
    ok: bool
    result: object = None  # RetrievalResult


@dataclasses.dataclass
class Prepared:
    """The inputs and plan of one seed: shared by every service built on
    them (the control reads several services off one plan)."""

    seed: int
    data: np.ndarray
    weights: np.ndarray
    pool: traffic_mod.Pool
    plan: object
    plan_s: float


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: spec.Cell
    seed: int
    setup_s: float
    plan_s: float
    build_s: float
    window_s: float
    records: list
    queries_answered: int
    memory_peak_bytes: int
    counters: dict
    launches: list  # each launch's shape and level tests (cost.step_least_s)
    trace: TraceView | None = None


def plan_keywords(config: dict, index_cls) -> dict:
    """``WLSHIndex``'s keywords beyond the plan's parameters:
    ``{"code_bits": n}`` where the configuration states the width of its
    bucket ids, ``{}`` where it does not (the program keeps its own, 32).
    Raises ValueError where ``index_cls`` takes no ``code_bits``."""
    if "code_bits" not in config:
        return {}
    if "code_bits" not in inspect.signature(index_cls).parameters:
        raise ValueError(
            f"configuration {config.get('name')!r} states code_bits "
            f"{config['code_bits']!r}, and the program's "
            "repro_torch.core.wlsh.WLSHIndex takes no code_bits keyword")
    return {"code_bits": spec.code_bits(config)}


def prepare(cell: spec.Cell, seed: int, device) -> Prepared:
    """Inputs from ``seed`` and the plan the program derives from them.

    A width of bucket ids that the configuration states reaches the
    program as ``WLSHIndex(code_bits=...)``; a program that cannot take
    it is refused here, before any input is made."""
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex

    cfg = cell.config
    width = plan_keywords(cfg, WLSHIndex)
    data = inputs.corpus(cfg["n"], cfg["d"], cfg["value_range"], seed, device)
    weights = inputs.weight_set(cfg["n_weights"], cfg["d"], cfg["n_subset"],
                                cfg["n_subrange"], cfg["weight_seed"])
    pool = traffic_mod.requests(cell.traffic, data, len(weights), seed)
    t0 = time.perf_counter()
    index = WLSHIndex(
        data, weights,
        PlanConfig(p=cfg["p"], c=cfg["c"], eps=cfg["eps"],
                   gamma_n=cfg["gamma_n"], n=cfg["n"]),
        tau=cfg["tau"], value_range=cfg["value_range"], v=cfg["v"],
        v_prime=cfg["v_prime"], seed=inputs.base_seed(seed), **width)
    plan = index.export_serving_plan()
    del index
    return Prepared(seed=seed, data=data, weights=weights, pool=pool,
                    plan=plan, plan_s=time.perf_counter() - t0)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def service_knobs(config: dict) -> dict:
    """The configuration's ``service`` knobs (the deployment's residency
    budget and host offload), passed to ``ServiceConfig`` as they are;
    raises ValueError on a knob the harness does not know."""
    knobs = dict(config.get("service", {}))
    extra = set(knobs) - SERVICE_KEYS
    if extra:
        raise ValueError(f"service keys not understood: {sorted(extra)}")
    return knobs


def build_service(cell: spec.Cell, prep: Prepared, device, **overrides):
    """(service, seconds): every group state built, then one request of
    the pool per group served, on ``device``."""
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cfg = cell.config
    kw = dict(k=cfg["k"], q_batch=cfg["q_batch"], vec_dtype=cfg["vec_dtype"],
              device=str(device))
    kw.update(service_knobs(cfg))
    kw.update(overrides)
    t0 = time.perf_counter()
    svc = RetrievalService(prep.plan, prep.data, cfg=ServiceConfig(**kw))
    svc.warmup()
    groups = prep.plan.group_of[prep.pool.weight_ids]  # (P, R)
    for gi in range(prep.plan.n_groups):
        j = int(np.argmax((groups == gi).any(axis=1)))
        svc.query(prep.pool.queries[j], prep.pool.weight_ids[j])
    _sync(device)
    svc.reset_stats()
    return svc, time.perf_counter() - t0


@contextlib.contextmanager
def _layer_ranges(svc):
    """Host ranges around the harness's calls into each layer of the
    program: routing, the lease (paging), the query encode and the
    engine's step.  The ranges only name idle gaps, so an attribute the
    program no longer has is left without one.  Removed on exit."""
    from torch.profiler import record_function

    b = svc.batcher
    patched = []

    def wrap(obj, attr, make):
        orig = getattr(obj, attr, None)
        if callable(orig):
            own = attr in getattr(obj, "__dict__", {})
            setattr(obj, attr, make(orig))
            patched.append((obj, attr, orig if own else None))

    def ranged(name):
        def make(fn):
            def call(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return call
        return make

    def leased(fn):
        @contextlib.contextmanager
        def lease(*a, **kw):
            with record_function("perfbench.lease"), fn(*a, **kw) as state:
                yield state
        return lease

    wrap(b, "route", ranged("perfbench.route"))
    wrap(b, "_encode", ranged("perfbench.encode"))
    wrap(b, "lease", leased)
    cache = getattr(b, "step_cache", None)
    wrap(cache, "get", lambda get: lambda *a, **kw: ranged(
        "perfbench.query_step")(get(*a, **kw)))
    try:
        yield
    finally:
        for obj, attr, own in reversed(patched):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)


def serve(svc, pool, seconds: float, device):
    """(records, window seconds): one closed-loop client for ``seconds``.

    The window opens at the first issue and closes when the last request
    has been answered and the device synchronized.
    """
    cache = svc.state_cache.stats
    paged = (svc.cfg.max_resident_groups is not None
             or svc.cfg.device_budget_bytes is not None)
    records, i, failed_in_row = [], 0, 0
    _sync(device)
    t0 = time.perf_counter()
    while not records or time.perf_counter() - t0 < seconds:
        j = i % len(pool)
        r0 = cache.n_restores if paged else 0
        t_a = time.perf_counter()
        try:
            res, ok = svc.query(pool.queries[j], pool.weight_ids[j]), True
        except Exception:  # a failed request is counted, and the run goes on
            traceback.print_exc(file=sys.stderr)
            res, ok = None, False
        t_b = time.perf_counter()
        restored = paged and cache.n_restores > r0
        records.append(Record(j, t_a - t0, t_b - t_a, restored, ok, res))
        i += 1
        failed_in_row = 0 if ok else failed_in_row + 1
        if failed_in_row >= 10:
            break
    _sync(device)
    return records, time.perf_counter() - t0


def traced_serve(svc, pool, seconds: float, device, workdir: str):
    """``serve`` under ``torch.profiler``: (records, window s, TraceView)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with _layer_ranges(svc), profile(activities=acts) as prof:
        with record_function(WINDOW):
            records, window_s = serve(svc, pool, seconds, device)
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    view = TraceView.from_file(path)
    os.remove(path)
    return records, window_s, view


def launches(svc, prep: Prepared, records, config: dict) -> list:
    """Each step launch of the answered requests: the group state's
    shapes, the bytes of a bucket id the configuration's deployment
    stores, and the level tests its real queries need."""
    plan = prep.plan
    code_bytes = spec.code_bits(config) // 8
    shapes = {}
    out = []
    for rec in records:
        if not rec.ok:
            continue
        wids = prep.pool.weight_ids[rec.index]
        gids = plan.group_of[wids]
        for gi in np.unique(gids):
            gi = int(gi)
            if gi not in shapes:
                c = svc.group_config(gi)
                shapes[gi] = dict(n=c.n, beta=c.beta, d=c.d, q=c.q_batch,
                                  k=c.k, n_levels=c.n_levels, p=c.p,
                                  vec_bytes=2 if c.vec_dtype == "bfloat16"
                                  else 4, code_bytes=code_bytes)
            g = plan.groups[gi]
            sel = wids[gids == gi]
            betas = g.beta_members[plan.member_slot[sel]].astype(np.int64)
            q = shapes[gi]["q"]
            for lo in range(0, len(sel), q):
                out.append(dict(shapes[gi], tests=int(
                    betas[lo:lo + q].sum()) * shapes[gi]["n"]))
    return out


def sample(records, count: int, seed: int) -> list:
    """Up to ``count`` answered requests drawn from the seed; where some
    were served from a restored state, half of the sample is drawn from
    those."""
    rng = np.random.default_rng([inputs.base_seed(seed), 2])
    ok = [r for r in records if r.ok]
    restored = [r for r in ok if r.restored]
    if not restored:
        parts = [(ok, count)]
    else:
        others = [r for r in ok if not r.restored]
        half = min(len(restored), max(1, count // 2))
        parts = [(restored, half), (others, count - half)]
    chosen = []
    for recs, want in parts:
        idx = rng.permutation(len(recs))[:want]
        chosen += [recs[i] for i in sorted(idx)]
    return sorted(chosen, key=lambda r: r.t_issue)


def answers_of(records, pool) -> tuple[np.ndarray, np.ndarray, dict]:
    """(queries, weight ids, answers) of ``records``, one row a query."""
    res = [r.result for r in records]
    got = dict(group=np.concatenate([x.group_ids for x in res]),
               stop=np.concatenate([x.stop_levels for x in res]),
               n_checked=np.concatenate([x.n_checked for x in res]),
               ids=np.concatenate([x.ids for x in res]),
               dists=np.concatenate([x.dists for x in res]))
    queries = np.concatenate([pool.queries[r.index] for r in records])
    wids = np.concatenate([pool.weight_ids[r.index] for r in records])
    return queries, wids, got


def reference_check(cell: spec.Cell, prep: Prepared, queries, wids, got,
                    device) -> tuple[dict, dict]:
    """(numbers, detail) of the program's answers ``got`` against the
    plain reference, run on ``device`` with bucket ids at the width the
    configuration states.  ``detail["codes_wrapped_pct"]`` is the share
    of the checked groups' corpus ids outside int32: a reading, with no
    limit."""
    import torch

    cfg = cell.config
    t0 = time.perf_counter()
    ref, fams = ref_planner.plan(prep.weights, cfg, cfg["n"],
                                 inputs.base_seed(prep.seed))
    points = torch.as_tensor(prep.data, device=device)
    ans = ref_search.answer(ref, fams, points, queries, wids, cfg["k"],
                            spec.code_bits(cfg))
    exact = ref_search.distances_of(points, queries, prep.weights[wids],
                                    got["ids"], ref.p)
    del points
    numbers, detail = check_mod.compare(got, ans, exact)
    detail["codes_wrapped_pct"] = (100.0 * ans.ids_outside_int32
                                   / max(ans.ids_counted, 1))
    detail["reference_s"] = time.perf_counter() - t0
    return numbers, detail


def free(svc) -> None:
    """Drop the service's device state and return its memory."""
    import torch

    svc.state_cache.clear()
    del svc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, prep: Prepared | None = None,
             **overrides) -> dict:
    """One run: the result line's fields and the check's table.

    ``t_start`` is the host clock when the run's process began: set-up
    counts from there to the window's opening.  ``prep``, where given, is
    the seed's inputs and plan made once for several runs (the control's
    readings); ``overrides`` go to the service's config (the control
    switches a lower precision on here).
    """
    import torch

    if prep is None:
        prep = prepare(cell, seed, device)
    svc, build_s = build_service(cell, prep, device, **overrides)
    setup_s = time.perf_counter() - t_start
    view = None
    if trace:
        with tempfile.TemporaryDirectory() as tmp:
            records, window_s, view = traced_serve(svc, prep.pool, seconds,
                                                   device, tmp)
    else:
        records, window_s = serve(svc, prep.pool, seconds, device)
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    counters = svc.cache_summary()
    run = Run(cell=cell, seed=seed, setup_s=setup_s, plan_s=prep.plan_s,
              build_s=build_s, window_s=window_s, records=records,
              queries_answered=sum(len(r.result.ids) for r in records
                                   if r.ok),
              memory_peak_bytes=peak, counters=counters,
              launches=launches(svc, prep, records, cell.config),
              trace=view)
    free(svc)
    checked = sample(records, int(cell.traffic["check_requests"]), seed)
    failed = sum(not r.ok for r in records)
    if checked:
        queries, wids, got = answers_of(checked, prep.pool)
        numbers, detail = reference_check(cell, prep, queries, wids, got,
                                          device)
    else:
        numbers, detail = {}, {"checked": 0}
    detail["restored_requests_checked"] = sum(r.restored for r in checked)
    correct, table = check_mod.verdict(numbers, cell.limits)
    return dict(run=run, correct=bool(correct and failed == 0),
                attempted=len(records), failed=failed, check=table,
                detail=detail)


def metrics(run: Run, entries: list) -> dict:
    """{name: {"value", "unit"}} of the ``entries`` whose reader finds
    something to read in ``run``."""
    out = {}
    for m in entries:
        value = spec.reader(m["name"])(run)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m['name']} read {value}")
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
