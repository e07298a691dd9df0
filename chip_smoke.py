#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py            # every phase, one card

Phases, one line each (more for the slice), any failure exits non-zero:

  1. device  — nvidia-smi's name and power limit, torch and CUDA versions
  2. build   — compile kernels/csrc/fused_query.cu with nvcc for sm_90a
  3. kernels — both fused-query kernels against their plain torch versions
               on the card, for p in {2, 1, 0.5}, at Q=64, d=400,
               beta=512 (beta_q ~ 450), L=16 and ~65k rows with a ragged
               tail and n_valid below the row count
  4. slice   — the synchronous query path at the paper's default data
               scale (n=400,000, d=400, |S|=24, p=2, tau=500, c=3,
               v=v'=6): plan, build every group state, serve 256 queries,
               check 8 against the host oracle search_dense and recall@10
               against exact brute force
  5. times   — each kernel on the main path's inputs for the widest group:
               held to its plain version there (the rules of phase 3),
               its time, its plain version's time, and the bound from
               bytes and operations

The line before the last is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script fails before
printing any result.  ``--phases`` runs a subset (e.g. ``device,build,
kernels``) for a short check; the full run needs all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "build", "kernels", "slice", "times")

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 rate,
# float32 outside the tensor cores, and int32 at 64 lanes per SM x 132 SMs
# x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9

# the slice configuration (paper Sec. 5.1 defaults, |S| cut to 24) and the
# kernel-check row count
SLICE = dict(n=400_000, d=400, n_weights=24, n_subset=6, n_subrange=20,
             p=2.0, tau=500.0, c=3, v=6, k=10, q_batch=64, n_queries=256,
             n_check=8, reps=3)
CHECK_ROWS = 65_536 - 53  # ragged against the kernel's 128-row blocks

KERNELS = {
    "fused_query_hist": "src/repro/kernels/fused_query.py:184",
    "fused_query_scores": "src/repro/kernels/fused_query.py:248",
}
SOURCE = "src/repro_torch/kernels/csrc/fused_query.cu"


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers


def _kernel_inputs(p: float, n_rows: int, seed: int, torch, dev):
    """Seeded pass inputs at the kernel-check shapes, as tensors on dev."""
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.distances import radius_bounds
    from repro_torch.core.families import hash_codes_np, sample_lp_family

    rng = np.random.default_rng(seed)
    q, d, beta, L, c = 64, SLICE["d"], 512, 16, 3
    data = make_dataset(n_rows, d, seed=seed)
    weights = make_weight_set(8, d, n_subset=2, n_subrange=20, seed=seed + 1)
    # p < 1 families are so heavy-tailed that codes overflow int32 at this
    # width; their level structure is what the check needs, so p = 0.5
    # distances are checked over a Cauchy (p = 1) family's codes
    p_fam = max(p, 1.0)
    r_min, r_max = radius_bounds(weights[0], 10_000.0, p_fam)
    fam = sample_lp_family(d, beta, p_fam, r_min, weights[0], r_max / r_min,
                           c, seed=seed + 2)
    # half the queries sit near a data row (early agreement), half anywhere
    near = data[rng.choice(n_rows, q // 2, replace=False)]
    near = near + rng.normal(0, 3.0, near.shape)
    far = rng.uniform(0, 10_000, (q - q // 2, d))
    queries = np.concatenate([near, far]).astype(np.float32)
    wq = weights[rng.integers(0, len(weights), q)].astype(np.float32)
    beta_q = rng.integers(440, 461, q).astype(np.int32)
    mu = np.array([rng.integers(b // 5, 3 * b // 5) for b in beta_q],
                  np.int32)
    rmin_q = wq.min(axis=1).astype(np.float32)
    stop = rng.integers(0, L + 1, q).astype(np.int32)

    def put(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

    return dict(
        codes_p=put(hash_codes_np(data, fam), np.int32),
        points=put(data, np.float32),
        codes_q=put(hash_codes_np(queries, fam), np.int32),
        queries=put(queries, np.float32),
        q_weight=put(wq, np.float32),
        mu=put(mu, np.int32),
        beta_q=put(beta_q, np.int32),
        r_min=put(rmin_q, np.float32),
        stop=put(stop, np.int32),
        c=c, n_levels=L,
    )


def _pass_args(inp, which):
    base = [inp[k] for k in ("codes_p", "points", "codes_q", "queries",
                             "q_weight", "mu", "beta_q")]
    return base + [inp["r_min" if which == "hist" else "stop"]]


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, torch, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------- phases


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


def phase_build():
    from repro_torch.kernels import fused_query

    path = fused_query.build(verbose=True)
    info = fused_query.build_info
    regs = [ln.strip() for ln in info.get("ptxas", "").splitlines()
            if "registers" in ln]
    say(f"build: nvcc {' '.join(fused_query.NVCC_FLAGS)} -> "
        f"{os.path.relpath(path, ROOT)} in {info['seconds']:.1f}s; "
        f"ptxas: {' | '.join(regs)}")


def _hold(torch, inp, p, kernel_out, plain_out, label):
    """Hold both kernels' outputs to their plain versions' on one input.

    ``kernel_out`` and ``plain_out`` are ``(hist_f, hist_g, scores)``.
    hist_f and the +inf mask must be equal; hist_g may move at most 1e-4
    of the (query, row) cells (a good level on a float boundary); finite
    scores must agree to rtol 1e-5, or for p = 2 to atol
    1e-6*sqrt(qw2+onorm).  Returns the max abs error of each kernel.
    """
    hf, hg, sc = kernel_out
    rf, rg, rs = plain_out
    n_rows = inp["points"].shape[0]
    if not torch.equal(hf, rf):
        raise AssertionError(f"{label}: hist_f differs from the plain "
                             f"version")
    moved = int((hg - rg).abs().sum().item()) // 2
    limit = 1e-4 * n_rows * inp["queries"].shape[0]
    if moved > limit:
        raise AssertionError(f"{label}: {moved} rows changed good level")
    inf_k, inf_r = torch.isinf(sc), torch.isinf(rs)
    if not torch.equal(inf_k, inf_r):
        raise AssertionError(f"{label}: +inf mask differs "
                             f"({int((inf_k != inf_r).sum())} cells)")
    fin = ~inf_k
    diff = (sc - rs).abs()[fin].double()
    note = ""
    held = torch.ones_like(diff, dtype=torch.bool)  # cells under the rule
    if abs(p - 2.0) < 1e-9:
        w2 = inp["q_weight"].double() ** 2
        x = inp["points"].double()
        qd = inp["queries"].double()
        s2 = (w2 * qd * qd).sum(1)[:, None] + w2 @ (x * x).T
        del x
        exact = (s2 - 2.0 * (w2 * qd) @ inp["points"].double().T)
        exact = exact.clamp_min(0).sqrt()[fin]
        scale = s2.sqrt()[fin]
        del s2
        rule = "atol 1e-6*sqrt(qw2+onorm)"
        zone = exact < 1e-3 * scale  # expansion lost >= 6 digits
        bad_cells = diff > 1e-6 * scale
        kd = sc[fin].double()
        ek = ((kd - exact).abs() / scale)[~zone]
        ep = ((rs[fin].double() - exact).abs() / scale)[~zone]
        # In the zone the float32 expansion has lost its digits in both
        # versions, and no two float32 sums meet the atol there.  The
        # kernel's squared distance is held to float64 within 1e-6*(qw2+
        # onorm), ~17 float32 ulps of the expansion's terms: a value far
        # from the true one fails, one the expansion cannot tell from 0
        # passes, so ranking there rests on the exact re-rank.
        bad_zone = (kd * kd - exact * exact).abs() > 1e-6 * scale * scale
        ez = ((kd * kd - exact * exact).abs() / (scale * scale))[zone]
        note = (f"; {int(zone.sum())} cells in the cancellation zone "
                f"(dist < 1e-3*sqrt(qw2+onorm)) held to |k^2-d64^2| <= "
                f"1e-6*(qw2+onorm), max {_top(ez):.3g}; outside it max "
                f"|err| / sqrt(qw2+onorm) vs float64: kernel {_top(ek):.3g}"
                f", plain {_top(ep):.3g}")
        bad = int(bad_cells[~zone].sum() + bad_zone[zone].sum())
        held = ~zone
    else:
        rule = "rtol 1e-5"
        bad = int((diff > 1e-5 * rs[fin].double().abs()).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} finite scores outside {rule}"
                             f"{note}")
    max_abs = _top(diff)
    rel = _top((diff / rs[fin].double().abs().clamp_min(1e-30))[held])
    say(f"{label}: hist_f exact, hist_g {moved} rows moved "
        f"(limit {limit:.0f}), +inf mask exact "
        f"({int(fin.sum())} finite), scores max abs err {max_abs:.3g} "
        f"(max rel {rel:.3g}) within {rule}{note}")
    return {"fused_query_hist": float((hg - rg).abs().max()),
            "fused_query_scores": max_abs}


def _top(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def _max_err(a, b):
    return {k: max(a[k], b[k]) for k in a}


def phase_kernels(torch, dev):
    """Each kernel against its plain version on the card, p in {2,1,.5}."""
    from repro_torch.kernels import fused_query, ref

    n_rows = CHECK_ROWS
    n_valid = n_rows - 777  # dead tail below the row count
    err = {"fused_query_hist": 0.0, "fused_query_scores": 0.0}
    for i, p in enumerate((2.0, 1.0, 0.5)):
        inp = _kernel_inputs(p, n_rows, seed=100 + i, torch=torch, dev=dev)
        kw = dict(boff=0, n_valid=n_valid, c=inp["c"],
                  n_levels=inp["n_levels"], p=p)
        row_ok = torch.arange(n_rows, device=dev) < n_valid
        hf, hg = fused_query.fused_query_hist(*_pass_args(inp, "hist"), **kw)
        sc = fused_query.fused_query_scores(*_pass_args(inp, "scores"), **kw)
        _sync(torch, dev)
        rf, rg = ref.fused_query_hist_ref(
            *_pass_args(inp, "hist"), row_ok, c=kw["c"],
            n_levels=kw["n_levels"], p=p)
        rs = ref.fused_query_scores_ref(
            *_pass_args(inp, "scores"), row_ok, c=kw["c"],
            n_levels=kw["n_levels"], p=p)
        _sync(torch, dev)
        err = _max_err(err, _hold(torch, inp, p, (hf, hg, sc), (rf, rg, rs),
                                  f"kernels p={p}"))
    return err


def _dense_check(host, qpts, wids, res, k, idx):
    def one(qi):
        want = host.search_dense(qpts[qi], weight_id=int(wids[qi]), k=k)
        ok = (np.array_equal(res.ids[qi], want.ids.astype(np.int32))
              and int(res.stop_levels[qi]) == want.stats.stop_level
              and int(res.n_checked[qi]) == want.stats.n_checked)
        return ok, (int(res.stop_levels[qi]), want.stats.stop_level,
                    int(res.n_checked[qi]), want.stats.n_checked)

    with ThreadPoolExecutor(max_workers=len(idx)) as pool:
        return list(pool.map(one, idx))


def _quality(torch, dev, data_t, weights, qpts, wids, res, k):
    """(recall@k, overall ratio) against exact float64 brute force.

    The overall ratio is the paper's accuracy measure: the mean over
    queries and ranks i of dist(i-th answer) / dist(i-th true neighbor).
    """
    hits, ratios = 0, []
    for qi in range(len(qpts)):
        w = torch.from_numpy(weights[wids[qi]]).to(dev)
        q = torch.from_numpy(qpts[qi].astype(np.float64)).to(dev)
        dist = (((data_t - q) * w) ** 2).sum(1).sqrt()
        top = torch.topk(dist, k, largest=False)
        exact = top.indices.cpu().numpy()
        hits += len(set(exact.tolist()) & set(res.ids[qi].tolist()))
        got = res.ids[qi]
        valid = got >= 0
        got_d = dist[torch.from_numpy(got[valid].astype(np.int64)).to(dev)]
        ratios.append((got_d / top.values[: int(valid.sum())]).cpu().numpy())
    return hits / (k * len(qpts)), float(np.concatenate(ratios).mean())


def phase_slice(torch, dev):
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.kernels import fused_query
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf = SLICE
    n, d, n_w, k, q_batch, n_q = (cf["n"], cf["d"], cf["n_weights"], cf["k"],
                                  cf["q_batch"], cf["n_queries"])
    t0 = time.time()
    data = make_dataset(n, d, seed=0)
    weights = make_weight_set(n_w, d, n_subset=cf["n_subset"],
                              n_subrange=cf["n_subrange"], seed=1)
    host = WLSHIndex(data, weights,
                     PlanConfig(p=cf["p"], c=cf["c"], n=n), tau=cf["tau"],
                     v=cf["v"], v_prime=cf["v"], seed=2)
    plan = host.export_serving_plan()
    t_plan = time.time() - t0
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        k=k, q_batch=q_batch, device=str(dev)))
    t0 = time.time()
    svc.warmup()
    _sync(torch, dev)
    t_build = time.time() - t0
    pads = [svc.group_config(g).beta for g in range(plan.n_groups)]
    say(f"slice plan: n={n} d={d} |S|={n_w} p={cf['p']} tau={cf['tau']} "
        f"c={cf['c']} v=v'={cf['v']} -> "
        f"{plan.n_groups} groups, beta_group "
        f"{[g.beta_group for g in plan.groups]}, beta_pad {pads}, L_pad "
        f"{[svc.group_config(g).n_levels for g in range(plan.n_groups)]} "
        f"(plan {t_plan:.1f}s)")
    say(f"slice build: {svc.resident_bytes} bytes resident on "
        f"{torch.cuda.get_device_name(0)} ({svc.resident_bytes / 2**30:.2f} "
        f"GiB), {svc.step_cache.n_compiled} query steps, {t_build:.1f}s")

    rng = np.random.default_rng(7)
    wids = rng.integers(0, n_w, n_q)
    qpts = data[rng.choice(n, n_q, replace=False)]
    qpts = (qpts + rng.normal(0, 3.0, qpts.shape)).astype(np.float32)
    svc.query(qpts, wids)  # warm: first launches, allocator
    _sync(torch, dev)

    lat: list[float] = []
    run_batch = svc.batcher.run_batch

    def timed(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = run_batch(*a, **kw)
        e.record()
        e.synchronize()
        lat.append(s.elapsed_time(e))
        return out

    svc.batcher.run_batch = timed
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fused_query.reset_launch_counts()
    t0 = time.perf_counter()
    runs = [svc.query(qpts, wids) for _ in range(cf["reps"])]
    _sync(torch, dev)
    t_q = time.perf_counter() - t0
    launches = dict(fused_query.launch_counts)
    svc.batcher.run_batch = run_batch
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    say(f"slice launches: {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    res = runs[-1]
    ok_shape = (res.ids.shape == (n_q, k) and res.dists.shape == (n_q, k)
                and np.isfinite(res.dists[res.ids >= 0]).all()
                and (res.ids < n).all())
    if not ok_shape:
        raise AssertionError("slice answers malformed")
    for other in runs[:-1]:  # atomics in any order: identical answers
        if not (np.array_equal(other.ids, res.ids)
                and np.array_equal(other.dists, res.dists)
                and np.array_equal(other.stop_levels, res.stop_levels)):
            raise AssertionError("repeated runs of the same queries differ")
    n_served = n_q * cf["reps"]
    say(f"slice serve: {cf['reps']} x {n_q} queries in {len(lat)} batches, "
        f"{t_q:.3f}s ({n_served / t_q:.1f} q/s), identical across runs; "
        f"per-batch latency (CUDA events) p50 {np.percentile(lat, 50):.2f} "
        f"ms, p95 {np.percentile(lat, 95):.2f} ms; peak device memory "
        f"{peak} bytes; mean stop level {res.stop_levels.mean():.2f}, mean "
        f"n_checked {res.n_checked.mean():.1f}")

    check = list(range(0, n_q, n_q // cf["n_check"]))[: cf["n_check"]]
    t0 = time.time()
    rows = _dense_check(host, qpts, wids, res, k, check)
    n_bad = sum(not ok for ok, _ in rows)
    detail = [info for ok, info in rows if not ok]
    say(f"slice check vs search_dense: {len(check) - n_bad}/{len(check)} "
        f"exact (stop, n_checked, ids){' ' + str(detail) if detail else ''} "
        f"({time.time() - t0:.1f}s)")
    if n_bad > len(check) // 8:
        raise AssertionError(f"{n_bad} of {len(check)} queries disagree "
                             f"with search_dense")
    data_t = torch.from_numpy(data).to(dev).double()
    rec, ratio = _quality(torch, dev, data_t, weights, qpts, wids, res, k)
    del data_t
    say(f"slice recall@{k} vs exact brute force: {rec:.4f}; overall ratio "
        f"{ratio:.4f}")
    return svc, plan, qpts, wids, launches


def _slice_pass_inputs(svc, plan, qpts, wids, torch, dev):
    """The inputs run_batch hands the kernels for one full batch of the
    group with the widest padded state."""
    from repro_torch.index.builder import pad_cols

    gi = max(range(plan.n_groups), key=lambda g: (
        svc.group_config(g).beta, plan.groups[g].beta_group))
    cfg = svc.group_config(gi)
    g = plan.groups[gi]
    rows = np.where(plan.group_of[wids] == gi)[0]
    take = rows[np.arange(cfg.q_batch) % len(rows)]
    slots = plan.member_slot[wids[take]]
    st = svc.batcher.state(gi)

    def put(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

    inp = dict(
        codes_p=st.codes, points=st.points,
        codes_q=put(pad_cols(g.encode_host(qpts[take]), cfg.beta), np.int32),
        queries=put(qpts[take], np.float32),
        q_weight=put(plan.weights[wids[take]], np.float32),
        mu=put(g.mu_members[slots], np.int32),
        beta_q=put(g.beta_members[slots], np.int32),
        r_min=put(g.r_min_members[slots], np.float32),
        c=cfg.c, n_levels=cfg.n_levels,
    )
    step = svc.step_cache.get(dev, cfg)
    _, _, stop, _ = step(st, inp["queries"], inp["codes_q"], inp["q_weight"],
                         inp["mu"], inp["r_min"], inp["beta_q"],
                         put(g.n_levels_members[slots], np.int32))
    inp["stop"] = stop.contiguous()
    return gi, cfg, st, inp


def phase_times(torch, dev, svc, plan, qpts, wids, launches, errs, smi):
    from repro_torch.kernels import fused_query, ref

    gi, cfg, st, inp = _slice_pass_inputs(svc, plan, qpts, wids, torch, dev)
    n, beta = st.codes.shape
    q, d = inp["queries"].shape
    kw = dict(boff=0, n_valid=st.n_valid, c=cfg.c, n_levels=cfg.n_levels,
              p=cfg.p)
    row_ok = torch.arange(n, device=dev) < st.n_valid
    tests = int(inp["beta_q"].clamp_max(beta).sum()) * n  # level tests
    flops = 4 * q * n * d  # p=2: cross and onorm multiply-adds
    in_bytes = 4 * (n * beta + n * d + q * beta + 2 * q * d + 4 * q)
    out_bytes = {"fused_query_hist": 2 * 4 * q * (cfg.n_levels + 3),
                 "fused_query_scores": 4 * q * n}
    ops_ms = 1e3 * max(tests / INT32_OPS, flops / F32_FLOPS)
    t_k, t_p, out_k, out_p = {}, {}, [], []
    for name, which in (("fused_query_hist", "hist"),
                        ("fused_query_scores", "scores")):
        kern = getattr(fused_query, name)
        plain = getattr(ref, name + "_ref")
        args = _pass_args(inp, which)
        out = kern(*args, **kw)  # warm; held to the plain version below
        out_k += list(out) if which == "hist" else [out]
        t_k[name] = _time_ms(lambda: kern(*args, **kw), torch, reps=5)
        t_p[name] = _time_ms(lambda: out_p.append(plain(
            *args, row_ok, c=cfg.c, n_levels=cfg.n_levels, p=cfg.p)),
            torch, reps=1)
    out_p = [*out_p[0], out_p[1]]
    err = _hold(torch, inp, cfg.p, out_k, out_p,
                f"times check (group {gi}, the main path's inputs)")
    errs = _max_err(errs, err)
    table = []
    for name in ("fused_query_hist", "fused_query_scores"):
        bytes_ms = 1e3 * (in_bytes + out_bytes[name]) / HBM_BYTES_PER_S
        bound = max(bytes_ms, ops_ms)
        say(f"times {name} (group {gi}: n={n} beta_pad={beta} Q={q} d={d} "
            f"L={cfg.n_levels}): kernel {t_k[name]:.3f} ms, plain "
            f"{t_p[name]:.3f} ms, "
            f"bound {bound:.3f} ms by "
            f"{'bytes' if bytes_ms >= ops_ms else 'operations'} "
            f"({tests} level tests, {flops} flops, "
            f"{in_bytes + out_bytes[name]} bytes) [{smi}]")
        table.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=KERNELS[name],
            launches=launches[name], max_abs_err=errs[name], ms=t_k[name],
            plain_ms=t_p[name], bound_ms=bound,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None,
        ))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = phase_device(torch)
    if "build" in phases:
        phase_build()
    errs = None
    if "kernels" in phases:
        errs = phase_kernels(torch, dev)
    sl = None
    if "slice" in phases:
        sl = phase_slice(torch, dev)
    if "times" in phases:
        if sl is None or errs is None:
            raise SystemExit("the times phase needs the kernels and slice "
                             "phases")
        table = phase_times(torch, dev, *sl, errs, smi)
        say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
