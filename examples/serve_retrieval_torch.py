"""End-to-end driver of the PyTorch port: embed a corpus with an
assigned-arch backbone, plan WLSH table groups over every user's
preference weight vector, and serve a mixed stream of weight-personalized
k-NN queries through the multi-group retrieval service.

    PYTHONPATH=src python examples/serve_retrieval_torch.py [--device cpu]

The port's copy of ``examples/serve_retrieval.py``: the reduced backbone
comes from ``repro_torch.models`` (parameters and tokens drawn from
seeded ``torch.Generator``s, so the corpus is not the JAX example's), the
plan from the numpy planner, and ``RetrievalService`` answers on the
device through the fused query passes (CUDA kernels on the card, their
plain torch versions on the CPU).  The same traffic is then replayed
open-loop through the deadline-aware async frontend on a manual clock,
which must answer bit-exactly like the sync service.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.datagen import make_weight_set
from repro_torch.core.distances import weighted_lp_np
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.kernels.platform import resolve_device
from repro_torch.models import build_model, init_params
from repro_torch.serving import (
    AsyncRetrievalService,
    ManualClock,
    RetrievalService,
    ServiceConfig,
    replay_open_loop,
)

N_USERS = 12
EMBED_BATCH = 64


def embed_corpus(n_docs: int, seq_len: int = 32, arch: str = "olmo-1b",
                 device="cuda"):
    """Mean-pooled final hidden states of a reduced backbone = doc vectors,
    shifted to the positive orthant."""
    dev = resolve_device(device)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model.defs(), gen, device=dev)
    gen.manual_seed(1)
    vecs = []
    with torch.no_grad():
        for i in range(0, n_docs, EMBED_BATCH):
            toks = torch.randint(0, cfg.vocab,
                                 (min(EMBED_BATCH, n_docs - i), seq_len),
                                 generator=gen, dtype=torch.int32, device=dev)
            h = model.hidden_states(params, {"tokens": toks})
            # a bfloat16 mean, as jnp.mean of the JAX example's states
            vecs.append(h.mean(dim=1).float().cpu().numpy())
    out = np.concatenate(vecs)
    # weighted l_p is used on magnitudes; any affine shift preserves the
    # neighbor structure under D_W
    out = out - out.min(axis=0, keepdims=True)
    return out, cfg


def plan_service(corpus: np.ndarray, k: int, q_batch: int, device):
    """(users, host index, plan, service): the example's weight set, WLSH
    plan and a RetrievalService over every group on ``device``."""
    n_docs, d = corpus.shape
    users = make_weight_set(size=N_USERS, d=d, n_subset=3, n_subrange=10,
                            seed=7)
    cfg = PlanConfig(p=2.0, c=3, n=n_docs, gamma_n=100.0)
    host = WLSHIndex(corpus, users, cfg, tau=500.0, v=d // 4, v_prime=d // 4,
                     value_range=float(corpus.max()), seed=8)
    plan = host.export_serving_plan()
    svc = RetrievalService(plan, corpus, cfg=ServiceConfig(
        k=k, q_batch=q_batch, device=str(device)))
    return users, host, plan, svc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_docs, n_queries, k = 4_096, 24, 5
    t0 = time.time()
    corpus, cfg_lm = embed_corpus(n_docs, device=dev)
    d = corpus.shape[1]
    print(f"embedded {n_docs} docs -> ({n_docs}, {d}) "
          f"with {cfg_lm.name} in {time.time() - t0:.1f}s")

    users, _, plan, svc = plan_service(corpus, k, q_batch=8, device=dev)
    print(f"WLSH plan: {plan.n_groups} groups, {plan.beta_total} tables, "
          f"group betas {[g.beta_group for g in plan.groups]}")
    t0 = time.time()
    svc.warmup()
    print(f"service: {plan.n_groups} group states on {dev}, "
          f"{svc.step_cache.n_compiled} query steps in "
          f"{time.time() - t0:.1f}s")

    # mixed batched requests: every user queries from docs they liked
    rng = np.random.default_rng(9)
    wids = rng.integers(0, N_USERS, size=n_queries)
    doc_ids = rng.choice(n_docs, n_queries, replace=False)
    queries = corpus[doc_ids] + rng.normal(
        0, 0.01, (n_queries, d)
    ).astype(np.float32)

    t0 = time.time()
    res = svc.query(queries, wids)
    dt = time.time() - t0
    print(f"served {n_queries} personalized queries spanning "
          f"{len(np.unique(res.group_ids))} groups in {dt:.2f}s "
          f"({n_queries / dt:.1f} q/s)")
    for gi, s in sorted(svc.stats_summary().items()):
        print(f"  group {gi}: {s['n_queries']} queries / {s['n_batches']} "
              f"batches, occupancy {s['occupancy']:.2f}, "
              f"mean stop level {s['mean_stop_level']:.1f}")

    # the same requests, one at a time at Poisson arrivals, through the
    # deadline-aware async frontend (shared states / stats / step cache)
    rate_qps, max_delay_ms = 2_000.0, 2.0
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, n_queries))
    svc.reset_stats()
    asvc = AsyncRetrievalService(svc, max_delay_ms=max_delay_ms,
                                 clock=ManualClock())
    ares, waits = replay_open_loop(asvc, queries, wids, arrivals)
    assert (
        np.array_equal(ares.ids, res.ids)
        and np.array_equal(ares.stop_levels, res.stop_levels)
        and np.array_equal(ares.n_checked, res.n_checked)
    ), "async frontend must answer bit-exactly like the sync service"
    occ = svc.mean_occupancy()
    print(f"async replay at {rate_qps:.0f} q/s, deadline {max_delay_ms} ms: "
          f"bit-exact with sync; {asvc.n_launched_full} full / "
          f"{asvc.n_launched_deadline} deadline launches, occupancy "
          f"{occ:.2f} (single-submission baseline "
          f"{1 / svc.cfg.q_batch:.2f}), wait mean "
          f"{1e3 * waits.mean():.2f} ms")

    ok = 0
    for qi, (wid, did) in enumerate(zip(wids, doc_ids)):
        w = users[wid]
        exact = np.argsort(weighted_lp_np(corpus, queries[qi], w, 2.0))[:k]
        got = res.ids[qi][res.ids[qi] >= 0]
        hit = did in got
        ok += hit
        overlap = len(set(got.tolist()) & set(exact.tolist()))
        print(f"  user w{wid} (group {res.group_ids[qi]}): source doc {did} "
              f"{'FOUND' if hit else 'missed'}; top-{k} overlap with exact: "
              f"{overlap}/{k}")
    assert ok >= int(0.75 * n_queries), (
        "service must find the perturbed source doc for most users"
    )
    print("ok")
    return {"found": ok, "n_queries": n_queries}


if __name__ == "__main__":
    main()
