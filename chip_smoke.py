#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py            # every phase, one card

Phases, one line each (more for the serving legs), any failure exits
non-zero:

  1. device  — nvidia-smi's name and power limit, torch and CUDA versions
  2. build   — compile every kernels/csrc/*.cu with nvcc for sm_90a (one
               object per source, in parallel) into one library; ptxas
               registers and spills per source, and the fused passes'
               (and the keep pass's) shared bytes per block and resident
               blocks per SM
  3. sentinel — benchmarks_torch.sentinel's seeded serving workload (async
               frontend, ServiceDriver, DeadlinePrefetch, paging, shadow
               recall, a degrade ladder) on the card and then on the CPU:
               the seeded metrics equal, the rest side by side; the keep
               pass and the mask launched and no other kernel; no
               regression row
               against experiments/bench_torch/BASELINE.json.  It runs
               before every other leg, in the state in which its baseline
               is pinned (a fresh process): run after the other legs, its
               host-bound steps read slower and its p50 gate can fail
               (benchmarks_torch/sentinel_drift.py prints the sentinel's
               p50 at each stage of one process)
  4. kernels — every kernel against its plain torch version on the card
               at ~65k rows with a ragged tail: both fused-query passes
               (and the keep pass and the mask, equal to them bit for
               bit)
               (p in {2, 1, 0.5}, Q=64, d=400, beta=512, beta_q ~ 450,
               L=16, n_valid below the row count; and c in {2, 3} at
               L=24 with Q=61, on real codes and on codes at the level
               test's edges: INT_MIN, INT_MAX, -1, 0, +-3^19, 3^20 -
               2^31, pairs that differ by +-c^k); hash_encode ((d,
               beta) in {(400, 512), (397, 449)}, and a ragged (12,345,
               37, 257) across every edge of its 128 x 64 blocks and
               32-dim slabs; the projections of real p = 2, 1, 0.5
               families) equal to its plain version, within the float64
               window and row-independent; freq_level (c in {2, 3}
               at L=16, and at L=24 with Q=61 on real and edge codes)
               exactly;
               weighted_lp (p in {1, 0.5, 1.5}, d in {400, 397}) to
               rtol 1e-5
  5. slice   — the synchronous query path at the paper's default data
               scale (n=400,000, d=400, |S|=24, p=2, tau=500, c=3,
               v=v'=6) from a plan with host codes: plan, build every
               group state, serve 256 queries, check 8 against the host
               oracle search_dense and recall@10 against exact brute force
  6. encode  — the same plan exported without host codes: every group
               state built and every query encoded on the card by the
               hash_encode kernel; the widest group's codes held to the
               float64 window, 65 self-queries found at rank 0, the 256
               queries served, recall beside the host-code leg's
  7. unfused — the host-code plan served with use_kernels="off" (the
               freq_level kernel, then torch distances and histograms):
               hist_f equal to the fused kernel's, answers equal to the
               fused leg's, and pass 1 of both routes timed
  8. paged   — the slice's 256 queries through a RetrievalService that
               keeps 3 of the 7 group states on the card (LRU eviction,
               offload to pinned host memory, restore on a copy stream):
               answers equal to the slice leg's bit for bit, restores > 0
               with no hash_encode launch, the fused passes launched as
               often as on the slice leg, peak device memory below the
               slice leg's; restores and evictions, bytes and device ms
               per restore (CUDA events on the copy stream), pinned
               bytes, per-batch latency and q/s
  9. async   — the same queries as open-loop arrivals at half the paged
               leg's q/s (real clock, 5 ms deadline) into an
               AsyncRetrievalService under the same budget, driven by a
               ServiceDriver thread with DeadlinePrefetch: every future
               resolves, each answer equals the slice leg's, a prefetch
               overlapped at least one restore; submit-to-resolve
               latency, deadline misses, wasted prefetches and the
               restore cost model's learned rate
 10. stream  — streaming writes on the host-code plan, 3 of 7 states on
               the card, 1,000 rows reserved per state (capacity 401,000):
               the 256 queries interleaved with 512 inserts (uniform over
               the 24 weight ids, past the corpus range), every insert's
               self-query at rank 0 by the exact scan, the 256 answers
               with rows pending equal to the slice leg's; compaction
               into the states on the card (some restored by the lease),
               the self-queries again through the fused kernels, every
               compacted state torch.equal a fresh union build and the
               256 answers equal the fresh builds'; every group evicted
               and restored with answers unchanged and the pinned buffers
               reused; 32 base rows and 32 inserts deleted (none served),
               a purge, the widest purged state equal to a fresh build
               over the survivors; then the plan without host codes: 128
               inserts sealed by the hash_encode kernel (each seal equal
               to the plain version on the card), compacted, the widest
               state equal to a fresh device build.  Seals, compactions,
               purges and rebuilds; ms per seal and compaction (CUDA
               events), host ms of the exact scan, p50 per batch with rows
               pending and after compaction, purge seconds and peak memory
 11. obs     — the host-code plan with the observability layer on
               (obs=True, recall_sample_rate 0.0625): the sync frontend's
               answers equal to the slice leg's bit for bit, one monotone
               span per query, the hash-sampled ids shadow-checked and the
               recall estimate equal to an offline scan_topk recomputation;
               one pass of 7 fused batches under a torch.profiler capture
               (answers unchanged), with the device time per stage (both
               passes, top-k, re-rank, H2D and D2H copies, the rest) and
               the device's idle share read from its Chrome trace; then
               the async frontend on a manual clock under a ServiceDriver
               with the stock SLO rules: the same answers, spans with
               their launch causes, the same sampled set and estimate as
               the sync leg, and the span, metrics and alert exports equal
               after a reload; obs-on p50 / p95 beside the slice leg's
 12. bf16    — the host-code plan with bfloat16 vector storage: every
               state's bytes equal to state_nbytes, the stored bits equal
               to float32 rounded to nearest even, the 256 queries served
               (p50 / p95, q/s, recall and ratio, ids in common with the
               float32 leg); both fused kernels on the widest bfloat16
               state equal to their plain versions and to the float32
               kernels on the widened rows; a pass raising peak device
               memory by less than a float32 copy of the rows; a paged
               round trip (3 of 7 states) equal to the unpaged bf16 leg,
               with pinned bfloat16 host buffers and its restore times
 13. shard   — the host-code plan with every group's rows split into S
               contiguous slices on the one card (devices named
               explicitly), 1,000 rows reserved a state (capacity 401,000
               = 4 x 100,250: the last shard holds the live rows' edge):
               S = 2 and 4 served bit-equal to the slice leg (ids,
               distance bits, stop, n_checked), every pass launched once
               a shard; on S = 4 both fused kernels on the straddling
               shard (boff 300,750) held to their plain versions, the
               per-host build (a loader called once a shard) torch.equal
               the materialized sharded build, the plan without host
               codes encoded shard by shard equal to the whole-state
               encode, and S = 3 refused by the divisibility rule; 4
               shards paged at 3 of 7 (a copy a shard) and on the async
               driver, bit-equal; 64 inserts, one compaction a group
               (every compacted state torch.equal a fresh sharded union
               build), 16 deletes and a purge (the widest state equal to a
               fresh sharded build over the survivors).  p50 / p95 per
               batch, q/s, peak memory a leg, bytes, ms and GB/s a shard
               copy
 14. search  — the paper's host search (WLSHIndex.search, numpy: per-table
               sorted codes, the C2LSH level loop with incremental
               collision counting and I/O accounting) on the slice's
               host index: 4 queries routed to the widest group and 4 to
               the narrowest (only those two groups' sorted tables are
               built, in parallel), each also through search_dense: stop
               level and n_checked equal on 8 of 8, ids equal wherever
               n_checked is below the budget k + ceil(gamma n); the same
               rules against the card's answers from the slice leg with at
               most 1 of 8 differing; seconds to sort each group's tables,
               host ms, io_blocks and n_collisions a query, the overall
               ratio of both answers against exact brute force, and the
               slice leg's p50 per batch beside them; no kernel launched
 15. lm      — the LM substrate (repro_torch.models, serving.decode): the
               10 reduced archs of every family in float32 on the card
               (hidden states, prefill logits, 3 decode steps' logits and
               cache) held to the port's CPU run of the same parameters,
               and each once in its bfloat16, finite; olmo-1b at full
               width (16 layers, d_model 2,048, d_ff 8,192, vocab 50,304,
               tied: ~1.18 B parameters from a seeded generator on the
               card) embedding 65,536 docs x 32 tokens mean-pooled in
               batches of 64 in bfloat16 (ms a batch, tokens/s, peak
               memory), 8 docs' float32 hidden states held to the CPU's,
               greedy generation (batch 8, prompt 16, 32 new) twice equal,
               decode logits held to prefill's (ms a decode step,
               tokens/s); the corpus served as examples/
               serve_retrieval_torch.py does (positive orthant, |S| = 12,
               p = 2, c = 3, tau = 500, v = v' = d/4, k = 5) through the
               fused kernels at q_batch 64: 256 noisy corpus rows, both
               passes held to their plain versions on the widest group, 8
               queries vs search_dense, the source docs found, top-k
               overlap with exact brute force, p50 / p95 and q/s, and the
               example's open-loop replay bit-exact with sync
 16. train   — the LM substrate's training side (repro_torch.training,
               launch/train.py): the 10 reduced archs' float32 loss and
               every gradient leaf on the card held to the port's CPU run
               of the same parameters, MoE routing integers equal, AdamW
               on the same state and gradients held to the CPU for
               float32, bfloat16 and int8 moments, and one bfloat16 train
               step each, finite; olmo-1b at full width in float32 (1 x
               64 tokens): the loss and the gradients of embed/tok and
               the first and last layer's attn/wq and mlp leaves held to
               the CPU's (a TF32 control must fall outside); olmo-1b at
               full width trained through the launcher, given bfloat16
               master (stochastic rounding), int8 moments and
               update_chunk 4 by ``train(args, optimizer=...)`` (bfloat16
               compute, 8 x 512 tokens on the markov stream, 20 steps,
               checkpoints every 10 into a directory under build/ removed
               afterwards): a failure injected after step 12, one restart
               from step 10, the resumed losses held to an uninterrupted
               twin's, the last 5 below the first; the launcher as
               shipped (float32 master and moments), 6 steps, finite,
               with its ms a step and peak memory; ms a step (the
               launcher's CUDA events), tokens/s, model FLOP/s against the bfloat16
               peak, the state's bytes, peak memory, checkpoint save and
               load GB/s, one profiled step's idle share and top kernels;
               and examples/train_lm_torch.py on the card with its own
               assertions, in a child process beside the first two
               checks.  No retrieval kernel is launched
 17. mesh    — the LM substrate on a device mesh (repro_torch.distributed.
               sharding, launch/{dryrun,roofline,estimate}.py): the dry-run
               of olmo-1b and olmoe-1b-7b train_4k on the single pod's
               (16, 16) mesh in child processes (a fake process group of
               256 ranks, meta DTensors, the two-point depth
               extrapolation): status ok, per-device state bytes equal to
               the local shards of train_state_shardings, GB a device,
               FLOPs, collective bytes by kind, the three roofline terms
               and the trace's seconds; the train leg's configuration
               (olmo-1b, 8 x 512 tokens, bfloat16 master, int8 moments,
               update_chunk 4) traced on a one-rank mesh: its state bytes
               equal the train leg's, its FLOP count equal to
               FlopCounterMode on the real step on the card, its roofline
               step and predicted peak beside the train leg's measured ms
               and max_memory_allocated; a one-rank NCCL group on the card:
               every family's reduced arch one train step through
               train_state_shardings / batch_shardings (bfloat16 master,
               int8 moments, update_chunk 1) with loss, every gradient and
               the new state bit-equal to the step without a mesh, and
               _moe_block_ep bit-equal to _moe_block_global; olmo-1b at
               full width through launch/train.py as shipped, 6 steps
               without a mesh and with --mesh 1,1 (ms a step: DTensor's
               dispatch); the index's mesh steps on the same one-rank
               mesh at the slice's widest group's shapes (n = 400,000,
               d = 400, beta_pad = 512, Q = 64, L = 16; seeded rows on the
               card): the state built by build_state (the family folded
               by fold_center_weight), every field bit-equal to
               make_build_step + distribute_state and its codes and
               vectors to the device encode (ops.hash_encode, as
               build_shards calls it), make_query_step's answers over it
               bit-equal to the device-list
               engine's query_step, the kernels launched exactly as the
               steps need, the StepCounter's count of the real CUDA steps
               equal to a meta trace's in a child process, each step's
               measured ms over its roofline step; kernels/ref.py's
               count_level_ref on the card at (Q, n, beta) = (64, 4,096,
               512), c = 3, levels 0-3 (the state's codes, half of them
               negated) equal to the same call on the CPU; and the
               dry-run's four
               wlsh_index cells (build and query on both production
               meshes, a child process): ok, state bytes a device, GB,
               terms and bottleneck
 18. times   — each kernel on the main path's inputs for the widest
               group: held to its plain version there (the rules of
               phase 3), its time, its plain version's time, the time of
               one PyTorch call that computes the same function where
               there is one, and the bound from bytes and operations
               (kernels/cost.py at launch/roofline.py's HW rates);
               the fused passes also on the group's rows in bfloat16;
               the serving path's single scan (the keep pass, the mask
               on its carry) held to both passes bit for bit and timed
               beside them; the host time of a call through a kernel's
               custom op against its launch function

The line before the last is the kernel table as one JSON object; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script fails before
printing any result.  ``--phases`` runs a subset (e.g. ``device,build,
kernels``) for a short check; the full run needs all of them.  ``obs``
and ``bf16`` need only ``slice`` (``--phases device,build,slice,obs,bf16``),
as does ``shard`` (``--phases device,build,slice,shard``) and ``search``
(``--phases device,build,slice,search``); ``lm``, ``train`` and
``sentinel`` need only ``device`` and ``build`` (``--phases
device,build,lm`` or ``device,build,train``); ``mesh`` needs only
``device`` (``--phases device,mesh``, ~40 s of command; after ``train``
it also sets the train leg's ms and peak beside the analysis).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "build", "sentinel", "kernels", "slice", "encode",
          "unfused", "paged", "async", "obs", "bf16", "stream", "shard",
          "search", "lm", "train", "mesh", "times")

# the slice configuration (paper Sec. 5.1 defaults, |S| cut to 24) and the
# kernel-check row count
SLICE = dict(n=400_000, d=400, n_weights=24, n_subset=6, n_subrange=20,
             p=2.0, tau=500.0, c=3, v=6, k=10, q_batch=64, n_queries=256,
             n_check=8, reps=3)
CHECK_ROWS = 65_536 - 53  # ragged against the kernels' 128-row blocks
# (n, d, beta) of the hash_encode checks; the last is ragged against its
# 128-row, 64-code blocks, its 32-dim slabs and its 8-dim runs
HASH_SHAPES = ((CHECK_ROWS, 400, 512), (CHECK_ROWS, 397, 449),
               (12_345, 37, 257))

_CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {  # name: (the TPU kernel it replaces, its CUDA source)
    "fused_query_hist": ("src/repro/kernels/fused_query.py:184",
                         _CSRC + "fused_query.cu"),
    "fused_query_scores": ("src/repro/kernels/fused_query.py:248",
                           _CSRC + "fused_query.cu"),
    # the serving path's single scan: pass 1 that keeps each (query,
    # row)'s level and distance, and pass 2 as a mask of them
    "fused_query_keep": ("src/repro/kernels/fused_query.py:184",
                         _CSRC + "fused_query.cu"),
    "fused_query_mask": ("src/repro/kernels/fused_query.py:248",
                         _CSRC + "fused_query.cu"),
    "hash_encode": ("src/repro/kernels/hash_encode.py:55",
                    _CSRC + "hash_encode.cu"),
    "freq_level": ("src/repro/kernels/freq_level.py:68",
                   _CSRC + "freq_level.cu"),
    "weighted_lp": ("src/repro/kernels/weighted_lp.py:57",
                    _CSRC + "weighted_lp.cu"),
}
_SELF_QUERIES = 64  # corpus rows asked as queries on the device-encoded leg
PAGED_SLOTS = 3  # group states the paged and async legs keep on the card
ASYNC_DELAY_MS = 5.0  # the async leg's deadline budget
ASYNC_LOAD = 0.5  # the async leg's arrival rate, as a share of paged q/s
WLP_PS = (1.0, 0.5, 1.5)  # weighted_lp's |t|, sqrt(|t|) and powf terms
# the stream leg: rows reserved per state (capacity 401,000, 104 rows into
# its last 128-row tile), the seal size, the inserts on the host-code and
# the codeless plan, and the base rows and inserts deleted before a purge
STREAM = dict(reserve=1_000, seal_rows=32, inserts=512, codeless_inserts=128,
              deletes=32)
# the shard leg: shard counts on the one card, the rows reserved a state
# (capacity 401,000 = 4 x 100,250, so the last shard holds n_valid's
# edge: 99,250 live rows and 1,000 dead), and the streaming sub-leg's
# inserts and deletes (base rows and inserts each)
SHARD = dict(counts=(2, 4), reserve=1_000, inserts=64, deletes=8)
# the search leg: queries a group searched by the host's C2LSH level loop
# (the first ones routed to the widest and to the narrowest group, whose
# per-table sorted orders take tens of seconds each to build)
SEARCH_PER_GROUP = 4
# the sentinel leg: metrics fixed by its seed, equal on the card and the CPU
SENTINEL_SEEDED = ("observed_recall", "recall_margin_min",
                   "n_shadow_dropped", "n_compiled_steps")
# the obs leg: shadow recall sample rate (~16 of the 256 queries), the
# recall floor its alert rule holds the shadow recall to, the threads that
# run the host oracle's scans, and the async replay's arrival rate (a
# manual clock)
OBS_RATE = 0.0625
OBS_FLOOR = 0.5
OBS_THREADS = 8
OBS_ARRIVALS = 1_000.0
# The cancellation zone of the p = 2 hold on bfloat16 rows.  The float32
# norms expansion errs by ~eps*(qw2+onorm) on the squared distance, i.e.
# by ~eps*(qw2+onorm)/(2 dist) on the distance, which meets the 1e-6 *
# sqrt(qw2+onorm) atol only above ~0.1*sqrt(qw2+onorm).  Float32 rows
# have no cell in [1e-3, 0.1): a query's source row sits at ~4e-4 of the
# scale, every other row above 0.3.  Rounding to bfloat16 moves the
# source row to ~1.3e-3, so on bfloat16 rows the squared-distance rule
# holds up to 0.1 (kernel and plain version alike miss the atol there).
BF16_ZONE = 0.1
# the lm leg: the reduced families' decode steps, sequence length and
# cache length; the full-width arch, its corpus (docs x tokens, embedded
# in batches), the docs held in float32 to the CPU, the greedy
# generation's batch, prompt and new tokens; the serving leg's users,
# queries, k, batch, oracle checks and timed passes, and the example's
# open-loop replay (rate, deadline)
LM = dict(family_steps=3, family_seq=32, cache_len=16, arch="olmo_1b",
          n_docs=65_536, seq=32, embed_batch=64, hold_docs=8, gen_batch=8,
          prompt=16, new=32, n_users=12, n_queries=256, k=5, q_batch=64,
          n_check=8, reps=3, async_rate=2_000.0, async_delay_ms=2.0)
# float32 on the card vs the port's CPU run: the reduced families (the
# CPU parity tests see at most 4e-6 between XLA and torch on values of
# order 4), and olmo-1b's 16 layers at d_model 2,048 (values of order 5;
# the card read 9.5e-6 there).  The full-width hold runs a control with
# TF32 matmuls on and fails unless that control falls outside its limit.
LM_F32_TOL = dict(rtol=1e-4, atol=1e-4)
LM_FULL_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 decode vs prefill at the last prompt position: relative
# Frobenius error of the logits (two bfloat16 paths that round apart)
LM_DECODE_REL = 0.05
# The p = 2 hold of the fused passes on the embedded corpus.  Its queries
# are corpus rows plus N(0, 0.01): a source row sits at ~1.1e-2 of
# sqrt(qw2+onorm), every other row above ~0.25, so the cancellation zone
# reaches 0.1 (as BF16_ZONE does for bfloat16 rows).  Both tolerances of
# the rule are scaled by d / 400 above d = 400: a float32 sum errs in
# proportion to its length, and the d = 400 rule is ~17 ulps of the
# expansion's terms.
LM_ZONE = 0.1
# the train leg: the reduced families' batch and sequence; olmo-1b at full
# width: the float32 gradient hold's tokens; the launcher's run (global
# batch x sequence, steps, checkpoint interval, the step an injected
# failure follows, learning rate), the resumed losses' limit against the
# uninterrupted twin's, the profiled steps, the example's time limit, the
# steps of the launcher run as shipped
TRAIN = dict(family_batch=2, family_seq=32, hold_seq=64, batch=8, seq=512,
             steps=20, ckpt_every=10, fail_at=12, lr=1e-3, resume_rtol=1e-3,
             profile_calls=2, example_timeout_s=300, default_steps=6)
# the launcher's optimizer fields for the timed run (``train(args,
# optimizer=...)``): bfloat16 master, int8 moments, the leaves stacked 16
# deep updated 4 slices at a time
TRAIN_OPT = dict(master_dtype="bfloat16", moment_dtype="int8",
                 update_chunk=4)
# olmo-1b's float32 gradients card vs CPU, each leaf over its largest
# magnitude (a TF32 control must fall outside); AdamW on the same state and
# gradients card vs CPU (atol that x a leaf's largest value); int8 codes
# and bfloat16 moments differ only at rounding ties, in at most this share
TRAIN_FULL_TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_ADAMW_RTOL = 1e-6
TRAIN_TIE_SHARE = 1e-3
# H100 SXM dense bfloat16 tensor-core peak (NVIDIA data sheet)
BF16_PEAK_FLOPS = 989e12


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers


def _kernel_inputs(p: float, n_rows: int, seed: int, torch, dev,
                   d: int = SLICE["d"], q: int = 64, c: int = 3,
                   L: int = 16):
    """Seeded pass inputs at the kernel-check shapes, as tensors on dev."""
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.distances import radius_bounds
    from repro_torch.core.families import hash_codes_np, sample_lp_family

    rng = np.random.default_rng(seed)
    beta = 512
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
    beta_q = rng.integers(int(0.86 * beta), int(0.9 * beta) + 1, q).astype(np.int32)
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


def _edge_inputs(n_rows: int, q: int, c: int, L: int, seed: int, torch,
                 dev):
    """``_kernel_inputs``' dict with codes at the level test's edges
    (``repro_torch.kernels.probe_inputs.make_edge_inputs``)."""
    from repro_torch.kernels.probe_inputs import make_edge_inputs

    arrs = make_edge_inputs(n_rows, SLICE["d"], 512, q, c, L, seed)
    names = ("codes_p", "codes_q", "points", "queries", "q_weight", "mu",
             "beta_q", "r_min", "stop")
    inp = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for k, a in zip(names, arrs)}
    inp.update(c=c, n_levels=L)
    return inp


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
    from repro_torch.kernels import _cuda

    path = _cuda.build(verbose=True)
    info = _cuda.build_info
    say(f"build: nvcc {' '.join(_cuda.NVCC_FLAGS)}, one object per source "
        f"in parallel -> {os.path.relpath(path, ROOT)} in "
        f"{info['seconds']:.1f}s")
    for src, report in info.get("ptxas", {}).items():
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln]
        say(f"  ptxas {src}: {' | '.join(regs)}")
    from repro_torch.kernels import fused_query

    say(f"build fused_query.cu {_ptxas_summary('fused_query.cu')}")
    say(f"build freq_level.cu {_ptxas_summary('freq_level.cu')}")
    say(f"build weighted_lp.cu {_ptxas_summary('weighted_lp.cu')}")
    for c, L in ((3, 16), (2, 24), (3, 24)):
        say(f"build {_occupancy_line(fused_query, c, L)}")
        say(f"build {_freq_level_occupancy(c, L)}")


def _ptxas_summary(src: str) -> str:
    """Registers and spill bytes of ``src``'s kernels (the most over its
    entry points), from the build phase's ptxas report."""
    from repro_torch.kernels import _cuda

    report = _cuda.build_info.get("ptxas", {}).get(src, "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       report)
    if not (regs and spill):
        return "ptxas: not reported (no fresh build in this run)"
    return (f"ptxas: {max(regs)} registers, "
            f"{max(int(st) for st, _ in spill)} B spill stores, "
            f"{max(int(ld) for _, ld in spill)} B spill loads (most over "
            f"{len(regs)} kernels)")


def _occupancy_line(fq, c: int, L: int) -> str:
    """Shared bytes per block and resident blocks per SM of both fused
    passes and of the keep pass at (c, L), from the loaded library."""
    occ = {w: fq.occupancy(w, c, L) for w in ("hist", "keep", "scores")}
    o = occ["hist"]
    return (f"fused_query c={c} L={L}: ROWS={o['rows']} QT={o['qt']} "
            f"TC={o['tc']}; " + "; ".join(
                f"{w} {v['smem_bytes']} B shared per block, "
                f"{v['blocks_per_sm']} blocks per SM, {v['registers']} "
                f"registers" for w, v in occ.items()))


def _freq_level_occupancy(c: int, L: int) -> str:
    """Shared bytes per block, resident blocks per SM and registers of the
    freq_level kernel at (c, L), from the loaded library."""
    from repro_torch.kernels import freq_level

    o = freq_level.occupancy(c, L)
    return (f"freq_level c={c} L={L}: {o['smem_bytes']} B shared per block, "
            f"{o['blocks_per_sm']} blocks per SM, {o['registers']} "
            f"registers")


def _hold(torch, inp, p, kernel_out, plain_out, label, zone_edge=1e-3,
          tol=1e-6):
    """Hold both kernels' outputs to their plain versions' on one input.

    ``kernel_out`` and ``plain_out`` are ``(hist_f, hist_g, scores)``.
    hist_f and the +inf mask must be equal; hist_g may move at most 1e-4
    of the (query, row) cells (a good level on a float boundary); finite
    scores must agree to rtol 1e-5, or for p = 2 to atol
    ``tol``*sqrt(qw2+onorm), except in the cancellation zone (float64
    distance below ``zone_edge``*sqrt(qw2+onorm)), where the squared
    distance is held to ``tol``*(qw2+onorm).  Returns the max abs error
    of each kernel.
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
        rule = f"atol {tol:g}*sqrt(qw2+onorm)"
        zone = exact < zone_edge * scale  # expansion lost its digits
        bad_cells = diff > tol * scale
        kd = sc[fin].double()
        ek = ((kd - exact).abs() / scale)[~zone]
        ep = ((rs[fin].double() - exact).abs() / scale)[~zone]
        # In the zone the float32 expansion has lost its digits in both
        # versions, and no two float32 sums meet the atol there.  The
        # kernel's squared distance is held to float64 within 1e-6*(qw2+
        # onorm) at the default tol, ~17 float32 ulps of the expansion's
        # terms: a value far from the true one fails, one the expansion
        # cannot tell from 0 passes, so ranking there rests on the exact
        # re-rank.
        bad_zone = ((kd * kd - exact * exact).abs()
                    > tol * scale * scale)
        ez = ((kd * kd - exact * exact).abs() / (scale * scale))[zone]
        note = (f"; {int(zone.sum())} cells in the cancellation zone "
                f"(dist < {zone_edge:g}*sqrt(qw2+onorm)) held to "
                f"|k^2-d64^2| <= "
                f"{tol:g}*(qw2+onorm), max {_top(ez):.3g}; outside it max "
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
    # the keep pass and the mask: held bit for bit to the two passes
    # wherever these are held (``_same_scan``), so their errors are these
    hist_err = float((hg - rg).abs().max())
    return {"fused_query_hist": hist_err, "fused_query_scores": max_abs,
            "fused_query_keep": hist_err, "fused_query_mask": max_abs}


def _same_scan(torch, dev, inp, kw, two_pass, label) -> None:
    """The serving path's single scan on ``inp``: the keep pass's
    histograms equal the two-pass kernels' ``two_pass`` (hist_f, hist_g,
    scores), and the mask on its carry gives their scores bit for bit."""
    from repro_torch.kernels import fused_query

    hf, hg, sc = two_pass
    kf, kg, lf, dist = fused_query.fused_query_keep(*_pass_args(inp, "hist"),
                                                    **kw)
    fused_query.fused_query_mask(lf, inp["stop"], dist)
    _sync(torch, dev)
    _need(torch.equal(kf, hf) and torch.equal(kg, hg),
          f"{label}: the keep pass's histograms differ from pass 1's")
    diff = int((dist.view(torch.int32) != sc.view(torch.int32)).sum())
    _need(diff == 0, f"{label}: {diff} masked distances differ from pass "
          f"2's scores")
    say(f"{label}: the keep pass and the mask equal pass 1 and pass 2 bit "
        f"for bit")


def _top(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def _max_err(a, b):
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in {**a, **b}}


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _window_misses(torch, codes, x, proj, b_int, b_frac, w, width) -> int:
    """Codes outside the float64 window (``ref.hash_code_window``)."""
    from repro_torch.kernels import ref

    lo, hi = ref.hash_code_window(x, proj, b_frac, w, width)
    v = ref.unbias_codes(codes, b_int)
    bad = int(((v < lo) | (v > hi)).sum())
    del lo, hi, v
    return bad


def _check_hash_encode(torch, dev) -> float:
    """The kernel vs its plain version at the check shapes: both within the
    float64 window, and a row's codes the same in any batch."""
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.distances import radius_bounds
    from repro_torch.core.families import sample_lp_family
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.hash_encode import hash_encode

    err = 0.0
    for n, d, beta in HASH_SHAPES:
        x = torch.from_numpy(make_dataset(n, d, seed=d)).to(dev)
        weights = make_weight_set(8, d, n_subset=2, n_subrange=20,
                                  seed=d + 1)
        for p in (2.0, 1.0, 0.5):
            r_min, r_max = radius_bounds(weights[0], 10_000.0, max(p, 1.0))
            fam = sample_lp_family(d, beta, p, r_min, weights[0],
                                   r_max / r_min, 3, seed=d + 2)
            w, proj, b_int, b_frac = (
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (weights[0].astype(np.float32), fam.proj,
                          fam.b_int, fam.b_frac))
            got = hash_encode(x, w, proj, b_int, b_frac, fam.width)
            want = ref.hash_encode_ref(x, proj, b_int, b_frac, w, fam.width)
            _sync(torch, dev)
            differ = float((got != want).double().mean())
            gap = (ref.unbias_codes(got, b_int)
                   - ref.unbias_codes(want, b_int)).abs()
            err = max(err, _top(gap.double()))
            miss_k = _window_misses(torch, got, x, proj, b_int, b_frac, w,
                                    fam.width)
            miss_p = _window_misses(torch, want, x, proj, b_int, b_frac, w,
                                    fam.width)
            sat = int(((got == 2**31 - 1 + b_int) | (got == -(2**31) + b_int)
                       ).sum())
            # rows 0..63 as a 64-row batch, and each alone in a batch of 64
            # copies (the service pads a ragged batch by cycling its rows)
            batch = hash_encode(x[:64].contiguous(), w, proj, b_int, b_frac,
                                fam.width)
            alone = torch.stack([hash_encode(
                x[i].expand(64, d).contiguous(), w, proj, b_int, b_frac,
                fam.width)[0] for i in range(64)])
            same = (torch.equal(batch, got[:64])
                    and torch.equal(alone, got[:64]))
            say(f"kernels hash_encode p={p} n={n} d={d} "
                f"beta={beta}: outside the float64 window (E = 16 * 2^-24 "
                f"* S): kernel {miss_k}, plain {miss_p}; kernel != plain on "
                f"{differ:.3g} of codes; {sat} entries at the saturated "
                f"INT_MAX/INT_MIN + b_int; rows 0..63 in a 64-row and a "
                f"1-row batch {'equal' if same else 'DIFFER FROM'} the "
                f"full call")
            _need(miss_k == 0 and miss_p == 0,
                  f"hash_encode p={p} d={d}: codes outside the window")
            _need(same, f"hash_encode p={p} d={d}: codes depend on the batch")
            _need(differ == 0, f"hash_encode p={p} d={d}: kernel != plain")
            del got, want, gap, batch, alone
    return err


def _check_freq_level(torch, dev) -> float:
    """The kernel vs its plain version, exactly, for c in {2, 3}: at L = 16
    and Q = 64 on one input's codes read at both c, and at L = 24 (the
    wide c = 3 word test) with Q = 61 on real and on edge codes."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.freq_level import freq_level

    base = _kernel_inputs(1.0, CHECK_ROWS, seed=110, torch=torch, dev=dev)
    cases = [("", c, base) for c in (2, 3)]
    for i, c in enumerate((2, 3)):
        cases.append(("", c, _kernel_inputs(1.0, CHECK_ROWS, seed=150 + i,
                                            torch=torch, dev=dev, q=61, c=c,
                                            L=24)))
        cases.append(("edge codes ", c, _edge_inputs(CHECK_ROWS, 61, c, 24,
                                                     160 + i, torch, dev)))
    for label, c, inp in cases:
        args = (inp["codes_p"], inp["codes_q"], inp["mu"], inp["beta_q"])
        L = inp["n_levels"]
        got = freq_level(*args, c=c, n_levels=L)
        want = ref.freq_level_ref(*args[:3], c, L, inp["beta_q"])
        _sync(torch, dev)
        hist = torch.bincount(got.flatten().long(), minlength=L + 2)
        say(f"kernels freq_level {label}c={c} Q={got.shape[0]} "
            f"n={CHECK_ROWS} beta=512 L={L}: "
            f"{'exact' if torch.equal(got, want) else 'DIFFERS'}; levels "
            f"0..L+1 counted {hist.tolist()}")
        _need(torch.equal(got, want), f"freq_level {label}c={c} L={L} "
              f"differs from the plain version")
    return 0.0


def _check_weighted_lp(torch, dev) -> float:
    """The kernel vs its plain version to rtol 1e-5 for p in {1, 0.5, 1.5}
    (each of its three terms); p = 2 takes the norms expansion and
    launches nothing."""
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels.weighted_lp import weighted_lp

    err = 0.0
    for d in (400, 397):
        inp = _kernel_inputs(1.0, CHECK_ROWS, seed=120 + d % 2,
                             torch=torch, dev=dev, d=d)
        qs, pts = inp["queries"], inp["points"]
        w = inp["q_weight"][0].contiguous()
        for p in WLP_PS:
            got = weighted_lp(qs, pts, w, p)
            want = ref.weighted_lp_ref(qs, pts, w, p)
            _sync(torch, dev)
            diff = (got - want).abs().double()
            rel = _top(diff / want.double().abs().clamp_min(1e-30))
            err = max(err, _top(diff))
            say(f"kernels weighted_lp p={p} Q={qs.shape[0]} n={CHECK_ROWS} "
                f"d={d}: max abs err {_top(diff):.3g}, max rel {rel:.3g} "
                f"(rtol 1e-5)")
            _need(rel <= 1e-5, f"weighted_lp p={p} d={d} outside rtol 1e-5")
        before = _cuda.launch_counts()["weighted_lp"]
        ops.weighted_lp_dist(qs, pts, w, 2.0)
        _need(_cuda.launch_counts()["weighted_lp"] == before,
              "weighted_lp_dist launched the kernel for p = 2")
    say("kernels weighted_lp p=2: the norms expansion, no launch")
    return err


def _check_fused(torch, dev, inp, p, label):
    """Both fused passes against their plain versions on ``inp``, rows at
    and past ``n_rows - 777`` dead (``_hold``'s rules), and the single
    scan against both passes (``_same_scan``)."""
    from repro_torch.kernels import fused_query, ref

    n_rows = inp["codes_p"].shape[0]
    n_valid = n_rows - 777  # dead tail below the row count
    kw = dict(boff=0, n_valid=n_valid, c=inp["c"], n_levels=inp["n_levels"],
              p=p)
    row_ok = torch.arange(n_rows, device=dev) < n_valid
    hf, hg = fused_query.fused_query_hist(*_pass_args(inp, "hist"), **kw)
    sc = fused_query.fused_query_scores(*_pass_args(inp, "scores"), **kw)
    _sync(torch, dev)
    rf, rg = ref.fused_query_hist_ref(*_pass_args(inp, "hist"), row_ok,
                                      c=kw["c"], n_levels=kw["n_levels"], p=p)
    rs = ref.fused_query_scores_ref(*_pass_args(inp, "scores"), row_ok,
                                    c=kw["c"], n_levels=kw["n_levels"], p=p)
    _sync(torch, dev)
    q, beta = inp["codes_q"].shape
    err = _hold(torch, inp, p, (hf, hg, sc), (rf, rg, rs),
                f"{label} (Q={q} n={n_rows} beta={beta} c={inp['c']} "
                f"L={inp['n_levels']}; first frequent levels 0..L+2 "
                f"counted {rf.sum(0).tolist()})")
    _same_scan(torch, dev, inp, kw, (hf, hg, sc), label)
    return err


def phase_kernels(torch, dev):
    """Each kernel against its plain version on the card."""
    n_rows = CHECK_ROWS
    err = {}
    for i, p in enumerate((2.0, 1.0, 0.5)):
        inp = _kernel_inputs(p, n_rows, seed=100 + i, torch=torch, dev=dev)
        err = _max_err(err, _check_fused(torch, dev, inp, p,
                                         f"kernels p={p}"))
    # the word test's edges: c = 2 and 3 at L = 24 (IndexConfig's default
    # depth), Q = 61 ragged against the query block, on real codes and on
    # codes at the int32 extremes, the signs' meeting point and +-c^k
    for i, c in enumerate((2, 3)):
        inp = _kernel_inputs(2.0, n_rows, seed=130 + i, torch=torch, dev=dev,
                             q=61, c=c, L=24)
        err = _max_err(err, _check_fused(torch, dev, inp, 2.0,
                                         f"kernels c={c} L=24 p=2.0"))
        inp = _edge_inputs(n_rows, 61, c, 24, 140 + i, torch, dev)
        err = _max_err(err, _check_fused(torch, dev, inp, 2.0,
                                         f"kernels edge codes c={c} L=24 "
                                         f"p=2.0"))
    err["hash_encode"] = _check_hash_encode(torch, dev)
    err["freq_level"] = _check_freq_level(torch, dev)
    err["weighted_lp"] = _check_weighted_lp(torch, dev)
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


def _serve(torch, dev, svc, qpts, wids, reps: int):
    """Serve ``qpts`` ``reps`` times with every launch count set to 0 just
    before and read just after; per-batch latency from CUDA events around
    each ``Batcher.run_batch``.  Returns (runs, latencies ms, seconds,
    launch counts)."""
    from repro_torch.kernels import _cuda

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
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    runs = [svc.query(qpts, wids) for _ in range(reps)]
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    svc.batcher.run_batch = run_batch
    res = runs[-1]
    n, k = svc.plan.n, svc.cfg.k
    _need(res.ids.shape == (len(qpts), k) and res.dists.shape == res.ids.shape
          and bool(np.isfinite(res.dists[res.ids >= 0]).all())
          and bool((res.ids < n).all()), "answers malformed")
    for other in runs[:-1]:  # atomics in any order: identical answers
        _need(np.array_equal(other.ids, res.ids)
              and np.array_equal(other.dists, res.dists)
              and np.array_equal(other.stop_levels, res.stop_levels),
              "repeated runs of the same queries differ")
    return runs, lat, secs, launches


def _lat(lat) -> str:
    return (f"per-batch latency (CUDA events) p50 {np.percentile(lat, 50):.2f}"
            f" ms, p95 {np.percentile(lat, 95):.2f} ms")


def _peak(torch, dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _free(torch, svc) -> None:
    """Empty a service's state cache and return the device memory.  The
    serving legs here set ``offload_evicted=False``, so nothing is copied
    to the host on the way out; the next lease rebuilds the state."""
    svc.state_cache.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _state(svc, gi):
    """Group ``gi``'s state (built on first use).  It stays on the card
    after the lease: these services keep every group resident."""
    with svc.state_cache.lease(gi) as st:
        return st


def _served(n) -> dict:
    """The fused kernels' launches on a serving leg of ``n`` steps: the
    keep pass and the mask once a step (``None``: at least once), the
    two-pass kernels never."""
    return {"fused_query_keep": n, "fused_query_mask": n,
            "fused_query_hist": 0, "fused_query_scores": 0}


def _need_launches(launches, want: dict, leg: str) -> None:
    say(f"{leg} launches: {launches}")
    for name, cnt in want.items():
        _need(launches[name] == cnt if cnt is not None
              else launches[name] > 0,
              f"{leg}: kernel {name} launched {launches[name]} times, "
              f"expected {'> 0' if cnt is None else cnt}")


def phase_slice(torch, dev):
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
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
        k=k, q_batch=q_batch, offload_evicted=False, device=str(dev)))
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

    _reset_peak(torch, dev)
    runs, lat, t_q, launches = _serve(torch, dev, svc, qpts, wids,
                                      cf["reps"])
    peak = _peak(torch, dev)
    _need_launches(launches, {**_served(None), "hash_encode": 0,
                              "freq_level": 0, "weighted_lp": 0}, "slice")
    res = runs[-1]
    n_served = n_q * cf["reps"]
    say(f"slice serve: {cf['reps']} x {n_q} queries in {len(lat)} batches, "
        f"{t_q:.3f}s ({n_served / t_q:.1f} q/s), identical across runs; "
        f"{_lat(lat)}; peak device memory {peak} bytes; mean "
        f"stop level {res.stop_levels.mean():.2f}, mean n_checked "
        f"{res.n_checked.mean():.1f}")

    check = list(range(0, n_q, n_q // cf["n_check"]))[: cf["n_check"]]
    t0 = time.time()
    rows = _dense_check(host, qpts, wids, res, k, check)
    n_bad = sum(not ok for ok, _ in rows)
    detail = [info for ok, info in rows if not ok]
    say(f"slice check vs search_dense: {len(check) - n_bad}/{len(check)} "
        f"exact (stop, n_checked, ids){' ' + str(detail) if detail else ''} "
        f"({time.time() - t0:.1f}s)")
    _need(n_bad <= len(check) // 8,
          f"{n_bad} of {len(check)} queries disagree with search_dense")
    data_t = torch.from_numpy(data).to(dev).double()
    rec, ratio = _quality(torch, dev, data_t, weights, qpts, wids, res, k)
    del data_t
    say(f"slice recall@{k} vs exact brute force: {rec:.4f}; overall ratio "
        f"{ratio:.4f}")
    return dict(svc=svc, plan=plan, host=host, data=data, weights=weights,
                qpts=qpts, wids=wids, res=res, launches=launches,
                recall=rec, ratio=ratio, peak=peak, lat=lat)


def _widest(svc, plan) -> int:
    """The group with the widest padded state (ties: the most tables)."""
    return max(range(plan.n_groups), key=lambda g: (
        svc.group_config(g).beta, plan.groups[g].beta_group))


def _batch_inputs(svc, plan, qpts, wids, take, torch, dev):
    """The step inputs ``run_batch`` hands the kernels for the queries
    ``take`` (all of one group), with host-encoded query codes."""
    from repro_torch.index.builder import pad_cols

    gi = int(plan.group_of[wids[take[0]]])
    cfg = svc.group_config(gi)
    g = plan.groups[gi]
    slots = plan.member_slot[wids[take]]

    def put(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

    return gi, cfg, dict(
        codes_q=put(pad_cols(g.encode_host(qpts[take]), cfg.beta), np.int32),
        queries=put(qpts[take], np.float32),
        q_weight=put(plan.weights[wids[take]], np.float32),
        mu=put(g.mu_members[slots], np.int32),
        beta_q=put(g.beta_members[slots], np.int32),
        r_min=put(g.r_min_members[slots], np.float32),
        levels_q=put(g.n_levels_members[slots], np.int32),
        c=cfg.c, n_levels=cfg.n_levels,
    )


def _slice_pass_inputs(sl, torch, dev):
    """The inputs run_batch hands the kernels for one full batch of the
    group with the widest padded state, with the stop levels its step
    chose."""
    svc, plan, wids = sl["svc"], sl["plan"], sl["wids"]
    gi = _widest(svc, plan)
    cfg = svc.group_config(gi)
    rows = np.where(plan.group_of[wids] == gi)[0]
    take = rows[np.arange(cfg.q_batch) % len(rows)]
    _, _, inp = _batch_inputs(svc, plan, sl["qpts"], wids, take, torch, dev)
    st = _state(svc, gi)
    inp.update(codes_p=st.codes, points=st.points)
    step = svc.step_cache.get(dev, cfg)
    _, _, stop, _ = step(st, inp["queries"], inp["codes_q"], inp["q_weight"],
                         inp["mu"], inp["r_min"], inp["beta_q"],
                         inp["levels_q"])
    inp["stop"] = stop.contiguous()
    return gi, cfg, st, inp


def phase_encode(torch, dev, sl):
    """The device-encoded leg: the slice's plan exported without host
    codes, every state and every query encoded by the hash_encode kernel."""
    from repro_torch.index.engine import encode_queries
    from repro_torch.kernels import _cuda, ref
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf, plan, data = SLICE, sl["plan"], sl["data"]
    qpts, wids = sl["qpts"], sl["wids"]
    plan_nc = sl["host"].export_serving_plan(include_codes=False)
    _need(all(g.codes is None for g in plan_nc.groups), "plan ships codes")
    svc = RetrievalService(plan_nc, data, cfg=ServiceConfig(
        k=cf["k"], q_batch=cf["q_batch"], offload_evicted=False,
        device=str(dev)))
    _reset_peak(torch, dev)
    _cuda.reset_launch_counts()
    t0 = time.time()
    svc.warmup()
    _sync(torch, dev)
    t_build = time.time() - t0
    built = _cuda.launch_counts()
    _need_launches(built, {"hash_encode": plan_nc.n_groups,
                           **_served(0),
                           "freq_level": 0, "weighted_lp": 0}, "encode build")
    built = built["hash_encode"]
    say(f"encode build: {plan_nc.n_groups} states encoded on the card by "
        f"{built} hash_encode launches in {t_build:.2f}s, {svc.resident_bytes}"
        f" bytes resident; peak device memory {_peak(torch, dev)} bytes "
        f"(the host-code leg's states still resident)")

    # the widest group's codes against float64, the host codes and the
    # plain version on the card
    gi = _widest(svc, plan_nc)
    st = _state(svc, gi)
    bg = plan.groups[gi].beta_group
    ones = torch.ones(plan.d, dtype=torch.float32, device=dev)
    t0 = time.time()
    miss = _window_misses(torch, st.codes, st.points, st.proj, st.b_int,
                          st.b_frac, ones, 1.0)
    host_codes = torch.from_numpy(plan.groups[gi].codes).to(dev)
    vs_host = float((st.codes[: plan.n, :bg] != host_codes).double().mean())
    del host_codes
    plain = ref.hash_encode_ref(st.points, st.proj, st.b_int, st.b_frac,
                                ones, 1.0)
    vs_plain = float((st.codes != plain).double().mean())
    del plain
    say(f"encode codes (group {gi}, n={st.codes.shape[0]} "
        f"beta_pad={st.codes.shape[1]} d={plan.d}): {miss} outside the "
        f"float64 window (E = 16 * 2^-24 * S); {vs_host:.4f} of the "
        f"{plan.n}x{bg} real codes differ from the host float64 codes, "
        f"{vs_plain:.3g} of all from the plain version on the card "
        f"({time.time() - t0:.1f}s)")
    _need(miss == 0, "device-built codes outside the float64 window")
    _need(vs_plain == 0, "device-built codes differ from the plain version")

    # self-queries: 64 corpus rows spread over the corpus, no noise, under
    # random weight ids, and one batch holding a single real row
    rng = np.random.default_rng(11)
    rows = np.linspace(0, plan.n - 1, _SELF_QUERIES).astype(np.int64)
    sw = rng.integers(0, plan.n_weights, _SELF_QUERIES)
    own = svc.query(data[rows], sw)
    one = svc.query(data[rows[:1]], sw[:1])
    ids0 = np.concatenate([own.ids[:, 0], one.ids[:, 0]])
    d0 = np.concatenate([own.dists[:, 0], one.dists[:, 0]])
    want = np.concatenate([rows, rows[:1]])
    found = int(np.sum((ids0 == want) & (d0 < 1e-3)))
    enc = encode_queries(st, data[rows])
    same = torch.equal(enc, st.codes[torch.from_numpy(rows).to(dev)])
    say(f"encode self-queries: {found}/{len(want)} corpus rows are their own "
        f"rank-0 answer (distance < 1e-3); encode_queries of the group "
        f"{gi} rows {'equals' if same else 'DIFFERS FROM'} their state codes")
    _need(found == len(want) and same, "a corpus row missed itself")

    svc.query(qpts, wids)  # warm
    _sync(torch, dev)
    runs, lat, t_q, launches = _serve(torch, dev, svc, qpts, wids, 1)
    n_batches = len(lat)
    _need_launches(launches, {"hash_encode": n_batches,
                              **_served(n_batches),
                              "freq_level": 0, "weighted_lp": 0},
                   "encode serve")
    res = runs[-1]
    data_t = torch.from_numpy(data).to(dev).double()
    rec, ratio = _quality(torch, dev, data_t, sl["weights"], qpts, wids, res,
                          cf["k"])
    del data_t
    same_ids = int(np.sum(np.all(res.ids == sl["res"].ids, axis=1)))
    say(f"encode serve: {len(qpts)} queries in {n_batches} batches, "
        f"{t_q:.3f}s ({len(qpts) / t_q:.1f} q/s); {_lat(lat)} (query encode "
        f"on the card included); recall@{cf['k']} {rec:.4f} and overall "
        f"ratio {ratio:.4f} (host-code leg {sl['recall']:.4f} and "
        f"{sl['ratio']:.4f}); {same_ids}/{len(qpts)} queries with the "
        f"host-code leg's ids; hash_encode launches {built} build + "
        f"{launches['hash_encode']} = {built + launches['hash_encode']} = "
        f"{plan_nc.n_groups} groups + "
        f"{n_batches} batches")
    _need(built + launches["hash_encode"] == plan_nc.n_groups + n_batches,
          "hash_encode launches != groups + batches")
    _free(torch, svc)
    return dict(launches=built + launches["hash_encode"],
                weighted_lp=launches["weighted_lp"])


def phase_unfused(torch, dev, sl):
    """The unfused route on the card: the host-code plan served with
    use_kernels="off" (freq_level kernel, torch distances, histograms)."""
    from repro_torch.index.engine import _unfused_pass
    from repro_torch.kernels import ops
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf, plan = SLICE, sl["plan"]
    qpts, wids, fused = sl["qpts"], sl["wids"], sl["res"]
    svc = RetrievalService(plan, sl["data"], cfg=ServiceConfig(
        k=cf["k"], q_batch=cf["q_batch"], use_kernels="off",
        offload_evicted=False, device=str(dev)))
    svc.warmup()
    svc.query(qpts, wids)  # warm
    _sync(torch, dev)
    runs, lat, t_q, launches = _serve(torch, dev, svc, qpts, wids, 1)
    n_batches = len(lat)
    _need_launches(launches, {"freq_level": 2 * n_batches,
                              **_served(0),
                              "hash_encode": 0, "weighted_lp": 0},
                   "unfused serve")
    res = runs[-1]
    agree = ((res.stop_levels == fused.stop_levels)
             & (res.n_checked == fused.n_checked)
             & np.all(res.ids == fused.ids, axis=1))
    for qi in np.where(~agree)[0]:  # which good-level bins moved
        gi, cfg, inp = _batch_inputs(svc, plan, qpts, wids, np.array([qi]),
                                     torch, dev)
        st = _state(svc, gi)
        args = (inp["codes_q"], inp["queries"], inp["q_weight"], inp["mu"],
                inp["r_min"], inp["beta_q"])
        _, hg = ops.fused_query_block(
            st.codes, st.points, *args, boff=0, n_valid=st.n_valid, c=cfg.c,
            n_levels=cfg.n_levels, p=cfg.p)
        _, hg_u = _unfused_pass(st, *args, cfg, None)
        moved = {j: (int(hg[0, j]), int(hg_u[0, j]))
                 for j in range(cfg.n_levels + 1) if hg[0, j] != hg_u[0, j]}
        say(f"  unfused query {qi} (group {gi}): stop {res.stop_levels[qi]} "
            f"vs fused {fused.stop_levels[qi]}, n_checked "
            f"{res.n_checked[qi]} vs {fused.n_checked[qi]}; hist_g bins "
            f"(fused, unfused) that differ: {moved}")

    # pass 1 at the widest group: hist_f bins 0..L equal, and both routes
    # timed on the same batch (the kernel bench's fused-vs-unfused sweep)
    gi, cfg, st, inp = _slice_pass_inputs(sl, torch, dev)
    args = (inp["codes_q"], inp["queries"], inp["q_weight"], inp["mu"],
            inp["r_min"], inp["beta_q"])
    kw = dict(boff=0, n_valid=st.n_valid, c=cfg.c, n_levels=cfg.n_levels,
              p=cfg.p)

    def fused_pass():
        return ops.fused_query_block(st.codes, st.points, *args, **kw)

    def unfused_pass():
        return _unfused_pass(st, *args, cfg, None)

    hf, _ = fused_pass()
    hf_u, _ = unfused_pass()
    L = cfg.n_levels
    equal = torch.equal(hf[:, : L + 1], hf_u[:, : L + 1])
    t_f = _time_ms(fused_pass, torch, reps=3)
    t_u = _time_ms(unfused_pass, torch, reps=3)
    say(f"unfused serve: {len(qpts)} queries in {n_batches} batches, "
        f"{t_q:.3f}s ({len(qpts) / t_q:.1f} q/s); {_lat(lat)}; stop, "
        f"n_checked and ids equal to the fused leg's on "
        f"{int(agree.sum())}/{len(qpts)} queries")
    say(f"unfused pass 1 (group {gi}: n={st.codes.shape[0]} "
        f"beta_pad={st.codes.shape[1]} Q={cfg.q_batch} L={L}): hist_f bins "
        f"0..L {'equal to' if equal else 'DIFFER FROM'} the fused kernel's; "
        f"fused kernel {t_f:.3f} ms, unfused stages {t_u:.3f} ms "
        f"(freq_level kernel + torch distances + histograms)")
    _need(equal, "unfused hist_f differs from the fused kernel's")
    _need(int(agree.sum()) >= len(qpts) - 2,
          f"only {int(agree.sum())} queries agree with the fused leg")
    _free(torch, svc)
    return dict(launches=launches["freq_level"],
                weighted_lp=launches["weighted_lp"], pass1=(t_f, t_u))


def _same_answers(res, want) -> bool:
    return all(np.array_equal(getattr(res, f), getattr(want, f))
               for f in ("ids", "dists", "stop_levels", "n_checked"))


def phase_paged(torch, dev, sl):
    """The slice's queries through a service that keeps PAGED_SLOTS of
    the plan's group states on the card and pages the rest."""
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf, plan = SLICE, sl["plan"]
    qpts, wids = sl["qpts"], sl["wids"]
    _free(torch, sl["svc"])  # the unpaged leg's states leave the card
    svc = RetrievalService(plan, sl["data"], cfg=ServiceConfig(
        k=cf["k"], q_batch=cf["q_batch"], max_resident_groups=PAGED_SLOTS,
        device=str(dev)))
    t0 = time.time()
    svc.warmup()
    svc.query(qpts, wids)  # warm: every group offloaded once, allocator
    _sync(torch, dev)
    t_warm = time.time() - t0
    svc.reset_stats()
    pager = svc.batcher.pager
    n0 = len(pager.summary()["copy_ms"])
    _reset_peak(torch, dev)
    runs, lat, t_q, launches = _serve(torch, dev, svc, qpts, wids,
                                      cf["reps"])
    peak = _peak(torch, dev)
    want = {name: sl["launches"][name] for name in
            ("fused_query_hist", "fused_query_scores", "fused_query_keep",
             "fused_query_mask")}
    _need_launches(launches, dict(want, hash_encode=0, freq_level=0,
                                  weighted_lp=0), "paged")
    cache = svc.cache_summary()
    ps = pager.summary()
    copy_ms = np.array(ps["copy_ms"][n0:])
    copy_b = np.array(ps["copy_bytes"][n0:], np.float64)
    same = all(_same_answers(r, sl["res"]) for r in runs)
    n_served = len(qpts) * cf["reps"]
    qps = n_served / t_q
    say(f"paged serve: {cf['reps']} x {len(qpts)} queries with "
        f"{PAGED_SLOTS} of {plan.n_groups} group states on the card, "
        f"{len(lat)} batches, {t_q:.3f}s ({qps:.1f} q/s); {_lat(lat)}; "
        f"{cache['n_restores']} restores, {cache['n_evictions']} "
        f"evictions, {cache['n_hits']} hits, {cache['n_builds']} builds; "
        f"answers {'equal to' if same else 'DIFFER FROM'} the slice leg's "
        f"bit for bit; peak device memory {peak} bytes (slice leg "
        f"{sl['peak']}); warmup {t_warm:.1f}s")
    _need(same, "paged answers differ from the unpaged slice leg's")
    _need(cache["n_restores"] > 0, "the paged leg restored nothing")
    _need(len(copy_ms) == cache["n_restores"],
          f"{len(copy_ms)} timed copies for {cache['n_restores']} restores")
    _need(peak < sl["peak"], "paged peak memory not below the slice leg's")
    rate = copy_b / (copy_ms / 1e3)
    say(f"paged restores (CUDA events on the copy stream): "
        f"{copy_b.mean():.0f} bytes per restore mean ({copy_b.min():.0f}"
        f"-{copy_b.max():.0f}), {copy_ms.mean():.3f} ms mean, p50 "
        f"{np.percentile(copy_ms, 50):.3f} ms, p95 "
        f"{np.percentile(copy_ms, 95):.3f} ms, {rate.mean() / 1e9:.2f} "
        f"GB/s mean; {ps['pinned_bytes']} bytes of pinned host buffers "
        f"({ps['n_offloads']} offloads in the leg's life); cost model "
        f"{svc.state_cache.cost_model.bytes_per_s / 1e9:.2f} GB/s after "
        f"{svc.state_cache.cost_model.n_observed} timed misses")
    return dict(svc=svc, qps=qps, launches=launches)


def phase_async(torch, dev, sl, paged, shards=1, leg="async"):
    """Open-loop arrivals into the async frontend over the paged leg's
    service, driven by a ServiceDriver thread with DeadlinePrefetch
    (``shards`` launches of each pass a batch on a sharded service)."""
    from repro_torch.kernels import _cuda
    from repro_torch.serving import (AsyncRetrievalService,
                                     DeadlinePrefetch, ServiceDriver)

    qpts, wids = sl["qpts"], sl["wids"]
    svc = paged["svc"]
    rate = ASYNC_LOAD * paged["qps"]
    arrivals = np.cumsum(np.random.default_rng(17).exponential(
        1.0 / rate, len(qpts)))
    asvc = AsyncRetrievalService(svc, max_delay_ms=ASYNC_DELAY_MS)
    driver = ServiceDriver(asvc, prefetch=DeadlinePrefetch())
    svc.reset_stats()
    _cuda.reset_launch_counts()
    driver.start()
    futs, t_sub = [], []
    t0 = time.monotonic()
    try:
        for i in range(len(qpts)):
            delay = t0 + arrivals[i] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            t_sub.append(time.monotonic())
            futs.append(driver.submit(qpts[i], wids[i]))
        deadline = time.monotonic() + 300.0
        while not all(f.done() for f in futs):
            _need(time.monotonic() < deadline, f"{leg} futures unresolved")
            time.sleep(0.005)
    finally:
        driver.stop(drain=True)
    t_all = time.monotonic() - t0
    _sync(torch, dev)
    launches = _cuda.launch_counts()
    n_batches = sum(s["n_batches"] for s in svc.stats_summary().values())
    _need_launches(launches, {**_served(shards * n_batches),
                              "hash_encode": 0, "freq_level": 0,
                              "weighted_lp": 0}, leg)
    want = sl["res"]
    same = sum(
        np.array_equal(f.result().ids, want.ids[i])
        and np.array_equal(f.result().dists, want.dists[i])
        and f.result().stop_level == want.stop_levels[i]
        and f.result().n_checked == want.n_checked[i]
        for i, f in enumerate(futs))
    wait_ms = 1e3 * (np.array([f.t_resolved for f in futs])
                     - np.array(t_sub))
    cache, d = svc.cache_summary(), driver.stats
    model = svc.state_cache.cost_model
    say(f"{leg} serve: {len(qpts)} open-loop arrivals at {rate:.1f} q/s "
        f"({ASYNC_LOAD:.0%} of the paged leg's), deadline "
        f"{ASYNC_DELAY_MS} ms, {PAGED_SLOTS} of {svc.plan.n_groups} "
        f"states on the card: {asvc.n_launched_full} full / "
        f"{asvc.n_launched_deadline} deadline / {asvc.n_launched_drain} "
        f"drain launches ({n_batches} batches) in {t_all:.3f}s; "
        f"submit-to-resolve p50 {np.percentile(wait_ms, 50):.2f} ms, p95 "
        f"{np.percentile(wait_ms, 95):.2f} ms; {same}/{len(qpts)} answers "
        f"equal to the slice leg's")
    say(f"{leg} driver: {d.n_ticks} ticks, {d.n_launches} launches, "
        f"deadline misses {d.n_deadline_misses}/{d.n_deadlines_due}, "
        f"{d.n_prefetches_issued} prefetches issued; cache "
        f"{cache['n_restores']} restores ({cache['n_restore_overlapped']} "
        f"overlapped by a prefetch), {cache['n_prefetch_wasted']} wasted "
        f"prefetches, {cache['n_evictions']} evictions, {cache['n_hits']} "
        f"hits; cost model {model.bytes_per_s / 1e9:.2f} GB/s learned "
        f"over {model.n_observed} restores")
    _need(asvc.n_launched_drain == 0, "the driver left futures to drain")
    _need(same == len(qpts), f"{leg} answers differ from the slice leg's")
    _need(cache["n_restore_overlapped"] > 0,
          "no prefetch overlapped a restore")
    _free(torch, svc)
    return dict(launches=launches)


# ------------------------------------------------------------ obs and bf16


def _drain_parallel(est) -> None:
    """Run every queued shadow job, OBS_THREADS at a time (numpy releases
    the GIL inside the scan; the estimate sums integer counts, so the
    order of the jobs cannot change it)."""
    with ThreadPoolExecutor(max_workers=OBS_THREADS) as pool:
        list(pool.map(lambda _: est.run(), range(OBS_THREADS)))


def _offline_recall(sl, qids, res) -> float:
    """Micro-averaged recall of the answers ``res`` on the queries
    ``qids``, recomputed from scratch with ``scan_topk`` over the whole
    corpus (each sampled query's group holds every row)."""
    from repro_torch.index.streaming import scan_topk

    plan = sl["plan"]
    data = np.asarray(sl["data"], np.float32)
    ids = np.arange(len(data), dtype=np.int64)

    def one(qi):
        exact, _ = scan_topk(sl["qpts"][qi][None],
                             plan.weights[int(sl["wids"][qi])][None]
                             .astype(np.float32), ids, data, plan.p,
                             SLICE["k"])
        exact = {int(i) for i in exact[0] if i >= 0}
        served = {int(i) for i in res.ids[qi] if i >= 0}
        return len(served & exact), len(exact)

    with ThreadPoolExecutor(max_workers=OBS_THREADS) as pool:
        counts = list(pool.map(one, qids))
    rel = sum(r for _, r in counts)
    return sum(h for h, _ in counts) / rel if rel else float("nan")


def _check_spans(tracer, res, n_q: int, leg: str) -> list:
    """One finished, monotone span per query, ids 0..n_q-1, carrying the
    answer's stop level and n_checked."""
    spans = sorted(tracer.spans(), key=lambda s: s.query_id)
    _need(tracer.n_started == tracer.n_finished == n_q == len(spans),
          f"{leg}: {tracer.n_started} spans started, {tracer.n_finished} "
          f"finished, {len(spans)} kept for {n_q} queries")
    _need([s.query_id for s in spans] == list(range(n_q)),
          f"{leg}: span query ids are not 0..{n_q - 1}")
    _need(all(s.monotone for s in spans), f"{leg}: a span is not monotone")
    _need(all(s.stop_level == int(res.stop_levels[i])
              and s.n_checked == int(res.n_checked[i])
              for i, s in enumerate(spans)),
          f"{leg}: spans disagree with the answers' stop / n_checked")
    return spans


_STAGES = ("pass 1", "pass 2", "top-k", "re-rank", "H2D", "D2H", "rest")


def _trace_stages(path: str, window: str):
    """Device milliseconds per stage, and the device's idle share, from
    a Chrome trace exported by ``Profiler.stop_trace``.

    The window is the CPU range of the ``window`` annotation.  Device
    events (kernels, copies, memsets) are classed by name: the fused
    kernel's pass from its MODE template argument, copies by direction;
    the rest by the device-side ``wlsh_topk`` / ``wlsh_rerank`` range of
    ``engine.query_step`` they fall in, else "rest".  Idle share = 1 -
    (union of device event intervals) / window.
    """
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    cat = lambda e: str(e.get("cat", "")).lower()  # noqa: E731
    win = [e for e in xs if e.get("name") == window
           and cat(e) == "user_annotation"]
    _need(len(win) == 1, f"trace: {len(win)} '{window}' ranges")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev_ev = [e for e in xs if cat(e) in ("kernel", "gpu_memcpy",
                                          "gpu_memset")
              and w0 <= e["ts"] <= w1]
    names = {"wlsh_topk": "top-k", "wlsh_rerank": "re-rank"}
    gpu_ranges = [(e["ts"], e["ts"] + e["dur"], names[e["name"]])
                  for e in xs if cat(e) == "gpu_user_annotation"
                  and e.get("name") in names]
    ms = dict.fromkeys(_STAGES, 0.0)
    how = dict(name=0, device_range=0, rest=0)
    for e in dev_ev:
        name = e.get("name", "")
        m = (re.search(r"fused_query_kernel<(\d)", name)
             or re.search(r"fused_query_kernelILi(\d)E", name))
        stage = None
        if m:
            stage, key = ("pass 1" if m.group(1) == "0" else "pass 2"), "name"
        elif "fused_query_mask_kernel" in name:  # pass 2 on pass 1's carry
            stage, key = "pass 2", "name"
        elif cat(e) == "gpu_memcpy" and "HtoD" in name:
            stage, key = "H2D", "name"
        elif cat(e) == "gpu_memcpy" and "DtoH" in name:
            stage, key = "D2H", "name"
        if stage is None:
            mid = e["ts"] + e["dur"] / 2
            stage = next((st for a, b, st in gpu_ranges if a <= mid <= b),
                         None)
            key = "device_range"
        if stage is None:
            stage, key = "rest", "rest"
        ms[stage] += e["dur"] / 1e3
        how[key] += 1
    busy, end = 0.0, w0  # union of the device intervals in the window
    for a, b in sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                       for e in dev_ev):
        if b > end:
            busy += b - max(a, end)
            end = b
    window_ms = (w1 - w0) / 1e3
    return ms, 1.0 - busy / 1e3 / window_ms, window_ms, len(dev_ev), how


def _obs_service(torch, dev, sl, **kw):
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    svc = RetrievalService(sl["plan"], sl["data"], cfg=ServiceConfig(
        k=SLICE["k"], q_batch=SLICE["q_batch"], offload_evicted=False,
        recall_sample_rate=OBS_RATE, recall_floor=OBS_FLOOR,
        device=str(dev), **kw))
    svc.warmup()
    _sync(torch, dev)
    return svc


def phase_obs(torch, dev, sl, smi):
    """The slice's queries with the observability layer on: trace spans,
    shadow recall sampling, a torch.profiler capture, and the async
    frontend under a ServiceDriver with SLO alerting."""
    from repro_torch.kernels import _cuda
    from repro_torch.obs import (HealthMonitor, Tracer, default_rules,
                                 should_sample)
    from repro_torch.serving import (AsyncRetrievalService, ManualClock,
                                     ServiceDriver, replay_with_driver)

    qpts, wids, want = sl["qpts"], sl["wids"], sl["res"]
    n_q = len(qpts)
    _free(torch, sl["svc"])
    out_dir = os.path.join(ROOT, "build", "chip_smoke_obs")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    launches = dict.fromkeys(KERNELS, 0)

    def count(got):
        for name, v in got.items():
            launches[name] += v

    # ---- sync frontend --------------------------------------------------
    t0 = time.time()
    svc = _obs_service(torch, dev, sl)
    _need(svc.cfg.obs, "recall_sample_rate did not imply obs")
    t_build = time.time() - t0
    res = svc.query(qpts, wids)  # the first pass: spans 0..n_q-1
    _sync(torch, dev)
    _need(_same_answers(res, want), "obs-on answers differ from the slice "
          "leg's")
    _check_spans(svc.batcher.tracer, res, n_q, "obs sync")
    est = svc.batcher.recall
    n_offered = est.backlog
    t0 = time.time()
    _drain_parallel(est)
    t_drain = time.time() - t0
    sampled = [i for i in range(n_q) if should_sample(i, OBS_RATE)]
    _need(sorted(est.executed_ids()) == sampled and n_offered == len(sampled),
          "obs sync: the shadow-checked ids are not the hash-sampled set")
    est_sync = est.estimate()
    t0 = time.time()
    offline = _offline_recall(sl, sampled, res)
    t_off = time.time() - t0
    _need(est_sync == offline, f"obs sync: estimate {est_sync!r} != "
          f"offline recomputation {offline!r}")
    sum_ = est.summary()
    # then the slice leg's timed passes, obs on (their shadow jobs queue)
    runs, lat, t_q, got = _serve(torch, dev, svc, qpts, wids,
                                 SLICE["reps"])
    count(got)
    _need_launches(got, {**_served(None), "hash_encode": 0, "freq_level": 0,
                         "weighted_lp": 0}, "obs sync")
    _need(all(_same_answers(r, want) for r in runs), "obs-on answers differ "
          "from the slice leg's")
    tr = svc.batcher.tracer
    n_all = n_q * (1 + SLICE["reps"])
    _need(tr.n_started == tr.n_finished == n_all
          and all(s.monotone for s in tr.spans()),
          f"obs sync: {tr.n_started} spans for {n_all} queries")
    say(f"obs sync: {n_q} queries, obs on and recall_sample_rate "
        f"{OBS_RATE}: answers equal to the slice leg's bit for bit; one "
        f"monotone span per query; {len(sampled)} of the first {n_q} "
        f"sampled ({sampled[:6]}...), shadow recall {est_sync:.4f} equal "
        f"to the offline scan_topk recomputation; shadow drain "
        f"{t_drain:.2f}s on {OBS_THREADS} threads, offline {t_off:.2f}s; "
        f"build {t_build:.1f}s; summary {json.dumps(sum_)}")
    say(f"obs sync timed: {SLICE['reps']} x {n_q} queries in {len(lat)} "
        f"batches, {t_q:.3f}s ({n_q * SLICE['reps'] / t_q:.1f} q/s), "
        f"{n_all} spans; {_lat(lat)} (slice leg, obs off: p50 "
        f"{np.percentile(sl['lat'], 50):.2f} / p95 "
        f"{np.percentile(sl['lat'], 95):.2f} ms) [{smi}]")
    prof = svc.batcher.profiler.summary()
    say(f"obs profiler: {prof['n_compiles']} steps built; dispatch "
        + "; ".join(f"{row['count']} x {1e3 * row['mean_s']:.2f} ms"
                    for row in prof["dispatch"].values()))

    # ---- one pass under a torch.profiler capture ------------------------
    profiler = svc.batcher.profiler
    profiler.profile_dir = os.path.join(out_dir, "profile")
    _cuda.reset_launch_counts()
    _need(profiler.start_trace(), "profiler capture did not start")
    t0 = time.perf_counter()
    with torch.profiler.record_function("chip_smoke_obs_capture"):
        cap = svc.query(qpts, wids)
        _sync(torch, dev)
    t_cap = time.perf_counter() - t0
    snap = os.path.join(out_dir, "memory_snapshot.pickle")
    _need(profiler.save_memory_snapshot(snap) == (dev.type == "cuda"),
          "no memory snapshot of the card")
    _need(profiler.stop_trace(), "profiler capture did not stop")
    got = _cuda.launch_counts()
    count(got)
    _need(_same_answers(cap, want), "answers under the profiler differ")
    path = profiler.trace_paths[-1]
    ms, idle, window_ms, n_ev, how = _trace_stages(path,
                                                   "chip_smoke_obs_capture")
    busy = sum(ms.values())
    n_b = got["fused_query_keep"]
    _need(n_ev > 0 and ms["pass 1"] > 0 and ms["pass 2"] > 0,
          f"the capture holds {n_ev} device events and no fused pass")
    say(f"obs capture: {n_b} fused batches in {1e3 * t_cap:.1f} ms of host "
        f"time under torch.profiler ({os.path.getsize(path)} bytes of "
        f"trace, {n_ev} device events classed by {how}; memory snapshot "
        f"{os.path.getsize(snap) if os.path.exists(snap) else 0} bytes)")
    say("obs stages (device ms over the pass, per batch, share of device "
        "busy time): " + "; ".join(
            f"{st} {ms[st]:.3f} ({ms[st] / max(n_b, 1):.3f}, "
            f"{ms[st] / busy:.1%})" for st in _STAGES)
        + f"; device busy {busy:.3f} ms of a {window_ms:.3f} ms window, "
        f"idle share {idle:.1%} [{smi}]")
    # the same device work over the wall time of a timed pass, which ran
    # the same 7 batches without the profiler's host overhead
    t_pass = t_q / SLICE["reps"]
    idle_free = 1.0 - busy / (1e3 * t_pass)
    say(f"obs idle share without the profiler (the capture's device busy "
        f"time over a timed pass's {1e3 * t_pass:.1f} ms of wall time): "
        f"{idle_free:.1%}")
    stages = dict(ms=ms, idle=idle, idle_free=idle_free,
                  window_ms=window_ms)
    _free(torch, svc)
    del svc, est
    _release(torch)

    # ---- async frontend under a driver with SLO alerting ----------------
    svc = _obs_service(torch, dev, sl)
    asvc = AsyncRetrievalService(svc, max_delay_ms=ASYNC_DELAY_MS,
                                 clock=ManualClock())
    health = HealthMonitor(svc.batcher.metrics, default_rules())
    driver = ServiceDriver(asvc, health=health)
    arrivals = np.cumsum(np.random.default_rng(19).exponential(
        1.0 / OBS_ARRIVALS, n_q))
    _cuda.reset_launch_counts()
    t0 = time.time()
    res_a, waits = replay_with_driver(driver, qpts, wids, arrivals)
    _sync(torch, dev)
    t_a = time.time() - t0
    got = _cuda.launch_counts()
    count(got)
    n_batches = sum(s["n_batches"] for s in svc.stats_summary().values())
    _need_launches(got, {**_served(n_batches), "hash_encode": 0,
                         "freq_level": 0, "weighted_lp": 0}, "obs async")
    _need(_same_answers(res_a, want), "obs async answers differ from the "
          "slice leg's")
    tr = svc.batcher.tracer
    spans = _check_spans(tr, res_a, n_q, "obs async")
    _need(all(s.cause in ("full", "deadline", "drain") for s in spans),
          "obs async: a span without a launch cause")
    est = svc.batcher.recall
    n_idle = len(est.executed_ids())
    _drain_parallel(est)
    _need(sorted(est.executed_ids()) == sampled,
          "obs async: sampled set differs from the sync leg's")
    _need(est.estimate() == est_sync, "obs async: estimate differs from "
          "the sync leg's")
    summary = driver.tick_summary()
    hs = health.summary()

    # ---- exports round-trip through their loaders -------------------------
    p_t = os.path.join(out_dir, "spans.jsonl")
    p_m = os.path.join(out_dir, "metrics.json")
    p_a = os.path.join(out_dir, "alerts.jsonl")
    n_sp = tr.export_jsonl(p_t)
    back = Tracer.load_jsonl(p_t)
    meta = Tracer.load_jsonl_meta(p_t)
    _need(n_sp == n_q and [json.dumps(s.to_dict()) for s in back]
          == [json.dumps(s.to_dict()) for s in tr.spans()]
          and meta["n_started"] == meta["n_finished"] == n_q,
          "trace export does not round-trip")
    snap_m = svc.batcher.metrics.snapshot()
    with open(p_m, "w") as fh:
        fh.write(svc.batcher.metrics.to_json())
    with open(p_m) as fh:
        _need(json.dumps(json.load(fh), sort_keys=True)
              == json.dumps(snap_m, sort_keys=True),
              "metrics export does not round-trip")
    n_al = health.export_jsonl(p_a)
    with open(p_a) as fh:
        lines = [json.loads(x) for x in fh if x.strip()]
    _need([json.dumps(x) for x in lines]
          == [json.dumps(a.to_dict()) for a in health.alerts()],
          "alert export does not round-trip")
    d = driver.stats
    say(f"obs async: {n_q} arrivals at {OBS_ARRIVALS:.0f} q/s on a manual "
        f"clock, deadline {ASYNC_DELAY_MS} ms, {n_batches} launches "
        f"({asvc.n_launched_full} full / {asvc.n_launched_deadline} "
        f"deadline / {asvc.n_launched_drain} drain) in {t_a:.2f}s of host "
        f"time; answers equal to the slice leg's; one monotone span per "
        f"query with its cause; {n_idle} of {len(sampled)} shadow jobs run "
        f"on {d.n_ticks} driver ticks, the rest drained; sampled set and "
        f"estimate equal to the sync leg's; alerts over {hs['tick']} "
        f"ticks: firing {hs['firing']}, {n_al} events (recall_floor "
        f"{OBS_FLOOR}); {summary}")
    say(f"obs exports: {n_sp} spans, {os.path.getsize(p_m)} bytes of "
        f"metrics, {n_al} alert events, each equal after a reload")
    _free(torch, svc)
    return dict(launches=launches, stages=stages, lat=lat)


def _rne_bits(x: np.ndarray) -> np.ndarray:
    """bfloat16 bits of float32 ``x`` rounded to nearest even (finite
    values), computed on the host apart from torch."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def phase_bf16(torch, dev, sl, smi):
    """The host-code plan served from bfloat16 vector storage."""
    from repro_torch.kernels import fused_query, ref
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf, plan = SLICE, sl["plan"]
    qpts, wids, want = sl["qpts"], sl["wids"], sl["res"]
    _free(torch, sl["svc"])
    kw = dict(k=cf["k"], q_batch=cf["q_batch"], vec_dtype="bfloat16",
              device=str(dev))
    svc = RetrievalService(plan, sl["data"], cfg=ServiceConfig(
        offload_evicted=False, **kw))
    t0 = time.time()
    svc.warmup()
    _sync(torch, dev)
    t_build = time.time() - t0
    states = [_state(svc, g) for g in range(plan.n_groups)]
    held = sum(st.nbytes for st in states)
    _need(all(st.points.dtype == torch.bfloat16 for st in states),
          "bf16 leg: a state's vectors are not bfloat16")
    # state_nbytes also prices the n_valid scalar the JAX package keeps
    # on the device (4 bytes a state; here a host int)
    _need(held + 4 * len(states) == svc.resident_bytes,
          f"bf16 leg: states hold {held} bytes, state_nbytes prices "
          f"{svc.resident_bytes}")
    gi = _widest(svc, plan)
    st = states[gi]
    data = np.asarray(sl["data"], np.float32)
    bits = st.points[: plan.n].view(torch.int16).cpu().numpy()
    _need(np.array_equal(bits.view(np.uint16), _rne_bits(data)),
          "bf16 leg: stored bits are not float32 rounded to nearest even")
    widest_bytes = st.nbytes
    del states, st, bits
    svc.query(qpts, wids)  # warm
    _sync(torch, dev)
    _reset_peak(torch, dev)
    runs, lat, t_q, launches = _serve(torch, dev, svc, qpts, wids,
                                      cf["reps"])
    peak = _peak(torch, dev)
    _need_launches(launches, {**_served(None), "hash_encode": 0,
                              "freq_level": 0, "weighted_lp": 0}, "bf16")
    res = runs[-1]
    qps = len(qpts) * cf["reps"] / t_q
    rows_equal = int(sum(np.array_equal(res.ids[i], want.ids[i])
                         for i in range(len(qpts))))
    stop_equal = int(np.sum(res.stop_levels == want.stop_levels))
    common = sum(len(set(res.ids[i].tolist()) & set(want.ids[i].tolist())
                     - {-1}) for i in range(len(qpts)))
    data_t = torch.from_numpy(data).to(dev).double()
    rec, ratio = _quality(torch, dev, data_t, sl["weights"], qpts, wids, res,
                          cf["k"])
    del data_t

    # ---- both fused kernels on the bf16 state vs their plain versions ----
    _, cfg, st, inp = _slice_pass_inputs(dict(sl, svc=svc), torch, dev)
    n, d = st.points.shape
    kwp = dict(boff=0, n_valid=st.n_valid, c=cfg.c, n_levels=cfg.n_levels,
               p=cfg.p)
    row_ok = torch.arange(n, device=dev) < st.n_valid
    out_k = list(fused_query.fused_query_hist(*_pass_args(inp, "hist"),
                                              **kwp))
    out_k.append(fused_query.fused_query_scores(*_pass_args(inp, "scores"),
                                                **kwp))
    _sync(torch, dev)
    out_p = list(ref.fused_query_hist_ref(*_pass_args(inp, "hist"), row_ok,
                                          c=cfg.c, n_levels=cfg.n_levels,
                                          p=cfg.p))
    out_p.append(ref.fused_query_scores_ref(
        *_pass_args(inp, "scores"), row_ok, c=cfg.c, n_levels=cfg.n_levels,
        p=cfg.p))
    err = _hold(torch, inp, cfg.p, out_k, out_p,
                f"bf16 kernels (group {gi}, bfloat16 rows)", zone_edge=BF16_ZONE)
    _same_scan(torch, dev, inp, kwp, out_k,
               f"bf16 kernels (group {gi}, bfloat16 rows)")
    wide = dict(inp, points=st.points.float())
    out_w = list(fused_query.fused_query_hist(*_pass_args(wide, "hist"),
                                              **kwp))
    out_w.append(fused_query.fused_query_scores(*_pass_args(wide, "scores"),
                                                **kwp))
    _need(all(torch.equal(a, b) for a, b in zip(out_k, out_w)),
          "bf16 kernels differ from the float32 kernels on the widened rows")
    del wide, out_w, out_p, out_k

    # ---- no (B, d) float32 copy of the rows on a pass ---------------------
    _sync(torch, dev)
    _reset_peak(torch, dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    svc.query(qpts, wids)
    _sync(torch, dev)
    rise = _peak(torch, dev) - base
    _need(rise < n * d * 4, f"bf16 leg: a pass allocated {rise} bytes, a "
          f"float32 copy of the rows is {n * d * 4}")
    say(f"bf16 kernels: the widest state's {n} x {d} bfloat16 rows through "
        f"both fused kernels equal their plain versions (above) and the "
        f"float32 kernels on the widened rows bit for bit; a pass raised "
        f"peak device memory by {rise} bytes, under the {n * d * 4} bytes "
        f"of a float32 copy")
    del st, inp
    _free(torch, svc)

    # ---- paged round trip --------------------------------------------------
    paged = RetrievalService(plan, sl["data"], cfg=ServiceConfig(
        max_resident_groups=PAGED_SLOTS, **kw))
    paged.warmup()
    paged.query(qpts, wids)  # every group evicted and restored once
    _sync(torch, dev)
    paged.reset_stats()
    pager = paged.batcher.pager
    n0 = len(pager.summary()["copy_ms"])
    p_runs, p_lat, p_t, p_launch = _serve(torch, dev, paged, qpts, wids, 1)
    cache = paged.cache_summary()
    ps = pager.summary()
    copy_ms = np.array(ps["copy_ms"][n0:])
    copy_b = np.array(ps["copy_bytes"][n0:], np.float64)
    hosts = [g.host for g in pager._groups.values() if g.host is not None]
    _need(_same_answers(p_runs[-1], res), "bf16 paged answers differ from "
          "the unpaged bf16 leg's")
    _need(cache["n_restores"] > 0 and len(copy_ms) == cache["n_restores"],
          "bf16 paged: no timed restore")
    _need(hosts and all(h.points.dtype == torch.bfloat16
                        and (h.points.is_pinned() or dev.type != "cuda")
                        for h in hosts),
          "bf16 paged: host buffers are not pinned bfloat16")
    say(f"bf16 serve: {cf['reps']} x {len(qpts)} queries in {len(lat)} "
        f"batches, {t_q:.3f}s ({qps:.1f} q/s); {_lat(lat)} (float32 slice "
        f"leg p50 {np.percentile(sl['lat'], 50):.2f} / p95 "
        f"{np.percentile(sl['lat'], 95):.2f} ms); states {held} bytes "
        f"resident (widest {widest_bytes}), peak device memory {peak} bytes "
        f"(float32 slice leg {sl['peak']}); build {t_build:.1f}s; "
        f"recall@{cf['k']} {rec:.4f}, ratio {ratio:.4f} (float32 leg "
        f"{sl['recall']:.4f}, {sl['ratio']:.4f}); {stop_equal}/{len(qpts)} "
        f"stop levels and {rows_equal}/{len(qpts)} id lists equal to the "
        f"float32 leg's, {common}/"
        f"{cf['k'] * len(qpts)} ids in common [{smi}]")
    say(f"bf16 paged: {PAGED_SLOTS} of {plan.n_groups} states on the card, "
        f"{len(p_lat)} batches, {_lat(p_lat)}; {cache['n_restores']} "
        f"restores of {copy_b.mean():.0f} bytes mean, {copy_ms.mean():.3f} ms "
        f"mean, {(copy_b / (copy_ms / 1e3)).mean() / 1e9:.2f} GB/s; pinned "
        f"bfloat16 host buffers, {ps['pinned_bytes']} bytes; answers equal "
        f"to the unpaged bf16 leg's bit for bit")
    launches = {k: launches[k] + p_launch[k] for k in launches}
    _free(torch, paged)
    return dict(launches=launches, err=err)


def _excluding(torch, fn, excluded: dict):
    """Run ``fn`` and add the kernel launches it makes to ``excluded``:
    a check's launches (the step on a fresh reference build) are not the
    main path's."""
    from repro_torch.kernels import _cuda

    before = _cuda.launch_counts()
    out = fn()
    for name, cnt in _cuda.launch_counts().items():
        excluded[name] = excluded.get(name, 0) + cnt - before[name]
    return out


def _timed_calls(torch, obj, name, times: list, keep=lambda out: True):
    """Wrap ``obj.name`` so that each call whose result ``keep`` accepts
    appends its milliseconds (CUDA events) to ``times``."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(*a, **kw)
        e.record()
        e.synchronize()
        if keep(out):
            times.append(s.elapsed_time(e))
        return out

    setattr(obj, name, timed)


def _self_found(res, pids) -> np.ndarray:
    """Which inserts came back as their own rank-0 answer at distance 0."""
    return (res.ids[:, 0] == np.asarray(pids)) & (res.dists[:, 0] == 0.0)


def _fresh_answers(torch, dev, svc, plan, gi, state, id_map, qpts, wids):
    """The group's queries answered by ``svc``'s step on ``state`` (a
    fresh build), in batches padded as ``run_batch`` pads them, state
    rows mapped to global ids through ``id_map``: (rows, ids, dists,
    stop, n_checked)."""
    rows = np.where(plan.group_of[wids] == gi)[0]
    cfg = svc.group_config(gi)
    step = svc.step_cache.get(dev, cfg)
    outs = []
    for lo in range(0, len(rows), cfg.q_batch):
        chunk = rows[lo:lo + cfg.q_batch]
        take = chunk[np.arange(cfg.q_batch) % len(chunk)]
        _, _, inp = _batch_inputs(svc, plan, qpts, wids, take, torch, dev)
        out = step(state, inp["queries"], inp["codes_q"], inp["q_weight"],
                   inp["mu"], inp["r_min"], inp["beta_q"], inp["levels_q"])
        outs.append([t.cpu().numpy()[:len(chunk)] for t in out])
    d, ids, stop, chk = (np.concatenate(x) for x in zip(*outs))
    ids = ids.astype(np.int64)
    live = ids >= 0
    ids[live] = id_map[ids[live]]
    return rows, ids.astype(np.int32), d, stop, chk


def _equal_states(torch, a, b) -> bool:
    return (a.n_valid == b.n_valid and torch.equal(a.codes, b.codes)
            and torch.equal(a.points, b.points))


def _stream_inserts(data, n_weights, m, seed):
    """``m`` fresh rows past the corpus range, as the launcher's mixed
    replay makes them (a noisy corpus row + the value range + 7 per
    insert), under weight ids spread uniformly over the plan's."""
    rng = np.random.default_rng(seed)
    src = rng.choice(len(data), m, replace=False)
    vecs = (data[src] + rng.normal(0, 3.0, (m, data.shape[1]))
            + 10_000.0 + 7.0 * np.arange(m)[:, None]).astype(np.float32)
    return vecs, rng.permutation(np.arange(m) % n_weights)


def _release(torch) -> None:
    """Collect dropped services: their states and pinned host buffers."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_stream(torch, dev, sl, smi):
    """Streaming on the card: the slice's queries interleaved with inserts
    into a paged service with reserved row capacity, sealed, compacted
    into the states on the card, held to fresh union builds, paged,
    deleted and purged (``_stream_host_codes``); then the plan without
    host codes, sealed through the hash_encode kernel
    (``_stream_codeless``)."""
    from repro_torch.kernels import _cuda
    from repro_torch.serving import delta as delta_mod
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf, plan = SLICE, sl["plan"]
    _free(torch, sl["svc"])  # the unpaged leg's states leave the card
    scfg = dict(k=cf["k"], q_batch=cf["q_batch"],
                max_resident_groups=PAGED_SLOTS,
                delta_seal_rows=STREAM["seal_rows"],
                delta_reserve_rows=STREAM["reserve"], device=str(dev))
    svc = RetrievalService(plan, sl["data"], cfg=ServiceConfig(**scfg))
    cap = svc.batcher.row_capacity()
    _need(cap % 128 != 0, "the capacity is a multiple of the 128-row tile")
    t0 = time.time()
    svc.warmup()
    _sync(torch, dev)
    t_warm = time.time() - t0
    svc.reset_stats()
    delta, cache = svc.batcher.delta_index(), svc.state_cache

    # timers: each seal and compaction (CUDA events), each exact scan
    # (host clock) and each batch (CUDA events, by step of the leg)
    seal_ms, compact_ms, scan_ms, lat, leg = [], [], [], {}, ["mixed"]
    seen = [0]

    def sealed(_):
        grew, seen[0] = delta.stats.n_seals > seen[0], delta.stats.n_seals
        return grew

    _timed_calls(torch, delta, "seal", seal_ms, keep=sealed)
    restored, compact_group = [], delta._compact_group

    def counted_compaction(gi, strict=True):
        r0 = cache.stats.n_restores
        rows = compact_group(gi, strict)
        if rows:
            restored.append(cache.stats.n_restores > r0)
        return rows

    delta._compact_group = counted_compaction
    _timed_calls(torch, delta, "_compact_group", compact_ms,
                 keep=lambda rows: rows > 0)
    scan = delta_mod.scan_topk

    def timed_scan(*a, **kw):
        t = time.perf_counter()
        out = scan(*a, **kw)
        scan_ms.append(1e3 * (time.perf_counter() - t))
        return out

    run_batch = svc.batcher.run_batch

    def timed_batch(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = run_batch(*a, **kw)
        e.record()
        e.synchronize()
        lat.setdefault(leg[0], []).append(s.elapsed_time(e))
        return out

    svc.batcher.run_batch = timed_batch
    excluded: dict = {}
    delta_mod.scan_topk = timed_scan
    _cuda.reset_launch_counts()
    try:
        out = _stream_host_codes(torch, dev, svc, sl, leg, excluded, smi)
    finally:
        delta_mod.scan_topk = scan
    main = {name: cnt - excluded.get(name, 0)
            for name, cnt in _cuda.launch_counts().items()}
    n_batches = sum(len(v) for v in lat.values())
    _need_launches(main, {**_served(n_batches), "hash_encode": 0,
                          "freq_level": 0, "weighted_lp": 0},
                   "stream (host codes)")
    ds = svc.delta_summary()
    say(f"stream counters: {ds['n_inserts']} inserts, {ds['n_deletes']} "
        f"deletes, {ds['n_seals']} seals, {ds['n_compactions']} "
        f"compactions ({sum(restored)} of {len(restored)} appends into a "
        f"state the lease restored), {ds['n_rows_compacted']} rows "
        f"compacted, {ds['n_purges']} purges ({ds['n_rows_purged']} rows "
        f"purged), {out['rebuilds']} rebuilds after the purge, "
        f"{ds['n_delta_scans']} delta scans, {n_batches} batches; capacity "
        f"{cap} rows ({cap % 128} past the last 128-row tile) [{smi}]")
    pend, post = np.array(lat["pending"]), np.array(lat["compacted"])
    say(f"stream timing: {np.mean(seal_ms):.3f} ms per seal (p50 "
        f"{np.percentile(seal_ms, 50):.3f}, {len(seal_ms)} seals, host "
        f"float64 encode), {np.mean(compact_ms):.3f} ms per compaction (p50 "
        f"{np.percentile(compact_ms, 50):.3f}, {len(compact_ms)}: lease, "
        f"append on the card, replace; CUDA events); exact scan "
        f"{np.mean(scan_ms):.3f} ms of host per batch (p50 "
        f"{np.percentile(scan_ms, 50):.3f}, p95 "
        f"{np.percentile(scan_ms, 95):.3f}, {len(scan_ms)} scans); per "
        f"batch with rows pending p50 {np.percentile(pend, 50):.2f} / p95 "
        f"{np.percentile(pend, 95):.2f} ms ({len(pend)} batches), after "
        f"compaction p50 {np.percentile(post, 50):.2f} / p95 "
        f"{np.percentile(post, 95):.2f} ms ({len(post)}); purge "
        f"{out['purge_s']:.3f} s, then {out['rebuild_s']:.3f} s for the "
        f"next pass with its rebuilds, peak device memory "
        f"{out['purge_peak']} bytes; warmup {t_warm:.1f} s [{smi}]")
    del svc, delta, cache, run_batch, compact_group
    _release(torch)
    nc = _stream_codeless(torch, dev, sl, scfg, smi)
    return dict(launches={name: main[name] + nc[name] for name in main})


def _stream_host_codes(torch, dev, svc, sl, leg, excluded, smi):
    """The stream leg's host-code plan: the mixed stream, the insert
    self-queries before and after compaction, states and answers held to
    fresh union builds, an evict/restore cycle, deletes, and the purge
    held to a fresh build over the survivors."""
    from repro_torch.index.builder import build_group_state, seal_segment

    cf, plan, data = SLICE, sl["plan"], sl["data"]
    qpts, wids = sl["qpts"], sl["wids"]
    n, cache, m = plan.n, svc.state_cache, STREAM["inserts"]
    ins, ins_w = _stream_inserts(data, plan.n_weights, m, seed=19)
    ins_g = plan.group_of[ins_w]

    # 1. the mixed stream: the i-th query op asks qpts[i] and the j-th
    # insert op inserts ins[j]; the queries between two inserts go in one
    # call, answered with every earlier insert visible
    order = np.random.default_rng(23).permutation(
        np.r_[np.zeros(len(qpts), bool), np.ones(m, bool)])
    pids, run, n_calls, qi = [], [], 0, 0
    t0 = time.time()
    for is_ins in order:
        if not is_ins:
            run.append(qi)
            qi += 1
            continue
        if run:
            svc.query(qpts[run], wids[run])
            n_calls, run = n_calls + 1, []
        j = len(pids)
        pids.append(svc.insert(ins[j], int(ins_w[j])))
    if run:
        svc.query(qpts[run], wids[run])
        n_calls += 1
    _sync(torch, dev)
    t_mixed = time.time() - t0
    pids = np.asarray(pids, np.int64)
    ds = svc.delta_summary()
    say(f"stream mixed: {len(qpts)} queries in {n_calls} calls interleaved "
        f"with {m} inserts over {plan.n_weights} weight ids (groups "
        f"{np.bincount(ins_g, minlength=plan.n_groups).tolist()}) in "
        f"{t_mixed:.2f} s; {ds['n_seals']} seals at "
        f"{STREAM['seal_rows']} rows, {ds['n_pending']} rows pending; "
        f"{PAGED_SLOTS} of {plan.n_groups} states on the card [{smi}]")
    _need(np.array_equal(pids, n + np.arange(m)),
          "insert ids do not continue the corpus")

    # 2. every insert found by the exact scan, and the 256 queries with
    # rows pending: the far inserts leave the slice leg's answers as they
    # were, bit for bit
    leg[0] = "self"
    pre = int(_self_found(svc.query(ins, ins_w), pids).sum())
    leg[0] = "pending"
    runs = [svc.query(qpts, wids) for _ in range(cf["reps"])]
    pending_same = all(_same_answers(r, sl["res"]) for r in runs)
    say(f"stream pre-compaction: {pre}/{m} insert self-queries at rank 0, "
        f"distance 0 (exact scan); the {len(qpts)} queries with {m} rows "
        f"pending "
        f"{'equal' if pending_same else 'DIFFER FROM'} the slice leg's "
        f"answers bit for bit")
    _need(pre == m, "an insert missed itself before compaction")
    _need(pending_same, "pending rows changed the slice's answers")

    # 3. compaction into the reserved rows on the card, then the inserts
    # found by the fused kernels over the appended rows
    leg[0] = "compact"
    absorbed = svc.compact()
    _need(absorbed == m, f"compaction absorbed {absorbed} of {m} rows")
    leg[0] = "self"
    post = int(_self_found(svc.query(ins, ins_w), pids).sum())
    leg[0] = "compacted"
    runs = [svc.query(qpts, wids) for _ in range(cf["reps"])]
    res_post = runs[-1]
    post_same = all(_same_answers(r, sl["res"]) for r in runs)
    n_valid = {}

    # 4. and 5. every group's state and answers against a fresh build over
    # its union corpus, on the card
    def union_check():
        n_state, n_ans = 0, 0
        for gi in range(plan.n_groups):
            sel = np.where(ins_g == gi)[0]
            cfg, g = svc.group_config(gi), plan.groups[gi]
            fresh = build_group_state(
                cfg, data, g, dev, extra_points=ins[sel],
                extra_codes=seal_segment(cfg, g, ins[sel]))
            with svc.batcher.lease(gi) as st:
                n_state += _equal_states(torch, st, fresh)
                n_valid[gi] = st.n_valid
            rows, ids, d, stop, chk = _fresh_answers(
                torch, dev, svc, plan, gi, fresh,
                np.concatenate([np.arange(n), pids[sel]]), qpts, wids)
            n_ans += int(np.sum(
                np.all(ids == res_post.ids[rows], axis=1)
                & np.all(d == res_post.dists[rows], axis=1)
                & (stop == res_post.stop_levels[rows])
                & (chk == res_post.n_checked[rows])))
            del fresh
        return n_state, n_ans

    n_state, n_ans = _excluding(torch, union_check, excluded)
    wide = _widest(svc, plan)
    say(f"stream post-compaction: {post}/{m} insert self-queries at rank 0, "
        f"distance 0 (fused kernels over the appended rows; n_valid "
        f"{n_valid} of {svc.batcher.row_capacity()}, the widest group {wide}"
        f" at {n_valid[wide] % 128} rows into its last 128-row tile); "
        f"{n_state}/{plan.n_groups} compacted states torch.equal a fresh "
        f"union build on the card (codes, points, n_valid); {n_ans}/"
        f"{len(qpts)} answers equal the fresh builds' (ids, dists, stop, "
        f"n_checked) and the slice leg's "
        f"{'too' if post_same else 'NOT'} [{smi}]")
    _need(post == m, "an insert missed itself after compaction")
    _need(n_state == plan.n_groups, "a compacted state differs from a "
          "fresh union build")
    _need(n_ans == len(qpts) and post_same,
          "answers over compacted states differ from a fresh build's")

    # 6. every group evicted to its pinned buffers and restored
    leg[0] = "paged"
    r0, pinned0 = cache.stats.n_restores, svc.batcher.pager.pinned_bytes
    cache.clear()
    res_paged = svc.query(qpts, wids)
    restores = cache.stats.n_restores - r0
    same = _same_answers(res_paged, res_post)
    pinned = svc.batcher.pager.pinned_bytes
    say(f"stream paging: every compacted state evicted and {restores} "
        f"restored, answers {'unchanged' if same else 'CHANGED'}; pinned "
        f"host buffers {pinned} bytes ({pinned0} before the cycle)")
    _need(same, "answers changed across an evict/restore cycle")
    _need(restores >= plan.n_groups and pinned == pinned0,
          "the evict/restore cycle did not reuse the groups' buffers")

    # 7. delete 32 base rows the queries found and 32 inserts; purge
    n_del = STREAM["deletes"]
    base = [i for i in dict.fromkeys(res_post.ids[:, 0].tolist())
            if 0 <= i < n][:n_del]
    gone = np.asarray(base + pids[:: m // n_del][:n_del].tolist())
    _need(len(gone) == 2 * n_del, "too few distinct base rows to delete")
    for pid in gone:
        svc.delete(int(pid))
    leg[0] = "deleted"
    seen = (np.isin(svc.query(qpts, wids).ids, gone).sum()
            + np.isin(svc.query(ins, ins_w).ids, gone).sum())
    leg[0] = "purged"
    b0 = cache.stats.n_builds
    _reset_peak(torch, dev)
    t0 = time.perf_counter()
    svc.compact(purge=True)
    purge_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_purged = svc.query(qpts, wids)
    _sync(torch, dev)
    rebuild_s = time.perf_counter() - t0
    peak = _peak(torch, dev)
    rebuilds = cache.stats.n_builds - b0
    self_p = svc.query(ins, ins_w)
    kept = ~np.isin(pids, gone)
    seen += (np.isin(res_purged.ids, gone).sum()
             + np.isin(self_p.ids, gone).sum())
    found = int(_self_found(self_p, pids)[kept].sum())
    sel = np.where((ins_g == wide) & kept)[0]
    surv = np.setdiff1d(np.arange(n), base)

    def purge_check():
        cfg, g = svc.group_config(wide), plan.groups[wide]
        fresh = build_group_state(
            cfg, data, g, dev, extra_points=ins[sel],
            extra_codes=seal_segment(cfg, g, ins[sel]), base_rows=surv)
        with svc.batcher.lease(wide) as st:
            return _equal_states(torch, st, fresh), st.n_valid

    same, nv = _excluding(torch, purge_check, excluded)
    say(f"stream delete and purge: {len(gone)} ids deleted ({n_del} base "
        f"rows the queries ranked first, {n_del} inserts), {seen} served "
        f"after the deletes or the purge; purge {purge_s:.3f} s, "
        f"{rebuilds} states rebuilt on the next pass in {rebuild_s:.3f} s "
        f"(peak {peak} bytes); {found}/{int(kept.sum())} surviving inserts "
        f"at rank 0; the widest group's purged state (n_valid {nv}) "
        f"{'torch.equal' if same else 'DIFFERS FROM'} a fresh build over "
        f"the survivors [{smi}]")
    _need(seen == 0, "a deleted id was served")
    _need(found == int(kept.sum()), "a surviving insert missed itself")
    _need(same, "the purged state differs from a fresh survivors' build")
    return dict(purge_s=purge_s, rebuild_s=rebuild_s, purge_peak=peak,
                rebuilds=rebuilds)


def _stream_codeless(torch, dev, sl, scfg, smi):
    """The stream leg on the plan without host codes: inserts sealed
    through the hash_encode kernel on the group's state (each seal held
    to the plain version on the card), compacted, and the widest state
    held to a fresh device build over the union corpus.  Evicted states
    are discarded here (rebuilt by hash_encode), to spare host memory."""
    from repro_torch.index.builder import build_group_state
    from repro_torch.kernels import _cuda, ref
    from repro_torch.serving import delta as delta_mod
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    data = sl["data"]
    plan = sl["host"].export_serving_plan(include_codes=False)
    m = STREAM["codeless_inserts"]
    ins, ins_w = _stream_inserts(data, plan.n_weights, m, seed=29)
    ones = torch.ones(plan.d, dtype=torch.float32, device=dev)
    excluded: dict = {}
    held, seal = [], delta_mod.seal_segment

    def sealed_and_held(cfg, gplan, vectors, state=None):
        codes = seal(cfg, gplan, vectors, state=state)
        plain = ref.hash_encode_ref(torch.tensor(vectors, device=dev),
                                    state.proj, state.b_int, state.b_frac,
                                    ones, 1.0)
        held.append(bool(np.array_equal(codes, plain.cpu().numpy())))
        return codes

    _cuda.reset_launch_counts()
    svc = RetrievalService(plan, data, cfg=ServiceConfig(
        offload_evicted=False, **scfg))
    svc.warmup()
    delta_mod.seal_segment = sealed_and_held
    try:
        pids = np.asarray([svc.insert(v, int(w))
                           for v, w in zip(ins, ins_w)])
        pre = int(_self_found(svc.query(ins, ins_w), pids).sum())
        for gi in range(plan.n_groups):
            svc.batcher.delta.seal(gi)
    finally:
        delta_mod.seal_segment = seal
    absorbed = svc.compact()
    post = int(_self_found(svc.query(ins, ins_w), pids).sum())
    wide = _widest(svc, plan)
    sel = np.where(plan.group_of[ins_w] == wide)[0]

    def union_check():
        fresh = build_group_state(svc.group_config(wide), data,
                                  plan.groups[wide], dev,
                                  extra_points=ins[sel])
        with svc.batcher.lease(wide) as st:
            return _equal_states(torch, st, fresh), st.n_valid

    same, nv = _excluding(torch, union_check, excluded)
    main = {name: cnt - excluded.get(name, 0)
            for name, cnt in _cuda.launch_counts().items()}
    builds = svc.cache_summary()["n_builds"]
    seals = svc.delta_summary()["n_seals"]
    n_batches = sum(s["n_batches"] for s in svc.stats_summary().values())
    _need_launches(main, {"hash_encode": builds + seals + n_batches,
                          **_served(n_batches),
                          "freq_level": 0, "weighted_lp": 0},
                   "stream (no host codes)")
    say(f"stream codeless: {m} inserts -> {seals} seals through the "
        f"hash_encode kernel on the group's state, {sum(held)}/{len(held)} "
        f"bit-equal to the plain version on the card; {pre}/{m} self-queries "
        f"at rank 0 before and {post}/{m} after compacting {absorbed} rows; "
        f"the widest group's state (group {wide}, n_valid {nv}) "
        f"{'torch.equal' if same else 'DIFFERS FROM'} a fresh device build "
        f"over the union corpus; hash_encode launches {main['hash_encode']} "
        f"= {builds} builds + {seals} seals + {n_batches} query batches "
        f"[{smi}]")
    _need(len(held) == seals and all(held),
          "sealed codes differ from the plain hash_encode")
    _need(pre == m and post == m and absorbed == m,
          "a codeless insert missed itself")
    _need(same, "the codeless compacted state differs from a fresh build")
    del svc
    _release(torch)
    return main


# ------------------------------------------------------------------- shard


def _shard_service(sl, dev, shards: int, **kw):
    """A service over the slice's plan with every group's rows split into
    ``shards`` slices, all on the one card (devices named explicitly)."""
    from repro_torch.serving.retrieval import RetrievalService, ServiceConfig

    cf = SLICE
    return RetrievalService(sl["plan"], sl["data"], cfg=ServiceConfig(
        k=cf["k"], q_batch=cf["q_batch"],
        delta_reserve_rows=SHARD["reserve"], **kw),
        devices=(str(dev),) * shards)


def _equal_sharded(torch, a, b) -> bool:
    return a.n_valid == b.n_valid and len(a.shards) == len(b.shards) and all(
        _equal_states(torch, x, y) for x, y in zip(a.shards, b.shards))


def _need_same(runs, want, leg: str) -> None:
    """Every run's answers equal ``want``'s bit for bit; else print the
    first queries that differ (ids and distances of both) and fail."""
    for res in runs:
        bad = np.where(~(np.all(res.ids == want.ids, axis=1)
                         & np.all(res.dists.view(np.uint32)
                                  == want.dists.view(np.uint32), axis=1)
                         & (res.stop_levels == want.stop_levels)
                         & (res.n_checked == want.n_checked)))[0]
        for qi in bad[:3]:
            say(f"{leg}: query {qi} ids {res.ids[qi].tolist()} dists "
                f"{res.dists[qi].tolist()} stop {res.stop_levels[qi]}, the "
                f"slice leg's ids {want.ids[qi].tolist()} dists "
                f"{want.dists[qi].tolist()} stop {want.stop_levels[qi]}")
        _need(len(bad) == 0, f"{leg}: {len(bad)} answers differ from the "
              f"slice leg's")


def _shard_checks(torch, dev, sl, svc, smi):
    """On the 4-shard service: both fused passes on the shard that
    straddles n_valid held to their plain versions, the per-host builds
    (host codes, and device-encoded shard by shard) held to the
    materialized and the whole-state builds, and S = 3 refused."""
    import dataclasses

    from repro_torch.index.builder import build_group_state
    from repro_torch.kernels import fused_query, ref

    plan, data = sl["plan"], sl["data"]
    gi = _widest(svc, plan)
    cfg, g = svc.group_config(gi), plan.groups[gi]
    st = _state(svc, gi)
    s_last = max(i for i, off in enumerate(st.offsets) if off < st.n_valid)
    sh, off = st.shards[s_last], st.offsets[s_last]
    n_loc = st.rows_per_shard
    rows = np.where(plan.group_of[sl["wids"]] == gi)[0]
    take = rows[np.arange(cfg.q_batch) % len(rows)]
    _, _, inp = _batch_inputs(svc, plan, sl["qpts"], sl["wids"], take,
                              torch, dev)
    step = svc.step_cache.get(dev, cfg)
    _, _, stop, _ = step(st, inp["queries"], inp["codes_q"],
                         inp["q_weight"], inp["mu"], inp["r_min"],
                         inp["beta_q"], inp["levels_q"])
    inp.update(codes_p=sh.codes, points=sh.points, stop=stop.contiguous())
    kw = dict(boff=off, n_valid=st.n_valid, c=cfg.c, n_levels=cfg.n_levels,
              p=cfg.p)
    row_ok = (off + torch.arange(n_loc, device=dev)) < st.n_valid
    hf, hg = fused_query.fused_query_hist(*_pass_args(inp, "hist"), **kw)
    sc = fused_query.fused_query_scores(*_pass_args(inp, "scores"), **kw)
    pk = dict(c=cfg.c, n_levels=cfg.n_levels, p=cfg.p)
    rf, rg = ref.fused_query_hist_ref(*_pass_args(inp, "hist"), row_ok, **pk)
    rs = ref.fused_query_scores_ref(*_pass_args(inp, "scores"), row_ok, **pk)
    dead = int(hf[:, -1].sum()) // hf.shape[0]
    _need(dead == off + n_loc - st.n_valid,
          f"the straddling shard binned {dead} dead rows a query")
    err = _hold(torch, inp, cfg.p, (hf, hg, sc), (rf, rg, rs),
                f"shard hold (group {gi}, shard {s_last} of "
                f"{st.n_shards}: boff={off}, n_valid={st.n_valid}, "
                f"{n_loc - dead} live and {dead} dead rows, Q="
                f"{cfg.q_batch}) [{smi}]")
    _same_scan(torch, dev, inp, kw, (hf, hg, sc),
               f"shard hold (group {gi}, shard {s_last})")

    calls = []

    def loader(lo, hi):
        calls.append((lo, hi))
        return data[lo:hi]

    t0 = time.time()
    hosted = build_group_state(cfg, None, g, svc.devices,
                               points_loader=loader, n_points=plan.n)
    _sync(torch, dev)
    t_host, n_calls = time.time() - t0, len(calls)
    same_host = _equal_sharded(torch, hosted, st)
    del hosted
    _need(all(hi - lo <= n_loc for lo, hi in calls),
          f"the loader was asked for more than a shard: {calls}")
    cg = sl["host"].export_serving_plan(include_codes=False).groups[gi]
    coded = build_group_state(cfg, None, cg, svc.devices,
                              points_loader=loader, n_points=plan.n)
    whole = build_group_state(dataclasses.replace(cfg, n_shards=1), data,
                              cg, dev)
    same_enc = all(
        torch.equal(x.codes, whole.codes[o:o + n_loc])
        and torch.equal(x.points, whole.points[o:o + n_loc])
        for x, o in zip(coded.shards, coded.offsets))
    del coded, whole
    try:
        build_group_state(dataclasses.replace(cfg, n_shards=3), data, g,
                          (str(dev),) * 3)
        refused = "nothing"
    except ValueError as e:
        refused = str(e)
    say(f"shard builds (group {gi}): the per-host build from "
        f"{n_calls} loader ranges of at most {n_loc} rows "
        f"{'torch.equal' if same_host else 'DIFFERS FROM'} the materialized "
        f"sharded build, shard by shard ({t_host:.2f} s); the plan without "
        f"host codes encoded shard by shard by hash_encode "
        f"{'equal to' if same_enc else 'DIFFERS FROM'} the whole-state "
        f"encode (codes and vectors); S = 3 at capacity {cfg.n}: "
        f"{refused!r}")
    _need(same_host, "the per-host build differs from the materialized one")
    _need(same_enc, "the per-shard device encode differs from the whole")
    _need("does not divide 3 shards" in refused,
          "S = 3 was not refused by the strict divisibility rule")
    return err


def _shard_stream(torch, dev, sl, svc, smi):
    """Inserts, one compaction per group, deletes and a purge on the
    4-shard paged service: compacted and purged states equal fresh
    sharded builds.  Returns the main path's launches."""
    from repro_torch.index.builder import build_group_state, seal_segment
    from repro_torch.kernels import _cuda

    plan, data, n = sl["plan"], sl["data"], sl["plan"].n
    m, n_del = SHARD["inserts"], SHARD["deletes"]
    ins, ins_w = _stream_inserts(data, plan.n_weights, m, seed=37)
    ins_g = plan.group_of[ins_w]
    svc.reset_stats()
    excluded: dict = {}
    _cuda.reset_launch_counts()
    pids = np.asarray([svc.insert(v, int(w)) for v, w in zip(ins, ins_w)])
    pre = int(_self_found(svc.query(ins, ins_w), pids).sum())
    ds0 = svc.delta_summary()
    absorbed = svc.compact()
    ds = svc.delta_summary()
    post = int(_self_found(svc.query(ins, ins_w), pids).sum())
    res_post = svc.query(sl["qpts"], sl["wids"])

    def union_check():
        n_same = 0
        for gi in range(plan.n_groups):
            sel = np.where(ins_g == gi)[0]
            cfg, g = svc.group_config(gi), plan.groups[gi]
            fresh = build_group_state(
                cfg, data, g, svc.devices, extra_points=ins[sel],
                extra_codes=seal_segment(cfg, g, ins[sel]))
            with svc.batcher.lease(gi) as st:
                n_same += _equal_sharded(torch, st, fresh)
            del fresh
        return n_same

    n_same = _excluding(torch, union_check, excluded)
    base = [i for i in dict.fromkeys(res_post.ids[:, 0].tolist())
            if 0 <= i < n][:n_del]
    gone = np.asarray(base + pids[:: m // n_del][:n_del].tolist())
    for pid in gone:
        svc.delete(int(pid))
    t0 = time.perf_counter()
    svc.compact(purge=True)
    purge_s = time.perf_counter() - t0
    res_purged = svc.query(sl["qpts"], sl["wids"])
    self_p = svc.query(ins, ins_w)
    kept = ~np.isin(pids, gone)
    seen = int(np.isin(res_purged.ids, gone).sum()
               + np.isin(self_p.ids, gone).sum())
    found = int(_self_found(self_p, pids)[kept].sum())
    wide = _widest(svc, plan)
    sel = np.where((ins_g == wide) & kept)[0]

    def purge_check():
        cfg, g = svc.group_config(wide), plan.groups[wide]
        fresh = build_group_state(
            cfg, data, g, svc.devices, extra_points=ins[sel],
            extra_codes=seal_segment(cfg, g, ins[sel]),
            base_rows=np.setdiff1d(np.arange(n), base))
        with svc.batcher.lease(wide) as st:
            return _equal_sharded(torch, st, fresh), st.n_valid

    same_purge, nv = _excluding(torch, purge_check, excluded)
    _sync(torch, dev)
    main = {name: cnt - excluded.get(name, 0)
            for name, cnt in _cuda.launch_counts().items()}
    n_batches = sum(s["n_batches"] for s in svc.stats_summary().values())
    shards = svc.batcher.n_shards
    _need_launches(main, {**_served(shards * n_batches),
                          "hash_encode": 0, "freq_level": 0,
                          "weighted_lp": 0}, "shard stream")
    say(f"shard stream ({shards} shards, {PAGED_SLOTS} of {plan.n_groups} "
        f"states on the card): {m} inserts, {pre}/{m} self-queries at rank "
        f"0 by the exact scan; {ds['n_compactions'] - ds0['n_compactions']} "
        f"compactions (one a group) absorbed {absorbed} rows, {post}/{m} "
        f"self-queries at rank 0 through the fused kernels; {n_same}/"
        f"{plan.n_groups} compacted sharded states torch.equal a fresh "
        f"sharded union build, shard by shard; {len(gone)} ids deleted, "
        f"purge {purge_s:.3f} s, {seen} deleted ids served, {found}/"
        f"{int(kept.sum())} surviving inserts at rank 0, the widest purged "
        f"state (n_valid {nv}) "
        f"{'torch.equal' if same_purge else 'DIFFERS FROM'} a fresh sharded "
        f"build over the survivors [{smi}]")
    _need(pre == m and post == m and absorbed == m,
          "a sharded insert missed itself")
    _need(ds["n_compactions"] - ds0["n_compactions"]
          == len(np.unique(ins_g)), "not one compaction a group")
    _need(n_same == plan.n_groups, "a compacted sharded state differs from "
          "a fresh sharded union build")
    _need(seen == 0 and found == int(kept.sum()) and same_purge,
          "the sharded purge differs from a fresh build over the survivors")
    return main


def phase_shard(torch, dev, sl, smi):
    """The slice's plan with every group's rows split into S slices on the
    one card (S in SHARD["counts"]), capacity 401,000 so the last shard
    straddles n_valid: answers bit-equal to the slice leg's for sync, 4
    shards paged at PAGED_SLOTS of 7 and on the async driver; the
    straddling shard's kernels, the per-host builds and S = 3 checked
    (``_shard_checks``); a streaming sub-leg (``_shard_stream``)."""
    cf, plan = SLICE, sl["plan"]
    qpts, wids = sl["qpts"], sl["wids"]
    _free(torch, sl["svc"])  # the unpaged leg's states leave the card
    launches: dict = {}

    def add(got):
        for name, cnt in got.items():
            launches[name] = launches.get(name, 0) + cnt

    errs = {}
    for shards in SHARD["counts"]:
        svc = _shard_service(sl, dev, shards, offload_evicted=False)
        t0 = time.time()
        svc.warmup()
        _sync(torch, dev)
        t_build = time.time() - t0
        cap = svc.batcher.row_capacity()
        svc.query(qpts, wids)  # warm
        _sync(torch, dev)
        _reset_peak(torch, dev)
        runs, lat, t_q, got = _serve(torch, dev, svc, qpts, wids, cf["reps"])
        peak = _peak(torch, dev)
        _need_launches(got, {**_served(shards * len(lat)),
                             "hash_encode": 0, "freq_level": 0,
                             "weighted_lp": 0}, f"shard S={shards}")
        add(got)
        n_served = len(qpts) * cf["reps"]
        held = 0  # every slice shares the card: all of them count there
        for gi in range(plan.n_groups):
            with svc.state_cache.lease(gi) as st:
                held += st.nbytes + 4 * shards  # + the n_valid scalars
        del st  # else the last state outlives its service on the card
        say(f"shard S={shards} serve: {cf['reps']} x {len(qpts)} queries, "
            f"{shards} shards of {cap // shards} rows on one card (capacity "
            f"{cap}, last live row in shard "
            f"{(plan.n - 1) // (cap // shards)}), {len(lat)} batches, "
            f"{t_q:.3f}s ({n_served / t_q:.1f} q/s); {_lat(lat)} (slice "
            f"leg p50 {np.percentile(sl['lat'], 50):.2f} ms); peak device "
            f"memory {peak} bytes (slice leg {sl['peak']}); build "
            f"{t_build:.1f}s; {svc.resident_bytes} bytes accounted on the "
            f"card, {held} held by the {plan.n_groups} states' slices [{smi}]")
        _need_same(runs, sl["res"], f"shard S={shards}")
        _need(held == svc.resident_bytes, f"shard S={shards}: the states' "
              f"slices hold {held} bytes, {svc.resident_bytes} accounted")
        if shards == max(SHARD["counts"]):
            errs = _shard_checks(torch, dev, sl, svc, smi)
        _free(torch, svc)
        del svc
        _release(torch)

    shards = max(SHARD["counts"])
    svc = _shard_service(sl, dev, shards, max_resident_groups=PAGED_SLOTS)
    svc.warmup()
    svc.query(qpts, wids)  # warm: every group offloaded once, allocator
    _sync(torch, dev)
    svc.reset_stats()
    pager = svc.batcher.pager
    n0 = len(pager.summary()["copy_ms"])
    _reset_peak(torch, dev)
    runs, lat, t_q, got = _serve(torch, dev, svc, qpts, wids, cf["reps"])
    peak = _peak(torch, dev)
    _need_launches(got, {**_served(shards * len(lat)),
                         "hash_encode": 0, "freq_level": 0,
                         "weighted_lp": 0}, "shard paged")
    add(got)
    cache, ps = svc.cache_summary(), pager.summary()
    copy_ms = np.array(ps["copy_ms"][n0:])
    copy_b = np.array(ps["copy_bytes"][n0:], np.float64)
    qps = len(qpts) * cf["reps"] / t_q
    say(f"shard paged serve: {shards} shards, {PAGED_SLOTS} of "
        f"{plan.n_groups} states on the card, {len(lat)} batches, "
        f"{t_q:.3f}s ({qps:.1f} q/s); {_lat(lat)}; {cache['n_restores']} "
        f"restores as {len(copy_ms)} shard copies, "
        f"{copy_b.mean():.0f} bytes and {copy_ms.mean():.3f} ms a shard "
        f"copy mean (p50 {np.percentile(copy_ms, 50):.3f}, p95 "
        f"{np.percentile(copy_ms, 95):.3f} ms), "
        f"{(copy_b / (copy_ms / 1e3)).mean() / 1e9:.2f} GB/s a shard mean; "
        f"{ps['pinned_bytes']} pinned bytes; peak device memory {peak} "
        f"bytes [{smi}]")
    _need_same(runs, sl["res"], "shard paged")
    _need(cache["n_restores"] > 0, "the sharded paged leg restored nothing")
    _need(len(copy_ms) == shards * cache["n_restores"],
          f"{len(copy_ms)} shard copies for {cache['n_restores']} restores")
    add(phase_async(torch, dev, sl, dict(svc=svc, qps=qps), shards=shards,
                    leg="shard async")["launches"])
    add(_shard_stream(torch, dev, sl, svc, smi))
    del svc, pager
    _release(torch)
    return dict(launches=launches, err=errs)


def _narrowest(svc, plan) -> int:
    """The group with the narrowest padded state (ties: the fewest
    tables)."""
    return min(range(plan.n_groups), key=lambda g: (
        svc.group_config(g).beta, plan.groups[g].beta_group))


def phase_search(torch, dev, sl, smi):
    """The paper's host search at the slice's full width, held to the dense
    host oracle and to the card's answers (see the module docstring)."""
    from types import SimpleNamespace

    from repro_torch.kernels import _cuda

    svc, plan, host = sl["svc"], sl["plan"], sl["host"]
    qpts, wids, card = sl["qpts"], sl["wids"], sl["res"]
    k = SLICE["k"]
    budget = k + int(np.ceil(plan.gamma_n))
    t_phase = time.time()
    groups = (_widest(svc, plan), _narrowest(svc, plan))
    take = []
    for gi in groups:
        rows = np.where(plan.group_of[wids] == gi)[0][:SEARCH_PER_GROUP]
        _need(len(rows) == SEARCH_PER_GROUP,
              f"group {gi} serves {len(rows)} of the slice's queries")
        take += [int(qi) for qi in rows]

    def sort_tables(gi):  # numpy's sort releases the GIL: both at once
        t0 = time.time()
        host._group(gi).sorted_tables()
        return time.time() - t0

    _cuda.reset_launch_counts()
    with ThreadPoolExecutor(max_workers=len(groups)) as pool:
        t_sort = list(pool.map(sort_tables, groups))
    for gi, secs in zip(groups, t_sort):
        g = plan.groups[gi]
        say(f"search tables: group {gi} (beta_group {g.beta_group}, "
            f"beta_pad {svc.group_config(gi).beta}, n={plan.n}) sorted per "
            f"table in {secs:.1f}s")
    found, host_ms = [], []
    for qi in take:
        t0 = time.perf_counter()
        found.append(host.search(qpts[qi], weight_id=int(wids[qi]), k=k))
        host_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(take)) as pool:
        dense = list(pool.map(lambda qi: host.search_dense(
            qpts[qi], weight_id=int(wids[qi]), k=k), take))
    t_dense = time.time() - t0
    launches = _cuda.launch_counts()

    def agree(r, stop, n_checked, ids):
        """(stop and n_checked equal, ids equal or None where the budget
        truncated the frequent set, top-1 equal)."""
        same = (r.stats.stop_level == int(stop)
                and r.stats.n_checked == int(n_checked))
        ids_eq = (np.array_equal(r.ids, np.asarray(ids, np.int64))
                  if r.stats.n_checked < budget else None)
        return same, ids_eq, int(r.ids[0]) == int(ids[0])

    vs_dense, vs_card = [], []
    for i, (qi, r, rd) in enumerate(zip(take, found, dense)):
        st = r.stats
        vs_dense.append(agree(r, rd.stats.stop_level, rd.stats.n_checked,
                              rd.ids))
        vs_card.append(agree(r, card.stop_levels[qi], card.n_checked[qi],
                             card.ids[qi]))
        say(f"search query {qi} (group {plan.group_of[wids[qi]]}, weight "
            f"{wids[qi]}): {host_ms[i]:.1f} ms on the host, stop level "
            f"{st.stop_level} (dense {rd.stats.stop_level}, card "
            f"{card.stop_levels[qi]}), n_checked {st.n_checked} (dense "
            f"{rd.stats.n_checked}, card {card.n_checked[qi]}), "
            f"n_collisions {st.n_collisions}, io_blocks {st.io_blocks:.1f}, "
            f"found_k {st.found_k}")

    def count(rows):
        return (sum(same and ids_eq is not False for same, ids_eq, _ in rows),
                sum(ids_eq is None for _, ids_eq, _ in rows),
                sum(top1 for same, ids_eq, top1 in rows if ids_eq is None))

    n_q = len(take)
    ok_d, trunc_d, top1_d = count(vs_dense)
    ok_c, trunc_c, top1_c = count(vs_card)
    data_t = torch.from_numpy(sl["data"]).to(dev).double()
    q_t, w_t = qpts[take], wids[take]
    rec_h, ratio_h = _quality(torch, dev, data_t, sl["weights"], q_t, w_t,
                              SimpleNamespace(ids=np.stack(
                                  [r.ids for r in found])), k)
    rec_c, ratio_c = _quality(torch, dev, data_t, sl["weights"], q_t, w_t,
                              SimpleNamespace(ids=card.ids[take]), k)
    del data_t
    _release(torch)
    io = np.array([r.stats.io_blocks for r in found])
    secs = time.time() - t_phase
    say(f"search vs search_dense: {ok_d}/{n_q} agree (stop, n_checked, and "
        f"ids where n_checked < budget {budget}); {trunc_d} truncated by the "
        f"budget, top-1 equal on {top1_d} of them; search_dense "
        f"{t_dense:.1f}s for {n_q} in parallel")
    say(f"search vs the card's answers (slice leg): {ok_c}/{n_q} agree; "
        f"{trunc_c} truncated, top-1 equal on {top1_c} of them")
    say(f"search summary: {n_q} queries, host ms p50 "
        f"{np.percentile(host_ms, 50):.1f} (max {max(host_ms):.1f}); "
        f"io_blocks mean {io.mean():.1f} (min {io.min():.1f}, max "
        f"{io.max():.1f}); overall ratio {ratio_h:.4f} (card {ratio_c:.4f}), "
        f"recall@{k} {rec_h:.4f} (card {rec_c:.4f}); the card's p50 per "
        f"batch of {SLICE['q_batch']} on the slice leg "
        f"{np.percentile(sl['lat'], 50):.2f} ms; phase {secs:.1f}s [{smi}]")
    _need_launches(launches, {name: 0 for name in KERNELS}, "search")
    _need(ok_d == n_q, f"search agrees with search_dense on {ok_d} of {n_q}")
    _need(ok_c >= n_q - 1,
          f"search agrees with the card's answers on {ok_c} of {n_q}")
    return dict(seconds=secs, sort_seconds=t_sort, host_ms=host_ms,
                io_blocks=io.tolist(), ratio=ratio_h, card_ratio=ratio_c)


def phase_sentinel(torch, dev, smi):
    """The bench sentinel's workload on the card, then on the CPU; gated
    against the committed baseline."""
    from benchmarks_torch import sentinel
    from repro_torch.kernels import _cuda

    _release(torch)  # the earlier legs' dropped services and cached blocks
    t0 = time.time()
    _cuda.reset_launch_counts()
    card = sentinel.collect(device=str(dev))
    launches = _cuda.launch_counts()
    t_card = time.time() - t0
    _need_launches(launches, {**_served(None), "hash_encode": 0,
                              "freq_level": 0, "weighted_lp": 0}, "sentinel")
    t0 = time.time()
    cpu = sentinel.collect(device="cpu")
    t_cpu = time.time() - t0
    for name in card:
        say(f"sentinel {name}: card {card[name]!r}, cpu {cpu[name]!r}")
    say(f"sentinel: {t_card:.1f}s on the card, {t_cpu:.1f}s on the CPU "
        f"[{smi}]")
    for name in SENTINEL_SEEDED:
        _need(card[name] == cpu[name], f"sentinel {name}: card {card[name]}"
              f" != cpu {cpu[name]}")
    base_path = sentinel.DEFAULT_BASELINE
    with open(base_path) as fh:
        pinned = json.load(fh)
    rows = sentinel.compare(card, pinned["metrics"])
    for r in rows:
        say(f"sentinel vs {os.path.relpath(base_path, ROOT)} "
            f"({pinned.get('device')}): {r['metric']} {r['current']!r} vs "
            f"{r['baseline']!r}, limit {r['limit']!r} ({r['direction']} is "
            f"better), {'PASS' if r['ok'] else 'FAIL'} [{smi}]")
    bad = [r["metric"] for r in rows if not r["ok"]]
    _need(rows and not bad, f"sentinel regressions: {bad}")
    return dict(launches=launches, card=card, cpu=cpu)


# ---------------------------------------------------------------- lm leg


def _lm_full_config():
    """The full-width model of the lm leg (a function, so a rehearsal on
    the CPU can shrink it)."""
    from repro_torch.configs import get_config

    return get_config(LM["arch"])


def _lm_batch(torch, cfg, rng, dev, b: int, s: int):
    """Seeded inputs of ``b`` x ``s``: token ids, or frame/patch
    embeddings for the archs whose frontend is a stub."""
    if cfg.input_mode == "embeddings":
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"embeddings": torch.from_numpy(x).to(dev)}
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(dev)}


def _lm_run(torch, model, params, batch, toks, dev):
    """(hidden, prefill logits, last decode logits, cache) of one model on
    ``dev``: the forward, then ``len(toks)`` decode steps from position 0."""
    b = {k: v.to(dev) for k, v in batch.items()}
    with torch.no_grad():
        hid = model.hidden_states(params, b)
        pre = model.prefill(params, b)
        cache = model.init_cache(toks.shape[1], LM["cache_len"], device=dev)
        for t in range(toks.shape[0]):
            logits, cache = model.decode_step(params, cache,
                                              toks[t].to(dev), t)
    return hid, pre, logits, cache


def _lm_err(torch, got, want, tol, label) -> float:
    """Max abs error of ``got`` (the card) against ``want`` (the CPU)
    within ``tol`` (float8 within one float8 step more)."""
    got = got.cpu()
    if got.dtype == torch.float8_e4m3fn:
        tol = dict(tol, rtol=tol["rtol"] + 2.0 ** -3)
    g, w = got.double(), want.double()
    ok = (g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()
    err = _top((g - w).abs())
    _need(bool(ok.all()) and bool(torch.isfinite(g).all()),
          f"{label}: {int((~ok).sum())} values outside {tol}, max abs err "
          f"{err:.3g}")
    return err


def _lm_profile(torch, dev, fn, label: str, smi, calls: int = 4):
    """``calls`` runs of ``fn`` under ``torch.profiler`` after a warm one:
    device busy time a call (the kernels' spans), its share of the host
    wall time of ``calls`` runs timed without the profiler (1 - the idle
    share; the profiler's own per-launch cost would inflate a wall taken
    under it), and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    _sync(torch, dev)
    wall_us = 1e6 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync(torch, dev)
        prof_us = 1e6 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    say(f"lm profile {label}: {calls} calls, host wall "
        f"{wall_us / 1e3 / calls:.2f} ms a call without the profiler "
        f"({prof_us / 1e3 / calls:.2f} under it), device "
        f"busy {busy / 1e3 / calls:.2f} ms a call, idle share "
        f"{1 - busy / wall_us:.1%}; {len(by_name)} kernels, the most "
        f"device time: " + "; ".join(
            f"{name[:60]} {us / 1e3 / calls:.2f} ms" for name, us in top)
        + f" [{smi}]")
    return dict(busy_ms=busy / 1e3 / calls, wall_ms=wall_us / 1e3 / calls,
                top=[(name, us / 1e3 / calls) for name, us in top])


def _lm_families(torch, dev, smi):
    """Every LM family's reduced arch on the card, float32, held to the
    port's CPU run on the same parameters; once in bfloat16, finite."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map

    t0 = time.time()
    cpu = torch.device("cpu")
    archs = [a for a in ARCHS if a != "wlsh_index"]
    steps = LM["family_steps"]
    for i, arch in enumerate(archs):
        base = reduced(get_config(arch))
        model = build_model(dataclasses.replace(base, dtype="float32"))
        p_cpu = init_params(model.defs(),
                            torch.Generator().manual_seed(100 + i),
                            device="cpu")
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        rng = np.random.default_rng(100 + i)
        batch = _lm_batch(torch, base, rng, cpu, 2, LM["family_seq"])
        toks = torch.from_numpy(rng.integers(0, base.vocab, (steps, 2)).astype(
            np.int32))
        want = _lm_run(torch, model, p_cpu, batch, toks, cpu)
        got = _lm_run(torch, model, p_dev, batch, toks, dev)
        errs = [_lm_err(torch, g, w, LM_F32_TOL, f"lm {arch} {name}")
                for name, g, w in zip(("hidden", "prefill", "decode"),
                                      got[:3], want[:3])]
        cache_err = max(_lm_err(torch, got[3][k], want[3][k], LM_F32_TOL,
                                f"lm {arch} cache {k}") for k in want[3])
        bf = build_model(base)  # the config's own bfloat16
        hb, pb, lb, cb = _lm_run(torch, bf, p_dev, batch, toks, dev)
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (hb, pb, lb, *cb.values()))
        _need(finite and hb.dtype == torch.bfloat16,
              f"lm {arch}: bfloat16 run not finite")
        say(f"lm family {arch} ({base.family}, {base.n_layers} layers, "
            f"d={base.d_model}): card vs CPU float32 max abs err hidden "
            f"{errs[0]:.3g}, prefill {errs[1]:.3g}, decode step {steps} "
            f"logits {errs[2]:.3g}, cache {cache_err:.3g} (cache "
            f"{sorted(want[3])}, kv {base.kv_dtype_}); bfloat16 run finite")
    say(f"lm families: {len(archs)} archs held to rtol "
        f"{LM_F32_TOL['rtol']:g}, atol {LM_F32_TOL['atol']:g} (float8 "
        f"caches one float8 step more), {time.time() - t0:.1f}s [{smi}]")


def _lm_embed(torch, dev, smi):
    """olmo-1b at full width: init on the card, embed the corpus in
    bfloat16, hold 8 docs' float32 hidden states to the CPU's, generate
    greedily twice and hold the decode path to prefill."""
    import dataclasses

    from repro_torch.models import (build_model, count_params, init_params,
                                    tree_bytes)
    from repro_torch.models.params import tree_map
    from repro_torch.serving import SamplerConfig, generate

    cfg = _lm_full_config()
    model = build_model(cfg)
    n_params = count_params(model.defs())
    _reset_peak(torch, dev)
    t0 = time.time()
    params = init_params(model.defs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    _sync(torch, dev)
    say(f"lm {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied "
        f"{cfg.tie_embeddings}, {cfg.norm}: count_params {n_params}, "
        f"{tree_bytes(params)} bytes of {cfg.param_dtype} params on the "
        f"card, initialised in {time.time() - t0:.1f}s")

    n_docs, seq, bs = LM["n_docs"], LM["seq"], LM["embed_batch"]
    gen = torch.Generator(device=dev).manual_seed(1)
    vecs = torch.empty((n_docs, cfg.d_model), dtype=torch.float32,
                       device=dev)
    events, first = [], None
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(0, n_docs, bs):
            toks = torch.randint(0, cfg.vocab, (min(bs, n_docs - i), seq),
                                 generator=gen, dtype=torch.int32, device=dev)
            if first is None:
                first = toks[: LM["hold_docs"]].clone()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            h = model.hidden_states(params, {"tokens": toks})
            # bfloat16 mean, as jnp.mean of the JAX example's hidden states
            vecs[i:i + len(toks)] = h.mean(dim=1).float()
            e.record()
            events.append((s, e))
    _sync(torch, dev)
    secs = time.perf_counter() - t0
    ms = [s.elapsed_time(e) for s, e in events]
    peak = _peak(torch, dev)
    _need(bool(torch.isfinite(vecs).all()), "lm embeddings not finite")
    say(f"lm embed: {n_docs} docs x {seq} tokens in {len(ms)} batches of "
        f"{bs} ({cfg.dtype}): per batch (CUDA events) p50 "
        f"{np.percentile(ms, 50):.2f} ms, p95 {np.percentile(ms, 95):.2f} "
        f"ms, first {ms[0]:.2f} ms; {secs:.2f}s wall, "
        f"{n_docs * seq / secs:.0f} tokens/s; peak device memory {peak} "
        f"bytes [{smi}]")

    # 8 docs in float32 on the card against the CPU on the same params
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    t0 = time.time()
    with torch.no_grad():
        h_card = m32.hidden_states(params, {"tokens": first}).cpu()
        p_cpu = tree_map(lambda t: t.cpu(), params)
        h_cpu = m32.hidden_states(p_cpu, {"tokens": first.cpu()})
        # the control: the same docs with TF32 matmuls on the card
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            h_tf32 = m32.hidden_states(params, {"tokens": first}).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    del p_cpu
    err = _lm_err(torch, h_card, h_cpu, LM_FULL_TOL, "lm hold")
    rel = float((h_card - h_cpu).double().norm() / h_cpu.double().norm())
    g, w = h_tf32.double(), h_cpu.double()
    tf32_out = int(((g - w).abs() > LM_FULL_TOL["atol"]
                    + LM_FULL_TOL["rtol"] * w.abs()).sum())
    tf32_err = _top((g - w).abs())
    tf32_rel = float((g - w).norm() / w.norm())
    say(f"lm hold: {LM['hold_docs']} docs' float32 hidden states on the card "
        f"vs the CPU: max abs err {err:.3g} (values up to "
        f"{_top(h_cpu.abs()):.3g}), relative {rel:.3g}, within rtol "
        f"{LM_FULL_TOL['rtol']:g}, atol {LM_FULL_TOL['atol']:g}; control "
        f"with TF32 matmuls: max abs err {tf32_err:.3g}, relative "
        f"{tf32_rel:.3g}, {tf32_out} of {g.numel()} values outside "
        f"({time.time() - t0:.1f}s)")
    _need(tf32_out > 0, "lm hold: the TF32 control passes the float32 "
          "tolerance, which then cannot tell TF32 matmuls from float32")

    # greedy generation, twice, with every decode step timed
    gb, plen, new = LM["gen_batch"], LM["prompt"], LM["new"]
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab, (gb, plen)).astype(np.int32)
    step_events = []
    decode_step = model.decode_step

    def timed(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = decode_step(*a, **kw)
        e.record()
        step_events.append((s, e))
        return out

    model.decode_step = timed
    runs, walls = [], []
    try:
        for _ in range(2):
            step_events.clear()
            t0 = time.perf_counter()
            runs.append(generate(model, params, prompts, new, plen + new + 1,
                                 SamplerConfig(temperature=0.0), device=dev))
            _sync(torch, dev)
            walls.append(time.perf_counter() - t0)
    finally:
        del model.decode_step
    step_ms = [s.elapsed_time(e) for s, e in step_events]
    _need(runs[0].shape == (gb, new) and np.array_equal(runs[0], runs[1]),
          "lm generate: two greedy runs differ")
    # where a batch's and a step's device time goes
    pt = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        prof_embed = _lm_profile(torch, dev, lambda: model.hidden_states(
            params, {"tokens": first.repeat(bs // len(first) + 1, 1)[:bs]}),
            f"embed batch ({bs} x {seq})", smi)
        cache = model.init_cache(gb, plen + 1, device=dev)
        prof_step = _lm_profile(torch, dev, lambda: model.decode_step(
            params, cache, pt[:, 0], 0), f"decode step (batch {gb})", smi)
    # the decode path's logits after the prompt vs prefill's last position
    with torch.no_grad():
        cache = model.init_cache(gb, plen + 1, device=dev)
        for pos in range(plen):
            logits, cache = model.decode_step(params, cache, pt[:, pos], pos)
        full = model.prefill(params, {"tokens": pt})
    lg, fl = logits.float(), full.float()
    err = _top((lg - fl).abs())
    rel = float((lg - fl).double().norm() / fl.double().norm())
    same_top = int((lg.argmax(-1) == fl.argmax(-1)).sum())
    say(f"lm generate: batch {gb}, prompt {plen}, {new} new tokens greedy, "
        f"two runs equal; {len(step_ms)} decode steps a run, p50 "
        f"{np.percentile(step_ms, 50):.2f} ms, p95 "
        f"{np.percentile(step_ms, 95):.2f} ms a step (CUDA events); "
        f"{gb * new / walls[1]:.1f} new tokens/s ({walls[1]:.2f}s wall, "
        f"first run {walls[0]:.2f}s); decode vs prefill at the last prompt "
        f"position: max abs err {err:.3g} (logits up to "
        f"{_top(fl.abs()):.3g}), relative {rel:.3g}, argmax equal on "
        f"{same_top}/{gb} [{smi}]")
    _need(rel <= LM_DECODE_REL, f"lm decode vs prefill: relative error "
          f"{rel:.3g} above {LM_DECODE_REL}")
    del params, cache
    out = vecs.cpu().numpy()
    del vecs
    _release(torch)
    return dict(corpus=out, embed_ms=ms, embed_tok_s=n_docs * seq / secs,
                step_ms=step_ms, gen_tok_s=gb * new / walls[1], peak=peak,
                n_params=n_params, prof_embed=prof_embed, prof_step=prof_step)


def _lm_serve(torch, dev, smi, corpus):
    """The embedded corpus served with the example's plan settings through
    the fused kernels (see the module docstring)."""
    from types import SimpleNamespace

    from repro_torch.core.datagen import make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.kernels import _cuda, platform
    from repro_torch.serving import (AsyncRetrievalService, ManualClock,
                                     RetrievalService, ServiceConfig,
                                     replay_open_loop)

    corpus = corpus - corpus.min(axis=0, keepdims=True)
    n, d = corpus.shape
    k = LM["k"]
    users = make_weight_set(size=LM["n_users"], d=d, n_subset=3,
                            n_subrange=10, seed=7)
    t0 = time.time()
    host = WLSHIndex(corpus, users, PlanConfig(p=2.0, c=3, n=n,
                                               gamma_n=100.0),
                     tau=500.0, v=d // 4, v_prime=d // 4,
                     value_range=float(corpus.max()), seed=8)
    plan = host.export_serving_plan()
    t_plan = time.time() - t0
    svc = RetrievalService(plan, corpus, cfg=ServiceConfig(
        k=k, q_batch=LM["q_batch"], offload_evicted=False, device=str(dev)))
    path = platform.resolve(svc.cfg.use_kernels, svc.device)
    _need(path.label == "fused-cuda", f"lm serve path {path.label}")
    t0 = time.time()
    svc.warmup()
    _sync(torch, dev)
    say(f"lm plan: n={n} d={d} |S|={LM['n_users']} p=2 c=3 gamma_n=100 "
        f"tau=500 v=v'={d // 4} -> {plan.n_groups} groups, beta_group "
        f"{[g.beta_group for g in plan.groups]}, beta_pad "
        f"{[svc.group_config(g).beta for g in range(plan.n_groups)]} (plan "
        f"{t_plan:.1f}s); {svc.resident_bytes} bytes of states on the card, "
        f"built in {time.time() - t0:.1f}s; {path.label}")

    n_q = LM["n_queries"]
    rng = np.random.default_rng(9)
    wids = rng.integers(0, LM["n_users"], n_q)
    doc_ids = rng.choice(n, n_q, replace=False)
    qpts = (corpus[doc_ids] + rng.normal(0, 0.01, (n_q, d))).astype(
        np.float32)
    svc.query(qpts, wids)  # warm
    _sync(torch, dev)
    runs, lat, t_q, launches = _serve(torch, dev, svc, qpts, wids,
                                      LM["reps"])
    _need_launches(launches, {**_served(None), "hash_encode": 0,
                              "freq_level": 0, "weighted_lp": 0}, "lm serve")
    res = runs[-1]
    say(f"lm serve: {LM['reps']} x {n_q} queries in {len(lat)} batches, "
        f"{t_q:.3f}s ({LM['reps'] * n_q / t_q:.1f} q/s), identical across "
        f"runs; {_lat(lat)}; mean stop level {res.stop_levels.mean():.2f}, "
        f"mean n_checked {res.n_checked.mean():.1f} [{smi}]")

    # both passes on the widest group's state: held to their plain
    # versions and timed at d = 2,048
    inputs = _slice_pass_inputs(dict(svc=svc, plan=plan, wids=wids,
                                     qpts=qpts), torch, dev)
    gi, st = inputs[0], inputs[2]
    f = _fused_passes(torch, dev, inputs, st.points,
                      f"lm kernels (group {gi}, the lm leg's inputs)",
                      zone_edge=LM_ZONE,
                      tol=1e-6 * max(1.0, d / SLICE["d"]))
    for name in _FUSED:
        bound = f["bound"][name]
        say(f"lm times {name} (group {gi}: {f['shape']}): kernel "
            f"{f['t_k'][name]:.3f} ms, plain {f['t_p'][name]:.3f} ms, bound "
            f"{bound[0]:.3f} ms by {bound[1]} ({f['tests']} level tests, "
            f"{f['flops']} flops, {f['bytes'][name]} bytes) [{smi}]")

    check = list(range(0, n_q, n_q // LM["n_check"]))[: LM["n_check"]]
    t0 = time.time()
    rows = _dense_check(host, qpts, wids, res, k, check)
    n_bad = sum(not ok for ok, _ in rows)
    detail = [info for ok, info in rows if not ok]
    say(f"lm check vs search_dense: {len(check) - n_bad}/{len(check)} exact "
        f"(stop, n_checked, ids){' ' + str(detail) if detail else ''} "
        f"({time.time() - t0:.1f}s)")
    _need(n_bad <= len(check) // 8,
          f"lm: {n_bad} of {len(check)} queries disagree with search_dense")
    data_t = torch.from_numpy(corpus).to(dev).double()
    overlap, ratio = _quality(torch, dev, data_t, users, qpts, wids, res, k)
    del data_t
    found = float(np.mean([did in res.ids[qi]
                           for qi, did in enumerate(doc_ids)]))
    say(f"lm quality: source doc found in the top {k} for {found:.4f} of "
        f"{n_q} queries (the example asks >= 0.75"
        f"{'' if found >= 0.75 else '; BELOW IT'}); top-{k} overlap with "
        f"exact brute force {overlap:.4f}, overall ratio {ratio:.4f}")

    # the example's open-loop replay on a manual clock: bit-exact
    arrivals = np.cumsum(rng.exponential(1.0 / LM["async_rate"], n_q))
    svc.reset_stats()
    asvc = AsyncRetrievalService(svc, max_delay_ms=LM["async_delay_ms"],
                                 clock=ManualClock())
    _cuda.reset_launch_counts()
    ares, waits = replay_open_loop(asvc, qpts, wids, arrivals)
    _sync(torch, dev)
    a_launches = _cuda.launch_counts()
    same = (np.array_equal(ares.ids, res.ids)
            and np.array_equal(ares.dists, res.dists)
            and np.array_equal(ares.stop_levels, res.stop_levels)
            and np.array_equal(ares.n_checked, res.n_checked))
    say(f"lm async replay at {LM['async_rate']:.0f} q/s, deadline "
        f"{LM['async_delay_ms']} ms (manual clock): "
        f"{'bit-exact' if same else 'DIFFERENT'} with sync; "
        f"{asvc.n_launched_full} full / {asvc.n_launched_deadline} deadline "
        f"launches, occupancy {svc.mean_occupancy():.2f}, wait mean "
        f"{1e3 * waits.mean():.2f} ms; launches {a_launches}")
    _need(same, "lm async answers differ from the sync answers")
    _need(a_launches["fused_query_keep"] > 0, "lm async launched nothing")
    _free(torch, svc)
    return dict(launches={name: launches[name] + a_launches[name]
                          for name in launches},
                err=f["err"], times=f, lat=lat, qps=LM["reps"] * n_q / t_q,
                found=found,
                overlap=overlap, ratio=ratio,
                res=SimpleNamespace(ids=res.ids))


def phase_lm(torch, dev, smi):
    """The LM substrate on the card: every family reduced and held to the
    CPU, olmo-1b at full width embedding a corpus, and that corpus served
    through the fused kernels."""
    t0 = time.time()
    _release(torch)
    _lm_families(torch, dev, smi)
    emb = _lm_embed(torch, dev, smi)
    out = _lm_serve(torch, dev, smi, emb.pop("corpus"))
    out.update(emb)
    say(f"lm phase: {time.time() - t0:.1f}s [{smi}]")
    return out


# --------------------------------------------------------------- train leg


def _train_batch(torch, cfg, rng, b: int, s: int):
    """Seeded inputs of ``b`` x ``s`` with next-token labels, on the CPU."""
    batch = _lm_batch(torch, cfg, rng, torch.device("cpu"), b, s)
    batch["labels"] = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    return batch


def _train_grads(torch, model, params, batch, wanted=None):
    """(loss, {key: grad}) of ``model.loss``: the gradients of every leaf,
    or of the leaves whose ``keystr`` keys are in ``wanted``."""
    from repro_torch.models.params import tree_map
    from repro_torch.training.checkpoint import _leaf_keys

    keys = iter(_leaf_keys(params))
    tracked = {}

    def track(t):
        key, t = next(keys), t.detach()
        if wanted is None or key in wanted:
            tracked[key] = t.requires_grad_()
        return t

    loss = model.loss(tree_map(track, params), batch)
    grads = torch.autograd.grad(loss, list(tracked.values()),
                                materialize_grads=True)
    return loss.detach(), dict(zip(tracked, grads))


def _ties(torch, got, want, label) -> float:
    """int8 codes or bfloat16 moments of two devices: equal but at rounding
    ties (each by one code or bfloat16 ulp, a share of at most
    ``TRAIN_TIE_SHARE``); returns the differing share."""
    if want.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    diff = (got.cpu().long() - want.long()).abs()
    share = float((diff != 0).double().mean())
    _need(int(diff.max()) <= 1 and share <= TRAIN_TIE_SHARE,
          f"{label}: codes differ by up to {int(diff.max())} on a share "
          f"{share:.3g}")
    return share


def _close_scaled(torch, got, want, rtol, label) -> float:
    """Max abs error of ``got`` against ``want`` within rtol and an atol of
    rtol x ``want``'s largest magnitude (a leaf's values near zero carry
    the rounding of its large ones)."""
    scale = max(_top(want.abs()), 1e-30)
    return _lm_err(torch, got, want, dict(rtol=rtol, atol=rtol * scale),
                   label)


def _leaf_err(torch, got, want, tol, label) -> float:
    """A gradient leaf held on its own scale: ``got`` and ``want`` over
    ``want``'s largest magnitude within ``tol``; returns that max abs
    error."""
    scale = max(_top(want.abs()), 1e-30)
    return _lm_err(torch, got / scale, want / scale, tol, label)


def _train_adamw(torch, dev, p_cpu, grads, arch):
    """``adamw_update`` on the same state and gradients on the card and the
    CPU, float32 master, for every moment dtype, two steps (each from the
    CPU's state): master to ``TRAIN_ADAMW_RTOL``, moments likewise (codes
    and bfloat16 moments by ``_ties``).  Returns the largest errors."""
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training import AdamWConfig, adamw_init, adamw_update

    errs = {}
    g_dev = tree_map(lambda t: t.to(dev), grads)
    for md in ("float32", "bfloat16", "int8"):
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                           moment_dtype=md)
        cpu = adamw_init(p_cpu, ocfg)
        err = share = 0.0
        for step in range(2):
            card = tree_map(lambda t: t.to(dev, copy=True), cpu)
            card, mc = adamw_update(g_dev, card, ocfg)
            cpu, mh = adamw_update(grads, cpu, ocfg)
            err = max(err, _close_scaled(
                torch, mc["grad_norm"], mh["grad_norm"], TRAIN_ADAMW_RTOL,
                f"train {arch} adamw {md} grad norm"))
            for got, want in zip(tree_leaves(card["master"]),
                                 tree_leaves(cpu["master"])):
                err = max(err, _close_scaled(torch, got, want,
                                             TRAIN_ADAMW_RTOL,
                                             f"train {arch} adamw {md} "
                                             f"master, step {step + 1}"))
            for got, want in zip(tree_leaves(card["moments"]),
                                 tree_leaves(cpu["moments"])):
                if want.dtype in (torch.int8, torch.bfloat16):
                    share = max(share, _ties(torch, got, want,
                                             f"train {arch} adamw {md}"))
                else:
                    err = max(err, _close_scaled(
                        torch, got, want, TRAIN_ADAMW_RTOL,
                        f"train {arch} adamw {md} moments"))
        errs[md] = (err, share)
    return errs


def _train_families(torch, dev, smi):
    """Every LM family's reduced arch: float32 loss and gradients on the
    card held to the CPU's, MoE routing integers equal, AdamW held to the
    CPU for each moment dtype, and one bfloat16 train step, finite."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.models import build_model, init_params, moe
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)
    from repro_torch.training.optimizer import _global_norm

    t0 = time.time()
    cpu = torch.device("cpu")
    archs = [a for a in ARCHS if a != "wlsh_index"]
    route = moe._route
    for i, arch in enumerate(archs):
        base = reduced(get_config(arch))
        model = build_model(dataclasses.replace(base, dtype="float32"))
        p_cpu = init_params(model.defs(),
                            torch.Generator().manual_seed(200 + i),
                            device="cpu")
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        batch = _train_batch(torch, base, np.random.default_rng(200 + i),
                             TRAIN["family_batch"], TRAIN["family_seq"])
        routes = []

        def recorded(*a, **kw):
            out = route(*a, **kw)
            routes.append([t.cpu() for t in (out[0], out[1], out[3])])
            return out

        moe._route = recorded
        try:
            loss_c, g_c = _train_grads(torch, model, p_cpu, batch)
            n_routes = len(routes)
            loss_d, g_d = _train_grads(
                torch, model, p_dev, {k: v.to(dev) for k, v in batch.items()})
        finally:
            moe._route = route
        _need(len(routes) == 2 * n_routes and all(
            torch.equal(a, b) for rc, rd in zip(routes[:n_routes],
                                                routes[n_routes:])
            for a, b in zip(rc, rd)),
            f"train {arch}: MoE routing integers differ card vs CPU")
        errs = [_lm_err(torch, loss_d, loss_c, LM_F32_TOL,
                        f"train {arch} loss"),
                _lm_err(torch, _global_norm(g_d), _global_norm(g_c),
                        LM_F32_TOL, f"train {arch} grad norm")]
        # most of a reduced arch's gradient entries are ~1e-4 or smaller
        errs += [_leaf_err(torch, g_d[k], g_c[k], LM_F32_TOL,
                           f"train {arch} grad {k}") for k in g_c]
        it = iter(g_c.values())  # the CPU gradients, as a tree
        grads = tree_map(lambda _: next(it), p_cpu)
        adamw = _train_adamw(torch, dev, p_cpu, grads, arch)
        bf = build_model(base)  # the config's own bfloat16 compute
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        state = init_train_state(bf.defs(), p_dev, ocfg)
        state, m = make_train_step(bf, ocfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        finite = (bool(torch.isfinite(m["loss"])) and bool(
            torch.isfinite(m["grad_norm"])) and all(
            bool(torch.isfinite(t.float()).all())
            for t in tree_leaves(state["opt"]["master"])))
        _need(finite, f"train {arch}: bfloat16 train step not finite")
        say(f"train family {arch} ({base.family}): card vs CPU float32 loss "
            f"{loss_c.item():.5f} (max abs err {errs[0]:.3g}), grad norm "
            f"{_global_norm(g_c).item():.5f} ({errs[1]:.3g}), "
            f"{len(g_c)} gradient leaves max abs err over the leaf's largest "
            f"magnitude {max(errs[2:]):.3g}; "
            f"{n_routes // 2 if n_routes else 0} MoE routings equal; adamw "
            + ", ".join(f"{md} moments max abs err {e:.3g}"
                        + (f" (ties {sh:.2g})" if md != "float32" else "")
                        for md, (e, sh) in adamw.items())
            + f"; bfloat16 train step loss {m['loss'].item():.4f}, finite")
    say(f"train families: {len(archs)} archs held to rtol "
        f"{LM_F32_TOL['rtol']:g}, atol {LM_F32_TOL['atol']:g} (gradients "
        f"over each leaf's largest magnitude); adamw to "
        f"rtol {TRAIN_ADAMW_RTOL:g} (atol that x the leaf's largest value), "
        f"codes at ties at most {TRAIN_TIE_SHARE:g}; "
        f"{time.time() - t0:.1f}s [{smi}]")


def _train_hold(torch, dev, smi):
    """olmo-1b at full width, float32: the loss and the gradients of
    embed/tok and of the first and last layer's attn/wq and mlp leaves on
    the card held to the CPU's; a TF32 control must fall outside."""
    import dataclasses

    from repro_torch.models import build_model, init_params
    from repro_torch.models.params import tree_map

    t0 = time.time()
    cfg = dataclasses.replace(_lm_full_config(), dtype="float32")
    model = build_model(cfg)
    params = init_params(model.defs(),
                         torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    batch = _train_batch(torch, cfg, np.random.default_rng(13), 1,
                         TRAIN["hold_seq"])
    wanted = {"['embed']['tok']", "['blocks']['attn']['wq']",
              "['blocks']['mlp']['wd']", "['blocks']['mlp']['wg']",
              "['blocks']['mlp']['wu']"}
    b_dev = {k: v.to(dev) for k, v in batch.items()}
    loss_d, g_d = _train_grads(torch, model, params, b_dev, wanted)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loss_t, g_t = _train_grads(torch, model, params, b_dev, wanted)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    p_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    loss_c, g_c = _train_grads(torch, model, p_cpu, batch, wanted)
    del p_cpu

    def held(g):
        """The held slices: embed/tok whole, the stacked leaves' first and
        last layer."""
        out = {}
        for k, v in g.items():
            if v.dim() == 3:
                out[f"{k}[0]"], out[f"{k}[-1]"] = v[0], v[-1]
            else:
                out[k] = v
        return out

    h_d, h_t, h_c = held(g_d), held(g_t), held(g_c)
    tol = TRAIN_FULL_TOL
    err_loss = _lm_err(torch, loss_d, loss_c, tol, "train hold loss")
    errs, outside, total = {}, 0, 0
    for k, want in h_c.items():
        errs[k] = _leaf_err(torch, h_d[k], want, tol, f"train hold grad {k}")
        scale = max(_top(want.abs()), 1e-30)
        g, w = (h_t[k].cpu() / scale).double(), (want / scale).double()
        outside += int(((g - w).abs() > tol["atol"]
                        + tol["rtol"] * w.abs()).sum())
        total += w.numel()
    tf32_loss = abs(loss_t.item() - loss_c.item())
    say(f"train hold: {cfg.name} full width float32, 1 x {TRAIN['hold_seq']}"
        f" tokens, card vs CPU: loss {loss_c.item():.6f} (max abs err "
        f"{err_loss:.3g}); gradients scaled by each leaf's largest "
        f"magnitude, max abs err " + ", ".join(
            f"{k} {e:.3g}" for k, e in errs.items())
        + f", within rtol {tol['rtol']:g}, atol {tol['atol']:g}; control "
        f"with TF32 matmuls: loss err {tf32_loss:.3g}, {outside} of {total} "
        f"gradient values outside ({time.time() - t0:.1f}s) [{smi}]")
    _need(outside > 0, "train hold: the TF32 control passes the float32 "
          "tolerance, which then cannot tell TF32 matmuls from float32")
    _release(torch)


def _train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of a train step (6 N T over the matrix products'
    parameters, the tied unembedding included, plus the attention scores
    and values at full 512-blocks: 12 L S d a token, forward and
    backward); rematerialization's recompute is not counted."""
    d, L = cfg.d_model, cfg.n_layers
    attn = d * cfg.head_dim_ * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 3 * d * cfg.d_ff
    n = L * (attn + mlp) + d * cfg.vocab
    return 6.0 * n * tokens + 12.0 * L * seq * cfg.n_heads * (
        cfg.head_dim_) * tokens


def _train_launch(torch, dev, steps, ckpt=None, fail_at=None,
                  optimizer=None):
    """``launch/train.py::train`` on olmo-1b at full width: ``optimizer``
    holds the ``AdamWConfig`` fields that replace the launcher's (None runs
    it as shipped: float32 master and moments); returns (report, per step
    (CUDA-event ms, loss, optimizer step)) from the launcher's own
    report."""
    import repro_torch.launch.train as T

    argv = ["--arch", LM["arch"], "--steps", str(steps), "--global-batch",
            str(TRAIN["batch"]), "--seq-len", str(TRAIN["seq"]), "--lr",
            str(TRAIN["lr"]), "--log-every", "5", "--device", str(dev)]
    if ckpt is not None:
        argv += ["--ckpt-dir", ckpt, "--ckpt-every", str(TRAIN["ckpt_every"])]
    if fail_at is not None:
        argv += ["--fail-at", str(fail_at)]
    out = T.train(T.parse_args(argv), cfg=_lm_full_config(),
                  optimizer=optimizer)
    return out, [(r["ms"], r["loss"], r["opt_step"]) for r in out["steps"]]


def _train_default(torch, dev, smi):
    """The launcher as a user runs it from the command line (float32
    master and moments) at full width, a few steps: finite losses, ms a
    step, the state's bytes and peak memory."""
    from repro_torch.models import abstract_params, build_model, tree_bytes
    from repro_torch.training import AdamWConfig, train_state_defs

    cfg = _lm_full_config()
    _reset_peak(torch, dev)
    t0 = time.time()
    out, run = _train_launch(torch, dev, TRAIN["default_steps"])
    peak = _peak(torch, dev)
    losses = [loss for _, loss, _ in run]
    _need(out["restarts"] == 0 and bool(np.isfinite(losses).all()),
          f"train default: restarts {out['restarts']}, losses {losses}")
    ms = np.array([m for m, _, _ in run[1:]])  # the first step warms
    state_bytes = tree_bytes(abstract_params(train_state_defs(
        build_model(cfg).defs(), AdamWConfig())))
    say(f"train default: {cfg.name} full width through launch/train.py as "
        f"shipped (bfloat16 compute, float32 master and moments), "
        f"{TRAIN['batch']} x {TRAIN['seq']} tokens, {len(run)} steps, "
        f"losses " + " ".join(f"{x:.4f}" for x in losses) + f"; per step "
        f"(CUDA events, steps 1-{len(run) - 1}) p50 "
        f"{np.percentile(ms, 50):.2f} ms, max {ms.max():.2f} ms; train "
        f"state {state_bytes} bytes; peak device memory {peak} bytes; "
        f"{time.time() - t0:.1f}s [{smi}]")
    _release(torch)
    return dict(step_ms=ms.tolist(), peak=peak, state_bytes=state_bytes)


def _train_run(torch, dev, smi):
    """olmo-1b at full width trained through the launcher: an injected
    failure and one restart from the last checkpoint, then an
    uninterrupted twin; checkpoint save and load timed; one step
    profiled."""
    import shutil
    import tempfile

    from repro_torch.models import abstract_params, build_model, tree_bytes
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      SyntheticStream, load_checkpoint,
                                      make_train_step, save_checkpoint,
                                      train_state_defs)

    cfg = _lm_full_config()
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    dirs = [tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build)
            for _ in range(3)]
    steps, every, fail = TRAIN["steps"], TRAIN["ckpt_every"], TRAIN["fail_at"]
    try:
        _reset_peak(torch, dev)
        t0 = time.time()
        out, run = _train_launch(torch, dev, steps, dirs[0], fail, TRAIN_OPT)
        peak = _peak(torch, dev)
        t_run = time.time() - t0
        t0 = time.time()
        twin_out, twin = _train_launch(torch, dev, steps, dirs[1],
                                       optimizer=TRAIN_OPT)
        t_twin = time.time() - t0

        resumed = (fail // every) * every
        want_steps = (list(range(1, fail + 2))
                      + list(range(resumed + 1, steps + 1)))
        got_steps = [s for _, _, s in run]
        _need(out["restarts"] == 1 and got_steps == want_steps,
              f"train run: restarts {out['restarts']}, optimizer steps "
              f"{got_steps} (want {want_steps})")
        _need(twin_out["restarts"] == 0
              and [s for _, _, s in twin] == list(range(1, steps + 1)),
              "train twin: not one uninterrupted run")
        losses = [loss for _, loss, _ in run]
        twin_l = np.array([loss for _, loss, _ in twin])
        _need(bool(np.isfinite(losses).all() and np.isfinite(twin_l).all()),
              "train run: a loss is not finite")
        after = np.array(losses[fail + 1:])  # steps resumed .. steps - 1
        ref = twin_l[resumed:]
        rel = float(np.max(np.abs(after - ref) / np.abs(ref)))
        bit = bool(np.array_equal(after, ref))
        _need(rel <= TRAIN["resume_rtol"],
              f"train resume: losses after the restart differ from the "
              f"twin's by {rel:.3g} (relative)")
        first, last5 = losses[0], float(np.mean(after[-5:]))
        _need(last5 < first, f"train run: mean of the last 5 losses "
              f"{last5:.4f} not below the first {first:.4f}")
        say(f"train run: {cfg.name} full width ({TRAIN['batch']} x "
            f"{TRAIN['seq']} tokens a step, bfloat16 compute and master, "
            f"int8 moments, update_chunk {TRAIN_OPT['update_chunk']}, lr "
            f"{TRAIN['lr']:g}), {steps} steps, checkpoints every {every}, "
            f"failure injected at step {fail}: restarts {out['restarts']}, "
            f"resumed at step {resumed}; losses " + " ".join(
                f"{x:.4f}" for x in losses) + f"; {t_run:.1f}s [{smi}]")
        say(f"train resume: steps {resumed}-{steps - 1} after the restart vs "
            f"the uninterrupted twin: max relative difference {rel:.3g} "
            f"(limit {TRAIN['resume_rtol']:g}), bit-equal {bit} "
            f"(torch.use_deterministic_algorithms "
            f"{torch.are_deterministic_algorithms_enabled()}); first loss "
            f"{first:.4f}, mean of the last 5 {last5:.4f}; twin "
            f"{t_twin:.1f}s [{smi}]")

        ms = np.array([m for m, _, _ in twin[1:]])  # the first step warms
        tokens = TRAIN["batch"] * TRAIN["seq"]
        p50 = float(np.percentile(ms, 50))
        flops = _train_flops(cfg, tokens, TRAIN["seq"])
        ocfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=10, total_steps=steps,
                           **TRAIN_OPT)
        model = build_model(cfg)
        template = abstract_params(train_state_defs(model.defs(), ocfg))
        state_bytes = tree_bytes(template)
        say(f"train step: {cfg.name} {tokens} tokens a step, per step (CUDA "
            f"events, twin steps 1-{steps - 1}) p50 {p50:.2f} ms, p95 "
            f"{np.percentile(ms, 95):.2f} ms, first {twin[0][0]:.2f} ms; "
            f"{tokens / (p50 / 1e3):.0f} tokens/s at p50 "
            f"({steps * tokens / twin_out['wall_s']:.0f} over the twin's "
            f"wall, checkpoints and data included); model FLOPs "
            f"{flops / 1e12:.2f} T a step (6 N T + attention, no recompute) "
            f"= {flops / (p50 / 1e3) / 1e12:.1f} TFLOP/s, "
            f"{flops / (p50 / 1e3) / BF16_PEAK_FLOPS:.1%} of the bfloat16 "
            f"dense peak; train state {state_bytes} bytes; peak device "
            f"memory {peak} bytes [{smi}]")

        _sync(torch, dev)
        t0 = time.perf_counter()
        _, state, _ = load_checkpoint(dirs[1], template, device=dev)
        _sync(torch, dev)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_checkpoint(dirs[2], steps, state)
        t_save = time.perf_counter() - t0
        say(f"train checkpoint: {state_bytes} bytes, save (device to host, "
            f"np.save, rename) {t_save:.2f}s = "
            f"{state_bytes / t_save / 1e9:.2f} GB/s, load (np.load, to the "
            f"card) {t_load:.2f}s = {state_bytes / t_load / 1e9:.2f} GB/s "
            f"[{smi}]")

        stream = SyntheticStream(DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN["seq"],
            global_batch=TRAIN["batch"], mode="markov"))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.global_batch(steps).items()}
        step = make_train_step(model, ocfg)
        prof = _lm_profile(torch, dev, lambda: step(state, batch),
                           f"train step ({TRAIN['batch']} x {TRAIN['seq']})",
                           smi, calls=TRAIN["profile_calls"])
        del state
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    _release(torch)
    return dict(step_ms=ms.tolist(), tok_s=tokens / (p50 / 1e3), peak=peak,
                state_bytes=state_bytes, save_s=t_save, load_s=t_load,
                mfu=flops / (p50 / 1e3) / BF16_PEAK_FLOPS, prof=prof,
                losses=losses, resume_rel=rel, resume_bit=bit)


def _train_example_start():
    """examples/train_lm_torch.py's quick mode on the card, in a process of
    its own (it runs beside the families and the hold, which time
    nothing)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", "train_lm_torch.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def _train_example_finish(proc, t0: float, smi) -> None:
    """Wait for the example and hold it to its own assertions."""
    out, err = proc.communicate(timeout=TRAIN["example_timeout_s"])
    last = out.strip().splitlines()[-1:] or [""]
    _need(proc.returncode == 0 and last[0].startswith("ok:"),
          f"train example exit {proc.returncode}: {err[-2000:]}")
    say(f"train example: examples/train_lm_torch.py on the card, "
        f"{time.time() - t0:.1f}s: {last[0]} [{smi}]")


def phase_train(torch, dev, smi):
    """The LM substrate's training side on the card (see the module
    docstring); it launches none of the retrieval kernels."""
    from repro_torch.kernels import _cuda

    t0 = time.time()
    _release(torch)
    _cuda.reset_launch_counts()
    proc = _train_example_start()
    try:
        _train_families(torch, dev, smi)
        _train_hold(torch, dev, smi)
        _train_example_finish(proc, t0, smi)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    out = _train_run(torch, dev, smi)
    out["default"] = _train_default(torch, dev, smi)
    _need_launches(_cuda.launch_counts(), dict.fromkeys(KERNELS, 0), "train")
    say(f"train phase: {time.time() - t0:.1f}s [{smi}]")
    return out


# the mesh leg: the production dry-run's cells (arch, shape) on the single
# pod's (16, 16) mesh, the children's time limit, the reduced families'
# train step (batch x sequence) and optimizer, and the launcher's steps
# with and without a (1, 1) mesh
MESH = dict(dryrun=(("olmo-1b", "train_4k"), ("olmoe-1b-7b", "train_4k")),
            child_timeout_s=400, family_batch=2, family_seq=32,
            launch_steps=6)
# the mesh leg's index steps: the slice's widest group's shapes (its
# IndexConfig but float32 rows and n_shards 1: one rank), and the timed
# runs of each step
MESH_INDEX = dict(n=SLICE["n"], d=SLICE["d"], beta=512, q_batch=64,
                  k=SLICE["k"], c=SLICE["c"], n_levels=16, p=SLICE["p"])
MESH_INDEX_REPS = 5
MESH_OPT = dict(master_dtype="bfloat16", moment_dtype="int8", update_chunk=1)

# the analysis child: the train leg's configuration traced on a one-rank
# (1, 1) mesh of meta tensors; its counts as JSON on the last line
_LEG_TRACE = """
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig
cfg, b, s, opt = json.loads(sys.argv[1])
model = build_model(get_config(cfg), mesh=dryrun._mesh("one", "cuda"))
r = dryrun.trace_train(model, ShapeConfig("leg", s, b, "train"),
                       AdamWConfig(**opt))
print(json.dumps(r))
"""


# the index child: the mesh leg's index steps traced on a one-rank (1, 1)
# mesh of meta tensors; their counts as JSON on the last line
_INDEX_TRACE = """
import json, sys
from repro_torch.index.config import IndexConfig
from repro_torch.launch import dryrun
icfg = IndexConfig(**json.loads(sys.argv[1]))
mesh = dryrun._mesh("one", "cuda")
print(json.dumps({k: dryrun.trace_index(icfg, k, mesh)
                  for k in ("build", "query")}))
"""


def _mesh_children():
    """Start the dry-run cells (the LM cells, the four wlsh_index cells),
    the train leg's analysis and the index steps' meta trace, each in a
    process of its own (a fake process group cannot share one with the
    card's)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for arch, shape in MESH["dryrun"]:
        procs[(arch, shape)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out,
             "--force"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=ROOT)
    leg = json.dumps([LM["arch"], TRAIN["batch"], TRAIN["seq"], TRAIN_OPT])
    procs["leg"] = subprocess.Popen(
        [sys.executable, "-c", _LEG_TRACE, leg], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    procs["index cells"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "wlsh-index", "--mesh", "both", "--out", out, "--force"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    procs["index trace"] = subprocess.Popen(
        [sys.executable, "-c", _INDEX_TRACE, json.dumps(MESH_INDEX)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    return procs, out


def _mesh_wait(proc, what: str) -> str:
    out, err = proc.communicate(timeout=MESH["child_timeout_s"])
    _need(proc.returncode == 0, f"mesh {what}: exit {proc.returncode}: "
          f"{err[-3000:]}")
    return out


def _mesh_dryrun(procs, out_dir, smi) -> None:
    """Each dry-run cell: status ok, its per-device state bytes equal to
    the local shard bytes of ``train_state_shardings`` on the (16, 16)
    mesh, and its numbers."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.models.params import torch_dtype, tree_leaves
    from repro_torch.training import train_state_defs, train_state_shardings

    pod = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 16, "model": 16})
    for arch, shape in MESH["dryrun"]:
        t0 = time.time()
        line = _mesh_wait(procs[(arch, shape)], f"dryrun {arch} {shape}")
        name = arch.replace("-", "_")
        with open(os.path.join(out_dir, f"{name}__{shape}__single.json")) as f:
            r = json.load(f)
        _need(r["status"] == "ok", f"mesh dryrun {arch} {shape}: "
              f"{r.get('error')}\n{r.get('traceback', '')[-2000:]}")
        cfg = get_config(arch)
        ocfg = dryrun._opt_cfg(name)
        sdefs = train_state_defs(build_model(cfg).defs(), ocfg)
        want = sum(
            int(np.prod(sh.shard_shape(d.shape)))
            * torch_dtype(d.dtype).itemsize
            for d, sh in zip(tree_leaves(sdefs), tree_leaves(
                train_state_shardings(build_model(cfg).defs(), ocfg, pod))))
        got = r["memory"]["state_bytes"]
        _need(got == want, f"mesh dryrun {arch}: state bytes a device {got}"
              f", the local shards of train_state_shardings {want}")
        c = r["coll_detail"]["bytes"]
        say(f"mesh dryrun {arch} {shape} on (16, 16) = {r['chips']} cards "
            f"(fake group, meta tensors, {r['analysis_method']}): "
            f"{r['hbm_gb']} GB a device (fits 80 GB: {r['fits_hbm']}; state "
            f"{got} bytes = the local shards of train_state_shardings), "
            f"{r['hlo_flops_per_chip']:.4g} FLOPs a device (model "
            f"{r['model_flops']:.4g} over all, useful "
            f"{r['useful_fraction']:.3f}), {r['hlo_bytes_per_chip']:.4g} "
            f"bytes a device, collectives {r['coll_bytes_per_chip']:.4g} "
            f"bytes a device (by kind: {c['by_kind']}; "
            f"{c['per_layer_bytes']:.4g} a layer); terms compute "
            f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
            f"collective {r['collective_s']:.4g} s -> {r['bottleneck']}; "
            f"traced in {r['compile_s']} s, waited {time.time() - t0:.1f}s; "
            f"{line.strip().splitlines()[-1][:60]!r} [{smi}]")


def _mesh_index_cells(proc, out_dir, smi) -> None:
    """The dry-run's wlsh_index cells: build (train_4k) and query
    (prefill_32k) ok on both production meshes, the decode shapes
    skipped; state bytes a device the local shard's, and their numbers."""
    from repro_torch.index.config import IndexConfig

    t0 = time.time()
    _mesh_wait(proc, "index cells")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for mesh in ("single", "multi"):
            with open(os.path.join(out_dir, f"wlsh_index__{shape}__{mesh}"
                                   ".json")) as f:
                r = json.load(f)
            if shape.startswith(("decode", "long")):
                _need(r["status"] == "skipped", f"mesh index {shape} {mesh}:"
                      f" {r['status']}, expected skipped")
                continue
            _need(r["status"] == "ok", f"mesh index {shape} {mesh}: "
                  f"{r.get('error')}\n{r.get('traceback', '')[-2000:]}")
            icfg = IndexConfig(**r["index_cfg"])
            mem, c = r["memory"], r["coll_detail"]
            if shape == "prefill_32k":  # n_valid is a launch argument
                _need(mem["state_bytes"] + 4 == icfg.state_nbytes,
                      f"mesh index {mesh}: state {mem['state_bytes']} B, "
                      f"state_nbytes {icfg.state_nbytes}")
            ks = ", ".join(f"{k} {v['launches']} launch {1e3 * v['ops_s']:.3f}"
                           f" ms" for k, v in r["kernels"].items())
            say(f"mesh index cell {shape} {mesh} = {r['chips']} cards (meta, "
                f"{r['analysis_method']}): {r['hbm_gb']} GB a device "
                f"(arguments {mem['argument_bytes']} B, "
                + (f"state {mem['state_bytes']}" if "state_bytes" in mem
                   else f"rows {mem['points_bytes']}")
                + f" B, temp {mem['temp_bytes']} B), "
                f"{r['hlo_flops_per_chip']:.4g} "
                f"FLOPs a device (useful {r['useful_fraction']:.3f}; kernels "
                f"{ks}), {r['hlo_bytes_per_chip']:.4g} bytes, collectives "
                f"{c['total']} B {c['counts']}; terms compute "
                f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s, "
                f"collective {r['collective_s']:.4g} s -> {r['bottleneck']} "
                f"[{smi}]")
    say(f"mesh index cells: 4 ok, 4 skipped; waited {time.time() - t0:.1f}s")


def _mesh_index_state(torch, dev):
    """Seeded rows on the card, a p = 2 family (on the host) and 64
    queries near the rows ``take``, at the mesh leg's index shapes."""
    from repro_torch.core.distances import radius_bounds
    from repro_torch.core.families import sample_lp_family

    mi = MESH_INDEX
    n, d, beta, q = mi["n"], mi["d"], mi["beta"], mi["q_batch"]
    rng = np.random.default_rng(11)
    w = rng.uniform(1.0, 10.0, d)  # the group's center weight
    r_min, r_max = radius_bounds(w, 10_000.0, mi["p"])
    fam = sample_lp_family(d, beta, mi["p"], r_min, w, r_max / r_min,
                           mi["c"], seed=12)

    def put(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)

    g = torch.Generator(device=dev).manual_seed(13)
    points = torch.randint(0, 10_001, (n, d), generator=g, device=dev,
                           dtype=torch.int32).float()
    take = torch.randperm(n, generator=g, device=dev)[:q]
    queries = points[take] + 3.0 * torch.randn((q, d), generator=g,
                                               device=dev)
    wq = w[None, :] * rng.uniform(0.8, 1.2, (q, d))
    beta_q = rng.integers(int(0.86 * beta), int(0.9 * beta) + 1, q)
    return dict(
        fam=fam, take=take, points=points, queries=queries,
        q_weight=put(wq, np.float32),
        mu=put([rng.integers(b // 5, 3 * b // 5) for b in beta_q], np.int32),
        beta_q=put(beta_q, np.int32), r_min=put(wq.min(axis=1), np.float32),
        levels_q=put(np.full(q, mi["n_levels"]), np.int32))


def _mesh_index(torch, dev, mesh, proc, smi):
    """The index's mesh steps on the one-rank mesh (see the module
    docstring).  Returns the launches of the steps' own run and every
    launch the leg makes."""
    from repro_torch.distributed.group_sharding import (distribute_state,
                                                        state_shardings)
    from repro_torch.index.builder import (build_state, fold_center_weight,
                                           make_build_step)
    from repro_torch.index.config import IndexConfig
    from repro_torch.index.engine import (QueryState, encode_queries,
                                          make_query_step, query_step)
    from repro_torch.kernels import _cuda, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import analyze

    t0 = time.time()
    icfg = IndexConfig(**MESH_INDEX)
    x = _mesh_index_state(torch, dev)
    folded = {k: torch.as_tensor(v, device=dev)
              for k, v in fold_center_weight(x["fam"]).items()}
    fam = {k: folded[k] for k in ("proj", "b_int", "b_frac")}
    fields = ("codes", "points", "proj", "b_int", "b_frac", "width")
    before = _cuda.launch_counts()
    # the main path: build the state, encode the queries, answer them
    state = build_state(mesh, icfg, x["points"], x["fam"])
    local = QueryState(n_valid=state.n_valid, **{
        f: getattr(state, f).to_local() for f in fields})
    q_codes = encode_queries(local, x["queries"])
    args = [x["queries"], q_codes, x["q_weight"], x["mu"], x["r_min"],
            x["beta_q"], x["levels_q"]]
    step = make_query_step(mesh, icfg)
    got = [o.to_local() for o in step(state, *args)]
    _sync(torch, dev)
    now = _cuda.launch_counts()
    main = {k: now[k] - before[k] for k in now}
    _need_launches(main, {**_served(1),
                          "hash_encode": 2, "freq_level": 0,
                          "weighted_lp": 0}, "mesh index steps")

    # held to make_build_step + distribute_state, the device encode and
    # the device-list engine
    build = make_build_step(mesh, icfg)
    codes, vecs = build(x["points"], *fam.values())
    hand = distribute_state(QueryState(
        codes=codes.full_tensor(), points=vecs.full_tensor(),
        width=folded["width"], n_valid=icfg.n, **fam),
        state_shardings(mesh, icfg))
    differ = [f for f in fields if tuple(getattr(state, f).placements)
              != tuple(getattr(hand, f).placements) or not torch.equal(
                  getattr(local, f), getattr(hand, f).to_local())]
    _need(not differ and state.n_valid == hand.n_valid == icfg.n,
          f"mesh index: build_state differs from make_build_step + "
          f"distribute_state in {differ} (n_valid {state.n_valid})")
    ones = torch.ones(icfg.d, dtype=torch.float32, device=dev)
    want_codes = ops.hash_encode(x["points"], ones, *fam.values(), 1.0)
    _need(torch.equal(local.codes, want_codes)
          and torch.equal(local.points, x["points"]),
          "mesh index: build_state differs from the device encode")
    want = query_step(local, *args, cfg=icfg)
    same = [torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(got, want)]
    _need(all(same), f"mesh index: make_query_step differs from query_step "
          f"(dists, ids, stop, n_checked equal: {same})")

    # the counter on the real CUDA steps against the meta trace
    inputs = dict(query=dict(state=local, **dict(zip(
        ("queries", "q_codes", "q_weight", "mu", "r_min", "beta_q",
         "levels_q"), args))), build=dict(points=x["points"], **fam))
    card = {k: dryrun.trace_index(icfg, k, mesh, v, device=dev)
            for k, v in inputs.items()}
    meta = json.loads(_mesh_wait(proc, "index trace").strip()
                      .splitlines()[-1])
    for kind in ("build", "query"):
        a, b = card[kind], meta[kind]
        diff = [k for k in ("flops", "bytes", "coll", "kernels", "memory",
                            "kernel_flops", "kernel_s") if a[k] != b[k]]
        _need(not diff, f"mesh index {kind}: the counter on the card and "
              f"the meta trace differ in {diff}: {[a[k] for k in diff]} vs "
              f"{[b[k] for k in diff]}")

    # each step's measured time over its roofline step
    reps = MESH_INDEX_REPS
    ms = dict(
        build=_time_ms(lambda: build(x["points"], *fam.values()), torch,
                       reps),
        query=_time_ms(lambda: step(state, *args), torch, reps))
    ms_state = _time_ms(lambda: build_state(mesh, icfg, x["points"],
                                            x["fam"]), torch, reps)
    ms_list = _time_ms(lambda: query_step(local, *args, cfg=icfg), torch,
                       reps)
    n, q, d = icfg.n, icfg.q_batch, icfg.d
    useful = dict(build=2.0 * n * d * icfg.beta, query=4.0 * q * n * d)
    for kind in ("build", "query"):
        rr = analyze("wlsh_index", kind, "one", 1, card[kind], useful[kind])
        roof = 1e3 * rr.step_time_s
        ks = card[kind]["kernels"]
        say(f"mesh index {kind} step (n={n} d={d} beta_pad={icfg.beta} "
            f"Q={q} L={icfg.n_levels}, one-rank NCCL mesh): measured "
            f"{ms[kind]:.3f} ms a step (mean of {reps}) over the roofline "
            f"{roof:.3f} ms (compute {1e3 * rr.compute_s:.3f}, memory "
            f"{1e3 * rr.memory_s:.3f} -> {rr.bottleneck}) = "
            f"{ms[kind] / roof:.2f}x; the counter's FLOPs "
            f"{rr.hlo_flops_per_chip:.6g}, bytes {rr.hlo_bytes_per_chip:.6g},"
            f" kernels {sorted(ks)} (= the meta trace's); predicted peak "
            f"{card[kind]['memory']['total_bytes']} B"
            + (f"; the device-list engine {ms_list:.3f} ms" if kind ==
               "query" else f"; build_state {ms_state:.3f} ms (the fold, "
               f"the family's upload and layout on top)") + f" [{smi}]")
    _mesh_count_level(torch, local.codes, q_codes, x["take"], smi)
    stop, n_checked = got[2].float(), got[3].float()
    say(f"mesh index: build_state bit-equal to make_build_step + "
        f"distribute_state and to the device encode, the query step to "
        f"query_step; mean stop {stop.mean():.2f}, mean n_checked "
        f"{n_checked.mean():.1f}; {time.time() - t0:.1f}s [{smi}]")
    # every launch of the leg: the steps' run, the holds, the counter's
    # runs and the timed runs
    total = dict(main, hash_encode=main["hash_encode"] + 3 + 2 * reps,
                 fused_query_keep=main["fused_query_keep"] + 2 + 2 * reps,
                 fused_query_mask=main["fused_query_mask"] + 2 + 2 * reps)
    return main, total


def _mesh_count_level(torch, codes, q_codes, take, smi) -> None:
    """``kernels/ref.py``'s ``count_level_ref`` (the paper-faithful
    collision counts at one level; plain torch, no kernel) on the card
    against the same call on the CPU, bit for bit: the query codes against
    4,096 state rows, the queries' own source rows first; the second half
    of the rows and of the queries negated (-x - 1, which keeps their
    collisions at every level) for floor division below zero."""
    from repro_torch.kernels import ref

    def neg(t):
        return torch.cat([t[:len(t) // 2], -t[len(t) // 2:] - 1])

    q, h, half = len(take), len(take) // 2, 2048
    cp = neg(torch.cat([codes[take[:h]], codes[:half - h],
                        codes[take[h:]], codes[half:2 * half - (q - h)]]))
    cq = neg(q_codes)
    own = torch.cat([torch.arange(h), half + torch.arange(q - h)])
    cp_h, cq_h = cp.cpu(), cq.cpu()
    means = []
    for level in range(4):
        got = ref.count_level_ref(cp, cq, 3, level)
        want = ref.count_level_ref(cp_h, cq_h, 3, level)
        _need(got.device == cp.device and got.dtype == torch.int32
              and torch.equal(got.cpu(), want),
              f"count_level_ref at level {level}: the card differs from "
              f"the CPU")
        means.append(f"{want[torch.arange(q), own].double().mean():.1f} / "
                     f"{want.double().mean():.3f}")
    ms = _time_ms(lambda: ref.count_level_ref(cp, cq, 3, 3), torch, 3)
    say(f"count_level_ref: (Q, n, beta) = ({cq.shape[0]}, {cp.shape[0]}, "
        f"{cp.shape[1]}), c = 3, levels 0-3 on the card equal to the CPU bit "
        f"for bit; mean counts with the query's own row / over all rows "
        f"{'; '.join(means)}; {ms:.3f} ms a call at level 3 [{smi}]")


def _mesh_analysis(torch, dev, proc, train, smi) -> None:
    """The train leg's configuration traced on a one-rank mesh: its state
    bytes equal to the train leg's, its FLOP count equal to
    ``FlopCounterMode`` on the real step on the card; its roofline step
    and predicted peak beside the train leg's measured ones."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.roofline import HW
    from repro_torch.models import (abstract_params, build_model,
                                    init_params, tree_bytes)
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      SyntheticStream, init_train_state,
                                      make_train_step, train_state_defs)

    cfg = _lm_full_config()
    ocfg = AdamWConfig(lr=TRAIN["lr"], **TRAIN_OPT)
    model = build_model(cfg)
    state_bytes = tree_bytes(abstract_params(train_state_defs(model.defs(),
                                                              ocfg)))
    params = init_params(model.defs(), torch.Generator(device=dev)
                         .manual_seed(0), device=dev)
    state = init_train_state(model.defs(), params, ocfg)
    del params
    stream = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN["seq"], global_batch=TRAIN["batch"],
        mode="markov"))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.global_batch(0).items()}
    step = make_train_step(model, ocfg)
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    _sync(torch, dev)
    card_flops = fc.get_total_flops()
    del state
    _release(torch)

    r = json.loads(_mesh_wait(proc, "analysis").strip().splitlines()[-1])
    mem = r["memory"]
    _need(mem["state_bytes"] == state_bytes, f"mesh analysis: state bytes "
          f"{mem['state_bytes']}, the train leg's {state_bytes}")
    _need(int(r["flops"]) == int(card_flops), f"mesh analysis: FLOPs "
          f"{r['flops']}, FlopCounterMode on the card {card_flops}")
    hw = HW()
    terms = dict(compute=r["flops"] / hw.peak_flops,
                 memory=r["bytes"] / hw.hbm_bw,
                 collective=r["coll"] / hw.link_bw)
    roof_ms = 1e3 * max(terms.values())
    if train is not None:
        ms = float(np.percentile(train["step_ms"], 50))
        peak = train["peak"]
        vs = (f"measured p50 {ms:.2f} ms a step (train leg) = "
              f"{ms / roof_ms:.2f}x the roofline; predicted peak "
              f"{mem['total_bytes']} bytes vs max_memory_allocated {peak} "
              f"= {mem['total_bytes'] / peak:.3f}")
    else:
        vs = "the train leg's ms and peak not measured in this call"
    say(f"mesh analysis: {cfg.name} {TRAIN['batch']} x {TRAIN['seq']} tokens"
        f", {TRAIN_OPT} on a (1, 1) mesh of meta tensors: state "
        f"{mem['state_bytes']} bytes (= the train leg's), FLOPs "
        f"{r['flops']:.6g} (= FlopCounterMode on the card's step), bytes "
        f"{r['bytes']:.4g}, predicted peak {mem['total_bytes']} bytes; "
        f"roofline terms " + ", ".join(
            f"{k} {1e3 * v:.3f} ms" for k, v in terms.items())
        + f" -> {roof_ms:.3f} ms ({hw.name}); {vs} [{smi}]")


def _mesh_group(torch, dev):
    """A one-rank NCCL group on the card and a (1, 1) mesh over it."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def _mesh_families(torch, dev, mesh, smi) -> None:
    """Every family's reduced arch: one train step through
    ``train_state_shardings`` / ``batch_shardings`` on the (1, 1) mesh,
    loss, every gradient and the new state bit-equal to the step without
    a mesh; ``_moe_block_ep`` bit-equal to ``_moe_block_global``."""
    from repro_torch.configs import ARCHS, ShapeConfig, get_config, reduced
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.models import build_model, init_params, make_batch
    from repro_torch.models.moe import _moe_block_ep, _moe_block_global
    from repro_torch.models.params import distribute, tree_leaves, tree_map
    from repro_torch.training import (AdamWConfig, batch_shardings,
                                      init_train_state, make_train_step,
                                      train_state_shardings)
    from repro_torch.training.train_loop import _cast_compute, _value_and_grad

    t0 = time.time()
    ocfg = AdamWConfig(**MESH_OPT)
    shape = ShapeConfig("mesh", MESH["family_seq"], MESH["family_batch"],
                        "train")
    n_leaves, moe_eq = 0, []
    for i, arch in enumerate(a for a in ARCHS if a != "wlsh_index"):
        cfg = reduced(get_config(arch))
        m0, m1 = build_model(cfg), build_model(cfg, mesh=mesh)
        defs = m0.defs()
        params = init_params(defs, torch.Generator(device=dev).manual_seed(i),
                             device=dev)
        st0 = init_train_state(defs, params, ocfg, seed=i)
        st1 = distribute(tree_map(lambda t: t.clone(), st0),
                         train_state_shardings(defs, ocfg, mesh))
        b0 = make_batch(cfg, shape, seed=i, device=dev)
        b1 = distribute(b0, batch_shardings(mesh, b0))
        with torch.no_grad():
            c0 = _cast_compute(st0["opt"]["master"])
            c1 = _cast_compute(st1["opt"]["master"])
        l0, g0 = _value_and_grad(m0, c0, b0)
        l1, g1 = _value_and_grad(m1, c1, b1)
        bad = [k for k, (a, b) in enumerate(zip(tree_leaves(g0),
                                                tree_leaves(g1)))
               if not torch.equal(a, b.full_tensor())]
        _need(torch.equal(l0, l1) and not bad, f"mesh {arch}: loss "
              f"{float(l0)} vs {float(l1)}, gradient leaves {bad} differ")
        st0, met0 = make_train_step(m0, ocfg)(st0, b0)
        st1, met1 = make_train_step(m1, ocfg)(st1, b1)
        bad = [k for k, (a, b) in enumerate(zip(tree_leaves(st0),
                                                tree_leaves(st1)))
               if not torch.equal(a, b.full_tensor())]
        _need(torch.equal(met0["loss"], met1["loss"]) and not bad,
              f"mesh {arch}: step loss or state leaves {bad} differ")
        n_leaves += len(tree_leaves(st0))
        if cfg.n_experts:
            p = {k: v[0] for k, v in params["blocks"]["moe"].items()
                 if k != "shared"}
            x = torch.randn(MESH["family_batch"], MESH["family_seq"],
                            cfg.d_model, generator=torch.Generator(
                                device=dev).manual_seed(i), device=dev
                            ).to(torch.bfloat16)
            rep = {k: distribute(v, NamedSharding(mesh, (None,) * v.ndim))
                   for k, v in p.items()}
            y_ep = _moe_block_ep(rep, distribute(
                x, NamedSharding(mesh, (None,) * 3)), cfg, mesh)
            eq = torch.equal(_moe_block_global(p, x, cfg), y_ep.full_tensor())
            _need(eq, f"mesh {arch}: _moe_block_ep differs from "
                  "_moe_block_global on one data shard")
            moe_eq.append(arch)
    say(f"mesh families: 10 reduced archs, one train step each ({MESH_OPT}, "
        f"{shape.global_batch} x {shape.seq_len} tokens) on a (1, 1) mesh "
        f"of a one-rank NCCL group vs no mesh: loss, every gradient and "
        f"the {n_leaves} state leaves bit-equal; _moe_block_ep == "
        f"_moe_block_global bit for bit on {moe_eq}; "
        f"{time.time() - t0:.1f}s [{smi}]")


def _mesh_launcher(torch, dev, smi) -> None:
    """olmo-1b at full width through ``launch/train.py`` as shipped, 6
    steps without a mesh and with ``--mesh 1,1``: DTensor's dispatch
    cost a step."""
    import repro_torch.launch.train as T

    runs = {}
    for spec in ("", "1,1"):
        argv = ["--arch", LM["arch"], "--steps", str(MESH["launch_steps"]),
                "--global-batch", str(TRAIN["batch"]), "--seq-len",
                str(TRAIN["seq"]), "--lr", str(TRAIN["lr"]), "--log-every",
                "100", "--device", str(dev), "--mesh", spec]
        out = T.train(T.parse_args(argv), cfg=_lm_full_config())
        ms = np.array([r["ms"] for r in out["steps"][1:]])
        losses = [r["loss"] for r in out["steps"]]
        _need(bool(np.isfinite(losses).all()), f"mesh launcher "
              f"--mesh {spec!r}: losses {losses}")
        runs[spec] = (float(np.percentile(ms, 50)), losses)
        _release(torch)
    (p0, l0), (p1, l1) = runs[""], runs["1,1"]
    say(f"mesh launcher: {LM['arch']} full width through launch/train.py as "
        f"shipped, {TRAIN['batch']} x {TRAIN['seq']} tokens, "
        f"{MESH['launch_steps']} steps: p50 {p0:.2f} ms a step without a "
        f"mesh, {p1:.2f} ms with --mesh 1,1 ({p1 - p0:+.2f} ms, "
        f"{p1 / p0:.3f}x: DTensor's dispatch on one rank); losses equal "
        f"{l0 == l1} [{smi}]")


def phase_mesh(torch, dev, smi, train=None):
    """The LM substrate and the index on a device mesh (see the module
    docstring); only the index steps launch retrieval kernels."""
    import torch.distributed as dist

    from repro_torch.kernels import _cuda

    t0 = time.time()
    _release(torch)
    _cuda.reset_launch_counts()
    procs, out_dir = _mesh_children()
    try:
        mesh = _mesh_group(torch, dev)
        try:
            _mesh_families(torch, dev, mesh, smi)
            _mesh_launcher(torch, dev, smi)
            _need_launches(_cuda.launch_counts(), dict.fromkeys(KERNELS, 0),
                           "mesh LM legs")
            main, total = _mesh_index(torch, dev, mesh,
                                      procs.pop("index trace"), smi)
        finally:
            dist.destroy_process_group()
        _release(torch)
        _mesh_analysis(torch, dev, procs.pop("leg"), train, smi)
        _mesh_index_cells(procs.pop("index cells"), out_dir, smi)
        _mesh_dryrun(procs, out_dir, smi)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    _need_launches(_cuda.launch_counts(), total, "mesh")
    say(f"mesh phase: {time.time() - t0:.1f}s [{smi}]")
    return {"launches": main}


def _bound(c):
    """(bound ms, what bounds it) of a ``kernels.cost.Cost`` at the H100's
    peak rates (``launch.roofline.HW``: HBM3, and float32, int32 and the
    special-function units on the CUDA cores)."""
    from repro_torch.launch.roofline import HW

    s, by = c.bound(HW())
    return 1e3 * s, by


def _row(name, launches, err, ms, plain_ms, bound, library_ms=None):
    replaces, source = KERNELS[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=library_ms)


# the fused kernels of the kernel table: the two passes, then the serving
# path's single scan (the keep pass and the mask on its carry)
_FUSED = ("fused_query_hist", "fused_query_scores", "fused_query_keep",
          "fused_query_mask")


def _fused_passes(torch, dev, inputs, points, label, **hold_kw):
    """Both fused passes on one group's state with ``points`` as its rows:
    held to their plain versions (``_hold``, with ``hold_kw``), the keep
    pass and the mask held to them bit for bit (``_same_scan``), each
    timed (kernel: mean of 5 launches after a warm one, 20 for the mask;
    plain: one call), and the bound of each from the bytes it must move
    (each input read once, each output written once) and its level tests
    and p = 2 flops."""
    from repro_torch.kernels import cost, fused_query, ref

    gi, cfg, st, inp = inputs
    n, beta = st.codes.shape
    q, d = inp["queries"].shape
    inp = dict(inp, points=points)
    kw = dict(boff=0, n_valid=st.n_valid, c=cfg.c, n_levels=cfg.n_levels,
              p=cfg.p)
    row_ok = torch.arange(n, device=dev) < st.n_valid
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
    err = _hold(torch, inp, cfg.p, out_k, out_p, label, **hold_kw)
    _same_scan(torch, dev, inp, kw, out_k, label)
    del out_k, out_p
    keep_args = _pass_args(inp, "hist")
    _, _, lf, dist = fused_query.fused_query_keep(*keep_args, **kw)
    t_k["fused_query_keep"] = _time_ms(
        lambda: fused_query.fused_query_keep(*keep_args, **kw), torch, reps=5)
    # in place and idempotent: each launch reads and writes every cell
    t_k["fused_query_mask"] = _time_ms(
        lambda: fused_query.fused_query_mask(lf, inp["stop"], dist), torch,
        reps=20)
    t_p["fused_query_keep"] = _time_ms(lambda: ref.fused_query_keep_ref(
        *keep_args, row_ok, c=cfg.c, n_levels=cfg.n_levels, p=cfg.p),
        torch, reps=1)
    t_p["fused_query_mask"] = _time_ms(
        lambda: ref.fused_query_mask_ref(lf, inp["stop"], dist), torch,
        reps=1)
    del lf, dist
    tests = int(inp["beta_q"].clamp_max(beta).sum()) * n  # level tests
    kw = dict(vec_bytes=points.element_size(), p=cfg.p, tests=tests)
    costs = {"fused_query_hist": cost.fused_query_hist(n, beta, q, d,
                                                       cfg.n_levels, **kw),
             "fused_query_scores": cost.fused_query_scores(n, beta, q, d,
                                                           **kw),
             "fused_query_keep": cost.fused_query_keep(n, beta, q, d,
                                                       cfg.n_levels, **kw),
             "fused_query_mask": cost.fused_query_mask(n, q)}
    return dict(t_k=t_k, t_p=t_p, err=err, tests=tests,
                flops=int(costs["fused_query_hist"].flops),
                bytes={k: c.bytes for k, c in costs.items()},
                bound={k: _bound(c) for k, c in costs.items()},
                shape=f"n={n} beta_pad={beta} Q={q} d={d} L={cfg.n_levels}")


def _times_fused(torch, dev, sl, errs, smi, inputs, other):
    from repro_torch.kernels import fused_query

    gi, cfg, st, _ = inputs
    f = _fused_passes(torch, dev, inputs, st.points,
                      f"times check (group {gi}, the main path's inputs)")
    errs = _max_err(errs, f["err"])
    say(f"times {_occupancy_line(fused_query, cfg.c, cfg.n_levels)}; "
        f"{_ptxas_summary('fused_query.cu')} [{smi}]")
    table = []
    for name in _FUSED:
        bound = f["bound"][name]
        say(f"times {name} (group {gi}: {f['shape']}): kernel "
            f"{f['t_k'][name]:.3f} ms, plain {f['t_p'][name]:.3f} ms, bound "
            f"{bound[0]:.3f} ms by {bound[1]} ({f['tests']} level tests, "
            f"{f['flops']} flops, {f['bytes'][name]} bytes) [{smi}]")
        # launches: the slice leg's main path and the stream, obs, bf16,
        # shard, lm, mesh and sentinel legs'
        table.append(_row(name, sl["launches"][name] + other[name],
                          errs[name], f["t_k"][name], f["t_p"][name], bound))
    # the group's rows rounded to bfloat16 (what a bfloat16 state stores)
    b = _fused_passes(torch, dev, inputs, st.points.to(torch.bfloat16),
                      f"times bf16 check (group {gi}, bfloat16 rows)",
                      zone_edge=BF16_ZONE)
    for name in _FUSED:
        bound = b["bound"][name]
        say(f"times {name} bfloat16 rows (group {gi}: {b['shape']}): kernel "
            f"{b['t_k'][name]:.3f} ms (float32 rows {f['t_k'][name]:.3f} ms),"
            f" plain {b['t_p'][name]:.3f} ms, bound {bound[0]:.3f} ms by "
            f"{bound[1]} ({b['bytes'][name]} bytes) [{smi}]")
    return table


def _times_hash_encode(torch, dev, errs, smi, inputs, launches):
    """The widest group's build: its 400,000 x 400 vectors through its
    folded projection."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.hash_encode import hash_encode

    gi, _, st, _ = inputs
    x, a = st.points, st.proj
    n, d = x.shape
    beta = a.shape[1]
    ones = torch.ones(d, dtype=torch.float32, device=dev)
    args = (x, ones, a, st.b_int, st.b_frac, 1.0)
    got = hash_encode(*args)
    ms = _time_ms(lambda: hash_encode(*args), torch, reps=5)
    plain = []
    plain_ms = _time_ms(lambda: plain.append(ref.hash_encode_ref(
        x, a, st.b_int, st.b_frac, ones, 1.0)), torch, reps=1)
    lib_ms = _time_ms(lambda: torch.matmul(x, a), torch, reps=5)
    miss = _window_misses(torch, got, x, a, st.b_int, st.b_frac, ones, 1.0)
    differ = float((got != plain[0]).double().mean())
    gap = _top((ref.unbias_codes(got, st.b_int)
                - ref.unbias_codes(plain[0], st.b_int)).abs().double())
    _need(miss == 0, "hash_encode: main-path codes outside the window")
    _need(differ == 0, "hash_encode: main-path codes differ from the plain "
          "version")
    c = cost.hash_encode(n, d, beta)
    flops, bytes_, bound = int(c.flops), c.bytes, _bound(c)
    say(f"times hash_encode (group {gi}'s build: n={n} d={d} beta_pad={beta}"
        f"): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul "
        f"(the product alone, TF32 off) {lib_ms:.3f} ms, bound "
        f"{bound[0]:.3f} ms by {bound[1]} ({flops} flops, {bytes_} bytes); "
        f"{miss} codes outside the window, kernel != plain on {differ:.3g}; "
        f"{_ptxas_summary('hash_encode.cu')} [{smi}]")
    return _row("hash_encode", launches, max(errs["hash_encode"], gap), ms,
                plain_ms, bound, lib_ms)


def _times_freq_level(torch, dev, errs, smi, inputs, launches):
    """One 64-query batch at the widest group."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.freq_level import freq_level

    gi, cfg, st, inp = inputs
    n, beta = st.codes.shape
    q = inp["codes_q"].shape[0]
    args = (st.codes, inp["codes_q"], inp["mu"], inp["beta_q"])
    got = freq_level(*args, c=cfg.c, n_levels=cfg.n_levels)
    ms = _time_ms(lambda: freq_level(*args, c=cfg.c, n_levels=cfg.n_levels),
                  torch, reps=5)
    plain = []
    plain_ms = _time_ms(lambda: plain.append(ref.freq_level_ref(
        st.codes, inp["codes_q"], inp["mu"], cfg.c, cfg.n_levels,
        inp["beta_q"])), torch, reps=1)
    _need(torch.equal(got, plain[0]), "freq_level differs on the main "
          "path's inputs")
    tests = int(inp["beta_q"].clamp_max(beta).sum()) * n
    c = cost.freq_level(n, beta, q, tests=tests)
    bytes_, bound = c.bytes, _bound(c)
    say(f"times freq_level (group {gi}: n={n} beta_pad={beta} Q={q} "
        f"L={cfg.n_levels}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound[0]:.3f} ms by {bound[1]} ({tests} level tests, "
        f"{bytes_} bytes); exact; "
        f"{_freq_level_occupancy(cfg.c, cfg.n_levels)}; "
        f"{_ptxas_summary('freq_level.cu')} [{smi}]")
    return _row("freq_level", launches, errs["freq_level"], ms, plain_ms,
                bound)


def _times_weighted_lp(torch, dev, errs, smi, inputs, launches):
    """Q = 64 against the widest group's vectors under the first query's
    weight, p = 1 (the JSON row), 0.5 and 1.5."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import weighted_lp as wlp

    gi, _, st, inp = inputs
    qs, pts = inp["queries"], st.points
    w = inp["q_weight"][0].contiguous()
    q, d = qs.shape
    n = pts.shape[0]
    qw, pw = qs * w, pts * w
    rows, err = {}, errs["weighted_lp"]
    for p in WLP_PS:
        got = wlp.weighted_lp(qs, pts, w, p)
        ms = _time_ms(lambda: wlp.weighted_lp(qs, pts, w, p), torch, reps=5)
        plain = []
        plain_ms = _time_ms(lambda: plain.append(ref.weighted_lp_ref(
            qs, pts, w, p)), torch, reps=1)
        lib_ms = _time_ms(lambda: torch.cdist(qw, pw, p=p), torch, reps=3)
        diff = (got - plain[0]).abs().double()
        rel = _top(diff / plain[0].double().abs().clamp_min(1e-30))
        _need(rel <= 1e-5, f"weighted_lp p={p} outside rtol 1e-5 on the "
              f"main path's vectors")
        err = max(err, _top(diff))
        # a term is a subtract, a multiply and an add of |t|, three FP32
        # instructions that do not fuse without changing the rounding; p =
        # 0.5 adds a sqrt on the special-function units, other p a powf's
        # log2 and exp2 (kernels/cost.py)
        bound = _bound(cost.weighted_lp(q, n, d, p))
        occ = wlp.occupancy(p)
        say(f"times weighted_lp p={p} (group {gi}'s vectors: n={n} d={d} "
            f"Q={q}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"torch.cdist {lib_ms:.3f} ms, bound {bound[0]:.3f} ms by "
            f"{bound[1]}; max rel err {rel:.3g}; {occ['smem_bytes']} B "
            f"shared per block, {occ['blocks_per_sm']} blocks per SM, "
            f"{occ['registers']} registers; "
            f"{_ptxas_summary('weighted_lp.cu')} [{smi}]")
        rows[p] = (ms, plain_ms, bound, lib_ms)
    ms, plain_ms, bound, lib_ms = rows[1.0]
    return _row("weighted_lp", launches, err, ms, plain_ms, bound, lib_ms)


def _times_dispatch(torch, dev, smi, inputs, calls: int = 200) -> None:
    """Host microseconds a call of pass 1 through its custom op
    (``torch.ops.repro_torch.fused_query_hist``, the dispatcher picking
    the CUDA version) and straight through the launch function the op
    registers, on the widest group's first 128 rows (the kernels queue
    faster than they run only for so small a launch)."""
    from repro_torch.kernels import fused_query

    gi, cfg, st, inp = inputs
    args = _pass_args(dict(inp, codes_p=st.codes[:128].contiguous(),
                           points=st.points[:128].contiguous()), "hist")
    kw = dict(boff=0, n_valid=128, c=cfg.c, n_levels=cfg.n_levels, p=cfg.p)
    us = {}
    for name, fn in (("op", fused_query.fused_query_hist),
                     ("direct", fused_query._hist_cuda)):
        fn(*args, **kw)
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args, **kw)
        us[name] = 1e6 * (time.perf_counter() - t0) / calls
        _sync(torch, dev)
    say(f"times dispatch: fused_query_hist on 128 rows (Q={args[3].shape[0]}"
        f"): {us['op']:.1f} us of host a call through the custom op, "
        f"{us['direct']:.1f} us straight through its launch function: "
        f"{us['op'] - us['direct']:+.1f} us a launch for the dispatcher "
        f"({calls} calls each) [{smi}]")


def phase_times(torch, dev, sl, legs, errs, smi):
    inputs = _slice_pass_inputs(sl, torch, dev)
    stream, shard = legs["stream"]["launches"], legs["shard"]["launches"]
    mesh = legs["mesh"]["launches"]
    other = {k: stream[k] + legs["obs"]["launches"][k]
             + legs["bf16"]["launches"][k] + shard.get(k, 0)
             + legs["lm"]["launches"][k] + mesh[k]
             + legs["sentinel"]["launches"][k] for k in stream}
    errs = _max_err(errs, legs["bf16"]["err"])
    errs = _max_err(errs, legs["shard"]["err"])
    table = _times_fused(torch, dev, sl, errs, smi, inputs, other)
    table.append(_times_hash_encode(
        torch, dev, errs, smi, inputs, legs["encode"]["launches"]
        + stream["hash_encode"] + shard.get("hash_encode", 0)
        + mesh["hash_encode"]))
    table.append(_times_freq_level(
        torch, dev, errs, smi, inputs, legs["unfused"]["launches"]
        + stream["freq_level"] + shard.get("freq_level", 0)))
    _times_dispatch(torch, dev, smi, inputs)
    # on no serving path, as in the JAX package: each leg counted 0
    table.append(_times_weighted_lp(
        torch, dev, errs, smi, inputs, sl["launches"]["weighted_lp"]
        + legs["encode"]["weighted_lp"] + legs["unfused"]["weighted_lp"]
        + other["weighted_lp"]))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    t_main = time.time()
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
    sl, legs = None, {}
    if "sentinel" in phases:  # first: see the module docstring
        legs["sentinel"] = phase_sentinel(torch, dev, smi)
    errs = None
    if "kernels" in phases:
        errs = phase_kernels(torch, dev)
    if "slice" in phases:
        sl = phase_slice(torch, dev)
    for leg, fn in (("encode", phase_encode), ("unfused", phase_unfused),
                    ("paged", phase_paged)):
        if leg in phases:
            if sl is None:
                raise SystemExit(f"the {leg} phase needs the slice phase")
            legs[leg] = fn(torch, dev, sl)
    if "async" in phases:
        if "paged" not in legs:
            raise SystemExit("the async phase needs the paged phase")
        legs["async"] = phase_async(torch, dev, sl, legs["paged"])
    if "paged" in legs:  # its states and pinned buffers leave
        legs["paged"].pop("svc")
        _release(torch)
    for leg, fn in (("obs", phase_obs), ("bf16", phase_bf16)):
        if leg in phases:
            if sl is None:
                raise SystemExit(f"the {leg} phase needs the slice phase")
            legs[leg] = fn(torch, dev, sl, smi)
            _release(torch)
    if "stream" in phases:
        if sl is None:
            raise SystemExit("the stream phase needs the slice phase")
        legs["stream"] = phase_stream(torch, dev, sl, smi)
    if "shard" in phases:
        if sl is None:
            raise SystemExit("the shard phase needs the slice phase")
        legs["shard"] = phase_shard(torch, dev, sl, smi)
    if "search" in phases:
        if sl is None:
            raise SystemExit("the search phase needs the slice phase")
        legs["search"] = phase_search(torch, dev, sl, smi)
    if "lm" in phases:
        legs["lm"] = phase_lm(torch, dev, smi)
    if "train" in phases:
        legs["train"] = phase_train(torch, dev, smi)
    if "mesh" in phases:
        legs["mesh"] = phase_mesh(torch, dev, smi, legs.get("train"))
    if "times" in phases:
        want = set(PHASES) - {"device", "build", "kernels", "slice", "times"}
        if sl is None or errs is None or set(legs) != want:
            raise SystemExit("the times phase needs every other phase")
        table = phase_times(torch, dev, sl, legs, errs, smi)
    say(f"chip_smoke: {len(phases)} phases in {time.time() - t_main:.1f}s "
        f"[{smi}]")
    if "times" in phases:
        say(json.dumps({"kernels": table}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
