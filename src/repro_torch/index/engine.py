"""WLSH query engine on one device (the paper's Search, dense form).

One table group's state is its point codes ``(n, beta)`` and vectors
``(n, d)``, resident on the device.  A query step answers a batch of
queries, each under its own weight vector, collision threshold ``mu``,
radius base ``r_min``, table count ``beta_q`` and level cap ``levels_q``,
in two passes over every row:

  pass 1  codes + vectors -> first-frequent level, distance, good level
          -> per-level frequent/good histograms -> the paper's stop
          conditions (k found / budget) -> stop level per query
  pass 2  codes + vectors -> distances masked to rows frequent at the stop
          level -> top-k -> exact float32 re-rank of the k survivors

With ``use_kernels="on"`` each pass is one call of
``ops.fused_query_block`` over the whole state: one CUDA kernel launch on
the card (kernels/csrc/fused_query.cu), the plain torch version on the CPU.
``use_kernels="off"`` runs the unfused stage-by-stage scan, the parity
oracle: the ``freq_level`` kernel (its plain version on the CPU), then
per-query distances and histograms in torch.  Both bin dead rows
differently (excluded vs parked at level L+1), but the stop rule reads
only bins 0..L, so stop, n_checked, ids and distances agree.

Top-k order: the reference's running ``lax.top_k`` breaks distance ties
toward the lower row.  ``torch.topk`` promises no tie order on CUDA, so
the step selects on a unique int64 key ``(float bits of dist) << 32 | row``;
distances are >= 0 or +inf, so their bit patterns order like the floats.

Vectors are stored as ``float32`` or ``bfloat16`` (``IndexConfig.vec_dtype``).
Every score is computed in float32: the fused kernels widen bfloat16 rows
as they stage them, the unfused route and the re-rank with ``.float()``.
A step runs inside the layer span ``wlsh_step`` (``obs.trace.span``), each
shard's passes inside ``wlsh_pass1`` and ``wlsh_pass2``, the stop rule
inside ``wlsh_stop``, and pass 2's top-k and re-rank inside ``wlsh_topk``
and ``wlsh_rerank``, so a captured trace attributes their device time.
Without a capture (and without ``ServiceConfig.obs``) a span is one flag
check.

A ``ShardedQueryState`` (``IndexConfig.n_shards > 1``) holds the rows in
contiguous slices on several devices, and the step follows the JAX
package's ``_query_shard``: both passes on every shard at its row offset
against the global ``n_valid``, the level histograms added and the stop
rule run once on the first device, each shard's k survivors re-ranked
exactly on its device, then ``group_sharding.merge_shard_topk``.  The
fused passes and the re-rank score each row on its own, so the answers
equal the unsharded step's bit for bit wherever the approximate and the
exact order of the rank-k boundary agree.

Every engine runs one per-shard body in two halves around the histogram
merge: ``_pass1`` (pass 1 at the shard's row offset against the global
``n_valid``) and ``_pass2`` (pass 2, the top-k rebased to global rows,
the exact re-rank).  One device is one shard with nothing to merge; the
device list merges on its first device; ``make_query_step`` runs the
body on every rank of a ``DeviceMesh`` under ``shard_map_nocheck`` and
merges with one all-reduce and one all-gather
(``group_sharding.merge_*_mesh``), so the mesh step answers as the
device list does, bit for bit.  The serving stack keeps the device list.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..distributed import group_sharding
from ..distributed.group_sharding import ShardedQueryState
from ..distributed.sharding import (as_dtensor, named_sharding,
                                    shard_map_nocheck)
from ..kernels import ops, ref
from ..kernels import platform as kplatform
from ..obs.trace import span
from .config import VEC_DTYPES, IndexConfig

__all__ = ["QueryState", "QueryStepCache", "encode_queries",
           "make_query_step", "query_input_specs", "query_step",
           "shardings"]


@dataclasses.dataclass(frozen=True)
class QueryState:
    """Device-resident table-group state.

    ``codes``/``points`` are materialized at the config's row capacity
    (``IndexConfig.n``); ``n_valid`` counts the live rows, and rows at or
    beyond it are masked out of both passes.
    """

    codes: torch.Tensor  # (n, beta) int32
    points: torch.Tensor  # (n, d) float32 or bfloat16 (vec_dtype)
    proj: torch.Tensor  # (d, beta) f32 folded projection
    b_int: torch.Tensor  # (beta,) int32
    b_frac: torch.Tensor  # (beta,) f32
    width: torch.Tensor  # () f32
    n_valid: int  # live rows in [0, n]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def nbytes(self) -> int:
        """Bytes held on the device by this state's tensors."""
        return sum(t.numel() * t.element_size() for t in (
            self.codes, self.points, self.proj, self.b_int, self.b_frac,
            self.width))


def encode_queries(state: QueryState, queries):
    """(Q, beta) int32 query bucket codes through the device encode.

    ``state.proj`` is the folded projection (center weight and bucket
    width folded in at build time), so queries hash at unit weight and
    width, through the same ``hash_encode`` as a device-built state's
    rows: the kernel on the card, its plain version on the CPU.  The
    encode is row-independent, so a corpus row asked as a query gets its
    stored codes bit for bit.
    """
    q = torch.as_tensor(queries, dtype=torch.float32, device=state.device)
    ones = torch.ones(state.proj.shape[0], dtype=torch.float32,
                      device=state.device)
    return ops.hash_encode(q, ones, state.proj, state.b_int, state.b_frac,
                           1.0)


def _unfused_pass(state, codes_q, qf, wf, mu, r_min, beta_q, cfg, stop,
                  boff: int = 0, n_valid: int | None = None):
    """Stage-by-stage oracle: (hist_f, hist_g) (Q, L+2), or (Q, n) scores.

    Row ``i`` of ``state`` is global row ``boff + i``; rows at or past
    ``n_valid`` (``state.n_valid`` when None) are dead and parked at
    level L+1 (the fused passes exclude them).
    """
    c, L = cfg.c, cfg.n_levels
    n_valid = state.n_valid if n_valid is None else n_valid
    lf = ops.freq_level(state.codes, codes_q, mu, c=c, n_levels=L,
                        beta_q=beta_q)
    row_ok = boff + torch.arange(lf.shape[1], device=lf.device) < n_valid
    lf = torch.where(row_ok[None, :], lf, torch.full_like(lf, L + 1))
    dist = ref.per_query_dist(qf, wf, state.points.float(), cfg.p)
    if stop is None:
        return (ref.level_hist(lf, L + 2),
                ref.level_hist(ref.good_level(lf, dist, r_min, c), L + 2))
    return torch.where(lf <= stop[:, None], dist,
                       torch.full_like(dist, math.inf))


def _topk_rows(scores, k: int):
    """(vals, ids) of the k smallest scores per row; ties -> lower row.

    Missing slots (fewer than k finite scores) are ``+inf`` / ``-1``.
    """
    q, n = scores.shape
    if n < k:
        scores = torch.cat([scores, torch.full((q, k - n), math.inf,
                                               device=scores.device)], 1)
        n = k
    # in place: one (Q, n) int64 buffer beside the scores
    key = scores.contiguous().view(torch.int32).to(torch.int64)
    key.bitwise_left_shift_(32).bitwise_or_(
        torch.arange(n, device=scores.device)[None, :])
    pos = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    vals = torch.gather(scores, 1, pos)
    ids = torch.where(torch.isinf(vals), -1, pos).to(torch.int32)
    return vals, ids


def _stop_levels(hist_f, hist_g, levels_q, cfg: IndexConfig):
    """(stop (Q,) int32, nf_cum (Q, L+1)) from the level histograms."""
    L, k = cfg.n_levels, cfg.k
    with span("wlsh_stop"):
        nf_cum = torch.cumsum(hist_f[:, : L + 1], dim=1)
        ng_cum = torch.cumsum(hist_g[:, : L + 1], dim=1)
        # Stop conditions evaluated only up to each query's own level cap:
        # the bound L may be padded above the member's n_levels (bucketed
        # shape sharing), and a query that exhausts its levels stops *at*
        # them.
        levels = torch.arange(L + 1, device=hist_f.device)
        cond = ((ng_cum >= k) | (nf_cum >= cfg.budget)) & (
            levels[None, :] <= levels_q[:, None])
        first = torch.where(cond, levels[None, :], L + 1).amin(dim=1)
        stop = torch.where(first <= L, first,
                           levels_q.long()).to(torch.int32)
    return stop, nf_cum


def _rerank(points, rows, qf, wf, vals, idx, p: float):
    """Exact float32 distances of the k survivors, re-sorted (stable).

    The p=2 scan scores with the norms expansion, whose f32 cancellation
    error swamps genuinely small distances; recompute the survivors'
    distances from the coordinate differences of the stored rows
    (``points[rows]``) and re-sort, so ties keep their scan order.
    """
    cand = points[rows].float()  # (Q, k, d)
    diff = torch.abs((qf[:, None, :] - cand) * wf[:, None, :])
    if abs(p - 2.0) < 1e-9:
        exact = torch.sqrt(torch.sum(diff * diff, dim=-1))
    elif abs(p - 1.0) < 1e-9:
        exact = torch.sum(diff, dim=-1)
    else:
        exact = torch.sum(diff**p, dim=-1) ** (1.0 / p)
    vals = torch.where(torch.isfinite(vals), exact, vals)
    order = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def _n_checked(nf_cum, stop, cfg: IndexConfig):
    return torch.clamp_max(
        torch.gather(nf_cum, 1, stop[:, None].long())[:, 0], cfg.budget
    ).to(torch.int32)


def _pass1(state, ins, boff: int, n_valid: int, cfg: IndexConfig, path):
    """Pass 1 of one shard: its (hist_f, hist_g) (Q, L+2) level histograms.

    ``state`` holds the global rows ``[boff, boff + n_loc)``; rows at or
    past the global ``n_valid`` are dead.  ``ins`` is ``(codes_q, qf, wf,
    mu, r_min, beta_q)`` on the shard's device.  With the stop rule over
    the merged histograms and ``_pass2``, this is the per-shard body of
    every engine: one device, a list of devices, a mesh.
    """
    codes_q, qf, wf, mu, r_min, beta_q = ins
    with span("wlsh_pass1"):
        if path.fused:
            return ops.fused_query_block(
                state.codes, state.points, codes_q, qf, wf, mu, r_min,
                beta_q, boff=boff, n_valid=n_valid, c=cfg.c,
                n_levels=cfg.n_levels, p=cfg.p)
        return _unfused_pass(state, codes_q, qf, wf, mu, r_min, beta_q, cfg,
                             None, boff=boff, n_valid=n_valid)


def _pass2(state, ins, stop, boff: int, n_valid: int, cfg: IndexConfig,
           path):
    """Pass 2 of one shard after the stop rule: its k survivors, ``(vals
    (Q, k), ids (Q, k))`` with global row ids (-1 where missing), each
    distance re-ranked exactly on the shard's stored rows."""
    codes_q, qf, wf, mu, r_min, beta_q = ins
    with span("wlsh_pass2"):
        if path.fused:
            scores = ops.fused_query_block(
                state.codes, state.points, codes_q, qf, wf, mu, r_min,
                beta_q, boff=boff, n_valid=n_valid, c=cfg.c,
                n_levels=cfg.n_levels, p=cfg.p, stop=stop)
        else:
            scores = _unfused_pass(state, codes_q, qf, wf, mu, r_min,
                                   beta_q, cfg, stop, boff=boff,
                                   n_valid=n_valid)
        with span("wlsh_topk"):
            vals, idx = _topk_rows(scores, cfg.k)
            idx = torch.where(idx >= 0, idx + boff, idx)  # global rows
        del scores
        with span("wlsh_rerank"):
            rows = (idx.long() - boff).clamp(0, state.codes.shape[0] - 1)
            return _rerank(state.points, rows, qf, wf, vals, idx, cfg.p)


def _check_vec_dtype(cfg: IndexConfig) -> None:
    if cfg.vec_dtype not in VEC_DTYPES:
        raise NotImplementedError(f"vec_dtype {cfg.vec_dtype!r}: vectors "
                                  f"are stored as one of {VEC_DTYPES}")


def query_step(state, queries, codes_q, q_weight, mu, r_min,
               beta_q, levels_q, *, cfg: IndexConfig):
    """Answer one query batch on ``state``'s device.

    Inputs are tensors on the state's device: queries/q_weight (Q, d)
    f32, codes_q (Q, beta) int32, mu/beta_q/levels_q (Q,) int32, r_min
    (Q,) f32.  Returns ``(dists (Q, k) f32, ids (Q, k) int32, stop (Q,)
    int32, n_checked (Q,) int32)``.  A ``ShardedQueryState`` (with
    ``cfg.n_shards`` equal to its shard count) is answered shard by
    shard (``_query_sharded``); the answers land on its first device.
    The step is the layer span ``wlsh_step``.
    """
    _check_vec_dtype(cfg)
    with span("wlsh_step"):
        if isinstance(state, ShardedQueryState) or cfg.n_shards != 1:
            return _query_sharded(state, queries, codes_q, q_weight, mu,
                                  r_min, beta_q, levels_q, cfg=cfg)
        path = kplatform.resolve(cfg.use_kernels, state.device)
        ins = (codes_q, queries.float(), q_weight.float(), mu, r_min,
               beta_q)
        hist_f, hist_g = _pass1(state, ins, 0, state.n_valid, cfg, path)
        stop, nf_cum = _stop_levels(hist_f, hist_g, levels_q, cfg)
        vals, idx = _pass2(state, ins, stop, 0, state.n_valid, cfg, path)
        return vals, idx, stop, _n_checked(nf_cum, stop, cfg)


def _query_sharded(state, queries, codes_q, q_weight, mu, r_min, beta_q,
                   levels_q, *, cfg: IndexConfig):
    """``query_step`` over a ``ShardedQueryState``, shard by shard.

    Step for step the JAX package's ``_query_shard``: pass 1 on every
    shard at its row offset against the global ``n_valid``; the
    histograms added on the first device (``merge_histograms``) and the
    stop rule run once there; ``stop`` sent to every shard, pass 2, a
    top-k whose rows are rebased to global ids, and an exact re-rank of
    each shard's k survivors (gathered at ``id - offset``) before
    ``merge_shard_topk`` picks the k smallest on the first device.  The
    merged set is the exact top-k of the union of the shards' candidates.
    Inputs are on the first shard's device and are copied to each
    shard's (a no-op for shards on that device).
    """
    if not isinstance(state, ShardedQueryState):
        raise ValueError(f"cfg.n_shards={cfg.n_shards} needs a "
                         f"ShardedQueryState, got {type(state).__name__}")
    if state.n_shards != cfg.n_shards:
        raise ValueError(f"state has {state.n_shards} shards, cfg.n_shards "
                         f"is {cfg.n_shards}")
    dev0 = state.device
    path = kplatform.resolve(cfg.use_kernels, dev0)
    shards = list(zip(state.shards, state.offsets))
    ins = [tuple(t.to(sh.device) for t in (codes_q, queries.float(),
                                           q_weight.float(), mu, r_min,
                                           beta_q))
           for sh, _ in shards]

    # ---- pass 1 on every shard, histograms merged, stop rule once --------
    hists = [_pass1(sh, x, off, state.n_valid, cfg, path)
             for (sh, off), x in zip(shards, ins)]
    hist_f, hist_g = group_sharding.merge_histograms(
        [h[0] for h in hists], [h[1] for h in hists], dev0)
    stop, nf_cum = _stop_levels(hist_f, hist_g, levels_q, cfg)

    # ---- pass 2, top-k and exact re-rank on every shard; exact merge ------
    outs = [_pass2(sh, x, stop.to(sh.device), off, state.n_valid, cfg, path)
            for (sh, off), x in zip(shards, ins)]
    vals, idx = group_sharding.merge_shard_topk(
        [o[0] for o in outs], [o[1] for o in outs], cfg.k, dev0)
    return vals, idx, stop, _n_checked(nf_cum, stop, cfg)


# ------------------------------------------------------------ on a mesh


def shardings(mesh) -> dict:
    """Placements of the mesh query step's arguments and answers
    (``NamedSharding``s): the state's rows over every mesh axis, its
    family and scalars, the queries and the answers replicated."""
    rows = named_sharding(mesh, ("rows", None))
    rep2, rep1, rep0 = (named_sharding(mesh, (None,) * r) for r in (2, 1, 0))
    return {
        "state": QueryState(codes=rows, points=rows, proj=rep2, b_int=rep1,
                            b_frac=rep1, width=rep0, n_valid=rep0),
        "queries": rep2,
        "q_meta": rep1,
        "out": rep2,
    }


def make_query_step(mesh, cfg: IndexConfig):
    """The query step over a ``DeviceMesh`` (the JAX package's jit'd
    ``shard_map``):
    ``(state, queries, q_codes, q_weight, mu, r_min, beta_q, levels_q) ->
    (dists (Q, k), ids (Q, k), stop (Q,), n_checked (Q,))``, replicated
    ``DTensor``s.

    ``state`` is a ``QueryState`` of ``DTensor``s laid out by
    ``group_sharding.state_shardings`` (rows over every mesh axis; a
    capacity that does not divide the mesh raises) with the global
    ``n_valid``; plain query tensors are taken as replicated.  Each rank
    runs the per-shard body under ``shard_map_nocheck``: pass 1 at its
    row offset (``shard_row_offset``), the histograms summed by one
    all-reduce, the stop rule, pass 2 and the exact re-rank of its k
    survivors, then one all-gather of every shard's survivors and the
    k smallest of them (``merge_shard_topk_mesh``).  The body is the
    device-list engine's, so both answer alike bit for bit.
    """
    _check_vec_dtype(cfg)
    sh = shardings(mesh)
    rows = group_sharding.state_shardings(mesh, cfg).codes.spec
    rep2, rep1 = sh["queries"].spec, sh["q_meta"].spec

    def body(codes, points, n_valid, queries, codes_q, q_weight, mu, r_min,
             beta_q, levels_q):
        n_loc = codes.shape[0]
        local = QueryState(codes=codes, points=points, proj=None,
                           b_int=None, b_frac=None, width=None,
                           n_valid=n_valid)
        off = group_sharding.shard_row_offset(mesh, n_loc)
        path = kplatform.resolve(cfg.use_kernels, codes.device)
        ins = (codes_q, queries.float(), q_weight.float(), mu, r_min, beta_q)
        hist_f, hist_g = group_sharding.merge_histograms_mesh(
            *_pass1(local, ins, off, n_valid, cfg, path), mesh)
        stop, nf_cum = _stop_levels(hist_f, hist_g, levels_q, cfg)
        vals, idx = group_sharding.merge_shard_topk_mesh(
            *_pass2(local, ins, stop, off, n_valid, cfg, path), cfg.k, mesh)
        return vals, idx, stop, _n_checked(nf_cum, stop, cfg)

    mapped = shard_map_nocheck(
        body, mesh,
        in_specs=(rows, rows, None, rep2, rep2, rep2, rep1, rep1, rep1,
                  rep1),
        out_specs=[rep2, rep2, rep1, rep1])

    def step(state, queries, q_codes, q_weight, mu, r_min, beta_q,
             levels_q):
        args = [as_dtensor(x, mesh) for x in (
            queries, q_codes, q_weight, mu, r_min, beta_q, levels_q)]
        return mapped(as_dtensor(state.codes, mesh),
                      as_dtensor(state.points, mesh), int(state.n_valid),
                      *args)

    return step


def query_input_specs(cfg: IndexConfig) -> dict:
    """Meta tensors of the query step's arguments at their global shapes
    (the dry-run's inputs; nothing is allocated), ``n_valid`` the whole
    capacity."""
    from .builder import storage_dtype

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, i32 = cfg.q_batch, torch.int32
    state = QueryState(
        codes=meta((cfg.n, cfg.beta), i32),
        points=meta((cfg.n, cfg.d), storage_dtype(cfg)),
        proj=meta((cfg.d, cfg.beta)), b_int=meta((cfg.beta,), i32),
        b_frac=meta((cfg.beta,)), width=meta(()), n_valid=cfg.n)
    return dict(state=state, queries=meta((q, cfg.d)),
                q_codes=meta((q, cfg.beta), i32), q_weight=meta((q, cfg.d)),
                mu=meta((q,), i32), r_min=meta((q,)), beta_q=meta((q,), i32),
                levels_q=meta((q,), i32))


class QueryStepCache:
    """Query-step reuse across table groups.

    Keyed by (device, cfg): ``IndexConfig`` is a frozen eq dataclass, so
    groups whose shapes quantize to the same buckets (``pad_beta`` /
    ``pad_levels``) share one step.  ``n_compiled`` counts distinct
    (device, config) steps, as the JAX package counts its compiled steps.
    ``on_compile`` (optional, set by the observability layer) is called
    with the config on every cache miss, attributing step builds to shape
    signatures.
    """

    def __init__(self):
        self._steps: dict = {}
        self.n_compiled = 0
        self.on_compile = None  # hook: on_compile(cfg) per step built

    def get(self, device, cfg: IndexConfig):
        key = (torch.device(device), cfg)
        step = self._steps.get(key)
        if step is None:
            step = functools.partial(query_step, cfg=cfg)
            self._steps[key] = step
            self.n_compiled += 1
            if self.on_compile is not None:
                self.on_compile(cfg)
        return step

    def __len__(self) -> int:
        return len(self._steps)
