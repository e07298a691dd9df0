"""Sharded big-group serving: one group's rows across several devices.

A table group's ``QueryState`` (codes ``(n, beta)`` and vectors
``(n, d)``) is the unit the serving stack pages, and without sharding it
has to fit one device.  Here its rows split into S contiguous slices, one
per device, and one process drives them all (the JAX package's serving
mesh is single-controller too: one process, a mesh of addressable
devices, the merges inside ``shard_map``):

  devices     ``serving_devices(S, device)``: ``cuda:0 .. cuda:S-1`` (it
              raises when fewer cards are visible), or S CPU devices, the
              counterpart of XLA's forced host devices.  A caller that
              wants several shards on one card names the devices itself
              (``Batcher(devices=("cuda:0",) * S)``).
  state       ``ShardedQueryState``: one ``QueryState`` per shard on its
              device, holding the rows ``[s * n_loc, (s + 1) * n_loc)``
              and its own copy of the folded family, plus the global
              ``n_valid`` and the shards' row offsets.  A capacity that
              does not divide S is an error (``host_row_ranges``), never
              a silent replica.  ``build_group_state_per_host`` builds it
              from per-shard row ranges, so the whole corpus never exists
              as one host array; ``offload_state_sharded`` /
              ``restore_state_sharded`` page it one host chunk per shard.
  query       the engine runs both fused passes on every shard at its
              row offset (``s * n_loc``) against the global
              ``n_valid``; the only traffic between devices is
              ``merge_histograms`` (the (Q, L+2) int32 level histograms
              added on the first device: integers, exact in any order)
              and ``merge_shard_topk`` (the (Q, k) survivors of every
              shard, each shard's re-ranked exactly first, and a k-smallest
              selection over them on the first device, ties to the lower
              gather position).

On a ``DeviceMesh`` (one process a device, ``torchrun``) the same state
is a ``QueryState`` of ``DTensor``s: ``state_shardings`` lays the rows
over every mesh axis (strict: a capacity that does not divide the mesh
raises) and replicates the family; rank r holds rows ``[r * n_loc, (r +
1) * n_loc)`` (``shard_row_offset``: mesh-axis order, major to minor).
The engine's ``make_query_step`` runs the per-shard body of the
device-list engine on each rank and merges with collectives over all of
the mesh's ranks: ``merge_histograms_mesh`` (one all-reduce of both
histograms) and ``merge_shard_topk_mesh`` (one all-gather of the (Q, k)
survivors, 8 bytes each, then the same selection in rank order).  The
serving stack keeps the device list; the mesh steps are the counterparts
of the JAX functions its dry-run lowers.

Cross-device ordering: ``Tensor.to`` between two CUDA devices orders the
copy after the current streams of both devices (PyTorch's peer copy
records and waits on events on both), so a histogram reaches the first
device only after its shard's pass 1, and ``stop`` reaches a shard only
after the stop rule ran.  Nothing here synchronizes the host.  On one
card, shards that share it share its current stream.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels import ops
from ..kernels.platform import resolve_device
from .sharding import named_sharding

__all__ = [
    "HostShardedState",
    "ShardedQueryState",
    "build_group_state_per_host",
    "build_shards",
    "distribute_state",
    "host_row_ranges",
    "merge_histograms",
    "merge_histograms_mesh",
    "merge_shard_topk",
    "merge_shard_topk_mesh",
    "offload_state_sharded",
    "restore_state_sharded",
    "serving_devices",
    "shard_devices_of",
    "shard_row_offset",
    "sharded_state",
    "state_shardings",
]


def serving_devices(n_shards: int = 1,
                    device: str | torch.device = "cuda"
                    ) -> tuple[torch.device, ...]:
    """The devices of ``n_shards`` row shards: one card each, or the CPU.

    On ``cuda`` the shards take consecutive cards from the device's index
    (``cuda:0`` when none is given), and fewer visible cards raise: a
    caller that means several shards on one card names them explicitly,
    ``Batcher(plan, points, cfg, devices=("cuda:0",) * n_shards)``.  On
    ``cpu`` every shard is the CPU device, the plain torch versions of
    the kernels.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,) * n_shards
    first = dev.index or 0
    have = torch.cuda.device_count()
    if first + n_shards > have:
        raise ValueError(
            f"n_shards={n_shards} from cuda:{first} exceeds the {have} "
            f"visible CUDA device(s); to run several shards on one card "
            f"name the devices explicitly, e.g. Batcher(plan, points, cfg, "
            f"devices=('cuda:0',) * {n_shards})"
        )
    return tuple(torch.device("cuda", first + s) for s in range(n_shards))


def host_row_ranges(capacity: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous per-shard row ranges ``[(lo, hi), ...]`` over a capacity.

    The capacity must divide evenly; each range is one shard's slice of
    the padded row space, and a range's tail past the live row count is
    dead weight the build fills deterministically.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if capacity % n_shards:
        raise ValueError(
            f"row capacity {capacity} does not divide {n_shards} shards; "
            f"round the capacity up first (Batcher.row_capacity does)"
        )
    n_loc = capacity // n_shards
    return [(s * n_loc, (s + 1) * n_loc) for s in range(n_shards)]


def merge_histograms(hists_f, hists_g, device: torch.device):
    """Add the shards' int32 (Q, L+2) level histograms on ``device``.

    Integer counts, so the sum is exact in any order: the stop rule over
    the merged histograms is the unsharded one, bit for bit.
    """
    def add(hists):
        out = hists[0].to(device)
        for h in hists[1:]:
            out = out + h.to(device)
        return out

    return add(hists_f), add(hists_g)


def merge_shard_topk(vals, idx, k: int, device: torch.device):
    """The k smallest of the shards' (Q, k) survivors, on ``device``.

    ``vals``/``idx`` are per-shard lists (shard order) of exact
    re-ranked distances (>= 0 or +inf) and global row ids (-1 where
    missing).  They are concatenated in shard order and selected by the
    engine's top-k (``engine._topk_rows``), so ties go to the lower
    shard, then the lower position inside it, as ``lax.top_k`` over the
    gathered pool breaks them; nothing is computed on the distances.
    """
    gv = torch.cat([v.to(device) for v in vals], dim=1)  # (Q, S*k)
    gi = torch.cat([i.to(device) for i in idx], dim=1)
    return _select(gv, gi, k)


def _select(gv, gi, k: int):
    """The k smallest of a (Q, S*k) pool of survivors, ties to the lower
    position, with their ids (-1 where missing)."""
    from ..index.engine import _topk_rows  # deferred: engine imports this

    top, pos = _topk_rows(gv, k)
    ids = torch.gather(gi, 1, pos.clamp_min(0).long())
    return top, torch.where(pos < 0, -1, ids).to(gi.dtype)


# ------------------------------------------------------------ on a mesh
#
# The same state on a ``DeviceMesh``, one process a device (the JAX
# package's ``shard_map``): rows over every mesh axis, major to minor, so
# rank r of the mesh's flattened order holds rows [r * n_loc, (r + 1) *
# n_loc).  The merges are collectives over all of the mesh's ranks.


def state_shardings(mesh, cfg):
    """Strict per-field placements (``NamedSharding``s) of one group's
    ``QueryState`` on ``mesh``: codes and points over every mesh axis
    (the "rows" rule), the folded family and the scalars replicated.  A
    capacity that does not divide the mesh raises instead of replicating
    the state onto every device."""
    from ..index.engine import QueryState  # deferred: engine imports us

    rows = functools.partial(named_sharding, mesh, ("rows", None),
                             strict=True)
    return QueryState(
        codes=rows(shape=(cfg.n, cfg.beta)),
        points=rows(shape=(cfg.n, cfg.d)),
        proj=named_sharding(mesh, (None, None)),
        b_int=named_sharding(mesh, (None,)),
        b_frac=named_sharding(mesh, (None,)),
        width=named_sharding(mesh, ()),
        n_valid=named_sharding(mesh, ()),
    )


def distribute_state(state, shardings):
    """A ``QueryState`` of whole tensors (the same on every rank) as
    ``DTensor``s laid out by ``shardings`` (``state_shardings``): each
    rank keeps its own rows; ``n_valid`` stays the global count."""
    from ..models.params import distribute

    return dataclasses.replace(state, **{
        f: distribute(getattr(state, f), getattr(shardings, f))
        for f in ("codes", "points", "proj", "b_int", "b_frac", "width")})


def _rows_mesh(mesh):
    """The mesh's ranks as one dimension, in row order (major to minor)."""
    return mesh._flatten() if mesh.ndim > 1 else mesh


def shard_row_offset(mesh, n_loc: int) -> int:
    """Global row id of this rank's first local row: its linearized mesh
    coordinate (mesh-axis order, major to minor) times its slice length,
    so a gather position orders like ascending global row."""
    off = 0
    for i, c in enumerate(mesh.get_coordinate()):
        off = off * mesh.size(i) + c
    return off * n_loc


def merge_histograms_mesh(hist_f, hist_g, mesh):
    """Sum every rank's int32 (Q, L+2) level histograms: one all-reduce
    of both over all of the mesh's ranks (integers: exact in any
    order)."""
    from torch.distributed import _functional_collectives as funcol

    flat = _rows_mesh(mesh)
    if flat.size() == 1:
        return hist_f, hist_g
    both = funcol.wait_tensor(funcol.all_reduce(
        torch.stack([hist_f, hist_g]), "sum", flat.get_group()))
    return both[0], both[1]


def merge_shard_topk_mesh(vals, idx, k: int, mesh):
    """The k smallest of every rank's (Q, k) survivors, on every rank.

    One all-gather of each rank's distance bits and global ids (8 bytes
    a survivor), laid out in rank order as ``merge_shard_topk``
    concatenates the shards, then the same selection."""
    from torch.distributed import _functional_collectives as funcol

    flat = _rows_mesh(mesh)
    s = flat.size()
    if s == 1:
        return _select(vals, idx, k)
    q = vals.shape[0]
    pair = torch.stack([vals.view(torch.int32), idx], -1)  # int32 ids
    # all_gather_single is the newer name of all_gather_tensor
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    g = funcol.wait_tensor(gather(pair, 0, flat.get_group())).view(
        s, q, k, 2)
    g = g.permute(1, 0, 2, 3).reshape(q, s * k, 2)
    gv = g[..., 0].contiguous().view(torch.float32)
    return _select(gv, g[..., 1].contiguous(), k)


@dataclasses.dataclass(frozen=True)
class ShardedQueryState:
    """One group's state with its rows split across devices.

    ``shards[s]`` is a ``QueryState`` on its device holding the rows
    ``[offsets[s], offsets[s] + n_loc)`` and its own copy of the folded
    family; its ``n_valid`` counts the live rows of its slice.
    ``n_valid`` is the global live-row count the passes mask against.
    ``nbytes`` prices the fullest device: the shards that share a device
    (several shards on one card) add up there.
    """

    shards: tuple  # per-shard QueryState, shard order
    offsets: tuple  # global row id of each shard's first row
    n_valid: int  # live rows in [0, S * n_loc]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].codes.shape[0]

    @property
    def device(self) -> torch.device:
        """The first shard's device: where the merges and answers land."""
        return self.shards[0].device

    # the replicated family, read from the first shard (query encode)
    @property
    def proj(self) -> torch.Tensor:
        return self.shards[0].proj

    @property
    def b_int(self) -> torch.Tensor:
        return self.shards[0].b_int

    @property
    def b_frac(self) -> torch.Tensor:
        return self.shards[0].b_frac

    @property
    def nbytes(self) -> int:
        """Bytes on the fullest device: every shard a device holds."""
        per_device: dict = {}
        for s in self.shards:
            per_device[s.device] = per_device.get(s.device, 0) + s.nbytes
        return max(per_device.values())


def sharded_state(shards: Sequence, n_loc: int, n_valid: int):
    """A ``ShardedQueryState`` over ``shards`` (a lone shard is returned
    as the plain ``QueryState`` it is)."""
    shards = tuple(shards)
    if len(shards) == 1:
        return shards[0]
    return ShardedQueryState(
        shards=shards,
        offsets=tuple(s * n_loc for s in range(len(shards))),
        n_valid=int(n_valid))


def build_shards(cfg, gplan, devices: Sequence, n_rows: int,
                 pieces: Callable, host_codes: bool):
    """Build one group's state shard by shard from row ranges.

    ``pieces(lo, hi)`` returns the live rows ``[lo, hi)`` as a list of
    ``(at, rows, codes)``: float32 ``rows`` for the global rows ``[at, at
    + len(rows))`` and, when ``host_codes``, their int32 codes at
    ``cfg.beta`` columns.  It is called once per shard that holds live
    rows, with that shard's live range only, and each piece is written
    straight into its slice.  Host codes: the vectors are stored in
    ``cfg.vec_dtype`` as they arrive (cast on the device) and the rows
    past ``n_rows`` hold zeros and the sentinel code.  Without them each
    shard's float32 rows, zeros past ``n_rows``, are encoded on its
    device by ``ops.hash_encode`` at the fixed ``(n_loc, d)`` shape and
    then cast; the encode is row-independent, so the codes are those of
    a whole-corpus encode.  Returns a ``ShardedQueryState``, or the plain
    ``QueryState`` for one device; shard s equals rows ``[s * n_loc, (s
    + 1) * n_loc)`` of the one-device build, bit for bit.
    """
    from ..index import builder  # deferred: builder imports this module
    from ..index.engine import QueryState

    if not 0 <= n_rows <= cfg.n:
        raise ValueError(
            f"{n_rows} live rows outside the row capacity [0, {cfg.n}]")
    store = builder.storage_dtype(cfg)
    folded = gplan.folded()
    family = {name: builder.pad_cols(folded[name], cfg.beta)
              for name in ("proj", "b_int", "b_frac")}
    shards = []
    for (lo, hi), dev in zip(host_row_ranges(cfg.n, len(devices)), devices):
        dev = resolve_device(dev)
        n_loc, m = hi - lo, max(0, min(hi, n_rows) - lo)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        fam = {name: put(x) for name, x in family.items()}
        vecs = torch.zeros((n_loc, cfg.d), device=dev,
                           dtype=store if host_codes else torch.float32)
        codes = (torch.full((n_loc, cfg.beta), builder._PAD_CODE,
                            dtype=torch.int32, device=dev)
                 if host_codes else None)
        for at, rows, rcodes in (pieces(lo, lo + m) if m else ()):
            a, b = at - lo, at - lo + len(rows)
            vecs[a:b] = put(np.asarray(rows, np.float32))
            if host_codes:
                codes[a:b] = put(np.asarray(rcodes, np.int32))
        if not host_codes:
            codes = ops.hash_encode(vecs, torch.ones(cfg.d, device=dev),
                                    fam["proj"], fam["b_int"],
                                    fam["b_frac"], 1.0)
            vecs = vecs.to(store)
        shards.append(QueryState(
            codes=codes, points=vecs, width=torch.tensor(
                1.0, dtype=torch.float32, device=dev), n_valid=m, **fam))
    return sharded_state(shards, cfg.n // len(devices), n_rows)


def build_group_state_per_host(cfg, gplan, points_loader: Callable,
                               n_points: int, devices: Sequence):
    """A sharded ``QueryState`` from per-shard row ranges of the corpus.

    ``points_loader(lo, hi)`` returns the corpus rows ``[lo, hi)`` as
    ``(hi - lo, d)`` float32 (a memmap slice, a file-chunk read) and is
    called once per shard range that holds live rows, so the full
    ``(n, d)`` corpus never exists as one host array: the host peak is
    one shard's slice.  Host plan codes are row-sliced the same way;
    without them each shard is encoded on its device.  Equal, shard by
    shard, to ``build_group_state`` over the materialized corpus at the
    same capacity.
    """
    from ..index.builder import pad_cols  # deferred, as build_shards

    def pieces(lo, hi):
        rows = np.asarray(points_loader(lo, hi), np.float32)
        if rows.shape != (hi - lo, cfg.d):
            raise ValueError(
                f"rows [{lo}, {hi}) came back with shape {rows.shape}, "
                f"expected ({hi - lo}, {cfg.d})")
        codes = (None if gplan.codes is None
                 else pad_cols(gplan.codes[lo:hi], cfg.beta))
        return [(lo, rows, codes)]

    return build_shards(cfg, gplan, devices, n_points, pieces,
                        host_codes=gplan.codes is not None)


# ------------------------------------------------------ per-shard paging


@dataclasses.dataclass
class HostShardedState:
    """Host copy of an evicted sharded state, one chunk per shard.

    ``shards[s]`` is the host ``QueryState`` of shard s (its row chunk
    and its family copy, pinned when it came from a card): a restore is
    one upload per shard straight to its device, never an all-rows host
    concatenation.
    """

    shards: tuple
    offsets: tuple
    n_valid: int


def offload_state_sharded(state: ShardedQueryState,
                          out: HostShardedState | None = None
                          ) -> HostShardedState:
    """Copy a sharded state to host memory shard by shard, bit for bit.

    ``out``, an earlier host copy of the same group, is written in place
    (``builder.offload_state``'s rule, per shard).
    """
    from ..index.builder import offload_state

    return HostShardedState(
        shards=tuple(offload_state(s, out=None if out is None
                                   else out.shards[i])
                     for i, s in enumerate(state.shards)),
        offsets=state.offsets, n_valid=state.n_valid)


def restore_state_sharded(host: HostShardedState, devices: Sequence
                          ) -> ShardedQueryState:
    """Upload an ``offload_state_sharded`` copy, shard s to ``devices[s]``
    on its current stream: the same bytes, the same placement
    (``builder.StatePager`` uploads on copy streams instead)."""
    from ..index.builder import restore_state

    if len(devices) != len(host.shards):
        raise ValueError(f"{len(devices)} devices for "
                         f"{len(host.shards)} shards")
    return ShardedQueryState(
        shards=tuple(restore_state(h, d) for h, d in
                     zip(host.shards, devices)),
        offsets=host.offsets, n_valid=host.n_valid)


def shard_devices_of(device, n_shards: int) -> tuple:
    """``device`` as the devices of ``n_shards`` shards: a sequence is
    taken as it is (and must name one device a shard), a single device
    goes through ``serving_devices``."""
    if isinstance(device, (list, tuple)):
        if len(device) != n_shards:
            raise ValueError(f"{len(device)} devices for {n_shards} shards")
        return tuple(resolve_device(d) for d in device)
    return serving_devices(n_shards, device)

