"""Table-group state build (the paper's Preprocess) from a serving plan.

The group's center weight and bucket width are *folded* into the
projection once, so serving never touches them:

    proj_folded = diag(W_center) @ A / w
    codes       = floor(x @ proj_folded + b_frac) + b_int

When the plan ships host-computed (float64) codes, the build places them
on the device as they are, so the device engine sees bit-identical
candidate sets to the host oracle.  Otherwise it encodes the group's rows
on the device through ``ops.hash_encode`` (the CUDA kernel on the card),
and queries must then be encoded the same way (``engine.encode_queries``).

Vectors are stored in ``IndexConfig.vec_dtype``: float32, or bfloat16
rounded to nearest even (the JAX package's ``astype(bfloat16)``, bit for
bit).  Codes always come from the float32 vectors: the host's, or
``hash_encode``'s before the cast.  Appended rows are cast the same way.

Paging moves built states between the device and host memory, bit for
bit (``offload_state`` / ``restore_state``); ``StatePager`` adds what the
card needs around them: one pinned host copy per group, reused across
evict/restore cycles, and restores enqueued on a dedicated copy stream
with a CUDA event that every launch stream waits on before it reads the
restored state.

A group sharded across devices (``cfg.n_shards > 1``) is built, written
and paged shard by shard (``distributed.group_sharding``): each shard
holds a contiguous row slice and equals that slice of the unsharded
build, bit for bit.  ``make_build_step`` is the same device encode over
a ``DeviceMesh``, one process a device, as the JAX package's sharded
build step (which the dry-run traces); ``build_state`` runs it on host
rows and a sampled family and returns the mesh ``QueryState``.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..core.families import LpFamilyParams
from ..core.serving_plan import GroupServingPlan
from ..distributed import group_sharding
from ..distributed.group_sharding import (
    HostShardedState,
    ShardedQueryState,
)
from ..kernels import ops
from ..kernels.platform import resolve_device
from ..obs.trace import span
from .config import VEC_DTYPES, IndexConfig
from .engine import QueryState, encode_queries

__all__ = [
    "StatePager",
    "append_to_state",
    "build_group_state",
    "build_input_specs",
    "build_state",
    "fold_center_weight",
    "make_build_step",
    "offload_state",
    "pad_cols",
    "restore_state",
    "seal_segment",
    "storage_dtype",
]

# Row-capacity padding fill of a host-code build: a fixed sentinel code and
# zero vectors (a device-encoded build encodes its zero vectors instead).
# Dead rows are masked out of the query step by ``QueryState.n_valid``, so
# the fill only has to be deterministic.
_PAD_CODE = np.iinfo(np.int32).max // 2


def storage_dtype(cfg: IndexConfig) -> torch.dtype:
    """The torch dtype a state stores its vectors in (``cfg.vec_dtype``)."""
    if cfg.vec_dtype not in VEC_DTYPES:
        raise NotImplementedError(f"vec_dtype {cfg.vec_dtype!r}: vectors "
                                  f"are stored as one of {VEC_DTYPES}")
    return getattr(torch, cfg.vec_dtype)


def pad_cols(x: np.ndarray, beta: int) -> np.ndarray:
    """Pad the trailing (table) axis to ``beta`` columns with zeros.

    Padded tables are dead weight only: every query masks lanes >= its
    beta_q, and beta_q never exceeds the group's real beta.
    """
    have = x.shape[-1]
    if have == beta:
        return x
    if have > beta:
        raise ValueError(f"group beta {have} exceeds padded config beta {beta}")
    pad = [(0, 0)] * (x.ndim - 1) + [(0, beta - have)]
    return np.pad(x, pad)


def fold_center_weight(fam: LpFamilyParams) -> dict[str, np.ndarray]:
    """Fold center weight + width into the projection (host-side, once):
    float64 fold, then float32 ``proj``, int32 ``b_int``, float32
    ``b_frac`` and ``width = 1.0`` (``LpFamilyParams.folded``, the same
    body as ``GroupServingPlan.folded``)."""
    return fam.folded()


def make_build_step(mesh, cfg: IndexConfig):
    """The build step over a ``DeviceMesh`` (the JAX package's jit'd
    sharded build): ``(points, proj, b_int, b_frac) -> (codes, vectors)``.

    ``points`` (n, d) float32 has its rows over every mesh axis (a plain
    tensor is taken as the whole corpus, the same on every rank, and each
    rank keeps its rows); the folded family is replicated.  Each rank
    encodes its rows through ``ops.hash_encode`` (the kernel on the card)
    at unit weight and width and casts them to ``cfg.vec_dtype``; no
    collective runs.  The encode is row-independent, so the codes are a
    whole-corpus encode's.  Returns (n, beta) int32 codes and (n, d)
    vectors, ``DTensor``s with their rows sharded.
    """
    from ..distributed.sharding import as_dtensor, shard_map_nocheck
    from ..models.params import distribute

    store = storage_dtype(cfg)
    sh = group_sharding.state_shardings(mesh, cfg)
    rows = sh.points

    def body(points, proj, b_int, b_frac):
        ones = torch.ones(points.shape[1], dtype=torch.float32,
                          device=points.device)
        codes = ops.hash_encode(points, ones, proj, b_int, b_frac, 1.0)
        return codes, points.to(store)

    mapped = shard_map_nocheck(
        body, mesh, in_specs=tuple(getattr(sh, f).spec for f in (
            "points", "proj", "b_int", "b_frac")),
        out_specs=[rows.spec, rows.spec])

    def step(points, proj, b_int, b_frac):
        if not hasattr(points, "device_mesh"):
            points = distribute(points, rows)
        return mapped(points, *(as_dtensor(x, mesh)
                                for x in (proj, b_int, b_frac)))

    return step


def build_state(mesh, cfg: IndexConfig, points,
                fam: LpFamilyParams) -> QueryState:
    """A mesh ``QueryState`` from host rows and a sampled family.

    Folds the family (``fold_center_weight``) and runs
    ``make_build_step(mesh, cfg)`` on the mesh's device: the
    ``hash_encode`` kernel on a CUDA mesh (which raises rather than fall
    back), its plain version on a CPU mesh.  Codes and vectors are
    ``DTensor``s with their rows over every mesh axis; the folded family
    and ``width`` are replicated as ``group_sharding.state_shardings``
    lays them out; ``n_valid`` is ``len(points)``, a Python int.
    ``points`` (a numpy array, a tensor or a rows-sharded ``DTensor``)
    fills the config's capacity ``cfg.n``.
    """
    from ..models.params import distribute

    dev = resolve_device(mesh.device_type)
    n_valid = len(points)
    if not hasattr(points, "device_mesh"):
        points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    fam_t = {k: torch.as_tensor(v, device=dev)
             for k, v in fold_center_weight(fam).items()}
    codes, vecs = make_build_step(mesh, cfg)(
        points, fam_t["proj"], fam_t["b_int"], fam_t["b_frac"])
    sh = group_sharding.state_shardings(mesh, cfg)
    return QueryState(codes=codes, points=vecs, n_valid=n_valid, **{
        k: distribute(v, getattr(sh, k)) for k, v in fam_t.items()})


def build_input_specs(cfg: IndexConfig) -> dict:
    """Meta tensors of the build step's arguments at their global shapes
    (the dry-run's inputs; nothing is allocated)."""
    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return dict(points=meta((cfg.n, cfg.d)), proj=meta((cfg.d, cfg.beta)),
                b_int=meta((cfg.beta,), torch.int32),
                b_frac=meta((cfg.beta,)))


def build_group_state(
    cfg: IndexConfig,
    points: np.ndarray | None,
    gplan: GroupServingPlan,
    device="cuda",
    *,
    extra_points: np.ndarray | None = None,
    extra_codes: np.ndarray | None = None,
    base_rows: np.ndarray | None = None,
    points_loader=None,
    n_points: int | None = None,
):
    """Materialize one table group's ``QueryState`` on ``device``.

    ``cfg.beta`` may exceed the group's real table count (bucketed shape
    padding, ``config.pad_beta``); codes and family are zero-padded to
    match.  ``cfg.n`` is a row *capacity* and may exceed the live row
    count: the excess rows hold zero vectors and, on the host-code path,
    the sentinel code ``int32 max // 2``; a device-encoded build encodes
    them like every row (an encoded zero row is exactly ``b_int``).
    ``n_valid`` masks them out of every query.

    Without host codes the corpus is uploaded once, padded on the device,
    and encoded there from its float32 vectors.  The vectors are then
    stored in ``cfg.vec_dtype`` (bfloat16: rounded to nearest even on the
    device).

    Sharding: with ``cfg.n_shards > 1`` the result is a
    ``ShardedQueryState`` whose shard s holds the rows ``[s * n_loc, (s +
    1) * n_loc)`` on ``device[s]`` (a sequence of one device a shard; a
    single device goes through ``group_sharding.serving_devices``).
    Each shard equals the same row slice of the unsharded build.
    ``points_loader`` + ``n_points`` replace ``points`` (pass None) with
    per-shard row ranges (``group_sharding.build_group_state_per_host``):
    the whole corpus never exists as one host array.  They do not combine
    with the streaming arguments.

    Streaming:

    * ``base_rows`` keeps only those base corpus rows, in that order (the
      tombstone purge's rebuild); the plan's host codes are row-sliced to
      match.  None keeps every row.
    * ``extra_points`` appends already-compacted streaming rows after the
      base rows; on the host-code path ``extra_codes`` carries their
      sealed codes (``seal_segment``, at ``cfg.beta`` columns), and a
      device-encoded build encodes them with the rest.  The result equals,
      bit for bit, a state that reached the same rows through
      ``append_to_state``.
    """
    if points_loader is not None:
        if points is not None:
            raise ValueError("pass either points or points_loader, not both")
        if n_points is None:
            raise ValueError("points_loader requires n_points")
        if (extra_points is not None or extra_codes is not None
                or base_rows is not None):
            raise ValueError(
                "points_loader does not combine with the streaming "
                "arguments (extra_points/extra_codes/base_rows)")
        return group_sharding.build_group_state_per_host(
            cfg, gplan, points_loader, n_points,
            group_sharding.shard_devices_of(device, cfg.n_shards))
    base = np.asarray(points, dtype=np.float32)
    if base_rows is not None:
        base_rows = np.asarray(base_rows, np.int64)
        base = base[base_rows]
    n_base = len(base)
    extra = (np.zeros((0, cfg.d), np.float32) if extra_points is None
             else np.asarray(extra_points, np.float32).reshape(-1, cfg.d))
    n_rows = n_base + len(extra)
    if n_rows > cfg.n:
        raise ValueError(
            f"{n_rows} live rows exceed the config row capacity {cfg.n}"
        )
    base_codes = None
    if gplan.codes is not None:
        base_codes = gplan.codes
        if base_rows is not None:
            base_codes = base_codes[base_rows]
        if len(base_codes) != n_base:
            raise ValueError(
                f"host codes cover {len(base_codes)} rows, expected {n_base}"
            )
        n_extra_codes = 0 if extra_codes is None else len(extra_codes)
        if n_extra_codes != len(extra):
            raise ValueError(
                f"{n_extra_codes} extra codes for {len(extra)} extra rows "
                f"(pass extra_codes alongside extra_points)"
            )
        if len(extra) and extra_codes.shape[1] != cfg.beta:
            raise ValueError(
                f"extra_codes must be sealed at cfg.beta={cfg.beta} "
                f"columns, got {extra_codes.shape[1]}"
            )
    host_codes = base_codes is not None

    def pieces(lo, hi):  # the base and extra rows among rows [lo, hi)
        out = []
        for at, rows, codes in ((0, base, base_codes),
                                (n_base, extra, extra_codes)):
            a, b = max(lo, at), min(hi, at + len(rows))
            if a < b:
                out.append((a, rows[a - at:b - at], pad_cols(
                    codes[a - at:b - at], cfg.beta) if host_codes else None))
        return out

    return group_sharding.build_shards(
        cfg, gplan, group_sharding.shard_devices_of(device, cfg.n_shards),
        n_rows, pieces, host_codes)


def seal_segment(
    cfg: IndexConfig,
    gplan: GroupServingPlan,
    vectors: np.ndarray,
    state: QueryState | None = None,
) -> np.ndarray:
    """Hash a delta segment into ``(m, cfg.beta)`` int32 bucket codes.

    The rows are hashed with the group's own family, through the same
    encoding as the group's data codes: the host float64 path when the
    plan ships host codes (equal to a fresh host build over the union
    corpus), otherwise ``engine.encode_queries`` on the group's device
    ``state`` (the ``hash_encode`` kernel on the card), whose encode is
    row-independent, so the codes equal those of a fresh device build
    over the union corpus.  ``append_to_state`` later splices the codes
    into the state: the hashing of a compaction happens here.
    """
    vectors = np.array(np.atleast_2d(vectors), np.float32)  # writable copy
    if gplan.codes is not None:
        return pad_cols(gplan.encode_host(vectors), cfg.beta).astype(np.int32)
    if state is None:
        raise ValueError(
            "sealing without plan host codes needs the group's device "
            "state for the device encode"
        )
    return encode_queries(state, vectors).cpu().numpy()


def append_to_state(state: QueryState, codes: np.ndarray,
                    vectors: np.ndarray) -> QueryState:
    """Write sealed rows into a group state's reserved capacity.

    The ``m`` rows are copied into ``state.codes`` and ``state.points``
    (cast to the state's vector dtype, as a build casts them) at row
    ``state.n_valid`` on the state's device (on the current stream),
    and a state over the same tensors with ``n_valid`` advanced by ``m``
    is returned: the shapes, and so the query step, never change.  The
    input state stays valid: the written rows lie at or past its
    ``n_valid``, where every query of it treats them as dead rows (bin
    L+2 in the fused pass, level L+1 in the unfused one), so its answers
    are unchanged.  Equal, bit for bit, to ``build_group_state`` over the
    union corpus at the same capacity.

    On a ``ShardedQueryState`` each row goes to the shard that owns its
    global row (several shards when the rows cross a slice boundary).
    """
    m = len(codes)
    if m != len(vectors):
        raise ValueError(f"codes/vectors row mismatch: {m} vs {len(vectors)}")
    if isinstance(state, ShardedQueryState):
        return _append_sharded(state, codes, vectors)
    off = state.n_valid
    cap, beta = state.codes.shape
    if off + m > cap:
        raise ValueError(
            f"append of {m} rows at {off} exceeds row capacity {cap} "
            f"(raise ServiceConfig.delta_reserve_rows)"
        )
    if m and np.shape(codes)[1] != beta:
        raise ValueError(f"codes must have {beta} columns, got "
                         f"{np.shape(codes)[1]}")
    state.codes[off:off + m].copy_(
        torch.from_numpy(np.ascontiguousarray(codes, np.int32)))
    state.points[off:off + m].copy_(
        torch.from_numpy(np.ascontiguousarray(vectors, np.float32)))
    return dataclasses.replace(state, n_valid=off + m)


def _append_sharded(state: ShardedQueryState, codes, vectors):
    """``append_to_state`` over the shards: global rows ``[n_valid,
    n_valid + m)`` split at the slice boundaries."""
    m, off, n_loc = len(codes), state.n_valid, state.rows_per_shard
    cap = n_loc * state.n_shards
    if off + m > cap:
        raise ValueError(
            f"append of {m} rows at {off} exceeds row capacity {cap} "
            f"(raise ServiceConfig.delta_reserve_rows)"
        )
    shards = []
    for sh, lo in zip(state.shards, state.offsets):
        a, b = max(off, lo), min(off + m, lo + n_loc)
        if a < b:  # this shard's live tail is at local row a - lo
            sh = append_to_state(sh, codes[a - off:b - off],
                                 vectors[a - off:b - off])
        shards.append(sh)
    return dataclasses.replace(state, shards=tuple(shards), n_valid=off + m)


def _tensor_fields(state: QueryState):
    """(name, tensor) of every tensor field of ``state``."""
    for f in dataclasses.fields(QueryState):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v


def offload_state(state: QueryState,
                  out: QueryState | None = None) -> QueryState:
    """Copy a ``QueryState`` into host memory, bit for bit.

    Every tensor keeps its dtype (bfloat16 vectors stay bfloat16) and
    shape.  From the card the copies land
    in pinned (page-locked) host memory, so a later ``restore_state`` can
    upload them asynchronously; on the CPU they are clones.  ``out``, an
    earlier host copy of the same shapes (a group's bytes keep their
    shapes), is written in place and returned, so a group's pinned
    buffers are allocated once and reused across evict/restore cycles.
    The copy is synchronous: the result holds the bytes on return.  A
    ``ShardedQueryState`` is copied shard by shard into a
    ``HostShardedState`` (``group_sharding.offload_state_sharded``).
    """
    if isinstance(state, ShardedQueryState):
        return group_sharding.offload_state_sharded(state, out=out)
    pin = state.device.type == "cuda"
    fields = {}
    for name, t in _tensor_fields(state):
        dst = getattr(out, name) if out is not None else None
        if (dst is None or dst.shape != t.shape or dst.dtype != t.dtype
                or dst.device.type != "cpu"):
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        dst.copy_(t)
        fields[name] = dst
    return QueryState(n_valid=state.n_valid, **fields)


def restore_state(host: QueryState, device: str | torch.device,
                  stream=None) -> QueryState:
    """Upload an ``offload_state`` copy to ``device``: the same bytes.

    No re-encode and no new query step: one host-to-device copy per
    tensor.  On the card the tensors are allocated on ``stream`` (the
    current stream when None) and the copies are enqueued there without
    blocking the host (``non_blocking`` from pinned memory); the caller
    orders every later use after them (``StatePager.ready``).  On the CPU
    the tensors are fresh clones.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return QueryState(n_valid=host.n_valid, **{
            name: t.to(dev, copy=True) for name, t in _tensor_fields(host)})
    stream = stream if stream is not None else torch.cuda.current_stream(dev)
    with torch.cuda.stream(stream):
        fields = {name: torch.empty(t.shape, dtype=t.dtype, device=dev)
                  .copy_(t, non_blocking=True)
                  for name, t in _tensor_fields(host)}
    return QueryState(n_valid=host.n_valid, **fields)


@dataclasses.dataclass
class _Copy:
    """The device work that made one shard of a group's current state: a
    restore on its device's copy stream, or a build or write on the
    stream that ran it."""

    start: object  # torch.cuda.Event (timing; None for a build or write)
    end: object  # torch.cuda.Event; launch streams wait on it
    nbytes: int
    streams: set = dataclasses.field(default_factory=set)  # waited on it


@dataclasses.dataclass
class _Group:
    """A group's paging record: its device state and its host buffers."""

    state: object = None  # weakref to the group's current device state
    host: object = None  # its host copy (pinned on the card)
    copies: list | None = None  # per shard: the work that produced it


def _shards(state) -> tuple:
    """The per-device ``QueryState``s of a state (itself when unsharded)."""
    if isinstance(state, (ShardedQueryState, HostShardedState)):
        return state.shards
    return (state,)


class StatePager:
    """Offload and restore executors for a ``StateCache``.

    ``offload(state)`` copies an evicted state into its group's host
    buffers (pinned on the card, allocated once per group) and
    ``restore(gi, host)`` uploads them again.  On the card a restore
    allocates its tensors on a dedicated copy stream of the device and
    enqueues the copies there between two timing events, so a prefetch
    returns at once and the upload overlaps the launches that run
    meanwhile.  Every use of a state's tensors (a launch, a seal's encode,
    a compaction's write) calls ``ready(gi, state)`` first: the current
    stream of the calling thread waits on the copy's end event and each
    tensor is recorded on that stream, so neither the use nor the caching
    allocator can touch the memory before the copy is done.  An offload
    waits for the restore that filled its group's buffers before it
    overwrites them.

    A sharded state (``ShardedQueryState``; ``device`` is then a sequence
    naming one device a shard) is paged shard by shard: one pinned host
    chunk per shard (``HostShardedState``), each device its own copy
    stream, each shard its own start and end events, and ``ready`` orders
    each shard's device's current stream after that shard's copy.  An
    offload waits for every shard's restore.

    A state that replaces the group's (a compaction's append writes the
    same tensors in place) is ``adopt``ed like a fresh build: the group
    keeps its host buffers, and the next offload copies the written rows
    into them again.

    ``restore_timings`` hands the ``StateCache`` the device time of each
    finished copy (one a shard); ``summary`` reports the finished copies'
    bytes and times, and the pinned host bytes.  On the CPU the same
    executors clone and nothing waits.
    """

    def __init__(self, device):
        self.devices = tuple(resolve_device(d) for d in (
            device if isinstance(device, (list, tuple)) else (device,)))
        self.device = self.devices[0]
        self._groups: dict[int, _Group] = {}
        self._streams: dict = {}  # device -> its copy stream, made lazily
        self._untimed: list[_Copy] = []  # copies whose time is not read yet
        self._copy_ms: list[float] = []  # device time of finished copies
        self._copy_bytes: list[int] = []
        self._n_reported = 0  # copies already handed to restore_timings
        self.n_offloads = 0

    def _group(self, gi: int) -> _Group:
        return self._groups.setdefault(int(gi), _Group())

    def adopt(self, gi: int, state) -> object:
        """Record ``state``, just built or written on the current streams,
        as group ``gi``'s current state; returns it.

        On the card an event is recorded on each shard's device's current
        stream after that work, and ``ready`` orders a use on any other
        stream after it.
        """
        g = self._group(gi)
        g.state = weakref.ref(state)
        g.copies = None
        if self.device.type == "cuda":
            g.copies = []
            for sh in _shards(state):
                stream = torch.cuda.current_stream(sh.device)
                g.copies.append(_Copy(None, stream.record_event(), 0,
                                      {stream.cuda_stream}))
        return state

    def offload(self, state):
        """StateCache offload executor: ``state``'s bytes in host memory
        (the layer span ``wlsh_offload``, its waits included)."""
        self.n_offloads += 1
        g = next((r for r in self._groups.values()
                  if r.state is not None and r.state() is state), None)
        with span("wlsh_offload"):
            if g is None:
                return offload_state(state)
            for c in g.copies or ():
                # the restore read these buffers and wrote ``state``: both
                # must be done before the buffers are overwritten from it
                c.end.synchronize()
            g.host = offload_state(state, out=g.host)
            return g.host

    def _copy_stream(self, dev: torch.device):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def restore(self, gi: int, host):
        """StateCache restore executor: upload ``host`` for group ``gi``
        (a ``HostShardedState`` shard by shard onto ``self.devices``).
        The layer span ``wlsh_restore`` is its host side: on the card the
        copies it enqueues run on after it."""
        with span("wlsh_restore"):
            g = self._group(gi)
            sharded = isinstance(host, HostShardedState)
            devices = self.devices if sharded else (self.device,)
            if self.device.type != "cuda":
                state = (group_sharding.restore_state_sharded(host, devices)
                         if sharded else restore_state(host, self.device))
                g.state, g.copies, g.host = weakref.ref(state), None, host
                return state
            shards, g.copies = [], []
            for h, dev in zip(_shards(host), devices):
                stream = self._copy_stream(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                shards.append(restore_state(h, dev, stream=stream))
                end.record(stream)
                g.copies.append(_Copy(start, end, shards[-1].nbytes))
            self._untimed += g.copies
            state = (group_sharding.ShardedQueryState(
                shards=tuple(shards), offsets=host.offsets,
                n_valid=host.n_valid) if sharded else shards[0])
            g.state, g.host = weakref.ref(state), host
            return state

    def ready(self, gi: int, state) -> None:
        """Order the current streams' next uses of ``state`` after the
        restore copies, build or write that made it, shard by shard (a
        no-op on the CPU)."""
        g = self._groups.get(int(gi))
        if g is None or g.copies is None or g.state() is not state:
            return
        for sh, c in zip(_shards(state), g.copies):
            stream = torch.cuda.current_stream(sh.device)
            if stream.cuda_stream in c.streams:
                continue
            stream.wait_event(c.end)
            for _, t in _tensor_fields(sh):
                t.record_stream(stream)
            c.streams.add(stream.cuda_stream)

    def _poll(self) -> None:
        """Read the device time of every copy that has finished."""
        pending = []
        for c in self._untimed:  # in restore order; devices end apart
            if c.end.query():
                self._copy_ms.append(c.start.elapsed_time(c.end))
                self._copy_bytes.append(c.nbytes)
            else:
                pending.append(c)
        self._untimed = pending

    def restore_timings(self) -> list[tuple[int, float]]:
        """(nbytes, seconds) of the copies finished since the last call."""
        self._poll()
        new = list(zip(self._copy_bytes[self._n_reported:],
                       (ms / 1e3 for ms in self._copy_ms[self._n_reported:])))
        self._n_reported = len(self._copy_ms)
        return new

    @property
    def pinned_bytes(self) -> int:
        """Host bytes held by the groups' offload buffers."""
        return sum(t.numel() * t.element_size()
                   for g in self._groups.values() if g.host is not None
                   for sh in _shards(g.host) for _, t in _tensor_fields(sh))

    def summary(self) -> dict:
        """Offloads, the finished restore copies' bytes and device times
        (ms, in restore order, one a shard), and the pinned host bytes."""
        self._poll()
        return dict(n_offloads=self.n_offloads,
                    copy_bytes=list(self._copy_bytes),
                    copy_ms=list(self._copy_ms),
                    pinned_bytes=self.pinned_bytes)
