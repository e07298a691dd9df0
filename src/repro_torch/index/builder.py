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
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..core.serving_plan import GroupServingPlan
from ..kernels import ops
from ..kernels.platform import resolve_device
from .config import VEC_DTYPES, IndexConfig
from .engine import QueryState, encode_queries

__all__ = [
    "StatePager",
    "append_to_state",
    "build_group_state",
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


def build_group_state(
    cfg: IndexConfig,
    points: np.ndarray,
    gplan: GroupServingPlan,
    device: str | torch.device = "cuda",
    *,
    extra_points: np.ndarray | None = None,
    extra_codes: np.ndarray | None = None,
    base_rows: np.ndarray | None = None,
) -> QueryState:
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
    dev = resolve_device(device)
    store = storage_dtype(cfg)
    folded = gplan.folded()

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    proj = put(pad_cols(folded["proj"], cfg.beta))
    b_int = put(pad_cols(folded["b_int"], cfg.beta))
    b_frac = put(pad_cols(folded["b_frac"], cfg.beta))

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
    if gplan.codes is None:
        vecs = torch.zeros((cfg.n, cfg.d), dtype=torch.float32, device=dev)
        vecs[:n_base] = put(base)
        vecs[n_base:n_rows] = put(extra)
        codes = ops.hash_encode(vecs, torch.ones(cfg.d, device=dev), proj,
                                b_int, b_frac, 1.0)
        vecs = vecs.to(store)
    else:
        vecs = torch.zeros((cfg.n, cfg.d), dtype=store, device=dev)
        vecs[:n_base] = put(base)  # a float32 upload, cast on the device
        vecs[n_base:n_rows] = put(extra)
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
        codes = torch.full((cfg.n, cfg.beta), _PAD_CODE, dtype=torch.int32,
                           device=dev)
        codes[:n_base] = put(pad_cols(base_codes, cfg.beta).astype(np.int32))
        if len(extra):
            if extra_codes.shape[1] != cfg.beta:
                raise ValueError(
                    f"extra_codes must be sealed at cfg.beta={cfg.beta} "
                    f"columns, got {extra_codes.shape[1]}"
                )
            codes[n_base:n_rows] = put(np.asarray(extra_codes, np.int32))
    return QueryState(
        codes=codes,
        points=vecs,
        proj=proj,
        b_int=b_int,
        b_frac=b_frac,
        width=torch.tensor(1.0, dtype=torch.float32, device=dev),
        n_valid=n_rows,
    )


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
    """
    m = len(codes)
    if m != len(vectors):
        raise ValueError(f"codes/vectors row mismatch: {m} vs {len(vectors)}")
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
    The copy is synchronous: the result holds the bytes on return.
    """
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
    """The device work that made a group's current state: a restore on
    the copy stream, or a build or write on the stream that ran it."""

    start: object  # torch.cuda.Event (timing; None for a build or write)
    end: object  # torch.cuda.Event; launch streams wait on it
    nbytes: int
    streams: set = dataclasses.field(default_factory=set)  # waited on it


@dataclasses.dataclass
class _Group:
    """A group's paging record: its device state and its host buffers."""

    state: object = None  # weakref to the group's current device state
    host: QueryState | None = None  # its host copy (pinned on the card)
    copy: _Copy | None = None  # the device work that produced ``state``


class StatePager:
    """Offload and restore executors for a ``StateCache`` on one device.

    ``offload(state)`` copies an evicted state into its group's host
    buffers (pinned on the card, allocated once per group) and
    ``restore(gi, host)`` uploads them again.  On the card a restore
    allocates its tensors on a dedicated copy stream and enqueues the
    copies there between two timing events, so a prefetch returns at once
    and the upload overlaps the launches that run meanwhile.  Every use of
    a state's tensors (a launch, a seal's encode, a compaction's write)
    calls ``ready(gi, state)`` first: the current stream of the calling
    thread waits on the copy's end event and each tensor is recorded on
    that stream, so neither the use nor the caching allocator can touch
    the memory before the copy is done.  An offload waits for the restore
    that filled its group's buffers before it overwrites them.

    A state that replaces the group's (a compaction's append writes the
    same tensors in place) is ``adopt``ed like a fresh build: the group
    keeps its host buffers, and the next offload copies the written rows
    into them again.

    ``restore_timings`` hands the ``StateCache`` the device time of each
    finished copy; ``summary`` reports the finished copies' bytes and
    times, and the pinned host bytes.  On the CPU the same executors clone
    and nothing waits.
    """

    def __init__(self, device: str | torch.device):
        self.device = resolve_device(device)
        self._groups: dict[int, _Group] = {}
        self._stream = None  # the copy stream, created on first restore
        self._untimed: list[_Copy] = []  # copies whose time is not read yet
        self._copy_ms: list[float] = []  # device time of finished copies
        self._copy_bytes: list[int] = []
        self._n_reported = 0  # copies already handed to restore_timings
        self.n_offloads = 0

    def _group(self, gi: int) -> _Group:
        return self._groups.setdefault(int(gi), _Group())

    def adopt(self, gi: int, state: QueryState) -> QueryState:
        """Record ``state``, just built or written on the current stream,
        as group ``gi``'s current state; returns it.

        On the card an event is recorded on the current stream after that
        work, and ``ready`` orders a use on any other stream after it.
        """
        g = self._group(gi)
        g.state = weakref.ref(state)
        g.copy = None
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            g.copy = _Copy(None, stream.record_event(), 0,
                           {stream.cuda_stream})
        return state

    def offload(self, state: QueryState) -> QueryState:
        """StateCache offload executor: ``state``'s bytes in host memory."""
        self.n_offloads += 1
        g = next((r for r in self._groups.values()
                  if r.state is not None and r.state() is state), None)
        if g is None:
            return offload_state(state)
        if g.copy is not None:
            # the restore read these buffers and wrote ``state``: both
            # must be done before the buffers are overwritten from it
            g.copy.end.synchronize()
        g.host = offload_state(state, out=g.host)
        return g.host

    def restore(self, gi: int, host: QueryState) -> QueryState:
        """StateCache restore executor: upload ``host`` for group ``gi``."""
        g = self._group(gi)
        if self.device.type != "cuda":
            state = restore_state(host, self.device)
            g.state, g.copy, g.host = weakref.ref(state), None, host
            return state
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(self._stream)
        state = restore_state(host, self.device, stream=self._stream)
        end.record(self._stream)
        g.state, g.host = weakref.ref(state), host
        g.copy = _Copy(start, end, state.nbytes)
        self._untimed.append(g.copy)
        return state

    def ready(self, gi: int, state: QueryState) -> None:
        """Order the current stream's next uses of ``state`` after the
        restore copy, build or write that made it (a no-op on the CPU)."""
        g = self._groups.get(int(gi))
        if g is None or g.copy is None or g.state() is not state:
            return
        stream = torch.cuda.current_stream(self.device)
        if stream.cuda_stream in g.copy.streams:
            return
        stream.wait_event(g.copy.end)
        for _, t in _tensor_fields(state):
            t.record_stream(stream)
        g.copy.streams.add(stream.cuda_stream)

    def _poll(self) -> None:
        """Read the device time of every copy that has finished."""
        while self._untimed and self._untimed[0].end.query():
            c = self._untimed.pop(0)  # one stream: copies end in order
            self._copy_ms.append(c.start.elapsed_time(c.end))
            self._copy_bytes.append(c.nbytes)

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
                   for _, t in _tensor_fields(g.host))

    def summary(self) -> dict:
        """Offloads, the finished restore copies' bytes and device times
        (ms, in restore order), and the pinned host bytes."""
        self._poll()
        return dict(n_offloads=self.n_offloads,
                    copy_bytes=list(self._copy_bytes),
                    copy_ms=list(self._copy_ms),
                    pinned_bytes=self.pinned_bytes)
