"""Streaming-insert primitives: delta memtables, sealed segments, exact scan.

A group state has fixed shapes (``IndexConfig.n`` rows of capacity), so
fresh inserts cannot enter it row by row.  Each table group instead
carries a small mutable side structure with an LSM-like lifecycle:

  open      a ``DeltaSegment`` memtable buffers raw inserted vectors on
            the host; queries scan it *exactly* (the full weighted l_p
            distance, in the coordinate-difference form of the engine's
            re-rank), so recall on unsealed points is perfect
  sealed    at ``IndexConfig.delta_seal_rows`` rows the memtable freezes
            into a ``SealedSegment``: its rows hashed with the group's
            own family (``builder.seal_segment``: host float64 codes, or
            the ``hash_encode`` kernel for a plan without host codes),
            still served by exact scan but ready to splice into the state
  compacted ``builder.append_to_state`` writes the sealed rows into the
            state's reserved row capacity on the device, after which the
            fused kernels serve them, bit for bit as a fresh build over
            the union corpus would

This module owns the host data structures and the exact-scan math, in
numpy as in the JAX package (the scan's bits equal the reference's); the
serving orchestration (routing, tombstones, the compaction transaction
against the ``StateCache``) lives in ``repro_torch.serving.delta``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DeltaSegment", "SealedSegment", "exact_weighted_lp", "scan_topk"]


class DeltaSegment:
    """Append-only open memtable of one group's unsealed inserts."""

    def __init__(self, d: int):
        self.d = int(d)
        self._ids: list[int] = []
        self._vecs: list[np.ndarray] = []
        self._stacked: np.ndarray | None = None  # cached ``vectors`` view

    def __len__(self) -> int:
        """Number of unsealed rows currently buffered."""
        return len(self._ids)

    def append(self, point_id: int, vector: np.ndarray) -> None:
        """Buffer one inserted vector under its assigned global id."""
        vector = np.ascontiguousarray(vector, np.float32).reshape(-1)
        if vector.shape != (self.d,):
            raise ValueError(
                f"insert must be a ({self.d},) vector, got {vector.shape}"
            )
        self._ids.append(int(point_id))
        self._vecs.append(vector)
        self._stacked = None  # invalidate the cached stack

    @property
    def ids(self) -> np.ndarray:
        """(m,) int64 global point ids of the buffered rows."""
        return np.asarray(self._ids, np.int64)

    @property
    def vectors(self) -> np.ndarray:
        """(m, d) float32 buffered rows, in insertion order.

        The stacked array is cached between writes, since every query
        routed to the group scans its pending rows; ``append`` and
        ``drain`` invalidate it.  It is shared across reads and returned
        read-only.
        """
        if self._stacked is None:
            if self._vecs:
                stacked = np.stack(self._vecs).astype(np.float32)
            else:
                stacked = np.empty((0, self.d), np.float32)
            stacked.flags.writeable = False
            self._stacked = stacked
        return self._stacked

    def drain(self) -> tuple[np.ndarray, np.ndarray]:
        """Freeze and clear the memtable, returning ``(ids, vectors)``."""
        ids, vecs = self.ids, self.vectors
        self._ids, self._vecs = [], []
        self._stacked = None
        return ids, vecs


@dataclasses.dataclass(frozen=True)
class SealedSegment:
    """An immutable hashed mini-state awaiting compaction.

    ``codes`` are the rows hashed with the owning group's family at the
    group's padded table width (``seal_segment``), so compaction is a
    pure splice: no hashing happens on the compaction path.
    """

    ids: np.ndarray  # (m,) int64 global point ids
    vectors: np.ndarray  # (m, d) float32
    codes: np.ndarray  # (m, beta_padded) int32

    def __len__(self) -> int:
        """Number of rows in the sealed segment."""
        return len(self.ids)


# (Q, rows, d) elements per chunk of the exact scan (4 MiB of float32)
_SCAN_CHUNK_ELEMS = 1 << 20


def exact_weighted_lp(
    queries: np.ndarray,
    vectors: np.ndarray,
    q_weights: np.ndarray,
    p: float,
) -> np.ndarray:
    """(Q, m) exact per-query weighted l_p distances, float32.

    Coordinate-difference form, as the engine's re-rank computes its
    top-k survivors (not the norms expansion, whose float32 cancellation
    swamps small distances), so delta hits rank against indexed hits on
    equal footing.

    The rows are taken in chunks that keep the ``(Q, rows, d)``
    intermediates near ``_SCAN_CHUNK_ELEMS`` elements: a row's distance
    depends on that row alone (its sum runs over its own ``d`` terms), so
    the chunking changes no bit, and a scan of the whole corpus (the
    shadow recall oracle) works in cache instead of streaming gigabytes
    of intermediates through main memory.
    """
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    q_weights = np.atleast_2d(np.asarray(q_weights, np.float32))
    vectors = np.atleast_2d(np.asarray(vectors, np.float32))
    m = len(vectors)
    rows = max(1, _SCAN_CHUNK_ELEMS // max(len(queries) * vectors.shape[1],
                                           1))
    if m <= rows:
        return _weighted_lp_rows(queries, vectors, q_weights, p)
    out = np.empty((len(queries), m), np.float32)
    for lo in range(0, m, rows):
        out[:, lo: lo + rows] = _weighted_lp_rows(
            queries, vectors[lo: lo + rows], q_weights, p)
    return out


def _weighted_lp_rows(queries, vectors, q_weights, p: float) -> np.ndarray:
    """``exact_weighted_lp`` on one chunk of rows."""
    diff = np.abs(
        (queries[:, None, :] - vectors[None, :, :]) * q_weights[:, None, :]
    ).astype(np.float32)
    if abs(p - 2.0) < 1e-9:
        return np.sqrt(np.sum(diff * diff, axis=-1, dtype=np.float32))
    if abs(p - 1.0) < 1e-9:
        return np.sum(diff, axis=-1, dtype=np.float32)
    return (
        np.sum(diff**np.float32(p), axis=-1, dtype=np.float32)
        ** np.float32(1.0 / p)
    )


def scan_topk(
    queries: np.ndarray,
    q_weights: np.ndarray,
    ids: np.ndarray,
    vectors: np.ndarray,
    p: float,
    k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k of the delta rows per query: ``(ids, dists)`` (Q, k).

    Missing slots (fewer than ``k`` delta rows) hold id -1 / distance
    +inf, the engine's conventions, so the batching layer's merge treats
    delta hits and indexed hits alike.  Ties sort by insertion order.

    Selection is O(m) per query (``np.argpartition``) on the unique key
    ``(distance bits << 32) | row``: the distances are non-negative
    float32, so their bit patterns order like the values, and the row
    breaks ties as a stable sort would.
    """
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    nq = len(queries)
    out_ids = np.full((nq, k), -1, np.int64)
    out_d = np.full((nq, k), np.inf, np.float32)
    m = len(ids)
    if m == 0:
        return out_ids, out_d
    dists = exact_weighted_lp(queries, vectors, q_weights, p)
    take = min(k, m)
    # + 0.0 turns any -0.0 into +0.0, so the uint32 bits order monotonically
    keys = (dists + np.float32(0.0)).view(np.uint32).astype(np.int64)
    keys = (keys << np.int64(32)) | np.arange(m, dtype=np.int64)[None, :]
    if take < m:
        part = np.argpartition(keys, take - 1, axis=1)[:, :take]
        sel = np.take_along_axis(keys, part, axis=1)
        order = np.take_along_axis(part, np.argsort(sel, axis=1), axis=1)
    else:
        order = np.argsort(keys, axis=1)
    out_ids[:, :take] = np.asarray(ids, np.int64)[order]
    out_d[:, :take] = np.take_along_axis(dists, order, axis=1)
    return out_ids, out_d
