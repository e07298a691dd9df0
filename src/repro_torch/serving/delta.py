"""Streaming delta-index orchestration: inserts, deletes, compaction.

``DeltaIndex`` is the mutable side of the serving stack.  The group
states on the device change only in a compaction; everything that moves
in between lives here, per table group, on the host:

  insert     ``insert(vector, weight_id)`` routes the row to
             ``plan.group_of[weight_id]`` (inserts are tenant-scoped: the
             row is indexed in, and visible to, its weight's table
             group), assigns the next global id past the corpus epoch,
             and appends to the group's open memtable.  Fresh rows are
             served at once by an exact scan, so recall on them is
             perfect before any index work.
  seal       at ``ServiceConfig.delta_seal_rows`` rows the memtable is
             hashed with the group's family (``builder.seal_segment``:
             host float64 codes, or the ``hash_encode`` kernel on the
             group's leased state for a plan without host codes) into a
             ``SealedSegment``.
  compact    sealed segments are written into the group state's reserved
             row capacity on the device (``builder.append_to_state``)
             under a short lease, and ``Batcher.replace_state`` installs
             the result at a bumped ``StateCache`` version: one group's
             cached bytes change, no other group's state and no query
             step.  The result equals a fresh ``build_group_state`` over
             the union corpus, bit for bit.
  delete     ``delete(id)`` tombstones a global id (base or inserted);
             tombstoned ids are filtered out of every merged top-k.
             Tombstones survive ordinary compaction.
  purge      ``compact(purge=True)`` rebuilds every group that drops a
             row over its *surviving* corpus (tombstoned base rows and
             inserts left out), reclaiming their ``n_valid`` capacity,
             and clears the tombstone set.  The purged state equals a
             fresh ``build_group_state`` over the survivors, and no query
             step changes (capacity shapes never change).

Every launch through ``Batcher.run_batch`` calls ``augment``: state rows
translate to global ids, the group's pending rows are scanned exactly
with the engine's own distance form, and ``batching.merge_topk`` folds
the two candidate lists under the no-drop / no-dup / tombstone
invariants.  A group with nothing pending and no tombstones passes
through bit for bit.

Every lease here that reads or writes a state's tensors goes through
``Batcher.lease``, which orders the current stream after the state's
restore copy (``StatePager.ready``) before the encode or the write.
Sharded states (``ServiceConfig.n_shards > 1``) take the same path:
``append_to_state`` writes each row into the shard that owns it, a
codeless seal encodes on the first shard, and a purge's rebuild builds
shard by shard.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..index.builder import append_to_state, seal_segment
from ..index.streaming import DeltaSegment, SealedSegment, scan_topk
from .batching import merge_topk

__all__ = ["DeltaIndex", "DeltaStats"]


@dataclasses.dataclass
class DeltaStats:
    """Running streaming counters (whole-service, monotone)."""

    n_inserts: int = 0  # rows ever inserted
    n_deletes: int = 0  # tombstones ever placed
    n_seals: int = 0  # memtable -> sealed-segment transitions
    n_compactions: int = 0  # compaction transactions committed
    n_rows_compacted: int = 0  # rows absorbed into main states
    n_delta_scans: int = 0  # launches that also scanned pending rows
    n_purges: int = 0  # purge sweeps (tombstone-dropping union rebuilds)
    n_rows_purged: int = 0  # tombstoned rows dropped from main states


class _GroupDelta:
    """One group's mutable side: open memtable, sealed queue, append log."""

    def __init__(self, d: int):
        self.open = DeltaSegment(d)
        self.sealed: list[SealedSegment] = []
        # append log of compacted rows (host copies): row r >= n_base_live
        # of the group state maps to compacted_ids[r - n_base_live];
        # vectors and sealed codes are kept so that a discard-mode cold
        # rebuild reproduces the union state bit for bit
        self.compacted_ids = np.empty(0, np.int64)
        self.compacted_vecs: list[np.ndarray] = []
        self.compacted_codes: list[np.ndarray] = []

    @property
    def n_pending(self) -> int:
        """Rows inserted but not yet compacted (open + sealed)."""
        return len(self.open) + sum(len(s) for s in self.sealed)

    def pending_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """(ids, vectors) of every uncompacted row, insertion order."""
        ids = [s.ids for s in self.sealed] + [self.open.ids]
        vecs = [s.vectors for s in self.sealed] + [self.open.vectors]
        return np.concatenate(ids), np.concatenate(vecs)


class DeltaIndex:
    """Per-group delta segments + tombstones over a ``Batcher``.

    Created lazily by ``Batcher.delta_index()`` on the first write; until
    then the serving fast path carries zero streaming overhead.  Single-
    threaded like the frontends that drive it: compaction runs inline
    (``compact``), opportunistically from the async frontend's idle poll,
    or automatically once a group holds
    ``ServiceConfig.auto_compact_segments`` sealed segments.
    """

    def __init__(self, batcher):
        self.batcher = batcher
        plan = batcher.plan
        self.base_n = int(plan.n)
        # global ids continue from the plan's corpus epoch, so a service
        # resumed from a compacted plan export never reuses an id
        self._next_id = int(plan.corpus_epoch or plan.n)
        self._groups = {
            gi: _GroupDelta(plan.d) for gi in range(plan.n_groups)
        }
        self.tombstones: set[int] = set()
        # surviving base-corpus rows after purges: global ids (== row
        # indices into batcher.points), insertion order.  None = every
        # base row is live (the pre-purge fast path).
        self._base_ids: np.ndarray | None = None
        self.stats = DeltaStats()

    @property
    def n_base_live(self) -> int:
        """Live (unpurged) base-corpus rows at the front of every state."""
        return self.base_n if self._base_ids is None else len(self._base_ids)

    def base_rows(self) -> np.ndarray | None:
        """Surviving base row indices for rebuilds (None = all rows).

        Shared by every group: tombstones are global, so a purged base
        row is gone from each group's state.  ``Batcher._build_state``
        threads this into ``build_group_state`` so discard-mode cold
        rebuilds after a purge cannot resurrect dropped rows.
        """
        return self._base_ids

    # -------------------------------------------------------------- writes

    def insert(self, vector, weight_id) -> int:
        """Insert one vector under ``weight_id``; returns its global id.

        The row lands in ``plan.group_of[weight_id]``'s open memtable and
        is queryable immediately (exact scan).  Reaching
        ``delta_seal_rows`` buffered rows seals the memtable; with
        ``auto_compact_segments`` set, enough sealed segments trigger an
        inline compaction.
        """
        gi = int(self.batcher.route(weight_id)[0])
        gd = self._groups[gi]
        pid = self._next_id
        gd.open.append(pid, np.asarray(vector, np.float32))
        self._next_id += 1
        self.stats.n_inserts += 1
        if len(gd.open) >= self.batcher.cfg.delta_seal_rows:
            self.seal(gi)
        return pid

    def delete(self, point_id: int) -> None:
        """Tombstone a global id (base corpus row or streamed insert).

        Tombstoned ids are filtered from every subsequent top-k merge;
        result slots they would have held backfill from the remaining
        candidates.  Raises on ids outside the corpus ever served.
        """
        pid = int(point_id)
        if not 0 <= pid < self._next_id:
            raise ValueError(
                f"delete of unknown id {pid} (corpus ids span "
                f"[0, {self._next_id}))"
            )
        self.tombstones.add(pid)
        self.stats.n_deletes += 1

    def seal(self, gi: int) -> None:
        """Seal group ``gi``'s open memtable into a hashed segment.

        Re-hashes the rows with the group's original family seeds at the
        padded table width; no query step is touched.  A no-op on an
        empty memtable.
        """
        gi = int(gi)
        gd = self._groups[gi]
        if not len(gd.open):
            return
        ids, vecs = gd.open.drain()
        cfg = self.batcher.group_config(gi)
        g = self.batcher.plan.groups[gi]
        if g.codes is not None:
            codes = seal_segment(cfg, g, vecs)
        else:  # device-encode plans hash on the group's (leased) state
            with self.batcher.lease(gi) as state:
                codes = seal_segment(cfg, g, vecs, state=state)
        gd.sealed.append(SealedSegment(ids=ids, vectors=vecs, codes=codes))
        self.stats.n_seals += 1
        auto = self.batcher.cfg.auto_compact_segments
        if auto is not None and len(gd.sealed) >= auto:
            self._compact_group(gi)

    # ---------------------------------------------------------- compaction

    def compact(self, group: int | None = None, purge: bool = False) -> int:
        """Compact sealed segments into the main state(s); returns rows.

        ``group=None`` sweeps every group.  Open (unsealed) memtables are
        sealed first, so an explicit ``compact()`` is a full flush.

        ``purge=True`` upgrades the sweep to a tombstone purge: every
        group's state is rebuilt over its surviving corpus (pending rows
        absorbed, tombstoned rows dropped, ``n_valid`` capacity
        reclaimed) and the tombstone set is cleared.  Tombstones are
        global, so a purge is necessarily whole-service: combining it
        with a single ``group`` raises.
        """
        if purge:
            if group is not None:
                raise ValueError(
                    "purge rebuilds every group (tombstones are global); "
                    "drop the group argument"
                )
            return self._purge()
        gis = (
            [int(group)] if group is not None
            else list(range(self.batcher.plan.n_groups))
        )
        total = 0
        for gi in gis:
            self.seal(gi)
            total += self._compact_group(gi)
        return total

    def compact_sealed(self) -> int:
        """Compact only the already-sealed backlog (the background path).

        Open memtables are left to fill toward their seal threshold, and
        groups whose reserved capacity cannot take their backlog are
        skipped (they keep serving by exact scan) instead of raising —
        this is the safe form the async frontend's idle poll calls.
        """
        return sum(
            self._compact_group(gi, strict=False)
            for gi in range(self.batcher.plan.n_groups)
        )

    def _compact_group(self, gi: int, strict: bool = True) -> int:
        """One compaction transaction: splice sealed rows, bump version."""
        gd = self._groups[gi]
        if not gd.sealed:
            return 0
        cfg = self.batcher.group_config(gi)
        ids = np.concatenate([s.ids for s in gd.sealed])
        vecs = np.concatenate([s.vectors for s in gd.sealed])
        codes = np.concatenate([s.codes for s in gd.sealed])
        rows_now = self.n_base_live + len(gd.compacted_ids)
        if rows_now + len(ids) > cfg.n:
            if not strict:
                return 0
            raise ValueError(
                f"group {gi} compaction needs {rows_now + len(ids)} rows "
                f"but the state capacity is {cfg.n}; raise "
                f"ServiceConfig.delta_reserve_rows"
            )
        with self.batcher.lease(gi) as state:
            if state.n_valid != rows_now:
                raise RuntimeError(
                    f"group {gi}: state holds {state.n_valid} rows, the "
                    f"append log {rows_now}"
                )
            new_state = append_to_state(state, codes, vecs)
        # versioned: only this group's bytes
        self.batcher.replace_state(gi, new_state)
        gd.compacted_ids = np.concatenate([gd.compacted_ids, ids])
        gd.compacted_vecs.append(vecs)
        gd.compacted_codes.append(codes)
        gd.sealed.clear()
        self.stats.n_compactions += 1
        self.stats.n_rows_compacted += len(ids)
        self.batcher.plan = self.batcher.plan.bumped(len(ids))
        return len(ids)

    def _purge(self) -> int:
        """Tombstone-purging rebuild of every group; returns rows absorbed.

        Full flush first (open memtables seal, like ``compact``), then
        each group's state is rebuilt from its surviving corpus: live
        base rows (shared across groups — tombstones are global) plus the
        group's compacted and sealed rows minus tombstoned ones, with
        their already-sealed codes reused.  ``StateCache.replace``
        installs each rebuilt state at a bumped version, ``n_valid``
        shrinks by the dropped rows (capacity reclaimed for future
        compactions), query steps are untouched (capacity shapes never
        change), and the result is bit-exact with a fresh
        ``build_group_state`` over the survivors.  Ends by clearing the
        tombstone set — merges stop paying the filter — and bumping the
        plan version, with ``corpus_epoch`` advanced to cover every id
        ever minted (a tombstoned pending row is dropped rather than
        absorbed, but its id is spent, so a resumed service must not
        re-mint it).

        The sweep is transactional *and* budget-respecting: capacity and
        pinning are validated for every group up front (the same
        explicit ``delta_reserve_rows`` error ordinary compaction
        raises), and the commit itself is pure host-side bookkeeping —
        log rewrites plus versioned ``StateCache.invalidate`` of the
        rebuilt groups, no device work at all.  Each invalidated group
        cold-builds lazily on its next acquire through the normal
        ``Batcher._build_state`` path (which threads the surviving base
        rows and the rewritten logs), so rebuilds page one at a time
        under the configured device budget instead of materializing
        every state at once.  Only groups that actually drop a row
        rebuild: with no base row dropped this sweep, a group whose
        rows all survive takes the ordinary (cheaper) append-compaction
        for its sealed backlog — or is left entirely untouched, cached
        state and all; with no tombstones at all the purge degrades to
        an ordinary full ``compact``.
        """
        if not self.tombstones:
            return self.compact()
        plan = self.batcher.plan
        cache = self.batcher.state_cache
        for gi in range(plan.n_groups):
            self.seal(gi)
        tomb = np.fromiter(
            self.tombstones, np.int64, count=len(self.tombstones)
        )
        base_ids = (
            self._base_ids if self._base_ids is not None
            else np.arange(self.base_n, dtype=np.int64)
        )
        base_keep = base_ids[~np.isin(base_ids, tomb)]
        base_changed = len(base_keep) < len(base_ids)

        # phase 1: gather survivors and validate every group, before any
        # state is touched — a raise here leaves the service unchanged
        survivors = {}
        rebuild = set()
        for gi in range(plan.n_groups):
            gd = self._groups[gi]
            n_comp = len(gd.compacted_ids)
            ids = np.concatenate(
                [gd.compacted_ids] + [s.ids for s in gd.sealed]
            )
            keep = ~np.isin(ids, tomb)
            surv_vecs = surv_codes = None
            if len(ids):
                vecs = np.concatenate(
                    gd.compacted_vecs + [s.vectors for s in gd.sealed]
                )
                codes = np.concatenate(
                    gd.compacted_codes + [s.codes for s in gd.sealed]
                )
                surv_vecs, surv_codes = vecs[keep], codes[keep]
            cfg = self.batcher.group_config(gi)
            if len(base_keep) + int(keep.sum()) > cfg.n:
                raise ValueError(
                    f"group {gi} purge needs "
                    f"{len(base_keep) + int(keep.sum())} rows but the "
                    f"state capacity is {cfg.n}; raise "
                    f"ServiceConfig.delta_reserve_rows"
                )
            if base_changed or not keep.all():
                rebuild.add(gi)
                if cache.pin_count(gi):
                    raise ValueError(
                        f"cannot purge while group {gi} is pinned "
                        f"(launch in flight)"
                    )
            survivors[gi] = (ids[keep], surv_vecs, surv_codes,
                             int(keep[n_comp:].sum()), int((~keep).sum()))

        # phase 2: commit — host-side log rewrites plus versioned
        # invalidations for rebuilt groups (their next acquire cold-builds
        # from the committed logs, one at a time under the paging budget);
        # untouched groups absorb their sealed backlog through the
        # ordinary append path (no-op with nothing sealed)
        absorbed = n_purged = 0
        for gi in range(plan.n_groups):
            if gi not in rebuild:
                absorbed += self._compact_group(gi)
                continue
            gd = self._groups[gi]
            surv_ids, surv_vecs, surv_codes, n_abs, n_drop = survivors[gi]
            cache.invalidate(gi)
            absorbed += n_abs
            n_purged += (len(base_ids) - len(base_keep)) + n_drop
            gd.compacted_ids = surv_ids
            gd.compacted_vecs = [surv_vecs] if len(surv_ids) else []
            gd.compacted_codes = [surv_codes] if len(surv_ids) else []
            gd.sealed.clear()
            self.stats.n_rows_compacted += n_abs
        if base_changed or self._base_ids is not None:
            self._base_ids = base_keep
        self.tombstones.clear()
        self.stats.n_compactions += 1
        self.stats.n_purges += 1
        self.stats.n_rows_purged += n_purged
        epoch = self.batcher.plan.corpus_epoch or self.base_n
        self.batcher.plan = self.batcher.plan.bumped(self._next_id - epoch)
        return absorbed

    def compacted_rows(
        self, gi: int
    ) -> tuple[np.ndarray | None, np.ndarray | None]:
        """(vectors, sealed codes) of rows already absorbed by group ``gi``.

        The cold-rebuild feed: ``Batcher._build_state`` appends these to
        the base corpus so a discard-mode eviction can never lose
        streamed rows.  ``(None, None)`` when nothing was compacted.
        """
        gd = self._groups[int(gi)]
        if not len(gd.compacted_ids):
            return None, None
        return (
            np.concatenate(gd.compacted_vecs),
            np.concatenate(gd.compacted_codes),
        )

    # --------------------------------------------------------------- reads

    def pending_rows(self, gi: int) -> int:
        """Uncompacted (open + sealed) rows buffered for group ``gi``."""
        return self._groups[int(gi)].n_pending

    def visible_rows(self, gi: int) -> tuple[np.ndarray, np.ndarray]:
        """(global ids, vectors) of every row group ``gi`` can return.

        The exact-oracle corpus for one group: live base rows, the
        group's compacted append log, and its uncompacted (open +
        sealed) rows, with tombstoned ids filtered out — precisely the
        candidate set a launch through ``augment`` can surface.  Used
        by the shadow recall estimator; read-only.
        """
        gd = self._groups[int(gi)]
        base_ids = (np.arange(self.base_n, dtype=np.int64)
                    if self._base_ids is None else self._base_ids)
        ids = [base_ids]
        vecs = [np.asarray(self.batcher.points)[base_ids]]
        if len(gd.compacted_ids):
            ids.append(gd.compacted_ids)
            vecs.append(np.concatenate(gd.compacted_vecs))
        if gd.n_pending:
            pids, pvecs = gd.pending_rows()
            ids.append(pids)
            vecs.append(pvecs)
        all_ids = np.concatenate(ids)
        all_vecs = np.concatenate(vecs)
        if self.tombstones:
            live = ~np.isin(all_ids, np.fromiter(
                self.tombstones, np.int64, count=len(self.tombstones)))
            all_ids, all_vecs = all_ids[live], all_vecs[live]
        return all_ids, all_vecs

    def augment(self, gi, queries, weight_ids, ids, dists):
        """Fold the group's delta state into one launch's indexed hits.

        Translates state rows to global ids (appended rows through the
        group's append log; post-purge base rows through the surviving-id
        map), scans the group's pending rows exactly under each query's
        own weight, and merges under the tombstone filter.  With nothing
        pending and no tombstones the indexed results pass through
        bit-exactly.
        """
        gi = int(gi)
        gd = self._groups[gi]
        nb = self.n_base_live
        translated = ids
        if len(gd.compacted_ids) or self._base_ids is not None:
            orig = np.asarray(ids, np.int64)
            t = orig.copy()
            hi = orig >= nb
            if hi.any():
                t[hi] = gd.compacted_ids[orig[hi] - nb]
            if self._base_ids is not None:
                lo = (orig >= 0) & (orig < nb)
                if lo.any():
                    t[lo] = self._base_ids[orig[lo]]
            translated = t
        if not gd.n_pending and not self.tombstones:
            if translated is ids:
                return ids, dists
            return translated.astype(np.int32), dists
        k = self.batcher.cfg.k
        plan = self.batcher.plan
        if gd.n_pending:
            d_ids, d_vecs = gd.pending_rows()
            q_w = plan.weights[
                np.asarray(weight_ids, np.int64)
            ].astype(np.float32)
            extra_ids, extra_d = scan_topk(
                queries, q_w, d_ids, d_vecs, plan.p, k
            )
            self.stats.n_delta_scans += 1
        else:
            nq = len(np.atleast_2d(queries))
            extra_ids = np.full((nq, 0), -1, np.int64)
            extra_d = np.full((nq, 0), np.inf, np.float32)
        return merge_topk(
            translated, dists, extra_ids, extra_d, k, drop=self.tombstones
        )

    def summary(self) -> dict:
        """Flat streaming report: counters, backlog, plan lineage."""
        plan = self.batcher.plan
        return dict(
            n_inserts=self.stats.n_inserts,
            n_deletes=self.stats.n_deletes,
            n_seals=self.stats.n_seals,
            n_compactions=self.stats.n_compactions,
            n_rows_compacted=self.stats.n_rows_compacted,
            n_delta_scans=self.stats.n_delta_scans,
            n_purges=self.stats.n_purges,
            n_rows_purged=self.stats.n_rows_purged,
            n_base_live=self.n_base_live,
            n_pending=sum(g.n_pending for g in self._groups.values()),
            n_sealed_segments=sum(
                len(g.sealed) for g in self._groups.values()
            ),
            n_tombstones=len(self.tombstones),
            plan_version=plan.version,
            corpus_epoch=plan.corpus_epoch,
        )
