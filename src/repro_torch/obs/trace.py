"""Per-query trace spans: where did this query's milliseconds go?

One :class:`TraceSpan` per submitted query walks the canonical stage
lifecycle::

    submit -> route -> admit -> queue -> prefetch/restore -> launch
           -> merge -> resolve

Every timestamp comes from the serving stack's injectable clock, so a
``ManualClock`` replay produces deterministic traces.  Spans also carry
the WLSH-native cost counters the paper's query-efficiency accounting
is built on: ``n_checked`` (candidates verified), ``stop_level``
(histogram levels scanned), the candidate ``budget`` and whether the
histogram pass stopped on it (``budget_capped``), the degradation
``rung`` at launch, and the shard count.

The :class:`Tracer` retains finished spans in a fixed-capacity ring
(old spans fall off; ``n_started``/``n_finished`` keep exact totals and
``n_dropped`` counts ring evictions explicitly, mirrored into the
registry as ``wlsh_trace_dropped_total`` when a registry is bound) and
exports them as JSONL — a ``_meta`` header line with the exact totals,
then one span per line.

Layer spans are the other half: :func:`span` names one layer boundary of
the serving path (``LAYER_SPANS``: the request, routing, one launch, the
lease and its offload / restore / build, the encode, the uploads, the
step and its passes, the downloads, the merge, the release, a driver
tick).  Under a running ``torch.profiler`` a span is a
``record_function`` range, so it lands in the Chrome trace on the
calling thread, on the same clock as the kernels and copies it waits
for.  Bound to a metrics registry (``ServiceConfig.obs``), it also adds
its host seconds and one call to ``wlsh_layer_seconds_total{layer}`` and
``wlsh_layer_calls_total{layer}``, for the spans it encloses too.
Neither running, a span is one flag check and a shared null context.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import math
import threading
import time
from collections import deque

import torch

__all__ = ["LAYER_SPANS", "STAGES", "TraceSpan", "Tracer", "span"]

# Canonical stage order; "prefetch" and "restore" are alternatives on
# the same slot (a launch either consumed a prefetched state, faulted
# one in, or hit — a hit marks neither).
STAGES: tuple[str, ...] = (
    "submit", "route", "admit", "queue", "prefetch", "restore",
    "launch", "merge", "resolve",
)

_ATTRS = ("query_id", "tenant", "weight_id", "group_id", "rung",
          "n_shards", "cause", "stop_level", "n_checked", "budget",
          "budget_capped", "recall")


class TraceSpan:
    """One query's stage timestamps plus its WLSH cost counters."""

    __slots__ = _ATTRS + ("stages",)

    def __init__(self, query_id: int, weight_id: int = -1,
                 group_id: int = -1, tenant: str | None = None):
        """Open a span; stages are stamped later with :meth:`mark`."""
        self.query_id = query_id
        self.weight_id = weight_id
        self.group_id = group_id
        self.tenant = tenant
        self.rung = 0
        self.n_shards = 1
        self.cause = None        # launch cause: full | deadline | drain
        self.stop_level = -1     # histogram levels scanned at stop
        self.n_checked = -1      # candidates verified (cost model)
        self.budget = -1         # candidate budget k + ceil(gamma*n)
        self.budget_capped = False  # histogram pass stopped on budget?
        self.recall = -1.0       # shadow-exact recall; -1 = not sampled
        self.stages: dict[str, float] = {}

    def mark(self, stage: str, t: float) -> None:
        """Stamp ``stage`` at clock time ``t`` (re-marking overwrites)."""
        if stage not in STAGES:
            raise ValueError(f"unknown trace stage {stage!r} "
                             f"(expected one of {STAGES})")
        self.stages[stage] = float(t)

    @property
    def monotone(self) -> bool:
        """True when the stamped stages are non-decreasing in order."""
        last = -math.inf
        for stage in STAGES:
            if stage in self.stages:
                if self.stages[stage] < last:
                    return False
                last = self.stages[stage]
        return True

    @property
    def duration_s(self) -> float:
        """submit -> resolve wall (clock) time; NaN while incomplete."""
        try:
            return self.stages["resolve"] - self.stages["submit"]
        except KeyError:
            return math.nan

    def to_dict(self) -> dict:
        """JSON-safe dict form (the JSONL line payload)."""
        out = {a: getattr(self, a) for a in _ATTRS}
        out["stages"] = dict(self.stages)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> TraceSpan:
        """Rebuild a span from :meth:`to_dict` output (JSONL import)."""
        span = cls(d["query_id"], d.get("weight_id", -1),
                   d.get("group_id", -1), d.get("tenant"))
        for a in _ATTRS[4:]:
            if a in d:
                setattr(span, a, d[a])
        for stage, t in d.get("stages", {}).items():
            span.mark(stage, t)
        return span


class Tracer:
    """Ring-buffered span store: begin/finish, retention, JSONL export."""

    def __init__(self, capacity: int = 4096, metrics=None):
        """Retain at most ``capacity`` finished spans (oldest dropped).

        When a :class:`~repro_torch.obs.metrics.MetricsRegistry` is passed as
        ``metrics``, every ring eviction also increments the
        ``wlsh_trace_dropped_total`` counter there, so overflow is
        visible on the same surface as every other serving metric.
        """
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        self._ring: deque[TraceSpan] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._next_id = 0
        self.n_started = 0
        self.n_finished = 0
        self.n_dropped = 0
        self._dropped_ctr = (
            metrics.counter("wlsh_trace_dropped_total",
                            "finished spans evicted from the trace ring")
            if metrics is not None else None)

    def begin(self, weight_id: int = -1, group_id: int = -1,
              tenant: str | None = None) -> TraceSpan:
        """Open a new span with the next query id."""
        with self._lock:
            qid = self._next_id
            self._next_id += 1
            self.n_started += 1
        return TraceSpan(qid, weight_id, group_id, tenant)

    def finish(self, span: TraceSpan) -> None:
        """Retire a span into the retention ring.

        When the ring is full the oldest retained span is evicted and
        counted in ``n_dropped`` (and ``wlsh_trace_dropped_total`` when
        a registry is bound) — overflow is never silent.  The exact
        ledger ``n_started == len(spans()) + n_dropped + n_inflight``
        holds at all times.
        """
        with self._lock:
            if len(self._ring) == self.capacity:
                self.n_dropped += 1
                if self._dropped_ctr is not None:
                    self._dropped_ctr.inc()
            self._ring.append(span)
            self.n_finished += 1

    @property
    def n_inflight(self) -> int:
        """Spans begun but not yet finished."""
        with self._lock:
            return self.n_started - self.n_finished

    def spans(self) -> list[TraceSpan]:
        """Snapshot of the retained spans, oldest first."""
        with self._lock:
            return list(self._ring)

    def export_jsonl(self, path) -> int:
        """Write retained spans to ``path`` as JSONL; returns the count.

        The first line is a ``_meta`` header carrying the exact totals
        (``n_started``/``n_finished``/``n_dropped``/``n_inflight`` and
        the ring capacity), so an export taken after overflow still
        states how many spans it is missing.  ``load_jsonl`` skips it.
        """
        spans = self.spans()
        with self._lock:
            meta = {"n_started": self.n_started,
                    "n_finished": self.n_finished,
                    "n_dropped": self.n_dropped,
                    "n_inflight": self.n_started - self.n_finished,
                    "n_retained": len(spans),
                    "capacity": self.capacity}
        with open(path, "w") as fh:
            fh.write(json.dumps({"_meta": meta}) + "\n")
            for span in spans:
                fh.write(json.dumps(span.to_dict()) + "\n")
        return len(spans)

    @staticmethod
    def load_jsonl(path) -> list[TraceSpan]:
        """Read spans back from a JSONL export (round-trip tests, CLI).

        The ``_meta`` header line (when present) is skipped; use
        :meth:`load_jsonl_meta` to read it.
        """
        out = []
        with open(path) as fh:
            for line in fh:
                if not line.strip():
                    continue
                d = json.loads(line)
                if "_meta" in d:
                    continue
                out.append(TraceSpan.from_dict(d))
        return out

    @staticmethod
    def load_jsonl_meta(path) -> dict | None:
        """The ``_meta`` header of a JSONL export (None on old exports)."""
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    d = json.loads(line)
                    return d.get("_meta")
        return None


# The serving path's layer spans, outermost first.  ``wlsh_lease`` holds
# ``wlsh_offload`` / ``wlsh_restore`` / ``wlsh_build`` (as ``wlsh_release``
# may hold ``wlsh_offload``); ``wlsh_step`` holds ``wlsh_pass1``,
# ``wlsh_stop`` and ``wlsh_pass2``, which holds ``wlsh_topk`` and
# ``wlsh_rerank`` (the ranges ``topk_rerank_ms`` reads).  ``wlsh_lease``,
# ``wlsh_encode``, ``wlsh_upload``, ``wlsh_step``, ``wlsh_download`` and
# ``wlsh_release`` are siblings inside ``wlsh_batch``.
LAYER_SPANS: tuple[str, ...] = (
    "wlsh_tick", "wlsh_query", "wlsh_route", "wlsh_batch", "wlsh_lease",
    "wlsh_offload", "wlsh_restore", "wlsh_build", "wlsh_encode",
    "wlsh_upload", "wlsh_step", "wlsh_pass1", "wlsh_stop", "wlsh_pass2",
    "wlsh_topk", "wlsh_rerank", "wlsh_download", "wlsh_merge",
    "wlsh_release",
)

_NULL_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
# the registry of the innermost span bound to one, for the spans it holds
_bound = contextvars.ContextVar("wlsh_layer_metrics", default=None)


class _LayerSpan:
    """A layer span that is traced, counted, or both."""

    __slots__ = ("name", "metrics", "_range", "_token", "_t0")

    def __init__(self, name: str, metrics):
        self.name = name
        self.metrics = metrics
        self._range = None
        self._token = None

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.metrics is not None:
            self._token = _bound.set(self.metrics)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.metrics is not None:
            dt = time.perf_counter() - self._t0
            _bound.reset(self._token)
            m = self.metrics
            m.counter("wlsh_layer_seconds_total",
                      "host seconds inside each layer span").inc(
                dt, layer=self.name)
            m.counter("wlsh_layer_calls_total",
                      "layer spans entered").inc(layer=self.name)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, metrics=None):
    """Context manager naming one layer boundary (``LAYER_SPANS``).

    ``metrics`` is the service's registry when ``ServiceConfig.obs`` is
    on; spans opened inside inherit it.  A ``record_function`` range is
    entered only while a ``torch.profiler`` runs; with neither, the shared
    null context comes back and nothing else is done.
    """
    if metrics is None:
        metrics = _bound.get()
        if metrics is None and not _profiling():
            return _NULL_SPAN
    return _LayerSpan(name, metrics)
