"""Online recall telemetry: sampled shadow-exact re-ranking.

WLSH's contract is a *provable* recall/efficiency trade-off per
weighted l_p query, but latency and cost counters alone cannot say
whether delivered recall still meets the guarantee once degradation,
compaction, sharding and paging interact.  The
:class:`RecallEstimator` closes that loop:

* a **deterministic sampler** — :func:`should_sample` hashes the
  span's query id (splitmix64 finalizer, no wall randomness), so the
  same traffic yields the same sampled set across the sync, async and
  driver-stepped frontends and across reruns;
* a **shadow queue** — sampled queries are enqueued as
  :class:`ShadowJob`\\ s (host copies of the query, its weight and the
  served ids) at answer time; enqueueing is the only serving-path
  work, so sampling is bit-invisible to results;
* **off-path execution** — ``run()`` pops jobs and re-ranks each
  against the exact host oracle (``scan_topk`` over the group's full
  visible corpus: live base rows + compacted + pending, tombstones
  filtered).  The async frontend drains a small slice per
  ``idle_work()`` tick, so shadow work never competes with deadline
  launches;
* **registry results** — per-(tenant, rung, p, group) counters
  (``wlsh_recall_hits_total`` / ``wlsh_recall_relevant_total`` /
  ``wlsh_recall_samples_total``), the micro-averaged
  ``wlsh_recall_observed`` gauge, the ``wlsh_recall_bound_margin``
  gauge (observed − the rung's planned ``recall_bound``), and a
  per-sample recall histogram.  Each job also stamps its recall onto
  the originating ``TraceSpan``.

The estimate is **exactly** reproducible offline: recall is
micro-averaged (``sum(matched) / sum(relevant)`` over integer counts),
and the oracle is the same ``scan_topk`` float32 scan an offline
checker would run — so ``estimate()`` equals the offline oracle
computation on the same sampled set bit-for-bit.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

__all__ = ["RecallEstimator", "ShadowJob", "sample_hash", "should_sample"]

_MASK64 = (1 << 64) - 1

# per-sample recall distribution buckets (recall lives in [0, 1])
RECALL_BUCKETS: tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0,
)


def sample_hash(query_id: int) -> int:
    """Deterministic 64-bit mix of a query id (splitmix64 finalizer).

    A pure function of the id: no seed, no clock, no process state —
    the sampling decision for query ``i`` is identical across
    frontends, replays and machines.
    """
    x = (int(query_id) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)

def should_sample(query_id: int, rate: float) -> bool:
    """True when ``query_id`` falls in the sampled fraction ``rate``.

    Threshold test on :func:`sample_hash`, so the sampled set is
    monotone in ``rate``: every id sampled at rate r is also sampled
    at every r' >= r (useful when comparing sampling configurations).
    """
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return sample_hash(query_id) < int(rate * 2.0 ** 64)


class ShadowJob:
    """One sampled query queued for exact-oracle re-ranking."""

    __slots__ = ("query_id", "tenant", "rung", "group_id", "weight_id",
                 "query", "served_ids", "span")

    def __init__(self, span, query, weight_id, group_id, rung,
                 served_ids):
        """Capture host copies of everything the oracle pass needs."""
        self.span = span
        self.query_id = int(span.query_id)
        self.tenant = span.tenant
        self.rung = int(rung)
        self.group_id = int(group_id)
        self.weight_id = int(weight_id)
        self.query = np.array(query, np.float32, copy=True)
        self.served_ids = np.array(served_ids, np.int64, copy=True)


class RecallEstimator:
    """Sampled shadow-exact recall estimation over a ``Batcher``.

    Construction reads the batcher's ``ServiceConfig`` knobs
    (``recall_sample_rate`` / ``recall_shadow_max`` /
    ``recall_shadow_slice``) and registers its metrics on the
    batcher's registry.  ``offer`` runs on the serving path (enqueue
    only); ``run``/``drain`` execute the oracle passes off-path.
    Thread-safe like the registry: one lock guards the queue, so the
    thread-mode driver can drain while the submit thread offers.
    """

    def __init__(self, batcher):
        """Attach to ``batcher``; see the class docstring."""
        self.batcher = batcher
        cfg = batcher.cfg
        self.rate = float(cfg.recall_sample_rate)
        self.shadow_max = int(cfg.recall_shadow_max)
        self.slice = int(cfg.recall_shadow_slice)
        self._queue: deque[ShadowJob] = deque()
        self._lock = threading.Lock()
        # executed sampled query ids, bounded (determinism tests and
        # the --health report; not needed for the estimate itself)
        self._executed_ids: deque[int] = deque(maxlen=65536)
        m = batcher.metrics
        self._samples = m.counter(
            "wlsh_recall_samples_total",
            "shadow jobs executed (oracle re-ranks)")
        self._hits = m.counter(
            "wlsh_recall_hits_total",
            "served ids found in the exact oracle top-k")
        self._relevant = m.counter(
            "wlsh_recall_relevant_total",
            "exact oracle top-k slots (micro-average denominator)")
        self._offered = m.counter(
            "wlsh_recall_offers_total",
            "served queries that hashed into the sample")
        self._dropped = m.counter(
            "wlsh_recall_shadow_dropped_total",
            "sampled queries dropped on a full shadow queue")
        self._observed = m.gauge(
            "wlsh_recall_observed",
            "micro-averaged shadow-exact recall per series")
        self._margin = m.gauge(
            "wlsh_recall_bound_margin",
            "observed recall minus the rung's planned recall bound")
        self._depth = m.gauge(
            "wlsh_recall_shadow_depth", "shadow jobs queued")
        self._hist = m.histogram(
            "wlsh_recall_sample",
            "per-sample shadow-exact recall distribution",
            buckets=RECALL_BUCKETS)

    # ------------------------------------------------------- serving path

    def offer(self, span, query, weight_id, group_id, rung,
              served_ids) -> bool:
        """Sample-test one served query; enqueue a shadow job if it hits.

        Called by ``Batcher.run_batch`` per real row.  Never touches
        the answer arrays; a full queue drops the job (counted) rather
        than growing unbounded.  Returns True when enqueued.
        """
        if not should_sample(span.query_id, self.rate):
            return False
        labels = self._labels(span.tenant, rung, group_id)
        self._offered.inc(**labels)
        job = ShadowJob(span, query, weight_id, group_id, rung,
                        served_ids)
        with self._lock:
            if len(self._queue) >= self.shadow_max:
                self._dropped.inc(**labels)
                return False
            self._queue.append(job)
            self._depth.set(len(self._queue))
        return True

    @property
    def backlog(self) -> int:
        """Shadow jobs queued and not yet executed."""
        with self._lock:
            return len(self._queue)

    # ----------------------------------------------------------- off path

    def run(self, max_jobs: int | None = None) -> int:
        """Execute up to ``max_jobs`` queued shadow jobs (None = all).

        Host-only work (numpy scan over the group's visible corpus):
        safe to call from an idle tick without perturbing any launch.
        Returns the number of jobs executed.
        """
        done = 0
        while max_jobs is None or done < max_jobs:
            with self._lock:
                if not self._queue:
                    break
                job = self._queue.popleft()
                self._depth.set(len(self._queue))
            self._execute(job)
            done += 1
        return done

    def drain(self) -> int:
        """Execute every queued shadow job; returns the count."""
        return self.run(None)

    def _labels(self, tenant, rung, group_id) -> dict:
        """Canonical label set for one series."""
        return {"tenant": tenant or "default", "rung": str(int(rung)),
                "p": str(float(self.batcher.plan.p)),
                "group": str(int(group_id))}

    def oracle_topk(self, query, weight_id: int,
                    group_id: int) -> np.ndarray:
        """Exact host-oracle top-k ids for one query against one group.

        ``scan_topk`` (the engine's own exact-scan epilogue: float32
        coordinate-difference distances, stable composite-key
        selection) over the group's full visible corpus.  Without a
        delta index that corpus is the base plan; with one it is
        ``DeltaIndex.visible_rows`` (live base + compacted + pending,
        tombstones filtered).
        """
        # deferred: keep `import repro_torch.obs` free of the index
        # package until an oracle pass actually runs
        from ..index.streaming import scan_topk

        b = self.batcher
        delta = b.delta
        if delta is None:
            ids = np.arange(int(b.plan.n), dtype=np.int64)
            vecs = np.asarray(b.points)
        else:
            ids, vecs = delta.visible_rows(group_id)
        q_w = np.asarray(b.plan.weights)[int(weight_id)]
        oids, _ = scan_topk(
            np.asarray(query, np.float32)[None],
            np.asarray(q_w, np.float32)[None],
            ids, vecs, float(b.plan.p), int(b.cfg.k),
        )
        return oids[0]

    def _execute(self, job: ShadowJob) -> None:
        """Run one oracle pass and publish its recall."""
        exact = self.oracle_topk(job.query, job.weight_id, job.group_id)
        exact_set = {int(i) for i in exact if i >= 0}
        served_set = {int(i) for i in job.served_ids if i >= 0}
        relevant = len(exact_set)
        matched = len(served_set & exact_set)
        r = (matched / relevant) if relevant else 1.0
        labels = self._labels(job.tenant, job.rung, job.group_id)
        self._samples.inc(**labels)
        self._hits.inc(matched, **labels)
        self._relevant.inc(relevant, **labels)
        self._hist.observe(r, **labels)
        hits = self._hits.value(**labels)
        rel = self._relevant.value(**labels)
        observed = (hits / rel) if rel else 1.0
        self._observed.set(observed, **labels)
        self._margin.set(
            observed - self.batcher.recall_bound_of(job.rung), **labels)
        if job.span is not None:
            job.span.recall = r
        with self._lock:
            self._executed_ids.append(job.query_id)

    # ------------------------------------------------------------ reading

    def executed_ids(self) -> list[int]:
        """Query ids of executed shadow jobs, execution order (bounded)."""
        with self._lock:
            return list(self._executed_ids)

    def estimate(self, **match) -> float:
        """Micro-averaged observed recall over matching series.

        ``match`` filters by label (e.g. ``rung="1"``,
        ``tenant="gold"``); no filter aggregates everything.  Returns
        ``sum(hits) / sum(relevant)`` — two exact integer counts, so
        the value reproduces bit-for-bit offline — or NaN with no
        samples.
        """
        want = {k: str(v) for k, v in match.items()}

        def _fold(counter) -> float:
            tot = 0.0
            for key, v in counter.series().items():
                labels = dict(kv.split("=", 1)
                              for kv in key.split(",") if kv)
                if all(labels.get(k) == s for k, s in want.items()):
                    tot += v
            return tot

        rel = _fold(self._relevant)
        return (_fold(self._hits) / rel) if rel else float("nan")

    def summary(self) -> dict:
        """One JSON-safe dict: rates, backlog, per-rung estimates."""
        rungs = sorted({
            key.split("rung=", 1)[1].split(",", 1)[0]
            for key in self._relevant.series()
            if "rung=" in key
        })
        return {
            "sample_rate": self.rate,
            "backlog": self.backlog,
            "n_sampled": int(self._offered.total()),
            "n_executed": int(self._samples.total()),
            "n_dropped": int(self._dropped.total()),
            "observed": {
                r: self.estimate(rung=r) for r in rungs
            },
            "bound": {
                r: self.batcher.recall_bound_of(int(r)) for r in rungs
            },
        }
