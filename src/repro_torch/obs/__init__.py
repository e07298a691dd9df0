"""Observability layer of the port: metrics, traces, profiling, quality
telemetry.

Building blocks threaded through the serving stack, each keeping the JAX
package's names, series and file formats:

* :mod:`repro_torch.obs.metrics`: typed counters / gauges / fixed-bucket
  histograms in a thread-safe :class:`MetricsRegistry`; Prometheus-style
  text exposition, JSON snapshot, tick-to-tick diffs.  The stats surfaces
  (``Batcher.stats``, ``CacheStats``, ``DriverStats``, ``TenantStats``)
  are thin views over one registry per stack.
* :mod:`repro_torch.obs.trace`: per-query :class:`TraceSpan` lifecycle
  (``submit -> route -> admit -> queue -> prefetch/restore -> launch ->
  merge -> resolve``) on the injectable clock, ring-buffered by
  :class:`Tracer` with JSONL export and exact drop accounting; and the
  layer spans (:func:`span`, ``LAYER_SPANS``: ``wlsh_query`` down to
  ``wlsh_pass1`` / ``wlsh_pass2``): ``torch.profiler`` ranges while a
  capture runs, and with ``obs`` the per-layer host seconds and calls
  (``wlsh_layer_seconds_total{layer}``, ``wlsh_layer_calls_total{layer}``).
* :mod:`repro_torch.obs.profile`: per-step build-count and dispatch-time
  attribution keyed by ``IndexConfig.shape_signature()``, plus
  ``torch.profiler`` captures exported as Chrome traces.
* :mod:`repro_torch.obs.recall`: online quality telemetry: a
  deterministic hash sampler feeding shadow jobs that re-rank served
  answers against the exact host oracle off the serving path
  (:class:`RecallEstimator`).
* :mod:`repro_torch.obs.health`: SLO burn-rate alerting: multi-window
  :class:`AlertRule` evaluation over registry diffs per driver tick,
  typed ring-retained :class:`Alert` events (:class:`HealthMonitor`).

Tracing and profiling are gated behind ``ServiceConfig.obs`` (off by
default, bit-exact on or off); the metrics registry always exists.  A
layer span with ``obs`` off and no capture running is one flag check.
Recall sampling (``ServiceConfig.recall_sample_rate``) implies ``obs``
and is equally invisible to answers.
"""

from .health import Alert, AlertRule, HealthMonitor, default_rules
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .profile import Profiler
from .recall import RecallEstimator, ShadowJob, sample_hash, should_sample
from .trace import LAYER_SPANS, STAGES, Tracer, TraceSpan, span

__all__ = [
    "Alert",
    "AlertRule",
    "Counter",
    "Gauge",
    "HealthMonitor",
    "Histogram",
    "LAYER_SPANS",
    "MetricsRegistry",
    "Profiler",
    "RecallEstimator",
    "STAGES",
    "ShadowJob",
    "TraceSpan",
    "Tracer",
    "default_rules",
    "sample_hash",
    "should_sample",
    "span",
]
