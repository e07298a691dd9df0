"""Observability layer of the port: the unified metrics registry.

:mod:`repro_torch.obs.metrics` holds typed counters, gauges and
fixed-bucket histograms in a thread-safe :class:`MetricsRegistry`, with
Prometheus-style text exposition, a JSON snapshot and tick-to-tick
diffs.  The stats surfaces of the serving stack (``Batcher.stats``,
``CacheStats``, ``DriverStats``, ``TenantStats``) are thin views over
one registry per stack, and every series keeps the JAX package's name.
Traces, profiling, shadow recall and health alerting are not ported yet.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]
