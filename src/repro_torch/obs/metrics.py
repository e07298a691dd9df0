"""Unified metrics registry: typed counters, gauges and histograms.

One :class:`MetricsRegistry` per serving stack is the single source of
truth for every operational counter — the legacy per-layer stats
objects (``GroupServeStats``, ``CacheStats``, ``DriverStats``,
``TenantStats``) are property views over it.  Design constraints:

* **zero dependencies** — stdlib only, importable anywhere;
* **thread-safe** — one registry ``RLock`` guards every mutation, so
  the thread-mode ``ServiceDriver`` and the submitting thread can race
  freely;
* **bounded memory** — histograms are fixed-bucket: p50/p95/p99 come
  from cumulative bucket counts with linear interpolation, no samples
  are retained;
* **exportable** — Prometheus-style text exposition (``to_text``),
  JSON-safe ``snapshot()``, and counter ``diff()`` between two
  snapshots (the driver's tick summary line).

Naming convention (pinned by docs and tests): counters are
``wlsh_<layer>_<noun>_total``, gauges ``wlsh_<layer>_<noun>``, latency
histograms ``wlsh_<noun>_seconds``; label keys are lowercase
identifiers (``group``, ``tenant``, ``cause``, ``sig``).
"""

from __future__ import annotations

import json
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS"]

# Prometheus-ish latency ladder (seconds): 100 us .. 10 s, geometric-ish.
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


def _labelkey(labels: dict) -> str:
    """Canonical series key: ``"k=v,k2=v2"`` sorted by key, ``""`` bare."""
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


def _fmt(v: float) -> str:
    """Exposition-format a value: integral floats print as ints."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _escape_label(value: str) -> str:
    """Escape a label value per the Prometheus exposition spec.

    Inside a quoted label value, backslash, double-quote and newline
    must be written as ``\\\\``, ``\\"`` and ``\\n`` respectively —
    everything else passes through verbatim.
    """
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labpair(kv: str) -> str:
    """Render one ``k=v`` label-key fragment as ``k="escaped-v"``."""
    k, v = kv.split("=", 1)
    return f'{k}="{_escape_label(v)}"'


class Counter:
    """Monotone counter with optional labels (one series per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        """Create the counter; use ``MetricsRegistry.counter`` instead."""
        self.name = name
        self.help = help
        self._lock = lock
        self._series: dict[str, float] = {}

    def inc(self, amount: float = 1, **labels) -> None:
        """Add ``amount`` (>= 0) to the series selected by ``labels``."""
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        key = _labelkey(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        """Current value of one labeled series (0 if never incremented)."""
        with self._lock:
            return self._series.get(_labelkey(labels), 0)

    def total(self) -> float:
        """Sum over every labeled series."""
        with self._lock:
            return sum(self._series.values())

    def series(self) -> dict[str, float]:
        """Snapshot of ``{label_key: value}`` for every series."""
        with self._lock:
            return dict(self._series)

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()


class Gauge(Counter):
    """Point-in-time value; supports ``set`` and signed ``add``.

    Gauges survive ``MetricsRegistry.reset`` — they describe current
    state (e.g. resident bytes), not accumulated work.
    """

    kind = "gauge"

    def inc(self, amount: float = 1, **labels) -> None:
        """Add ``amount`` (may be negative) to the labeled series."""
        key = _labelkey(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    add = inc

    def set(self, value: float, **labels) -> None:
        """Overwrite the labeled series with ``value``."""
        with self._lock:
            self._series[_labelkey(labels)] = value

    def _reset(self) -> None:  # state, not work: keep across resets
        pass


class Histogram:
    """Fixed-bucket histogram: percentiles without retaining samples.

    Observations land in cumulative-count buckets bounded by
    ``buckets`` (upper bounds, ascending; an implicit +Inf bucket
    catches the tail).  ``percentile`` interpolates linearly inside the
    selected bucket, clamped to the observed min/max, so p50/p95/p99
    are exact to within one bucket's width at O(len(buckets)) memory.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS):
        """Create the histogram; use ``MetricsRegistry.histogram``."""
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(f"histogram {name} buckets must be a "
                             f"strictly ascending non-empty sequence")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = lock
        self._series: dict[str, dict] = {}

    def _cell(self, key: str) -> dict:
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0,
                "min": math.inf, "max": -math.inf,
            }
        return cell

    def observe(self, value: float, **labels) -> None:
        """Record one observation into the labeled series."""
        v = float(value)
        with self._lock:
            cell = self._cell(_labelkey(labels))
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            cell["counts"][i] += 1
            cell["sum"] += v
            cell["count"] += 1
            cell["min"] = min(cell["min"], v)
            cell["max"] = max(cell["max"], v)

    def count(self, **labels) -> int:
        """Number of observations in the labeled series."""
        with self._lock:
            cell = self._series.get(_labelkey(labels))
            return cell["count"] if cell else 0

    def sum(self, **labels) -> float:
        """Sum of observations in the labeled series."""
        with self._lock:
            cell = self._series.get(_labelkey(labels))
            return cell["sum"] if cell else 0.0

    def percentile(self, q: float, **labels) -> float:
        """The q-th percentile (q in [0, 100]) of the labeled series.

        Linear interpolation inside the bucket that crosses the target
        rank, clamped to the observed min/max (so the +Inf tail bucket
        and the first bucket stay finite and tight).  NaN when empty.
        """
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            cell = self._series.get(_labelkey(labels))
            if cell is None or cell["count"] == 0:
                return math.nan
            rank = q / 100.0 * cell["count"]
            cum = 0
            for i, c in enumerate(cell["counts"]):
                if c and cum + c >= rank:
                    lo = self.buckets[i - 1] if i else cell["min"]
                    hi = (self.buckets[i] if i < len(self.buckets)
                          else cell["max"])
                    lo = max(lo, cell["min"])
                    hi = min(hi, cell["max"])
                    frac = max(0.0, (rank - cum)) / c
                    return lo + frac * max(0.0, hi - lo)
                cum += c
            return cell["max"]

    def series(self) -> dict[str, dict]:
        """Snapshot ``{label_key: {counts, sum, count, min, max}}``."""
        with self._lock:
            return {k: dict(v, counts=list(v["counts"]))
                    for k, v in self._series.items()}

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()


class MetricsRegistry:
    """Get-or-create registry of named metrics; the one source of truth.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the name is already registered (raising on a type mismatch), so
    call sites never coordinate creation.  One ``RLock`` guards every
    metric, making the registry safe under the thread-mode driver.
    """

    def __init__(self):
        """Create an empty registry."""
        self._lock = threading.RLock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind: type, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, lock=self._lock,
                                               **kwargs)
            elif not type(m) is kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {kind.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        """Get or create the named counter."""
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get or create the named gauge."""
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        """Get or create the named fixed-bucket histogram."""
        return self._get(name, Histogram, help=help, buckets=buckets)

    def metrics(self) -> dict[str, Counter | Gauge | Histogram]:
        """Snapshot of the registered metrics by name."""
        with self._lock:
            return dict(self._metrics)

    def reset(self, prefix: str = "") -> None:
        """Zero counters/histograms whose name starts with ``prefix``.

        Gauges are left untouched: they describe current state (e.g.
        resident bytes), which a stats reset must not fabricate.
        """
        with self._lock:
            for name, m in self._metrics.items():
                if name.startswith(prefix):
                    m._reset()

    def merge_from(self, other: MetricsRegistry) -> None:
        """Fold ``other``'s metrics into this registry (additive).

        Used when a standalone layer (e.g. a ``QosScheduler`` built
        before its service) re-binds onto the serving stack's registry:
        counter/gauge series add; histogram cells merge bucket-wise.
        """
        for name, m in other.metrics().items():
            if isinstance(m, Histogram):
                mine = self.histogram(name, m.help, m.buckets)
                with self._lock:
                    for key, cell in m.series().items():
                        tgt = mine._cell(key)
                        tgt["counts"] = [a + b for a, b in
                                         zip(tgt["counts"], cell["counts"])]
                        tgt["sum"] += cell["sum"]
                        tgt["count"] += cell["count"]
                        tgt["min"] = min(tgt["min"], cell["min"])
                        tgt["max"] = max(tgt["max"], cell["max"])
            else:
                mine = (self.gauge if isinstance(m, Gauge)
                        else self.counter)(name, m.help)
                for key, v in m.series().items():
                    labels = dict(kv.split("=", 1)
                                  for kv in key.split(",") if kv)
                    mine.inc(v, **labels)

    def snapshot(self) -> dict:
        """JSON-safe snapshot of every metric (series, buckets, help)."""
        out: dict = {}
        for name, m in sorted(self.metrics().items()):
            if isinstance(m, Histogram):
                series = {
                    k: {"count": c["count"], "sum": c["sum"],
                        "min": (None if c["count"] == 0 else c["min"]),
                        "max": (None if c["count"] == 0 else c["max"]),
                        "counts": list(c["counts"])}
                    for k, c in m.series().items()
                }
                out[name] = {"type": m.kind, "help": m.help,
                             "buckets": list(m.buckets), "series": series}
            else:
                out[name] = {"type": m.kind, "help": m.help,
                             "series": m.series()}
        return out

    def diff(self, prev: dict | None) -> dict:
        """Counter deltas since a previous ``snapshot()``.

        Returns ``{name: {label_key: delta}}`` with zero-delta series
        dropped — the driver's tick summary line is built from this.
        """
        prev = prev or {}
        out: dict = {}
        for name, entry in self.snapshot().items():
            if entry["type"] != "counter":
                continue
            before = prev.get(name, {}).get("series", {})
            deltas = {k: v - before.get(k, 0)
                      for k, v in entry["series"].items()
                      if v != before.get(k, 0)}
            if deltas:
                out[name] = deltas
        return out

    def to_text(self) -> str:
        """Prometheus-style text exposition of every metric."""
        lines: list[str] = []
        for name, m in sorted(self.metrics().items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, cell in sorted(m.series().items()):
                    base = [kv for kv in key.split(",") if kv]
                    cum = 0
                    for ub, c in zip(
                            list(m.buckets) + [math.inf], cell["counts"]):
                        cum += c
                        le = "+Inf" if ub == math.inf else _fmt(ub)
                        lab = ",".join(
                            [_labpair(kv) for kv in base] + [f'le="{le}"'])
                        lines.append(f"{name}_bucket{{{lab}}} {cum}")
                    suffix = ("{" + ",".join(
                        _labpair(kv) for kv in base) + "}") if base else ""
                    lines.append(f"{name}_sum{suffix} "
                                 f"{_fmt(cell['sum'])}")
                    lines.append(f"{name}_count{suffix} {cell['count']}")
            else:
                for key, v in sorted(m.series().items()):
                    lab = ""
                    if key:
                        lab = "{" + ",".join(
                            _labpair(kv) for kv in key.split(",")) + "}"
                    lines.append(f"{name}{lab} {_fmt(v)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> str:
        """The ``snapshot()`` dict serialized as JSON text."""
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)
