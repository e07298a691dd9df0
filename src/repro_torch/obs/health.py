"""SLO burn-rate alerting over the metrics registry.

A :class:`HealthMonitor` is fed one ``observe()`` per driver tick.  It
keeps a bounded per-counter window of tick deltas (via
``MetricsRegistry.diff``) and evaluates :class:`AlertRule`\\ s against
it:

* ``burn_ratio`` rules implement classic **multi-window burn-rate**
  alerting: the rule fires only when the bad/total ratio exceeds the
  threshold over *both* a fast window (recent ticks — so a recovered
  incident clears promptly) and a slow window (so a momentary spike
  does not page).  Deadline-miss rate, tenant SLO-miss rate and
  prefetch-waste are ratios of two counters; a rule with no
  denominator burns against ticks (events per tick).
* ``gauge_below`` / ``gauge_above`` rules watch current state: the
  observed-recall margin dropping under zero, or the pending-queue
  depth saturating.  They fire after the condition holds for
  ``for_ticks`` consecutive observations (min over series for
  *below*, max for *above* — the worst series decides).

Alerts are edge-triggered typed :class:`Alert` events: one event when
a rule starts firing (counted in ``wlsh_alerts_fired_total``), a clear
mark when it stops (``wlsh_alerts_cleared_total``).  Events are
ring-retained and JSONL-exportable; the driver surfaces the
currently-firing set in its ``tick_summary()`` line and the launcher
exports them via ``--alerts-out``.

Stdlib-only and clock-free: windows are counted in ticks, and the
timestamps on events come from the caller's injectable clock — a
``ManualClock`` replay produces deterministic alert streams.
"""

from __future__ import annotations

import dataclasses
import json
import math
from collections import deque

__all__ = ["Alert", "AlertRule", "HealthMonitor", "default_rules"]

_KINDS = ("burn_ratio", "gauge_below", "gauge_above")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative SLO rule evaluated every tick.

    ``kind`` selects the evaluator (see the module docstring);
    ``burn_ratio`` rules read ``numerator``/``denominator`` counter
    deltas over ``fast_window``/``slow_window`` ticks, gauge rules
    compare the ``gauge``'s worst series against ``threshold`` for
    ``for_ticks`` consecutive observations.
    """

    name: str
    kind: str
    threshold: float
    numerator: str = ""
    denominator: str = ""  # "" = burn against ticks, not a counter
    fast_window: int = 12
    slow_window: int = 60
    min_events: int = 1  # denominator events needed before judging
    gauge: str = ""
    for_ticks: int = 2
    severity: str = "page"  # "page" | "warn"

    def __post_init__(self):
        """Validate the rule shape at construction."""
        if self.kind not in _KINDS:
            raise ValueError(f"alert rule {self.name!r}: kind must be "
                             f"one of {_KINDS}, got {self.kind!r}")
        if self.kind == "burn_ratio":
            if not self.numerator:
                raise ValueError(f"alert rule {self.name!r}: burn_ratio "
                                 f"needs a numerator counter")
            if not (1 <= self.fast_window <= self.slow_window):
                raise ValueError(
                    f"alert rule {self.name!r}: need 1 <= fast_window "
                    f"<= slow_window, got {self.fast_window} / "
                    f"{self.slow_window}")
            if self.min_events < 1:
                raise ValueError(f"alert rule {self.name!r}: min_events "
                                 f"must be >= 1, got {self.min_events}")
        else:
            if not self.gauge:
                raise ValueError(f"alert rule {self.name!r}: gauge "
                                 f"rules need a gauge name")
            if self.for_ticks < 1:
                raise ValueError(f"alert rule {self.name!r}: for_ticks "
                                 f"must be >= 1, got {self.for_ticks}")

    @property
    def counters(self) -> tuple[str, ...]:
        """Counter names this rule's windows must track."""
        if self.kind != "burn_ratio":
            return ()
        return tuple(n for n in (self.numerator, self.denominator) if n)


@dataclasses.dataclass(frozen=True)
class Alert:
    """One edge-triggered alert event (a rule started firing)."""

    rule: str
    kind: str
    severity: str
    t_fired: float
    tick: int
    value: float  # the violating value (slow-window ratio / gauge)
    value_fast: float  # fast-window ratio (NaN for gauge rules)
    threshold: float
    message: str

    def to_dict(self) -> dict:
        """JSON-safe dict form (the JSONL line payload)."""
        return dataclasses.asdict(self)


def _ratio(window, n: int, num: str, den: str, min_events: int):
    """Bad/total ratio over the last ``n`` ticks; None when unjudgeable."""
    ticks = list(window[num])[-n:]
    bad = sum(ticks)
    if den:
        total = sum(list(window[den])[-n:])
    else:
        total = float(len(ticks))
    if total < min_events:
        return None
    return bad / total


class HealthMonitor:
    """Tick-driven SLO evaluation: rules in, typed alert events out."""

    def __init__(self, metrics, rules, capacity: int = 256):
        """Watch ``metrics`` (a MetricsRegistry) under ``rules``.

        ``capacity`` bounds the retained alert-event ring; firing
        state and counters stay exact regardless.
        """
        self.metrics = metrics
        self.rules = tuple(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"alert rule names must be unique: {names}")
        self.tick = 0
        self._prev_snap: dict | None = None
        slow = max((r.slow_window for r in self.rules
                    if r.kind == "burn_ratio"), default=1)
        tracked = {c for r in self.rules for c in r.counters}
        self._window = {c: deque(maxlen=slow) for c in tracked}
        self._streak = {r.name: 0 for r in self.rules}
        self._firing: dict[str, Alert] = {}
        self._ring: deque[Alert] = deque(maxlen=capacity)
        self._fired_ctr = metrics.counter(
            "wlsh_alerts_fired_total", "alert rule rising edges")
        self._cleared_ctr = metrics.counter(
            "wlsh_alerts_cleared_total", "alert rule falling edges")

    # ---------------------------------------------------------- evaluation

    def observe(self, now: float) -> list[Alert]:
        """Evaluate every rule against this tick; returns new alerts.

        Call once per driver tick with the injectable clock's time.
        Counter deltas since the previous call extend the burn
        windows; gauges are read at their current value.
        """
        snap = self.metrics.snapshot()
        diff = self.metrics.diff(self._prev_snap)
        self._prev_snap = snap
        self.tick += 1
        for name, dq in self._window.items():
            dq.append(sum(diff.get(name, {}).values()))
        fired: list[Alert] = []
        for rule in self.rules:
            alert = self._eval(rule, snap, now)
            was = rule.name in self._firing
            if alert is not None and not was:
                self._firing[rule.name] = alert
                self._ring.append(alert)
                self._fired_ctr.inc(rule=rule.name)
                fired.append(alert)
            elif alert is None and was:
                del self._firing[rule.name]
                self._cleared_ctr.inc(rule=rule.name)
        return fired

    def _eval(self, rule: AlertRule, snap: dict, now: float):
        """One rule against the current windows; Alert or None."""
        if rule.kind == "burn_ratio":
            fast = _ratio(self._window, rule.fast_window, rule.numerator,
                          rule.denominator, rule.min_events)
            slow = _ratio(self._window, rule.slow_window, rule.numerator,
                          rule.denominator, rule.min_events)
            if (fast is None or slow is None
                    or fast <= rule.threshold
                    or slow <= rule.threshold):
                return None
            return Alert(
                rule=rule.name, kind=rule.kind, severity=rule.severity,
                t_fired=float(now), tick=self.tick, value=slow,
                value_fast=fast, threshold=rule.threshold,
                message=(f"{rule.numerator} burn "
                         f"{fast:.3f}/{slow:.3f} (fast/slow) "
                         f"> {rule.threshold}"),
            )
        entry = snap.get(rule.gauge)
        series = (entry or {}).get("series", {})
        if not series:
            worst = None
        elif rule.kind == "gauge_below":
            worst = min(series.values())
        else:
            worst = max(series.values())
        bad = (worst is not None
               and (worst < rule.threshold
                    if rule.kind == "gauge_below"
                    else worst > rule.threshold))
        self._streak[rule.name] = (self._streak[rule.name] + 1
                                   if bad else 0)
        if self._streak[rule.name] < rule.for_ticks:
            return None
        op = "<" if rule.kind == "gauge_below" else ">"
        return Alert(
            rule=rule.name, kind=rule.kind, severity=rule.severity,
            t_fired=float(now), tick=self.tick, value=float(worst),
            value_fast=math.nan, threshold=rule.threshold,
            message=(f"{rule.gauge} {worst:.4g} {op} {rule.threshold} "
                     f"for {self._streak[rule.name]} ticks"),
        )

    # ------------------------------------------------------------- reading

    def firing(self) -> list[Alert]:
        """Currently-firing alerts, rule order."""
        return [self._firing[r.name] for r in self.rules
                if r.name in self._firing]

    def alerts(self) -> list[Alert]:
        """Retained alert events, oldest first (bounded ring)."""
        return list(self._ring)

    def export_jsonl(self, path) -> int:
        """Write retained alert events to ``path``; returns the count."""
        events = self.alerts()
        with open(path, "w") as fh:
            for a in events:
                fh.write(json.dumps(a.to_dict()) + "\n")
        return len(events)

    def summary(self) -> dict:
        """JSON-safe totals: per-rule fired/cleared/firing state."""
        fired = self._fired_ctr.series()
        cleared = self._cleared_ctr.series()
        return {
            "tick": self.tick,
            "firing": [a.rule for a in self.firing()],
            "rules": {
                r.name: {
                    "kind": r.kind,
                    "severity": r.severity,
                    "threshold": r.threshold,
                    "fired": int(fired.get(f"rule={r.name}", 0)),
                    "cleared": int(cleared.get(f"rule={r.name}", 0)),
                    "firing": r.name in self._firing,
                }
                for r in self.rules
            },
        }


def default_rules(max_pending: int | None = None) -> tuple[AlertRule, ...]:
    """The stock WLSH SLO rule set (driver metrics naming).

    Multi-window burns on deadline-miss rate, tenant SLO-miss rate and
    prefetch-waste, plus gauge rules on the observed-recall margin and
    the pending-queue depth (the latter only when ``max_pending`` gives
    a saturation point: the rule fires at 90% of the cap).
    """
    rules = [
        AlertRule(name="deadline_miss_burn", kind="burn_ratio",
                  numerator="wlsh_driver_deadline_misses_total",
                  denominator="wlsh_driver_deadlines_due_total",
                  threshold=0.25, fast_window=12, slow_window=60,
                  min_events=4, severity="page"),
        AlertRule(name="tenant_slo_burn", kind="burn_ratio",
                  numerator="wlsh_tenant_slo_misses_total",
                  denominator="wlsh_tenant_resolved_total",
                  threshold=0.25, fast_window=12, slow_window=60,
                  min_events=4, severity="page"),
        AlertRule(name="prefetch_waste_burn", kind="burn_ratio",
                  numerator="wlsh_state_prefetch_wasted_total",
                  denominator="wlsh_state_prefetches_total",
                  threshold=0.5, fast_window=20, slow_window=100,
                  min_events=4, severity="warn"),
        AlertRule(name="recall_below_bound", kind="gauge_below",
                  gauge="wlsh_recall_bound_margin", threshold=0.0,
                  for_ticks=2, severity="page"),
    ]
    if max_pending is not None:
        rules.append(
            AlertRule(name="queue_saturation", kind="gauge_above",
                      gauge="wlsh_pending_queue_depth",
                      threshold=0.9 * max_pending, for_ticks=3,
                      severity="warn"))
    return tuple(rules)
