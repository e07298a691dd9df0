"""Fault-tolerance substrate: preemption handling, straggler detection,
restart supervision (a copy of the JAX package's ``distributed/fault.py``,
which is host-side Python).

On a real cluster these hook SIGTERM (maintenance events), per-host heartbeats
and the checkpoint manager; everything here is host-side and fully
exercisable on CPU (tests simulate stragglers and restarts).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque

__all__ = ["PreemptionHandler", "StragglerMonitor", "RestartSupervisor"]


class PreemptionHandler:
    """Converts SIGTERM/SIGINT into a checkpoint-and-exit flag.

    Usage:  handler = PreemptionHandler(); ... if handler.should_stop: save.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except (ValueError, OSError):  # non-main thread / platform
                pass

    def _on_signal(self, signum, frame):
        self.should_stop = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    median: float
    ratio: float


class StragglerMonitor:
    """Flags steps (or, fed per-host durations, hosts) slower than
    ``threshold`` x the rolling median.  At cluster scale the mitigation is
    (1) log + alert, (2) exclude the host at the next elastic restart;
    both are driven off this signal.
    """

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.durations: deque[float] = deque(maxlen=window)
        self.flagged: list[StragglerReport] = []
        self._step = 0
        self._t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> StragglerReport | None:
        assert self._t0 is not None, "start() not called"
        dur = time.monotonic() - self._t0
        self._t0 = None
        return self.record(dur)

    def record(self, duration: float) -> StragglerReport | None:
        self._step += 1
        report = None
        if len(self.durations) >= max(5, self.window // 5):
            med = sorted(self.durations)[len(self.durations) // 2]
            if med > 0 and duration > self.threshold * med:
                report = StragglerReport(
                    self._step, duration, med, duration / med
                )
                self.flagged.append(report)
        self.durations.append(duration)
        return report


class RestartSupervisor:
    """Run a (resumable) body with bounded automatic restarts.

    The body must accept ``resume_step`` and return normally on success;
    any exception triggers a reload-from-latest-checkpoint restart.  This
    is the single-process stand-in for the cluster-level supervisor that
    re-schedules failed workers.
    """

    def __init__(self, max_restarts: int = 3, backoff_s: float = 0.0):
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0
        self.failures: list[str] = []

    def run(self, body, resume_step_fn):
        while True:
            try:
                return body(resume_step_fn())
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                self.restarts += 1
                self.failures.append(f"{type(e).__name__}: {e}")
                if self.restarts > self.max_restarts:
                    raise
                if self.backoff_s:
                    time.sleep(self.backoff_s)
