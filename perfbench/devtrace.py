"""Reduction of a ``torch.profiler`` Chrome trace to the window's numbers.

The window is the host range the harness opens around its timed loop
(``WINDOW``).  Device events are kernels, copies and memsets that start
inside it; they are classed by name (copies by direction) and by the
device-side ``record_function`` ranges they fall in (the engine's
``wlsh_topk`` and ``wlsh_rerank``).  Busy time is the union of the
device intervals, clipped to the window; each gap between them is
labelled by what the host was doing at its middle: the innermost range
the harness opened around a call into the program, and the innermost
operator under it.  The arithmetic follows the stage reduction of the
repository's ``chip_smoke.py`` (``_trace_stages``).
"""

from __future__ import annotations

import bisect
import collections
import json

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


class TraceView:
    """The traced window: its device events, ranges and host events."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and _cat(e) == "user_annotation"]
        if len(win) != 1:
            raise ValueError(f"trace holds {len(win)} '{WINDOW}' ranges")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             str(e.get("name", "")), _cat(e))
            for e in xs if _cat(e) in DEVICE_CATS
            and self.t0 <= float(e["ts"]) <= self.t1)
        self.gpu_ranges = [
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if _cat(e) == "gpu_user_annotation"]
        tid, pid = w.get("tid"), w.get("pid")
        self.host = [
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             str(e.get("name", "")), _cat(e))
            for e in xs if e.get("tid") == tid and e.get("pid") == pid
            and (_cat(e) in HOST_CATS or _cat(e) == "user_annotation")
            and e is not w]

    @classmethod
    def from_file(cls, path) -> "TraceView":
        with open(path) as fh:
            return cls(json.load(fh)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _intervals(self):
        return [(max(a, self.t0), min(b, self.t1)) for a, b, _, _ in
                self.device]

    def busy_s(self) -> float:
        """Seconds in which some device event ran, within the window."""
        busy, end = 0.0, self.t0
        for a, b in sorted(self._intervals()):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    def seconds(self, cats=DEVICE_CATS, names=None, ranges=None) -> float:
        """Device seconds of the events of ``cats`` whose name contains one
        of ``names`` (any name if None) and whose middle lies in a device
        range named in ``ranges`` (anywhere if None)."""
        total = 0.0
        for a, b, name, cat in self.device:
            if cat not in cats:
                continue
            if names is not None and not any(s in name for s in names):
                continue
            if ranges is not None and self._covering(
                    "gpu", (a + b) / 2) not in ranges:
                continue
            total += b - a
        return total / 1e6

    def top_ops(self, count: int = 10) -> list:
        """[[name, seconds]] of the device events that took most time."""
        by = collections.Counter()
        for a, b, name, _ in self.device:
            by[name] += (b - a) / 1e6
        return [[name, s] for name, s in by.most_common(count)]

    def _covering(self, kind: str, t: float) -> str | None:
        """Name of the latest-starting event of ``kind`` covering ``t``:
        a host "range" the harness opened, a host "op", or a "gpu" range."""
        if not hasattr(self, "_index"):
            self._index = {}
            groups = {
                "range": [(a, b, n) for a, b, n, c in self.host
                          if c == "user_annotation"],
                "op": [(a, b, n) for a, b, n, c in self.host
                       if c != "user_annotation"],
                "gpu": list(self.gpu_ranges)}
            for key, evs in groups.items():
                evs.sort()
                reach, top = [], float("-inf")
                for _, b, _ in evs:  # the latest end up to each event
                    top = max(top, b)
                    reach.append(top)
                self._index[key] = ([a for a, _, _ in evs], evs, reach)
        starts, evs, reach = self._index[kind]
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if reach[i] < t:
                break
            if evs[i][1] >= t:
                return evs[i][2]
        return None

    def _host_label(self, t: float) -> str:
        return " > ".join((self._covering("range", t) or "harness",
                           self._covering("op", t) or "python"))

    def idle_gaps(self, count: int = 10) -> list:
        """[[label, seconds]]: the device's idle time in the window summed
        by what the host was doing, largest first."""
        by = collections.Counter()
        end = self.t0
        for a, b in sorted(self._intervals()) + [(self.t1, self.t1)]:
            if a > end:
                by[self._host_label((a + end) / 2)] += (a - end) / 1e6
            end = max(end, b)
        return [[label, s] for label, s in by.most_common(count)]
