"""Profiling hooks: ``torch.profiler`` capture + per-shape attribution.

The serving stack's query steps are keyed by
``IndexConfig.shape_signature()``: one step per signature, one signature
per (shape bucket, rung, kernel path).  The :class:`Profiler` attributes
the two costs that matter to that key:

* **step count**: how many distinct query steps the step cache built
  (step-cache churn and rung switches become directly visible);
* **dispatch time**: host wall seconds inside a step's launch, the
  downloads of its outputs included, so on the card it covers the
  device work of the launch, per signature.

Both are host-side bookkeeping and never touch device values, so
enabling them is bit-exact.  A captured trace names each launch by the
serving path's own layer spans (``obs.trace.span``: ``wlsh_batch``,
``wlsh_upload``, ``wlsh_step``, ...); ``start_trace`` / ``stop_trace``
bracket an on-demand
``torch.profiler`` capture (CPU and CUDA activity on the card, CPU only
on a CPU service) exported as a Chrome trace into ``profile_dir``, and
``save_memory_snapshot`` writes the CUDA caching allocator's snapshot
(``torch.cuda.memory._dump_snapshot``).  A capture on the card also
records the allocator's history (``_record_memory_history``), which a
snapshot taken during it carries.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

__all__ = ["Profiler"]

_MEMORY_HISTORY_ENTRIES = 100_000


class Profiler:
    """Per-``shape_signature`` compile/dispatch attribution + capture."""

    def __init__(self, profile_dir: str | None = None,
                 timer=time.perf_counter, device="cpu"):
        """Attribute compiles/dispatches; ``profile_dir`` enables capture.

        ``timer`` is injectable for deterministic tests; dispatch times
        are wall-clock by nature (they measure real device work).
        ``device`` is the serving device: a capture records CUDA activity
        only for a service on the card.
        """
        self.profile_dir = profile_dir
        self.device = torch.device(device)
        self._timer = timer
        self._lock = threading.Lock()
        self._compiles: dict[str, int] = {}
        self._dispatch_s: dict[str, float] = {}
        self._dispatch_n: dict[str, int] = {}
        self._prof = None  # the running torch.profiler.profile
        self.trace_paths: list[str] = []  # exported Chrome traces

    def record_compile(self, sig: str) -> None:
        """Count one step build under signature ``sig``."""
        with self._lock:
            self._compiles[sig] = self._compiles.get(sig, 0) + 1

    @contextlib.contextmanager
    def dispatch(self, sig: str):
        """Time one step launch under signature ``sig``."""
        t0 = self._timer()
        try:
            yield
        finally:
            dt = self._timer() - t0
            with self._lock:
                self._dispatch_s[sig] = self._dispatch_s.get(sig, 0.0) + dt
                self._dispatch_n[sig] = self._dispatch_n.get(sig, 0) + 1

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def start_trace(self) -> bool:
        """Start a ``torch.profiler`` capture into ``profile_dir``.

        False without a ``profile_dir`` or while a capture runs; an error
        of the profiler itself propagates.
        """
        if self.profile_dir is None or self._prof is not None:
            return False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.memory._record_memory_history(
                stacks="python", max_entries=_MEMORY_HISTORY_ENTRIES)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._prof = prof
        return True

    def stop_trace(self) -> bool:
        """Stop the running capture and export it as a Chrome trace
        (``profile_dir/wlsh_trace_<pid>_<n>.json``, appended to
        ``trace_paths``).  False when no capture runs."""
        prof = self._prof
        if prof is None:
            return False
        self._prof = None
        if self._on_card:
            torch.cuda.synchronize(self.device)
        prof.stop()
        if self._on_card:
            torch.cuda.memory._record_memory_history(enabled=None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(
            self.profile_dir,
            f"wlsh_trace_{os.getpid()}_{len(self.trace_paths)}.json")
        prof.export_chrome_trace(path)
        self.trace_paths.append(path)
        return True

    def save_memory_snapshot(self, path: str) -> bool:
        """The CUDA caching allocator's snapshot to ``path`` (a pickle
        for ``torch.cuda.memory``'s viewer).  False for a CPU service,
        which has no device memory to profile."""
        if not self._on_card:
            return False
        torch.cuda.memory._dump_snapshot(path)
        return True

    def summary(self) -> dict:
        """Compile counts and dispatch-time attribution per signature."""
        with self._lock:
            return {
                "n_compiles": sum(self._compiles.values()),
                "compiles": dict(self._compiles),
                "dispatch": {
                    sig: {
                        "count": self._dispatch_n[sig],
                        "total_s": self._dispatch_s[sig],
                        "mean_s": (self._dispatch_s[sig]
                                   / self._dispatch_n[sig]),
                    }
                    for sig in sorted(self._dispatch_n)
                },
            }
