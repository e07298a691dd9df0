"""Fault-injection harness for the port's paging / scheduler / QoS tests.

``FaultyExecutor`` wraps the suite's fake build/offload/restore executor
pattern (``StateCache`` over host-side tuples, no device) with
*injectable* faults:

  * ``fail_builds`` / ``fail_restores`` — the next N calls of that
    executor raise a typed ``InjectedFault`` (set ``math.inf`` for a
    persistent fault; the counters are plain mutable attributes, so a
    test heals the executor mid-run by zeroing them);
  * ``build_delay_s`` / ``restore_delay_s`` — modeled latency spikes,
    *recorded* through the ``sleeper`` hook instead of wall-slept (the
    default appends to ``slept``), so property tests stay instant;
  * every call is logged to ``calls`` as ``(kind, group_id)`` for
    exact-sequence assertions.

``record_backoffs`` additionally intercepts a ``StateCache``'s retry
backoff sleeps, so bounded-retry tests can assert the doubling schedule
without ever sleeping.
"""

from __future__ import annotations

from repro_torch.serving import StateCache


class InjectedFault(RuntimeError):
    """The typed failure every injected fault raises (match="injected")."""


class FaultyExecutor:
    """Fake state executors with injectable failures and recorded delays.

    States are host-side tuples — ``build`` returns ``("dev", gi)``,
    ``offload`` wraps to ``("host", state)``, ``restore`` unwraps — so a
    restored state is trivially bit-identical to the evicted one and no
    device is involved anywhere.
    """

    def __init__(
        self,
        *,
        fail_builds: float = 0,
        fail_restores: float = 0,
        build_delay_s: float = 0.0,
        restore_delay_s: float = 0.0,
        sleeper=None,
    ):
        self.fail_builds = fail_builds
        self.fail_restores = fail_restores
        self.build_delay_s = float(build_delay_s)
        self.restore_delay_s = float(restore_delay_s)
        self.calls: list[tuple[str, int]] = []
        self.slept: list[float] = []
        self._sleep = sleeper if sleeper is not None else self.slept.append

    def build(self, gi: int):
        """Cold-build executor: fails while ``fail_builds`` > 0."""
        self.calls.append(("build", int(gi)))
        if self.build_delay_s:
            self._sleep(self.build_delay_s)
        if self.fail_builds > 0:
            self.fail_builds -= 1
            raise InjectedFault(f"injected build fault (group {gi})")
        return ("dev", int(gi))

    def offload(self, state):
        """Device-to-host offload executor (never fails: copies are cheap)."""
        self.calls.append(("offload", state[-1]))
        return ("host", state)

    def restore(self, gi: int, host):
        """Host-to-device restore executor: fails while ``fail_restores``
        > 0."""
        self.calls.append(("restore", int(gi)))
        if self.restore_delay_s:
            self._sleep(self.restore_delay_s)
        if self.fail_restores > 0:
            self.fail_restores -= 1
            raise InjectedFault(f"injected restore fault (group {gi})")
        return host[1]

    def n_calls(self, kind: str) -> int:
        """How many times executor ``kind`` ran (failed calls included)."""
        return sum(1 for k, _ in self.calls if k == kind)

    def make_cache(self, *, nbytes=lambda gi: 10, offload=True,
                   **kw) -> StateCache:
        """A ``StateCache`` wired to this executor's fault hooks."""
        if offload:
            kw.setdefault("offload", self.offload)
            kw.setdefault("restore", self.restore)
        return StateCache(build=self.build, nbytes_of=nbytes, **kw)


def record_backoffs(cache: StateCache) -> list[float]:
    """Divert ``cache``'s retry backoff sleeps into the returned list.

    The cache's ``retry_backoff_s`` schedule (doubling per attempt) is
    then assertable without any wall-clock sleep actually happening.
    """
    recorded: list[float] = []
    cache._sleep = recorded.append
    return recorded
