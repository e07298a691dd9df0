"""The port's data pipeline and fault-tolerance substrate
(``repro_torch.training.data``, ``repro_torch.distributed.fault``):
``SyntheticStream`` batches equal the JAX package's bit for bit (both
modes, global batches and host shards), and ``tests/test_data_fault.py``'s
semantics on the port."""

from __future__ import annotations

import os
import signal

import numpy as np
import pytest

from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticStream as JaxSyntheticStream
from repro_torch.distributed.fault import (
    PreemptionHandler,
    RestartSupervisor,
    StragglerMonitor,
)
from repro_torch.training.data import DataConfig, SyntheticStream


@pytest.mark.parametrize("mode", ["markov", "uniform"])
def test_stream_matches_jax_bit_for_bit(mode):
    kw = dict(vocab=50_304, seq_len=24, global_batch=8, seed=5, mode=mode)
    port = SyntheticStream(DataConfig(**kw))
    ref = JaxSyntheticStream(JaxDataConfig(**kw))
    for step in (0, 3, 17):
        for a, b in ((port.global_batch(step), ref.global_batch(step)),
                     (port.host_shard(step, 1, 4), ref.host_shard(step, 1, 4))):
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------------- data


def _cfg(**kw):
    base = dict(vocab=64, seq_len=12, global_batch=8, seed=3)
    base.update(kw)
    return DataConfig(**base)


def test_stream_deterministic():
    a = SyntheticStream(_cfg()).global_batch(5)
    b = SyntheticStream(_cfg()).global_batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_stream_steps_differ():
    s = SyntheticStream(_cfg())
    assert not np.array_equal(s.global_batch(0)["tokens"],
                              s.global_batch(1)["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticStream(_cfg()).global_batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_shards_partition_global_batch():
    s = SyntheticStream(_cfg())
    full = s.global_batch(2)
    parts = [s.host_shard(2, h, 4) for h in range(4)]
    glued = np.concatenate([p["tokens"] for p in parts])
    np.testing.assert_array_equal(full["tokens"], glued)


def test_markov_structure_learnable():
    """Markov mode: successor entropy is ~log(branching) << log(vocab)."""
    s = SyntheticStream(_cfg(mode="markov", branching=4, global_batch=64))
    b = s.global_batch(0)
    toks = b["tokens"]
    succ: dict[int, set] = {}
    for row in toks:
        for i in range(len(row) - 1):
            succ.setdefault(int(row[i]), set()).add(int(row[i + 1]))
    n_succ = [len(v) for v in succ.values() if v]
    assert np.mean(n_succ) <= 4.5  # bounded branching (vs 64 for uniform)


# ----------------------------------------------------------------- fault


def test_preemption_handler_sets_flag():
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    assert not h.should_stop
    os.kill(os.getpid(), signal.SIGUSR1)
    assert h.should_stop
    h.restore()


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(window=20, threshold=2.0)
    for _ in range(15):
        assert m.record(1.0) is None
    rep = m.record(3.5)
    assert rep is not None and rep.ratio == pytest.approx(3.5)
    assert m.flagged and m.flagged[0].duration == 3.5
    # normal steps after the spike are not flagged
    assert m.record(1.1) is None


def test_straggler_monitor_warmup_silent():
    m = StragglerMonitor(window=50)
    for _ in range(3):
        assert m.record(100.0) is None  # no baseline yet -> no flags


def test_restart_supervisor_recovers():
    calls = {"n": 0, "resume": []}

    def resume_step():
        return calls["n"]

    def body(resume):
        calls["resume"].append(resume)
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(f"simulated failure {calls['n']}")
        return "done"

    sup = RestartSupervisor(max_restarts=5)
    assert sup.run(body, resume_step) == "done"
    assert sup.restarts == 2
    assert calls["resume"] == [0, 1, 2]  # resumed from the advancing step


def test_restart_supervisor_gives_up():
    sup = RestartSupervisor(max_restarts=2)

    def body(_):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        sup.run(body, lambda: 0)
    assert sup.restarts == 3
    assert len(sup.failures) == 3
