"""Deterministic, shardable, resumable synthetic token pipeline (a copy of
the JAX package's ``training/data.py``: numpy only, so its batches equal
the reference's bit for bit).

Every batch is a pure function of (seed, step, shard), so:
  * resume-from-checkpoint needs only the step counter (exactly-once
    delivery across restarts — verified by tests/test_torch_checkpoint.py);
  * each host materializes only its shard (per-host data loading at cluster
    scale);
  * "markov" mode draws tokens from a fixed random Markov chain so small
    models have real structure to learn in examples/train_lm_torch.py
    ("uniform" is i.i.d. noise for pure-throughput runs).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticStream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "markov"  # markov | uniform
    branching: int = 4  # markov: candidate successors per token


class SyntheticStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.mode == "markov":
            rng = np.random.default_rng(cfg.seed)
            self._succ = rng.integers(
                0, cfg.vocab, size=(cfg.vocab, cfg.branching)
            ).astype(np.int32)

    def _rng(self, step: int, row: int):
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row])
        )

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step, row)
        if cfg.mode == "uniform":
            return rng.integers(0, cfg.vocab, size=cfg.seq_len + 1).astype(
                np.int32
            )
        toks = np.empty(cfg.seq_len + 1, np.int32)
        toks[0] = rng.integers(0, cfg.vocab)
        picks = rng.integers(0, cfg.branching, size=cfg.seq_len)
        for i in range(cfg.seq_len):
            toks[i + 1] = self._succ[toks[i], picks[i]]
        return toks

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        rows = np.stack(
            [self._row(step, r) for r in range(self.cfg.global_batch)]
        )
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def host_shard(self, step: int, host_id: int, n_hosts: int):
        """Rows this host owns (contiguous block of the global batch)."""
        per = self.cfg.global_batch // n_hosts
        rows = np.stack(
            [self._row(step, host_id * per + r) for r in range(per)]
        )
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
