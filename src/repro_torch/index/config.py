"""Configuration of one table group's query step.

An ``IndexConfig`` fixes every shape of one table group's query step.
Two groups whose configs compare equal share one query step
(``engine.QueryStepCache``); ``shape_signature()`` documents what sharing
depends on.  ``pad_beta`` / ``pad_levels`` quantize per-group sizes onto a
small set of buckets; per-query ``beta_q`` and ``levels_q`` inputs mask the
padding at run time, keeping results exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = ["VEC_DTYPES", "IndexConfig", "pad_beta", "pad_levels"]

# Default table-count buckets: multiples of 32 (the relaxed Eq. 11 betas
# land in the tens-to-hundreds, Table 6) capped by powers of two above 512.
_BETA_STEP = 32
_LEVEL_STEP = 4

# Vector storage types the query step serves (``torch`` dtype names);
# either way every distance is computed in float32.
VEC_DTYPES = ("float32", "bfloat16")
_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def pad_beta(beta: int, buckets: Sequence[int] | None = None) -> int:
    """Smallest admissible table count >= beta (bounds the step count)."""
    if buckets is not None:
        for b in sorted(buckets):
            if b >= beta:
                return int(b)
        raise ValueError(f"beta={beta} exceeds the largest bucket {max(buckets)}")
    if beta <= 512:
        return _BETA_STEP * math.ceil(beta / _BETA_STEP)
    return 1 << math.ceil(math.log2(beta))


def pad_levels(n_levels: int, step: int = _LEVEL_STEP) -> int:
    """Round the level-loop bound up to a multiple of ``step``."""
    return step * math.ceil(max(n_levels, 1) / step)


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Shapes + plan parameters for one table group's query step.

    With ``n_shards > 1`` the group's rows are split across that many
    devices (``distributed.group_sharding``): ``n`` is the whole row
    capacity, ``state_nbytes`` prices one device's slice, and the shard
    count is part of ``shape_signature``.  The JAX package's
    ``shard_axis`` has no counterpart: the serving stack shards over a
    list of devices, and the mesh steps (``make_query_step``,
    ``make_build_step``) lay the rows over every axis of their mesh.
    """

    n: int = 1 << 20  # row capacity; state.n_valid masks the dead tail
    d: int = 128  # dimensions
    beta: int = 128  # hash tables in the group (post-relaxation size)
    q_batch: int = 64  # query batch
    k: int = 10
    c: int = 2
    n_levels: int = 24  # virtual-rehashing levels (0..n_levels)
    p: float = 2.0
    gamma_n: float = 100.0  # gamma * n (paper default gamma = 100/n), so the
    # candidate budget k + ceil(gamma * n) stays aligned with the planner
    budget_override: int | None = None  # explicit budget; None = derive
    vec_dtype: str = "float32"  # stored vectors: one of VEC_DTYPES
    use_kernels: str = "on"  # kernel path (kernels.platform): "on" = fused
    # passes (CUDA kernels on the card, plain torch on the CPU), "off" =
    # the unfused stage-by-stage oracle
    delta_seal_rows: int = 1024  # streaming: an open delta memtable seals
    # into a hashed segment at this row count; absent from
    # shape_signature, but part of equality, so a Batcher threads one
    # value through every group config
    n_shards: int = 1  # devices the rows are sharded across, one
    # contiguous slice of n / n_shards rows each (distributed.group_sharding)

    @property
    def gamma(self) -> float:
        """The paper's gamma: the candidate budget's share of the rows."""
        return self.gamma_n / self.n

    @property
    def budget(self) -> int:
        """Candidate budget k + ceil(gamma * n) (paper stop condition 2).

        Computed as ``k + ceil(gamma_n)`` directly, which keeps the budget
        exact and independent of row-capacity padding.
        """
        if self.budget_override is not None:
            return self.budget_override
        return self.k + int(math.ceil(self.gamma_n))

    @property
    def state_nbytes(self) -> int:
        """Device bytes of one group's resident ``QueryState``.

        Codes ``(n, beta)`` i32, vectors ``(n, d)`` in ``vec_dtype``, the
        folded family (``proj (d, beta)`` f32, ``b_int``/``b_frac
        (beta,)``, ``width ()``) plus the ``n_valid`` row count, at the
        padded shapes actually materialized.
        """
        per_point = self.beta * 4 + self.d * _ITEMSIZE[self.vec_dtype]
        family = self.d * self.beta * 4 + self.beta * (4 + 4) + 4
        rows_per_shard = -(-self.n // max(self.n_shards, 1))
        return rows_per_shard * per_point + family + 4  # + n_valid scalar

    def shape_signature(self) -> tuple:
        """Everything that determines the query step."""
        return (
            self.n, self.d, self.beta, self.q_batch, self.k, self.c,
            self.n_levels, self.p, self.budget,
            self.vec_dtype, self.use_kernels, self.n_shards,
        )
