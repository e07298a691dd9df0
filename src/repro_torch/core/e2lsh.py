"""E2LSH (Indyk-Motwani / Datar et al.) baseline for the weighted l_p case.

Compound hash g = (h_1..h_m), L tables, hash tables re-created per radius
R in {r_min, c r_min, ...} (Sec. 2.3.1).  Parameterization:
m = ceil(log_{1/P2} n), L = ceil(n^rho), rho = ln(1/P1)/ln(1/P2).

Used in tests as a sanity baseline and by the benchmark suite to contrast
table counts; tables for one (weight, radius) pair at a time to bound memory.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .collision import collision_prob
from .distances import radius_bounds, weighted_lp_np
from .params import PlanConfig
from .pstable import sample_pstable_np

__all__ = ["E2LSH", "e2lsh_params"]


def e2lsh_params(n: int, w: float, c: float, p: float, R: float = 1.0):
    p1 = collision_prob(R, w, p)
    p2 = collision_prob(c * R, w, p)
    rho = math.log(1.0 / p1) / math.log(1.0 / p2)
    m = max(1, math.ceil(math.log(n) / math.log(1.0 / p2)))
    L = max(1, math.ceil(n**rho))
    return m, L, rho, p1, p2


@dataclasses.dataclass
class _RadiusTables:
    proj: np.ndarray  # (L, d, m)
    bias: np.ndarray  # (L, m)
    table: dict  # bucket tuple -> np.ndarray of ids  (per l in L: table[l])


class E2LSH:
    """Weighted E2LSH for a single weight vector (c-WNN baseline)."""

    def __init__(
        self,
        data: np.ndarray,
        weight: np.ndarray,
        cfg: PlanConfig,
        value_range: float = 10_000.0,
        width_mult: float = 4.0,
        max_tables: int = 64,
        seed: int = 0,
        t_factor: int = 3,
    ):
        self.data = np.asarray(data, np.float32)
        self.weight = np.asarray(weight, np.float64)
        self.cfg = dataclasses.replace(cfg, n=len(self.data))
        self.r_min, self.r_max = radius_bounds(self.weight, value_range, cfg.p)
        self.width = width_mult * self.r_min
        self.max_tables = max_tables
        self.seed = seed
        self.t_factor = t_factor  # check at most t*L candidates per radius
        self.n_levels = (
            math.ceil(math.log(self.r_max / self.r_min) / math.log(cfg.c)) + 1
        )
        self.m, self.L, self.rho, _, _ = e2lsh_params(
            len(self.data), self.width / self.r_min, cfg.c, cfg.p, R=1.0
        )
        self.L = min(self.L, max_tables)
        self._radius_tables: dict[int, _RadiusTables] = {}

    # Radius-j hashing uses width w * c^j (equivalent to rescaling R to 1).
    def _tables(self, j: int) -> _RadiusTables:
        if j in self._radius_tables:
            return self._radius_tables[j]
        rng = np.random.default_rng(self.seed + 104729 * j)
        d = self.data.shape[1]
        proj = sample_pstable_np(rng, self.cfg.p, (self.L, d, self.m)).astype(
            np.float32
        )
        w_j = self.width * (self.cfg.c**j)
        bias = rng.uniform(0, w_j, size=(self.L, self.m)).astype(np.float32)
        x = (self.data * self.weight).astype(np.float32)
        tables = []
        for l in range(self.L):
            codes = np.floor((x @ proj[l] + bias[l]) / w_j).astype(np.int64)
            tbl: dict = {}
            for i, key in enumerate(map(tuple, codes)):
                tbl.setdefault(key, []).append(i)
            tables.append({k: np.asarray(v) for k, v in tbl.items()})
        rt = _RadiusTables(proj=proj, bias=bias, table=tables)
        self._radius_tables[j] = rt
        return rt

    def query(self, q: np.ndarray, k: int = 1):
        q = np.asarray(q, np.float32)
        qw = q * self.weight
        seen: set[int] = set()
        results: list[tuple[float, int]] = []
        n_checked = 0
        for j in range(self.n_levels + 1):
            rt = self._tables(j)
            w_j = self.width * (self.cfg.c**j)
            R = self.r_min * (self.cfg.c**j)
            budget = self.t_factor * self.L
            got = 0
            for l in range(self.L):
                key = tuple(
                    np.floor((qw @ rt.proj[l] + rt.bias[l]) / w_j).astype(np.int64)
                )
                for i in rt.table[l].get(key, ()):  # type: ignore[index]
                    if i in seen:
                        continue
                    seen.add(int(i))
                    dist = float(
                        weighted_lp_np(self.data[i], q, self.weight, self.cfg.p)
                    )
                    n_checked += 1
                    got += 1
                    results.append((dist, int(i)))
                    if got >= budget:
                        break
                if got >= budget:
                    break
            good = [r for r in results if r[0] <= self.cfg.c * R]
            if len(good) >= k or got >= budget:
                break
        results.sort()
        ids = np.full(k, -1, dtype=np.int64)
        dists = np.full(k, np.inf)
        for i, (dist, pid) in enumerate(results[:k]):
            ids[i] = pid
            dists[i] = dist
        return ids, dists, n_checked
