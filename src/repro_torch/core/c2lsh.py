"""C2LSH (Gan et al., SIGMOD'12) as the single-weight special case of WLSH.

WLSH with |S| = 1 degenerates exactly to C2LSH for the weighted distance
D_W (Sec. 2.3.2): x_up = x, y_down = y, one group, beta/mu from Eqs. 4-5.
Provided as a named class because the paper treats C2LSH as both substrate
and baseline.
"""

from __future__ import annotations

import numpy as np

from .params import PlanConfig
from .wlsh import WLSHIndex

__all__ = ["C2LSH"]


class C2LSH(WLSHIndex):
    def __init__(
        self,
        data: np.ndarray,
        cfg: PlanConfig,
        weight: np.ndarray | None = None,
        value_range: float = 10_000.0,
        use_reduction: bool = True,
        seed: int = 0,
        tau: float | None = None,
    ):
        d = np.asarray(data).shape[1]
        w = np.ones(d) if weight is None else np.asarray(weight, np.float64)
        super().__init__(
            data=data,
            weights=w[None, :],
            cfg=cfg,
            tau=float("inf") if tau is None else tau,
            value_range=value_range,
            v=1,
            v_prime=1,
            use_reduction=use_reduction,
            seed=seed,
            materialize=True,
        )

    def query(self, q: np.ndarray, k: int = 1):
        return self.search(q, weight_id=0, k=k)
