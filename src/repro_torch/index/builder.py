"""Table-group state build (the paper's Preprocess) from a serving plan.

The group's center weight and bucket width are *folded* into the
projection once, so serving never touches them:

    proj_folded = diag(W_center) @ A / w
    codes       = floor(x @ proj_folded + b_frac) + b_int

When the plan ships host-computed (float64) codes, the build places them
on the device as they are, so the device engine sees bit-identical
candidate sets to the host oracle.  Otherwise it encodes the group's rows
on the device through ``ops.hash_encode`` (the CUDA kernel on the card),
and queries must then be encoded the same way (``engine.encode_queries``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.serving_plan import GroupServingPlan
from ..kernels import ops
from ..kernels.platform import resolve_device
from .config import IndexConfig
from .engine import QueryState

__all__ = ["build_group_state", "pad_cols"]

# Row-capacity padding fill of a host-code build: a fixed sentinel code and
# zero vectors (a device-encoded build encodes its zero vectors instead).
# Dead rows are masked out of the query step by ``QueryState.n_valid``, so
# the fill only has to be deterministic.
_PAD_CODE = np.iinfo(np.int32).max // 2


def pad_cols(x: np.ndarray, beta: int) -> np.ndarray:
    """Pad the trailing (table) axis to ``beta`` columns with zeros.

    Padded tables are dead weight only: every query masks lanes >= its
    beta_q, and beta_q never exceeds the group's real beta.
    """
    have = x.shape[-1]
    if have == beta:
        return x
    if have > beta:
        raise ValueError(f"group beta {have} exceeds padded config beta {beta}")
    pad = [(0, 0)] * (x.ndim - 1) + [(0, beta - have)]
    return np.pad(x, pad)


def build_group_state(
    cfg: IndexConfig,
    points: np.ndarray,
    gplan: GroupServingPlan,
    device: str | torch.device = "cuda",
) -> QueryState:
    """Materialize one table group's ``QueryState`` on ``device``.

    ``cfg.beta`` may exceed the group's real table count (bucketed shape
    padding, ``config.pad_beta``); codes and family are zero-padded to
    match.  ``cfg.n`` is a row *capacity* and may exceed the live row
    count: the excess rows hold zero vectors and, on the host-code path,
    the sentinel code ``int32 max // 2``; a device-encoded build encodes
    them like every row (an encoded zero row is exactly ``b_int``).
    ``n_valid`` masks them out of every query.

    Without host codes the corpus is uploaded once, padded on the device,
    and encoded there from the state's own vectors.
    """
    dev = resolve_device(device)
    if cfg.vec_dtype != "float32":
        raise NotImplementedError(f"vec_dtype {cfg.vec_dtype!r}: only "
                                  f"float32 vectors are supported so far")
    folded = gplan.folded()

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    proj = put(pad_cols(folded["proj"], cfg.beta))
    b_int = put(pad_cols(folded["b_int"], cfg.beta))
    b_frac = put(pad_cols(folded["b_frac"], cfg.beta))

    points = np.ascontiguousarray(points, dtype=np.float32)
    n_rows = len(points)
    if n_rows > cfg.n:
        raise ValueError(
            f"{n_rows} live rows exceed the config row capacity {cfg.n}"
        )
    vecs = torch.zeros((cfg.n, cfg.d), dtype=torch.float32, device=dev)
    vecs[:n_rows] = torch.from_numpy(points).to(dev)
    if gplan.codes is None:
        codes = ops.hash_encode(vecs, torch.ones(cfg.d, device=dev), proj,
                                b_int, b_frac, 1.0)
    else:
        codes_np = pad_cols(gplan.codes, cfg.beta).astype(np.int32)
        if len(codes_np) != n_rows:
            raise ValueError(
                f"host codes cover {len(codes_np)} rows, expected {n_rows}"
            )
        codes = torch.full((cfg.n, cfg.beta), _PAD_CODE, dtype=torch.int32,
                           device=dev)
        codes[:n_rows] = torch.from_numpy(codes_np).to(dev)
    return QueryState(
        codes=codes,
        points=vecs,
        proj=proj,
        b_int=b_int,
        b_frac=b_frac,
        width=torch.tensor(1.0, dtype=torch.float32, device=dev),
        n_valid=n_rows,
    )
