"""Weighted l_p distances (p != 2): the CUDA C++ kernel and its wrapper.

``weighted_lp`` gives the (Q, n) float32 matrix
``(sum_i |(x_i - q_i) w_i|^p)^(1/p)`` under one weight vector; the kernel
is in ``csrc/weighted_lp.cu`` (a 4-row x 8-query register tile per thread,
with the term chosen by p: |t| for p = 1, sqrt(|t|) for p = 0.5, powf for
any other p).  As in the JAX package it serves no serving
path: ``ops.weighted_lp_dist`` reaches it for p != 2, and p = 2 takes the
norms expansion there instead, so this wrapper rejects p = 2 on the card.

The wrapper is the custom op ``repro_torch::weighted_lp``, so the
dispatcher picks its version by device: the plain torch version
(``ref.weighted_lp_ref``) for tensors on the CPU; for CUDA tensors the
launch, which checks device, dtype, contiguity and shape, allocates the
output, launches on the current stream and raises if the launch fails
(there is no fallback); for meta tensors the output's shape and dtype.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _cuda, ref

__all__ = ["launch_counts", "occupancy", "weighted_lp"]

launch_counts = _cuda.counter("weighted_lp")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 3 + [_I] * 3 + [_F, _P, _P]
_OCC_KEYS = ("smem_bytes", "blocks_per_sm", "registers")


@torch.library.custom_op("repro_torch::weighted_lp", mutates_args=(),
                         device_types="cpu")
def weighted_lp(queries: Tensor, points: Tensor, weight: Tensor,
                p: float) -> Tensor:
    """(Q, n) float32 weighted l_p distances of ``queries`` (Q, d) to
    ``points`` (n, d) under ``weight`` (d,), p != 2 on the card."""
    return ref.weighted_lp_ref(queries, points, weight, p)


@weighted_lp.register_kernel("cuda")
def _weighted_lp_cuda(queries, points, weight, p):
    if abs(p - 2.0) < 1e-9 or not p > 0:
        raise ValueError(f"the weighted_lp kernel takes 0 < p != 2, got {p}")
    dev = queries.device
    q, d = queries.shape
    n = points.shape[0]
    for args in (("queries", queries, torch.float32, (q, d)),
                 ("points", points, torch.float32, (n, d)),
                 ("weight", weight, torch.float32, (d,))):
        _cuda.check(*args, dev)
    if max(n * d, q * n) >= 2**31:
        raise ValueError("inputs too large for 32-bit indices")
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    fn = _cuda.function("wlsh_weighted_lp", _ARGS)
    with torch.cuda.device(dev):
        err = fn(queries.data_ptr(), points.data_ptr(), weight.data_ptr(), q,
                 n, d, float(p), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("weighted_lp", err, launch_counts)
    return out


@weighted_lp.register_fake
def _weighted_lp_fake(queries, points, weight, p):
    return queries.new_empty((queries.shape[0], points.shape[0]),
                             dtype=torch.float32)


def occupancy(p: float) -> dict:
    """What one launch at ``p`` gets on the current card: static shared
    bytes per block, resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and registers per
    thread."""
    return _cuda.occupancy("wlsh_weighted_lp_occupancy", _OCC_KEYS,
                           float(p))
