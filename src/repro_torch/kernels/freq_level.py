"""First-frequent-level matrix: the CUDA C++ kernel and its wrapper.

``freq_level`` gives, per (query, row), the first virtual-rehashing level
j <= L at which at least mu[q] of the query's first beta_q[q] tables put
the row in the query's bucket (L+1 if never), as a (Q, n) int32 matrix;
the kernel is in ``csrc/freq_level.cu`` and is the fused passes' level
matching (``csrc/level_match.cuh``): digit words for c = 2 and 3, the
level walk for any other c.  Stage 1 of the engine's unfused route
(``use_kernels="off"``) runs through it.

The wrapper is the custom op ``repro_torch::freq_level``, so the
dispatcher picks its version by device: the plain torch version
(``ref.freq_level_ref``) for tensors on the CPU; for CUDA tensors the
launch, which checks device, dtype, contiguity and shape, allocates the
output, launches on the current stream and raises if the launch fails
(there is no fallback); for meta tensors the output's shape and dtype.  Integer
outputs equal the plain version's exactly.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _cuda, ref

__all__ = ["freq_level", "launch_counts", "occupancy"]

launch_counts = _cuda.counter("freq_level")
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 4 + [_I] * 5 + [_P, _P]
_OCC_KEYS = ("smem_bytes", "blocks_per_sm", "registers")


@torch.library.custom_op("repro_torch::freq_level", mutates_args=(),
                         device_types="cpu")
def freq_level(codes_p: Tensor, codes_q: Tensor, mu: Tensor, beta_q: Tensor,
               *, c: int, n_levels: int) -> Tensor:
    """(Q, n) int32 first-frequent levels of rows ``codes_p`` (n, beta)
    for queries ``codes_q`` (Q, beta) with per-query ``mu`` and ``beta_q``
    (Q,) int32."""
    return ref.freq_level_ref(codes_p, codes_q, mu, c, n_levels, beta_q)


@freq_level.register_kernel("cuda")
def _freq_level_cuda(codes_p, codes_q, mu, beta_q, *, c, n_levels):
    dev = codes_p.device
    n, beta = codes_p.shape
    q = codes_q.shape[0]
    for args in (("codes_p", codes_p, torch.int32, (n, beta)),
                 ("codes_q", codes_q, torch.int32, (q, beta)),
                 ("mu", mu, torch.int32, (q,)),
                 ("beta_q", beta_q, torch.int32, (q,))):
        _cuda.check(*args, dev)
    if max(n * beta, q * n) >= 2**31:
        raise ValueError("inputs too large for 32-bit indices")
    out = torch.empty((q, n), dtype=torch.int32, device=dev)
    fn = _cuda.function("wlsh_freq_level", _ARGS)
    with torch.cuda.device(dev):
        err = fn(codes_p.data_ptr(), codes_q.data_ptr(), mu.data_ptr(),
                 beta_q.data_ptr(), n, beta, q, int(c), int(n_levels),
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("freq_level", err, launch_counts)
    return out


@freq_level.register_fake
def _freq_level_fake(codes_p, codes_q, mu, beta_q, *, c, n_levels):
    return codes_p.new_empty((codes_q.shape[0], codes_p.shape[0]),
                             dtype=torch.int32)


def occupancy(c: int, n_levels: int) -> dict:
    """What one launch at (c, L) gets on the current card: dynamic shared
    bytes per block, resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and registers per
    thread."""
    return _cuda.occupancy("wlsh_freq_level_occupancy", _OCC_KEYS, int(c),
                           int(n_levels))
