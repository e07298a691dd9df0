"""Weighted LSH hash encode: the CUDA C++ kernel and its wrapper.

``hash_encode`` turns (n, d) vectors into (n, beta) int32 bucket codes,
``floor(((X o w) @ A) / width + b_frac) + b_int``; the kernel is in
``csrc/hash_encode.cu`` (see the source note there for the design).  The
device-encode build and the query encode of a plan without host codes
run through it.

The wrapper is the custom op ``repro_torch::hash_encode``, so the
dispatcher picks its version by device.  For tensors on the CPU it is
the plain torch version (``ref.hash_encode_ref``), which takes the
kernel's fused multiply-adds in the kernel's order and rounds each once,
so the two agree bit for bit.  For CUDA tensors it checks device, dtype,
contiguity and shape, allocates the output, launches on the current
stream and raises if the launch fails; there is no fallback.  For meta
tensors it gives the output's shape and dtype alone.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _cuda, ref

__all__ = ["hash_encode", "launch_counts"]

launch_counts = _cuda.counter("hash_encode")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 5 + [_F] + [_I] * 3 + [_P, _P]


@torch.library.custom_op("repro_torch::hash_encode", mutates_args=(),
                         device_types="cpu")
def hash_encode(points: Tensor, weight: Tensor, proj: Tensor, b_int: Tensor,
                b_frac: Tensor, width: float) -> Tensor:
    """(n, beta) int32 level-1 bucket codes of ``points`` (n, d) under
    ``weight`` (d,), ``proj`` (d, beta), ``b_int`` (beta,) int32,
    ``b_frac`` (beta,) and bucket width ``width``."""
    return ref.hash_encode_ref(points, proj, b_int, b_frac, weight, width)


@hash_encode.register_kernel("cuda")
def _hash_encode_cuda(points, weight, proj, b_int, b_frac, width):
    dev = points.device
    n, d = points.shape
    beta = proj.shape[1]
    for args in (("points", points, torch.float32, (n, d)),
                 ("weight", weight, torch.float32, (d,)),
                 ("proj", proj, torch.float32, (d, beta)),
                 ("b_int", b_int, torch.int32, (beta,)),
                 ("b_frac", b_frac, torch.float32, (beta,))):
        _cuda.check(*args, dev)
    if max(n * d, n * beta, d * beta) >= 2**31:
        raise ValueError("inputs too large for 32-bit indices")
    out = torch.empty((n, beta), dtype=torch.int32, device=dev)
    fn = _cuda.function("wlsh_hash_encode", _ARGS)
    with torch.cuda.device(dev):
        err = fn(points.data_ptr(), weight.data_ptr(), proj.data_ptr(),
                 b_int.data_ptr(), b_frac.data_ptr(), float(width), n, d,
                 beta, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("hash_encode", err, launch_counts)
    return out


@hash_encode.register_fake
def _hash_encode_fake(points, weight, proj, b_int, b_frac, width):
    return points.new_empty((points.shape[0], proj.shape[1]),
                            dtype=torch.int32)
