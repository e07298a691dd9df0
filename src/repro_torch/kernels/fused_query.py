"""Fused WLSH query passes: CUDA C++ kernels and their wrappers.

Two kernels in ``csrc/fused_query.cu`` carry the engine's two scan passes
over one table group's state (see the source note there for the design):

  pass 1  ``fused_query_hist``   -> (hist_f, hist_g), each (Q, L+3) int32
  pass 2  ``fused_query_scores`` -> (Q, B) float32 stop-masked distances

Each wrapper is a ``torch.library`` custom op (``repro_torch::<name>``),
so the dispatcher picks its version by the tensors' device: the plain
torch version (``ref.py``) for tensors on the CPU; for CUDA tensors the
launch, which checks device, dtype, contiguity and shape, allocates the
outputs, launches on the current stream and raises if the launch fails
(there is no fallback); for meta tensors the output shapes and dtypes
alone, so a dry-run traces the op without running it, and a dispatch
mode (``launch.roofline.StepCounter``) sees one op per call.  ``launch_counts`` counts kernel
launches per wrapper, so a run can show that its main path went through
the kernels.  The kernels are built with the port's other CUDA sources
(``_cuda.build``).

The vector rows may be float32 or bfloat16: the kernel is built for both
storage types and widens bfloat16 rows to float32 as it stages them into
shared memory, so every sum after the load is the float32 one, and a
bfloat16 state is scored without a float32 copy of its rows.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _cuda, ref
from ._cuda import reset_launch_counts

__all__ = [
    "fused_query_hist",
    "fused_query_scores",
    "launch_counts",
    "occupancy",
    "reset_launch_counts",
]

launch_counts = _cuda.counter("fused_query_hist", "fused_query_scores")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HIST_ARGS = [_P] * 8 + [_I] * 9 + [_F, _P, _P, _P]
_SCORES_ARGS = [_P] * 8 + [_I] * 9 + [_F, _P, _P]
_VEC_DTYPES = (torch.float32, torch.bfloat16)
_OCC_KEYS = ("smem_bytes", "blocks_per_sm", "registers", "rows", "qt", "tc")


def _check_inputs(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
                  last, last_name, last_dtype):
    dev = codes_p.device
    b, beta = codes_p.shape
    q, d = queries.shape
    for args in (("codes_p", codes_p, torch.int32, (b, beta)),
                 ("points", points, _VEC_DTYPES, (b, d)),
                 ("codes_q", codes_q, torch.int32, (q, beta)),
                 ("queries", queries, torch.float32, (q, d)),
                 ("q_weight", q_weight, torch.float32, (q, d)),
                 ("mu", mu, torch.int32, (q,)),
                 ("beta_q", beta_q, torch.int32, (q,)),
                 (last_name, last, last_dtype, (q,))):
        _cuda.check(*args, dev)
    if max(b * max(beta, d), q * b) >= 2**31:
        raise ValueError("state too large for 32-bit row/column indices")
    return dev, b, beta, q, d


def _bf16(points) -> int:
    """The kernel's storage-type flag: 1 for bfloat16 rows, 0 for float32."""
    return int(points.dtype == torch.bfloat16)


def _row_ok(b, boff, n_valid, dev):
    return (boff + torch.arange(b, device=dev)) < n_valid


@torch.library.custom_op("repro_torch::fused_query_hist", mutates_args=(),
                         device_types="cpu")
def fused_query_hist(codes_p: Tensor, points: Tensor, codes_q: Tensor,
                     queries: Tensor, q_weight: Tensor, mu: Tensor,
                     beta_q: Tensor, r_min: Tensor, *, boff: int,
                     n_valid: int, c: int, n_levels: int,
                     p: float) -> tuple[Tensor, Tensor]:
    """Pass 1 over rows ``codes_p``/``points`` (float32 or bfloat16):
    (hist_f, hist_g) (Q, L+3).

    Bin j counts rows whose first-frequent (resp. good) level is j; bin L+2
    holds dead rows (``boff + row >= n_valid``); good levels above L+2
    fall outside every bin.
    """
    row_ok = _row_ok(codes_p.shape[0], boff, n_valid, codes_p.device)
    return ref.fused_query_hist_ref(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q, r_min,
        row_ok, c=c, n_levels=n_levels, p=p)


@fused_query_hist.register_kernel("cuda")
def _hist_cuda(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
               r_min, *, boff, n_valid, c, n_levels, p):
    dev, b, beta, q, d = _check_inputs(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q,
        r_min, "r_min", torch.float32)
    hist_f = torch.zeros((q, n_levels + 3), dtype=torch.int32, device=dev)
    hist_g = torch.zeros_like(hist_f)
    fn = _cuda.function("wlsh_fused_query_hist", _HIST_ARGS)
    with torch.cuda.device(dev):
        err = fn(
            codes_p.data_ptr(), points.data_ptr(), codes_q.data_ptr(),
            queries.data_ptr(), q_weight.data_ptr(), mu.data_ptr(),
            beta_q.data_ptr(), r_min.data_ptr(), b, beta, q, d, int(boff),
            int(n_valid), int(c), int(n_levels), _bf16(points), float(p),
            hist_f.data_ptr(), hist_g.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("fused_query_hist", err, launch_counts)
    return hist_f, hist_g


@fused_query_hist.register_fake
def _hist_fake(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
               r_min, *, boff, n_valid, c, n_levels, p):
    shape = (queries.shape[0], n_levels + 3)
    return (codes_p.new_empty(shape, dtype=torch.int32),
            codes_p.new_empty(shape, dtype=torch.int32))


@torch.library.custom_op("repro_torch::fused_query_scores", mutates_args=(),
                         device_types="cpu")
def fused_query_scores(codes_p: Tensor, points: Tensor, codes_q: Tensor,
                       queries: Tensor, q_weight: Tensor, mu: Tensor,
                       beta_q: Tensor, stop: Tensor, *, boff: int,
                       n_valid: int, c: int, n_levels: int,
                       p: float) -> Tensor:
    """Pass 2 over rows ``codes_p``/``points`` (float32 or bfloat16):
    (Q, B) float32 scores.

    The weighted distance where the row's first-frequent level is at most
    ``stop[q]`` and the row is live, +inf elsewhere.
    """
    row_ok = _row_ok(codes_p.shape[0], boff, n_valid, codes_p.device)
    return ref.fused_query_scores_ref(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q, stop,
        row_ok, c=c, n_levels=n_levels, p=p)


@fused_query_scores.register_kernel("cuda")
def _scores_cuda(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
                 stop, *, boff, n_valid, c, n_levels, p):
    dev, b, beta, q, d = _check_inputs(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q,
        stop, "stop", torch.int32)
    scores = torch.empty((q, b), dtype=torch.float32, device=dev)
    fn = _cuda.function("wlsh_fused_query_scores", _SCORES_ARGS)
    with torch.cuda.device(dev):
        err = fn(
            codes_p.data_ptr(), points.data_ptr(), codes_q.data_ptr(),
            queries.data_ptr(), q_weight.data_ptr(), mu.data_ptr(),
            beta_q.data_ptr(), stop.data_ptr(), b, beta, q, d, int(boff),
            int(n_valid), int(c), int(n_levels), _bf16(points), float(p),
            scores.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("fused_query_scores", err, launch_counts)
    return scores


@fused_query_scores.register_fake
def _scores_fake(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
                 stop, *, boff, n_valid, c, n_levels, p):
    return codes_p.new_empty((queries.shape[0], codes_p.shape[0]),
                             dtype=torch.float32)


def occupancy(which: str, c: int, n_levels: int) -> dict:
    """What one launch of pass ``which`` ("hist" or "scores") at (c, L)
    gets on the current card: dynamic shared bytes per block, resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers per thread, and the kernel's ROWS, QT and TC."""
    return _cuda.occupancy("wlsh_fused_query_occupancy", _OCC_KEYS,
                           0 if which == "hist" else 1, int(c),
                           int(n_levels))
