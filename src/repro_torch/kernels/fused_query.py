"""Fused WLSH query passes: CUDA C++ kernels and their wrappers.

The kernels in ``csrc/fused_query.cu`` carry the engine's two passes over
one table group's state (see the source note there for the design):

  pass 1  ``fused_query_hist``   -> (hist_f, hist_g), each (Q, L+3) int32
  pass 2  ``fused_query_scores`` -> (Q, B) float32 stop-masked distances

and the serving path's single scan, the same two passes without a second
pass over the state:

  pass 1  ``fused_query_keep``   -> (hist_f, hist_g, lf, dist): pass 1's
                                    histograms and its carry, each (query,
                                    row)'s first-frequent level (Q, B) uint8
                                    and distance (Q, B) float32
  pass 2  ``fused_query_mask``   -> dist set to +inf in place where
                                    lf > stop[q]: pass 2's scores, bit for bit

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
    "fused_query_keep",
    "fused_query_mask",
    "fused_query_scores",
    "launch_counts",
    "occupancy",
    "reset_launch_counts",
]

launch_counts = _cuda.counter("fused_query_hist", "fused_query_scores",
                              "fused_query_keep", "fused_query_mask")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HIST_ARGS = [_P] * 8 + [_I] * 9 + [_F, _P, _P, _P, _P, _P]
_MASK_ARGS = [_P] * 3 + [_I] * 2 + [_P]
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


def _check_byte_levels(n_levels: int) -> None:
    """The keep form stores levels 0..L+2 as bytes."""
    if n_levels + 2 > 255:
        raise ValueError(f"n_levels={n_levels}: the keep form stores levels "
                         f"up to L + 2 in a byte, so L + 2 must be <= 255")


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


def _pass1_cuda(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
                r_min, boff, n_valid, c, n_levels, p, keep: bool):
    """Pass 1 on the card: (hist_f, hist_g), and with ``keep`` its carry
    (lf, dist) besides."""
    dev, b, beta, q, d = _check_inputs(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q,
        r_min, "r_min", torch.float32)
    hist_f = torch.zeros((q, n_levels + 3), dtype=torch.int32, device=dev)
    hist_g = torch.zeros_like(hist_f)
    carry = ((torch.empty((q, b), dtype=torch.uint8, device=dev),
              torch.empty((q, b), dtype=torch.float32, device=dev))
             if keep else ())
    fn = _cuda.function("wlsh_fused_query_hist", _HIST_ARGS)
    with torch.cuda.device(dev):
        err = fn(
            codes_p.data_ptr(), points.data_ptr(), codes_q.data_ptr(),
            queries.data_ptr(), q_weight.data_ptr(), mu.data_ptr(),
            beta_q.data_ptr(), r_min.data_ptr(), b, beta, q, d, int(boff),
            int(n_valid), int(c), int(n_levels), _bf16(points), float(p),
            hist_f.data_ptr(), hist_g.data_ptr(),
            *([t.data_ptr() for t in carry] if keep else [None, None]),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("fused_query_keep" if keep else "fused_query_hist", err,
                   launch_counts)
    return (hist_f, hist_g, *carry)


@fused_query_hist.register_kernel("cuda")
def _hist_cuda(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
               r_min, *, boff, n_valid, c, n_levels, p):
    return _pass1_cuda(codes_p, points, codes_q, queries, q_weight, mu,
                       beta_q, r_min, boff, n_valid, c, n_levels, p,
                       keep=False)


@fused_query_hist.register_fake
def _hist_fake(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
               r_min, *, boff, n_valid, c, n_levels, p):
    shape = (queries.shape[0], n_levels + 3)
    return (codes_p.new_empty(shape, dtype=torch.int32),
            codes_p.new_empty(shape, dtype=torch.int32))


@torch.library.custom_op("repro_torch::fused_query_keep", mutates_args=(),
                         device_types="cpu")
def fused_query_keep(codes_p: Tensor, points: Tensor, codes_q: Tensor,
                     queries: Tensor, q_weight: Tensor, mu: Tensor,
                     beta_q: Tensor, r_min: Tensor, *, boff: int,
                     n_valid: int, c: int, n_levels: int,
                     p: float) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Pass 1 that keeps its per-(query, row) results: (hist_f, hist_g)
    (Q, L+3) as ``fused_query_hist``, lf (Q, B) uint8 and dist (Q, B)
    float32.

    lf is the first-frequent level, L+2 for a dead row; dist the weighted
    distance, +inf for a dead row.  ``fused_query_mask`` turns them into
    ``fused_query_scores``' output.  L + 2 > 255 raises.
    """
    _check_byte_levels(n_levels)
    row_ok = _row_ok(codes_p.shape[0], boff, n_valid, codes_p.device)
    return ref.fused_query_keep_ref(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q, r_min,
        row_ok, c=c, n_levels=n_levels, p=p)


@fused_query_keep.register_kernel("cuda")
def _keep_cuda(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
               r_min, *, boff, n_valid, c, n_levels, p):
    _check_byte_levels(n_levels)
    return _pass1_cuda(codes_p, points, codes_q, queries, q_weight, mu,
                       beta_q, r_min, boff, n_valid, c, n_levels, p,
                       keep=True)


@fused_query_keep.register_fake
def _keep_fake(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
               r_min, *, boff, n_valid, c, n_levels, p):
    shape = (queries.shape[0], n_levels + 3)
    cells = (queries.shape[0], codes_p.shape[0])
    return (codes_p.new_empty(shape, dtype=torch.int32),
            codes_p.new_empty(shape, dtype=torch.int32),
            codes_p.new_empty(cells, dtype=torch.uint8),
            codes_p.new_empty(cells, dtype=torch.float32))


@torch.library.custom_op("repro_torch::fused_query_mask",
                         mutates_args=("dist",), device_types="cpu")
def fused_query_mask(lf: Tensor, stop: Tensor, dist: Tensor) -> None:
    """Pass 2 on ``fused_query_keep``'s carry: ``dist`` (Q, B) float32 set
    to +inf in place where ``lf`` (Q, B) uint8 > ``stop[q]`` (Q,) int32."""
    ref.fused_query_mask_ref(lf, stop, dist)


@fused_query_mask.register_kernel("cuda")
def _mask_cuda(lf, stop, dist):
    dev = dist.device
    q, b = dist.shape
    for args in (("lf", lf, torch.uint8, (q, b)),
                 ("stop", stop, torch.int32, (q,)),
                 ("dist", dist, torch.float32, (q, b))):
        _cuda.check(*args, dev)
    fn = _cuda.function("wlsh_fused_query_mask", _MASK_ARGS)
    with torch.cuda.device(dev):
        err = fn(lf.data_ptr(), stop.data_ptr(), dist.data_ptr(), b, q,
                 torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launched("fused_query_mask", err, launch_counts)


@fused_query_mask.register_fake
def _mask_fake(lf, stop, dist):
    return None


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
    """What one launch of pass ``which`` ("hist", "keep" or "scores") at
    (c, L) gets on the current card: dynamic shared bytes per block,
    resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers per thread, and the kernel's ROWS, QT and TC.  "keep" is
    pass 1's kernel with its carry's pointers set, so it reads as "hist"."""
    return _cuda.occupancy("wlsh_fused_query_occupancy", _OCC_KEYS,
                           1 if which == "scores" else 0, int(c),
                           int(n_levels))
