"""Fused WLSH query passes: CUDA C++ kernels and their wrappers.

Two kernels in ``csrc/fused_query.cu`` carry the engine's two scan passes
over one table group's state (see the source note there for the design):

  pass 1  ``fused_query_hist``   -> (hist_f, hist_g), each (Q, L+3) int32
  pass 2  ``fused_query_scores`` -> (Q, B) float32 stop-masked distances

Each wrapper takes the plain torch version (``ref.py``) for tensors on the
CPU.  For CUDA tensors it checks device, dtype, contiguity and shape,
allocates the outputs, launches on the current stream and raises if the
launch fails; there is no fallback.  ``launch_counts`` counts kernel
launches per wrapper, so a run can show that its main path went through
the kernels.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``.  The build runs at
first use (``build()``), lands in ``build/repro_torch_kernels/`` at the
repository root and is keyed by a hash of the source and the flags.  It is built without ``--use_fast_math``: the
good-level ceil and the distances need the accurate ``logf``, ``powf``,
``sqrtf`` and division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from . import ref

__all__ = [
    "NVCC_FLAGS",
    "build",
    "fused_query_hist",
    "fused_query_scores",
    "launch_counts",
    "reset_launch_counts",
]

_SRC = Path(__file__).resolve().parent / "csrc" / "fused_query.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

launch_counts = {"fused_query_hist": 0, "fused_query_scores": 0}

_lib = None
build_info: dict = {}  # seconds / path / ptxas report of the last build()


def reset_launch_counts() -> None:
    """Set every kernel launch count to 0."""
    for name in launch_counts:
        launch_counts[name] = 0


_BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/fused_query.cu`` (once per source/flags hash).

    Returns the shared library's path; ``build_info`` records the build
    seconds and, with ``verbose``, ptxas's register/shared-memory report.
    """
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libwlsh_fused_query_{key}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(_SRC)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs, cached=False,
                      ptxas=(res.stdout + res.stderr).strip())
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wlsh_fused_query_hist.argtypes = (
            [P] * 8 + [I] * 8 + [F, P, P, P])
        lib.wlsh_fused_query_hist.restype = I
        lib.wlsh_fused_query_scores.argtypes = (
            [P] * 8 + [I] * 8 + [F, P, P])
        lib.wlsh_fused_query_scores.restype = I
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
                  last, last_name, last_dtype):
    dev = codes_p.device
    b, beta = codes_p.shape
    q, d = queries.shape
    for args in (("codes_p", codes_p, torch.int32, (b, beta)),
                 ("points", points, torch.float32, (b, d)),
                 ("codes_q", codes_q, torch.int32, (q, beta)),
                 ("queries", queries, torch.float32, (q, d)),
                 ("q_weight", q_weight, torch.float32, (q, d)),
                 ("mu", mu, torch.int32, (q,)),
                 ("beta_q", beta_q, torch.int32, (q,)),
                 (last_name, last, last_dtype, (q,))):
        _check(*args, dev)
    if max(b * max(beta, d), q * b) >= 2**31:
        raise ValueError("state too large for 32-bit row/column indices")
    return dev, b, beta, q, d


def _row_ok(b, boff, n_valid, dev):
    return (boff + torch.arange(b, device=dev)) < n_valid


def fused_query_hist(codes_p, points, codes_q, queries, q_weight, mu, beta_q,
                     r_min, *, boff: int, n_valid: int, c: int,
                     n_levels: int, p: float):
    """Pass 1 over rows ``codes_p``/``points``: (hist_f, hist_g) (Q, L+3).

    Bin j counts rows whose first-frequent (resp. good) level is j; bin L+2
    holds dead rows (``boff + row >= n_valid``); good levels above L+2
    fall outside every bin.
    """
    if codes_p.device.type == "cpu":
        row_ok = _row_ok(codes_p.shape[0], boff, n_valid, codes_p.device)
        return ref.fused_query_hist_ref(
            codes_p, points, codes_q, queries, q_weight, mu, beta_q, r_min,
            row_ok, c=c, n_levels=n_levels, p=p)
    dev, b, beta, q, d = _check_inputs(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q,
        r_min, "r_min", torch.float32)
    hist_f = torch.zeros((q, n_levels + 3), dtype=torch.int32, device=dev)
    hist_g = torch.zeros_like(hist_f)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.wlsh_fused_query_hist(
            codes_p.data_ptr(), points.data_ptr(), codes_q.data_ptr(),
            queries.data_ptr(), q_weight.data_ptr(), mu.data_ptr(),
            beta_q.data_ptr(), r_min.data_ptr(), b, beta, q, d, int(boff),
            int(n_valid), int(c), int(n_levels), float(p),
            hist_f.data_ptr(), hist_g.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_query_hist kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["fused_query_hist"] += 1
    return hist_f, hist_g


def fused_query_scores(codes_p, points, codes_q, queries, q_weight, mu,
                       beta_q, stop, *, boff: int, n_valid: int, c: int,
                       n_levels: int, p: float):
    """Pass 2 over rows ``codes_p``/``points``: (Q, B) float32 scores.

    The weighted distance where the row's first-frequent level is at most
    ``stop[q]`` and the row is live, +inf elsewhere.
    """
    if codes_p.device.type == "cpu":
        row_ok = _row_ok(codes_p.shape[0], boff, n_valid, codes_p.device)
        return ref.fused_query_scores_ref(
            codes_p, points, codes_q, queries, q_weight, mu, beta_q, stop,
            row_ok, c=c, n_levels=n_levels, p=p)
    dev, b, beta, q, d = _check_inputs(
        codes_p, points, codes_q, queries, q_weight, mu, beta_q,
        stop, "stop", torch.int32)
    scores = torch.empty((q, b), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.wlsh_fused_query_scores(
            codes_p.data_ptr(), points.data_ptr(), codes_q.data_ptr(),
            queries.data_ptr(), q_weight.data_ptr(), mu.data_ptr(),
            beta_q.data_ptr(), stop.data_ptr(), b, beta, q, d, int(boff),
            int(n_valid), int(c), int(n_levels), float(p),
            scores.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused_query_scores kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["fused_query_scores"] += 1
    return scores
