"""One build of every CUDA C++ source of the port, and the launch counts.

``build()`` compiles each ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
an object file, all at once in parallel, and links them into one shared
library with a plain C interface, loaded through ``ctypes``.  It runs at
first use, lands in ``build/repro_torch_kernels/`` at the repository root
and is keyed by a hash of every source and header under ``csrc/`` plus
the flags.  Nothing is built when a module is imported.

The kernels are built without ``--use_fast_math``: the hash floor, the
good-level ceil and the distances need the accurate ``logf``, ``powf``,
``sqrtf`` and division.

Each kernel wrapper counts its launches in a dict made by ``counter()``;
``launch_counts()`` merges them and ``reset_launch_counts()`` sets them
all to 0, so a run can show that its main path went through the kernels.
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

__all__ = [
    "NVCC_FLAGS",
    "build",
    "build_info",
    "check",
    "counter",
    "function",
    "launch_counts",
    "launched",
    "occupancy",
    "reset_launch_counts",
]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
_BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")

build_info: dict = {}  # path / seconds / cached / per-source ptxas report
_lib = None
_fns: dict = {}
_counts: list[dict] = []


def counter(*names: str) -> dict:
    """A launch-count dict for ``names``, registered for the resets."""
    counts = dict.fromkeys(names, 0)
    _counts.append(counts)
    return counts


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel name."""
    return {k: v for counts in _counts for k, v in counts.items()}


def reset_launch_counts() -> None:
    """Set every kernel launch count to 0."""
    for counts in _counts:
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _sources() -> tuple[list[Path], str]:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # .cu and .cuh
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return srcs, h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> list[str]:
    """Run every command at once; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile and link ``csrc/*.cu`` (once per sources/flags hash).

    Returns the shared library's path; ``build_info`` records the build
    seconds and, with ``verbose``, ptxas's register / shared-memory report
    per source.
    """
    srcs, key = _sources()
    out = _BUILD_DIR / f"libwlsh_kernels_{key}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in srcs]
        ptxas = _run([[nvcc, *NVCC_FLAGS,
                       *(["-Xptxas", "-v"] if verbose else []),
                       "-c", "-o", o, str(s)] for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False,
                      ptxas={s.name: r.strip() for s, r in zip(srcs, ptxas)})
    return out


def function(name: str, argtypes):
    """The C entry point ``name`` of the built library (built on first
    use), with its ``ctypes`` signature; every entry point returns the
    CUDA error code of its launch (0 = launched)."""
    global _lib
    fn = _fns.get(name)
    if fn is None:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def occupancy(name: str, keys, *args) -> dict:
    """What a kernel's launch gets on the current card, from the C entry
    point ``name``, which takes the int or float ``args`` and fills one
    int per key (e.g. shared bytes per block, resident blocks per SM,
    registers per thread)."""
    out = (ctypes.c_int * len(keys))()
    fn = function(name, [ctypes.c_float if isinstance(a, float)
                         else ctypes.c_int for a in args] + [ctypes.c_void_p])
    err = fn(*args, out)
    if err:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return dict(zip(keys, out))


def check(name, t, dtype, shape, dev) -> None:
    """Raise unless tensor ``t`` is on ``dev``, of ``dtype`` (or one of a
    tuple of dtypes) and ``shape``, and contiguous."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launched(name: str, err: int, counts: dict) -> None:
    """Raise if a launch failed, else count it."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counts[name] += 1
