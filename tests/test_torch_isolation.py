"""The port stands alone: no JAX, no JAX package, no ml_dtypes, and the
card by default.

* Every ``repro_torch`` and ``benchmarks_torch`` module imports in a
  fresh interpreter in which ``jax``, ``repro``, ``benchmarks`` and
  ``ml_dtypes`` cannot be imported at all.
* No source file of the port (nor ``chip_smoke.py``, the port's
  ``benchmarks_torch/`` scripts and its ``examples/*_torch.py``)
  mentions an import of ``jax``, of the ``repro`` package
  (``repro_torch`` itself is fine), of the JAX package's ``benchmarks``
  (``benchmarks_torch`` is fine) or of ``ml_dtypes`` (bfloat16 data
  moves as torch tensors).
* Entry points default to ``device="cuda"`` and raise when no CUDA device
  is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.params import PlanConfig
from repro_torch.core.wlsh import WLSHIndex
from repro_torch.index import IndexConfig, build_group_state
from repro_torch.kernels.platform import resolve_device
from repro_torch.launch import retrieval as launch
from repro_torch.serving import RetrievalService, ServiceConfig

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
BENCH = ROOT / "benchmarks_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro\b(?!_)|from\s+repro\.|import\s+benchmarks\b(?!_)|"
    r"from\s+benchmarks\b(?!_)|from\s+benchmarks\.|"
    r"import\s+ml_dtypes\b|from\s+ml_dtypes\b)", re.M)


def _modules() -> list[str]:
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(info.name)
    names += [f"benchmarks_torch.{f.stem}" for f in sorted(BENCH.glob("*.py"))]
    return names


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.fused_query" in mods
    assert "repro_torch.launch.retrieval" in mods
    assert "repro_torch.index.streaming" in mods
    assert "repro_torch.serving.delta" in mods
    for name in ("core.c2lsh", "core.e2lsh", "core.alsh"):
        assert f"repro_torch.{name}" in mods
    for name in ("sentinel", "run", "table8_ratio", "fig1_query"):
        assert f"benchmarks_torch.{name}" in mods
    for name in ("trace", "profile", "recall", "health"):
        assert f"repro_torch.obs.{name}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'benchmarks'"
        " or m.startswith('benchmarks.') or m == 'ml_dtypes']\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_never_import_jax_or_repro():
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted(BENCH.glob("*.py"))
             + sorted((ROOT / "examples").glob("*_torch.py")))
    assert len(files) > 10
    assert ROOT / "examples" / "quickstart_torch.py" in files
    assert BENCH / "sentinel.py" in files
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True),
    ("from jax import numpy", True),
    ("import repro", True),
    ("from repro.core import wlsh", True),
    ("from repro import core", True),
    ("import benchmarks", True),
    ("from benchmarks import sentinel", True),
    ("from benchmarks.common import TAU", True),
    ("from benchmarks_torch import sentinel", False),
    ("import benchmarks_torch.sentinel", False),
    ("import ml_dtypes", True),
    ("from ml_dtypes import bfloat16", True),
    ("import repro_torch", False),
    ("from repro_torch.core import wlsh", False),
    ("    from ..core import wlsh", False),
])
def test_forbidden_import_pattern(line, bad):
    assert bool(_FORBIDDEN.search(line)) is bad


def test_package_docstring_names_the_port():
    assert "torch" in repro_torch.__doc__


@pytest.fixture(scope="module")
def tiny():
    data = make_dataset(n=256, d=8, seed=3)
    weights = make_weight_set(size=4, d=8, n_subset=2, n_subrange=10, seed=4)
    host = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=256),
                     tau=500.0, v=4, v_prime=4, seed=5)
    return data, host.export_serving_plan()


def _raises_without_cuda(fn):
    """Without a card the call must raise; with one it must not."""
    if torch.cuda.is_available():
        fn()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


def test_entry_points_default_to_cuda(tiny):
    data, plan = tiny
    assert ServiceConfig().device == "cuda"
    _raises_without_cuda(lambda: resolve_device())
    _raises_without_cuda(lambda: RetrievalService(plan, data))
    cfg = IndexConfig(n=256, d=8, beta=256)
    big = max(plan.groups, key=lambda g: g.beta_group)
    _raises_without_cuda(lambda: build_group_state(
        IndexConfig(n=256, d=8, beta=((big.beta_group + 31) // 32) * 32),
        data, big))
    assert cfg.use_kernels == "on"
    args = launch.parse_args(["--n", "64"])
    assert args.device == "cuda"


def test_cpu_runs_only_when_asked(tiny):
    data, plan = tiny
    svc = RetrievalService(plan, data, cfg=ServiceConfig(k=3, q_batch=2,
                                                         device="cpu"))
    res = svc.query(data[:3], np.array([0, 1, 2]))
    assert res.ids.shape == (3, 3)
    assert svc.device.type == "cpu"
    for gi in svc.state_cache.resident_group_ids():
        with svc.state_cache.lease(gi) as st:
            assert st.codes.device.type == "cpu"
