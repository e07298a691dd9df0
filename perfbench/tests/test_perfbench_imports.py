"""What the benchmark's files import, read from their source by ``ast``.

No file under ``perfbench/`` imports JAX or the JAX package, compared by
whole top-level names (``repro_torch`` begins with ``repro`` and is
allowed), and the plain reference imports nothing of the program.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench import spec

FILES = sorted(p for p in (spec.HERE).rglob("*.py")
               if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    """Top-level names of every module ``path`` imports (relative
    imports as the package they start from)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("perfbench" if node.level else
                      node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "repro_torch" not in names
    # nor any part of the harness that drives the program
    assert names <= {"__future__", "dataclasses", "functools", "math",
                     "numpy", "scipy", "torch", "perfbench"}
    if "perfbench" in names:
        tree = ast.parse(path.read_text())
        mods = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level}
        assert mods <= {None}  # only the reference package itself


def test_the_check_catches_a_whole_name_only():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_the_run_fixes_the_blas_pool_before_numpy_loads():
    """``run.py`` sizes numpy's OpenBLAS pool before anything loads numpy,
    whatever the environment asked for."""
    pytest.importorskip("threadpoolctl")
    code = ("import json, threadpoolctl, perfbench.run as r; print(json.dumps("
            "[r.BLAS_THREADS] + [p['num_threads'] for p in "
            "threadpoolctl.threadpool_info() if p['internal_api'] == "
            "'openblas']))")
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=spec.ROOT)
    want, *pools = json.loads(out.stdout.splitlines()[-1])
    assert pools and all(n == min(want, os.cpu_count()) for n in pools)
