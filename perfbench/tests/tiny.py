"""A copy of the benchmark with one more configuration, mix and cell at a
size the CPU tests hold (n = 1,024, d = 16, |S| = 8), added as files
and entries only, as a later change would add them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import spec

CONFIG = dict(
    name="tiny-l2", source="test", n=1024, d=16, value_range=10000, p=2.0,
    c=3, eps=0.01, gamma_n=100, k=5, tau=500, v=4, v_prime=4, n_weights=8,
    n_subset=4, n_subrange=20, weight_seed=1, q_batch=4,
    vec_dtype="float32")
# p = 0.5 with 64-bit bucket ids, as the weighted-l0.5 deployment stores
# them: at this size 3-5% of its ids lie outside int32.  The plan is the
# same from tau 500 up; 2,000 is the paper's tau at p = 0.5.
CONFIG_L05 = dict(CONFIG, name="tiny-l05", p=0.5, tau=2000, code_bits=64)
MIX = dict(loop="closed", clients=1, request_queries=4,
           weight_mix="per_request", weight_order="balanced", order_seed=1,
           query_noise_std=3.0, pool_requests=16, check_requests=4)
LIMITS = {"answers_off_pct": 0.0, "dist_err_max": 1e-5}


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``perfbench/`` copied under ``dst``."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def add_cell(root: Path, name: str = "tiny", config: dict = CONFIG,
             mix: dict = MIX, limits: dict = LIMITS) -> None:
    """A configuration, a mix and a cell over them, as new files and new
    entries of ``BENCHMARK.json``."""
    pb = root / "perfbench"
    cfg_name, mix_name = f"{name}-cfg", f"{name}-mix"
    (pb / "configs" / f"{cfg_name}.json").write_text(
        json.dumps(dict(config, name=cfg_name)))
    (pb / "traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    (pb / "checks" / f"{name}.json").write_text(
        json.dumps({"limits": limits}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name=cfg_name, source="test", reduced=[], why="test",
        file=f"perfbench/configs/{cfg_name}.json"))
    bench["workloads"].append(dict(name=name, config=cfg_name,
                                   traffic=mix_name, chips=1, why="test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
