"""Finding a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; everything else is found from those names:

* the configuration: the file its ``configs`` entry names;
* the traffic mix: ``perfbench/traffic/<traffic>.json``;
* the limits of the correctness check: ``perfbench/checks/<cell>.json``;
* each metric: ``perfbench/metrics/<metric>.py``, a reader with a
  ``read(run)`` function, for every metric whose ``workloads`` lists the
  cell or that has no such list.

A new cell, mix or metric is therefore new files and entries only.

A configuration file may say how wide the bucket ids are that its
deployment stores (``code_bits``, 32 where absent, or 64); the plain
reference and the yardstick read that width from it (``code_bits``).
Where the file states it, the program is handed it too, as
``WLSHIndex(code_bits=...)``; where absent, the program keeps its own 32.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CODE_BITS = (32, 64)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the mix file's contents
    limits: dict  # compared number -> its limit
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def code_bits(config: dict) -> int:
    """The width of the bucket ids the configuration's deployment stores:
    32 (two's-complement wrap of the exact id, as ``hash_codes_np`` stores
    it) where the file says nothing, or 64; raises ValueError otherwise."""
    bits = config.get("code_bits", 32)
    if type(bits) is not int or bits not in CODE_BITS:
        raise ValueError(f"code_bits {bits!r} in configuration "
                         f"{config.get('name')!r}: 32 or 64")
    return bits


def _covers(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The named cell of ``bench``, its files read from ``root``."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    w = entries[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    here = root / "perfbench"

    def read(path: Path) -> dict:
        with open(path) as fh:
            return json.load(fh)

    config = read(root / cfg_entry["file"])
    code_bits(config)  # a width the reference cannot hold is refused here
    return Cell(
        name=workload,
        config=config,
        traffic=read(here / "traffic" / f"{w['traffic']}.json"),
        limits=read(here / "checks" / f"{workload}.json")["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _covers(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _covers(m, workload)],
    )


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of metric ``name``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise KeyError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
