"""The port's copies of the host-search examples run and print what the
JAX package's examples print (both are host numpy, seeded)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _main(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("name", ["quickstart", "multi_weight_recsys"])
def test_example_matches_reference(name, capsys):
    _main(f"{name}_torch")()
    got = capsys.readouterr().out
    _main(name)()
    assert got == capsys.readouterr().out
    assert "avg overall ratio" in got
