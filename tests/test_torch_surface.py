"""The port's public surface covers the JAX package's.

Every ``src/repro/**/*.py`` is read with ``ast`` beside its twin under
``src/repro_torch/`` (neither package is imported).  Each public
top-level function, class and constant of the reference (``__version__``
too) and each public member of its classes (methods, properties, fields
and class attributes) must be defined in the twin.  Where both have an
``__all__``, the twin's lists each name the reference's lists and
defines; a package ``__init__``'s lists every name the reference's does.
The only exceptions are ``EXCEPTED``, each with its reason: a name there
that turns up in the port fails too, so the list stays true.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

_DEVICE_FORM = "a JAX device form; the port's equivalent is {}"
_CSRC = "a Pallas kernel; its port is the CUDA C++ in kernels/csrc/ ({})"
_TPU = "a TPU switch; the port's kernels/platform.resolve picks the route"
_NO_MESH = ("serving runs on a device list; there is no torch.distributed "
            "frontend")
_NO_PALLAS = "the Pallas route knob; the port's use_kernels picks the route"
_REVIEWED = ("not a RunFlags switch in the port: every layer is "
             "rematerialized under autograd, the sequence-sharded boundary "
             "is its only layout, and its loops are Python loops")
_HOST_LISTS = "the per-shard states are HostShardedState.shards / .offsets"

# (module relative to the package root, name) -> the reason it has no
# counterpart in the port
EXCEPTED = {
    ("__init__.py", "__version__"):
        "the port is versioned with the repository, not on its own",
    ("core/families.py", "hash_codes"):
        _DEVICE_FORM.format("ops.hash_encode"),
    ("core/distances.py", "weighted_lp"):
        _DEVICE_FORM.format("kernels/ref.py weighted_lp_ref"),
    ("core/pstable.py", "sample_pstable"):
        "draws jax.random bits torch cannot reproduce; the port keeps "
        "sample_pstable_np",
    ("core/wlsh.py", "BuiltGroup.sorted_codes"):
        "renamed: BuiltGroup.sorted_tables() sorts on first use",
    ("core/wlsh.py", "BuiltGroup.sorted_ids"):
        "renamed: BuiltGroup.sorted_tables() sorts on first use",
    **{("distributed/group_sharding.py", f"HostShardedState.{f}"): _HOST_LISTS
       for f in ("codes", "points", "proj", "b_int", "b_frac", "width")},
    ("distributed/group_sharding.py", "serving_mesh"): _NO_MESH,
    ("serving/retrieval.py", "RetrievalService.mesh"): _NO_MESH,
    ("index/config.py", "IndexConfig.use_pallas"): _NO_PALLAS,
    ("index/config.py", "IndexConfig.analysis_unroll"):
        "XLA's loop-body counting; the port's StepCounter counts every "
        "launch",
    ("index/config.py", "IndexConfig.width_placeholder"):
        "the width is folded into the projection before the state exists",
    ("index/config.py", "IndexConfig.block_n"):
        "the Pallas row block; the CUDA kernels pick their own blocks",
    ("index/config.py", "IndexConfig.shard_axis"):
        "the mesh steps lay rows over every mesh axis; serving shards over "
        "a device list",
    ("serving/batching.py", "ServiceConfig.use_pallas"): _NO_PALLAS,
    ("serving/batching.py", "ServiceConfig.block_n"):
        "the Pallas row block; the CUDA kernels pick their own blocks",
    ("serving/batching.py", "ServiceConfig.host_encode"):
        "decided: host_encode=False is left out; a plan without host codes "
        "encodes on the device",
    ("models/transformer.py", "RunFlags.remat"): _REVIEWED,
    ("models/transformer.py", "RunFlags.analysis_unroll"): _REVIEWED,
    ("models/transformer.py", "RunFlags.seq_shard_boundary"): _REVIEWED,
    ("kernels/fused_query.py", "fused_query_hist_pallas"):
        _CSRC.format("fused_query.cu"),
    ("kernels/fused_query.py", "fused_query_scores_pallas"):
        _CSRC.format("fused_query.cu"),
    ("kernels/fused_query.py", "nbins"):
        "the 128-lane padded bin count; the port's histograms have L+3 bins",
    ("kernels/hash_encode.py", "hash_encode_pallas"):
        _CSRC.format("hash_encode.cu"),
    ("kernels/freq_level.py", "freq_level_pallas"):
        _CSRC.format("freq_level.cu"),
    ("kernels/weighted_lp.py", "weighted_lp_pallas"):
        _CSRC.format("weighted_lp.cu"),
    ("kernels/ops.py", "on_tpu"): _TPU,
    **{("kernels/platform.py", n): _TPU
       for n in ("on_tpu", "set_platform", "gpu_pallas_supported",
                 "backend", "default_use_pallas", "KernelPath.pallas",
                 "KernelPath.interpret")},
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _targets(node) -> list[str]:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _all(tree: ast.Module) -> set[str] | None:
    for node in tree.body:
        if "__all__" in _targets(node):
            return set(ast.literal_eval(node.value))
    return None


def _members(cls: ast.ClassDef) -> set[str]:
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        out.update(_targets(node))
    return {f"{cls.name}.{m}" for m in out if _public(m)}


def _surface(path: Path) -> tuple[set[str], set[str] | None]:
    """(public names defined at the top level and in classes, __all__)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names |= _members(node)
        names.update(_targets(node))
    names = {n for n in names if _public(n) or n == "__version__"}
    return names, _all(tree)


def _modules() -> list[str]:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _missing(rel: str) -> set[str]:
    """The reference's public names of ``rel`` without a counterpart in
    the port's twin (excepted names included)."""
    ref_names, ref_all = _surface(REF / rel)
    twin = PORT / rel
    if not twin.exists():
        return ref_names | (ref_all or set())
    names, port_all = _surface(twin)
    want = set(ref_names)
    if ref_all is not None and port_all is not None:
        # exported like its neighbours: a package re-exports every name of
        # the reference's __all__, a module the ones it defines
        exported = (ref_all if rel.endswith("__init__.py")
                    else ref_all & ref_names)
        want |= {f"__all__:{n}" for n in exported}
        names |= {f"__all__:{n}" for n in port_all}
    return want - names


def _key(name: str) -> str:
    return name.removeprefix("__all__:")


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    missing = sorted(n for n in _missing(rel)
                     if (rel, _key(n)) not in EXCEPTED)
    assert not missing, (
        f"src/repro/{rel}: no counterpart in src/repro_torch/{rel} for "
        f"{missing}; port them, or add each to EXCEPTED with its reason")


def test_every_exception_is_still_needed():
    """An exception whose name the port now has, or the reference no
    longer has, is stale."""
    stale = [f"{rel}: {name}" for rel, name in EXCEPTED
             if (name if name in _surface(REF / rel)[0]
                 else f"__all__:{name}") not in _missing(rel)]
    assert not stale, f"exceptions with nothing to except: {stale}"
    assert all(reason.strip() for reason in EXCEPTED.values())


@pytest.mark.parametrize("rel,name", [
    ("core/families.py", "sample_hamming_family"),
    ("core/families.py", "hamming_codes_np"),
    ("core/families.py", "sample_angular_family"),
    ("core/families.py", "angular_codes_np"),
    ("core/distances.py", "weighted_hamming_np"),
    ("core/distances.py", "weighted_angular_np"),
    ("core/derived.py", "angular_bounds"),
    ("kernels/ref.py", "count_level_ref"),
    ("index/builder.py", "fold_center_weight"),
    ("index/builder.py", "build_state"),
    ("index/config.py", "IndexConfig.gamma"),
])
def test_a_name_taken_out_of_the_port_is_found(rel, name, tmp_path,
                                               monkeypatch):
    """The walk sees a removal: the twin without ``name`` misses it."""
    leaf = name.split(".")[-1]

    class Drop(ast.NodeTransformer):
        def visit_FunctionDef(self, node):
            return None if node.name == leaf else node

    assert not _missing(rel) - {f"__all__:{n}" for _, n in EXCEPTED} - {
        n for r, n in EXCEPTED if r == rel}
    twin = tmp_path / "repro_torch" / rel
    twin.parent.mkdir(parents=True)
    twin.write_text(ast.unparse(Drop().visit(ast.parse(
        (PORT / rel).read_text()))))
    monkeypatch.setattr(sys.modules[__name__], "PORT",
                        tmp_path / "repro_torch")
    assert name in _missing(rel)
