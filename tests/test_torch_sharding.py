"""The port's logical-axis sharding rules (``distributed/sharding.py``)
against the JAX package's.

* ``spec`` equals the JAX ``spec`` on every ``ParamDef`` leaf of every LM
  arch's full-size ``defs()`` and of its train state (float32 and int8
  moments), on stand-in meshes of the production shapes (16, 16) and
  (2, 16, 16), and on the decode caches under the dry-run's ``kv_seq``
  rules.
* ``_kv_repeat`` equals the JAX one for every arch at model = 16, 8, 2.
* The strict and warn-once contracts of ``tests/test_group_sharding.py``.
* On a (4, 2) mesh, the local shard of every leaf of the reduced archs'
  train states (``distribute`` over a ``DeviceMesh`` of a fake process
  group, in a child process, as each of the 8 ranks) has the shape JAX's
  ``NamedSharding.shard_shape`` gives on an Auto-axes mesh of 8 forced
  host devices (another child process).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.distributed.sharding import spec as jax_spec
from repro.distributed.sharding import with_rules as jax_with_rules
from repro.models import build_model as jax_build_model
from repro.models.params import ParamDef as JaxParamDef
from repro.models.transformer import _kv_repeat as jax_kv_repeat
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.train_loop import train_state_defs as jax_state_defs
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.sharding import spec, with_rules
from repro_torch.models import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import _kv_repeat
from repro_torch.training import AdamWConfig, train_state_defs

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = [a for a in ARCHS if a != "wlsh_index"]
MESHES = {"single": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}
# the dry-run's decode rules: the cache sequence over the data axes (batch
# too small), over "model" (MHA heads that cannot shard), or both
KV_RULES = [(), ("data",), ("pod", "data"), ("model",),
            ("pod", "data", "model")]


class _FakeMesh:
    """Just enough of a mesh for ``spec`` (axis names and sizes)."""

    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


def _jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JaxParamDef))


def _pairs(arch: str):
    """(JAX defs, port defs) of the arch's params and train states."""
    jd = jax_build_model(jax_get_config(arch), mesh=None).defs()
    pd = build_model(get_config(arch)).defs()
    out = [(jd, pd)]
    for mom in ("float32", "int8"):
        out.append((jax_state_defs(jd, JaxAdamWConfig(moment_dtype=mom)),
                    train_state_defs(pd, AdamWConfig(moment_dtype=mom))))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_matches_jax_on_every_leaf(arch, mesh_name):
    mesh = _FakeMesh(**MESHES[mesh_name])
    n = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for jd, pd in _pairs(arch):
            jl, pl = _jax_leaves(jd), tree_leaves(pd)
            assert len(jl) == len(pl)
            for j, p in zip(jl, pl):
                assert (tuple(j.shape), tuple(j.names)) == (p.shape, p.names)
                want = tuple(jax_spec(mesh, j.names, j.shape))
                assert spec(mesh, p.names, p.shape) == want, (p, want)
                assert spec(mesh, p.names) == tuple(jax_spec(mesh, j.names))
                n += 1
    assert n > 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_cache_specs_match_jax_under_kv_seq_rules(arch, mesh_name):
    mesh = _FakeMesh(**MESHES[mesh_name])
    names = {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
             "v": ("layers", "batch", "kv_seq", "kv_heads", None),
             "ssm": ("layers", "batch", "heads", None, None),
             "conv": ("layers", "batch", None, "model")}
    jc = jax_build_model(jax_get_config(arch), mesh=mesh).cache_shapes(
        128, 32_768)
    pc = build_model(get_config(arch), mesh=mesh).cache_shapes(128, 32_768)
    assert {k: tuple(v.shape) for k, v in jc.items()} == {
        k: tuple(v.shape) for k, v in pc.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for axes in KV_RULES:
            rules = {"kv_seq": axes} if axes else {}
            with jax_with_rules(**rules), with_rules(**rules):
                for k, s in pc.items():
                    want = tuple(jax_spec(mesh, names[k], tuple(s.shape)))
                    assert spec(mesh, names[k], tuple(s.shape)) == want


@pytest.mark.parametrize("model", [16, 8, 2])
def test_kv_repeat_matches_jax(model):
    mesh = _FakeMesh(data=16, model=model)
    for arch in LM_ARCHS:
        assert _kv_repeat(get_config(arch), mesh) == jax_kv_repeat(
            jax_get_config(arch), mesh), arch
        assert _kv_repeat(get_config(arch), None) == 1


def test_spec_strict_raises_on_non_dividing_dim():
    mesh = _FakeMesh(data=8, model=1)
    with pytest.raises(ValueError, match="strict sharding refuses"):
        spec(mesh, ("rows", None), (1003, 16), strict=True)
    # a dividing shape passes strict and shards over the present axes
    p = spec(mesh, ("rows", None), (1008, 16), strict=True)
    assert p == spec(mesh, ("rows", None), (1008, 16))
    assert p == tuple(jax_spec(mesh, ("rows", None), (1008, 16)))


def test_spec_replication_fallback_warns_once_per_shape():
    mesh = _FakeMesh(data=8, model=1)
    shape = (1001, 5)  # unique shape so the warn-once set can't be primed
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p1 = spec(mesh, ("rows", None), shape)
        p2 = spec(mesh, ("rows", None), shape)
    assert p1 == p2 == (None, None)  # replicated fallback, both calls
    msgs = [str(x.message) for x in w if x.category is UserWarning]
    assert len(msgs) == 1, msgs  # once per (name, shape), not per call
    assert "replicating" in msgs[0] and "8x" in msgs[0]


# --------------------------------------------------- local shard shapes

_PORT_SHARDS = """
import json, sys, warnings
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config, reduced
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.models import abstract_params, build_model
from repro_torch.models.params import distribute, param_shardings, tree_leaves
from repro_torch.training import AdamWConfig, train_state_defs
import torch.distributed as dist

warnings.simplefilter("ignore")
archs = json.loads(sys.argv[1])
out = {}
for rank in range(8):
    # the fake group's rank stands in for each device of the mesh
    dist.init_process_group("fake", rank=rank, world_size=8,
                            store=FakeStore())
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                      mesh_dim_names=("data", "model"))
    for arch in archs:
        defs = train_state_defs(build_model(reduced(get_config(arch))).defs(),
                                AdamWConfig(moment_dtype="int8"))
        tree = distribute(abstract_params(defs), param_shardings(defs, mesh))
        out.setdefault(arch, []).append(
            [list(t.to_local().shape) for t in tree_leaves(tree)])
    dist.destroy_process_group()
print(json.dumps(out))
"""

_JAX_SHARDS = """
import json, sys, warnings
import jax
from jax.sharding import AxisType, NamedSharding
from repro.configs.base import get_config, reduced
from repro.distributed.sharding import spec
from repro.models import build_model
from repro.models.params import ParamDef
from repro.training.optimizer import AdamWConfig
from repro.training.train_loop import train_state_defs

warnings.simplefilter("ignore")
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in json.loads(sys.argv[1]):
    defs = train_state_defs(build_model(reduced(get_config(arch)),
                                        mesh=None).defs(),
                            AdamWConfig(moment_dtype="int8"))
    leaves = jax.tree.leaves(defs, is_leaf=lambda x: isinstance(x, ParamDef))
    out[arch] = [list(NamedSharding(mesh, spec(mesh, d.names, d.shape))
                      .shard_shape(d.shape)) for d in leaves]
print(json.dumps(out))
"""


def _child(code: str, env_extra: dict, timeout: int = 300):
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               **env_extra)
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), json.dumps(LM_ARCHS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _result(proc, timeout: int = 300) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_local_shard_shapes_match_jax_shard_shape():
    jproc = _child(_JAX_SHARDS, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})
    pproc = _child(_PORT_SHARDS, {"OMP_NUM_THREADS": "1"})
    want, got = _result(jproc), _result(pproc)
    for arch in LM_ARCHS:
        for rank in range(8):  # every rank holds a shard of one shape
            assert got[arch][rank] == want[arch], (arch, rank)
