"""The port's training on a (4, 2) device mesh: 8 gloo ranks on the CPU
(``torchrun``), held to the JAX package's train step on a (4, 2) Auto-axes
mesh of 8 forced host devices, to its own one-device step, and across a
restart.

Parameters come from one numpy generator in both packages (``_PARAMS``,
the init kinds of ``ParamDef``) and the configs are the reduced ones in
float32, so the two packages compute the same function:

* reduced olmo-1b and olmoe-1b-7b, one train step: the loss to rtol 1e-5
  of JAX's mesh step, and olmoe's differs from the one-device loss of
  either package (the expert-parallel path drops tokens per data shard);
  the new master weights to rtol 1e-5, atol 7.5e-6: the first step moves
  each weight by lr x (g / (|g| + eps) + wd p), lr = 3e-6 in warmup, so a
  gradient near zero whose bfloat16 value has another sign in the other
  package moves its weight ~2 lr apart (3 elements of 16,384 read 6e-6);
  the moments to the float32 reductions of bfloat16 gradients (the step's
  compute copy is bfloat16 in both packages, and a sharded product adds
  its partial sums in bfloat16 in another order: rtol 2e-2 of each leaf's
  largest value).
* The port's mesh step against its own one-device step, for the dense,
  SSM and hybrid families (MoE drops other tokens on a mesh) and a
  one-kv-head variant of olmo (its attention takes per-device slices of
  the whole kv heads): the float32
  loss of ``Model.loss`` (float32 compute) to rtol 1e-6 and its gradients
  to 2e-6 of each leaf's largest value (partial sums over devices add in
  another order, and the vocab-parallel cross-entropy forms its softmax
  as exp(x - max) / sum over the shards' sums: 1.5e-6 read on olmo), and
  the optimizer bit for bit (AdamW given the same gradients, whose
  squares sum exactly in float32 in any order, so the global norm is the
  same): float32, bfloat16 and int8 moments, bfloat16 master with
  stochastic rounding, ``update_chunk``, and int8 blocks both whole on a
  shard and straddling shards.
* A decode step on the mesh (batch over "data"; or 2 rows with the
  cache's sequence over "data", the dry-run's long-context rule) equals
  the one-device step: logits and caches to rtol 1e-5.
* ``moe_block`` on the mesh against JAX's ``_moe_block_ep``: outputs and
  the gradients of the router, the experts and the input to 1e-5, and the
  routing integers of every data shard equal.
* A checkpoint saved under a (2, 4) mesh restores under (4, 2) bit for
  bit, and ``launch/train.py`` refuses a ``--mesh`` whose size is not the
  world's.
* ``launch/train.py --mesh 4,2 --device cpu`` under ``torchrun`` with one
  injected failure: the resumed steps' losses and the final checkpoint
  equal an uninterrupted twin's.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("olmo_1b", "olmoe_1b_7b")
# ":kv1": the arch with one kv head, so the kv heads do not divide the
# "model" axis and each device attends with its slice of them
F32_ARCHS = ("olmo_1b", "olmo_1b:kv1", "mamba2_780m", "zamba2_1p2b",
             "chameleon_34b")
DECODE_ARCHS = ("olmo_1b", "olmo_1b:kv1", "zamba2_1p2b", "olmoe_1b_7b")
B, S = 8, 32
LAUNCH = ["--arch", "olmo-1b", "--reduced", "--steps", "6",
          "--global-batch", "8", "--seq-len", "16", "--device", "cpu",
          "--mesh", "4,2", "--ckpt-every", "2", "--log-every", "1"]

# numpy parameters of a tree of ParamDefs (either package's), leaves in
# sorted key order, and the batch
_PARAMS = '''
import math
import numpy as np

def np_params(leaves, seed):
    rng = np.random.default_rng(seed)
    out = []
    for d in leaves:
        if d.init == "zeros":
            out.append(np.zeros(d.shape, np.float32))
        elif d.init == "ones":
            out.append(np.ones(d.shape, np.float32))
        else:
            x = rng.standard_normal(d.shape).astype(np.float32)
            if d.init == "scaled":
                fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
                out.append((x / math.sqrt(fan)).astype(np.float32))
            else:
                out.append((x * d.scale).astype(np.float32))
    return out

def np_batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
'''

_JAX = _PARAMS + '''
import dataclasses, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.base import get_config, reduced
from repro.models import build_model
from repro.models.moe import _route, moe_block
from repro.models.params import ParamDef
from repro.training.optimizer import AdamWConfig
from repro.training.train_loop import (batch_shardings, init_train_state,
    make_train_step, train_state_shardings)

B, S, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
is_def = lambda x: isinstance(x, ParamDef)
res = {}
for arch in ("olmo_1b", "olmoe_1b_7b"):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    ocfg = AdamWConfig()
    model = build_model(cfg, mesh=mesh)
    leaves, treedef = jax.tree.flatten(model.defs(), is_leaf=is_def)
    params = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in
                                          np_params(leaves, 0)])
    batch = {k: jnp.asarray(v) for k, v in np_batch(cfg.vocab, B, S,
                                                    1).items()}
    one = build_model(cfg, mesh=None)
    _, met = jax.jit(make_train_step(one, ocfg))(
        init_train_state(one.defs(), params, ocfg), batch)
    res[arch + "/one_loss"] = np.asarray(met["loss"])
    sh = train_state_shardings(model.defs(), ocfg, mesh)
    state = jax.tree.map(lambda x, s: jax.device_put(x, s),
                         init_train_state(model.defs(), params, ocfg), sh,
                         is_leaf=lambda x: hasattr(x, "shape"))
    bsh = batch_shardings(mesh, batch)
    step = jax.jit(make_train_step(model, ocfg), in_shardings=(sh, bsh))
    new, met = step(state, jax.tree.map(jax.device_put, batch, bsh))
    res[arch + "/loss"] = np.asarray(met["loss"])
    for i, x in enumerate(jax.tree.leaves(new)):
        res[f"{arch}/state/{i}"] = np.asarray(x)
    if cfg.n_experts:
        p = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                        jnp.float32)
        w = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                        jnp.float32)
        f = jax.jit(lambda p, x: jnp.sum(moe_block(p, x, cfg, mesh) * w))
        y = jax.jit(lambda p, x: moe_block(p, x, cfg, mesh))(p, x)
        gp, gx = jax.grad(f, argnums=(0, 1))(p, x)
        res["moe/y"] = np.asarray(y)
        res["moe/gx"] = np.asarray(gx)
        for k in ("router", "wg", "wu", "wd"):
            res["moe/g_" + k] = np.asarray(gp[k])
        for d in range(4):  # the routing of each data shard's tokens
            xt = x[d * B // 4:(d + 1) * B // 4].reshape(-1, cfg.d_model)
            for j, a in enumerate(_route(xt, p["router"], cfg)):
                res[f"moe/route/{d}/{j}"] = np.asarray(a)
np.savez(out, **res)
print("ok")
'''

_PORT = _PARAMS + '''
import dataclasses, json, sys, warnings
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.sharding import (NamedSharding,
    implicit_replication)
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, pdef
from repro_torch.models.moe import _route, moe_block
from repro_torch.models.params import (distribute, param_shardings,
    tree_leaves, tree_map)
from repro_torch.training import (AdamWConfig, adamw_update, batch_shardings,
    init_train_state, load_checkpoint, make_train_step, save_checkpoint,
    train_state_shardings)
from repro_torch.training.train_loop import _value_and_grad

warnings.simplefilter("ignore")
torch.set_num_threads(1)
B, S, out, ck = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo")
rank = dist.get_rank()
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
res = {}

def full(x):
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).numpy()

def tree_from(defs, arrays):
    it = iter(arrays)
    return tree_map(lambda _: torch.from_numpy(next(it)), defs)

def setup(arch):
    name, _, variant = arch.partition(":")
    cfg = dataclasses.replace(reduced(get_config(name)), dtype="float32")
    if variant == "kv1":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    one, model = build_model(cfg), build_model(cfg, mesh=mesh)
    defs = one.defs()
    params = tree_from(defs, np_params(tree_leaves(defs), 0))
    batch = {k: torch.from_numpy(v) for k, v in np_batch(cfg.vocab, B, S,
                                                         1).items()}
    if cfg.input_mode == "embeddings":
        rng = np.random.default_rng(4)
        batch["embeddings"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        del batch["tokens"]
    return cfg, one, model, defs, params, batch, distribute(
        batch, batch_shardings(mesh, batch))

for arch in json.loads(sys.argv[5]):  # float32 loss and gradients
    cfg, one, model, defs, params, batch, mb = setup(arch)
    p1 = distribute(params, param_shardings(defs, mesh))
    l0, g0 = _value_and_grad(one, params, batch)
    l1, g1 = _value_and_grad(model, p1, mb)
    res[arch + "/f32_loss"] = np.array([float(l0), float(l1)])
    res[arch + "/f32_grad_err"] = np.array([
        float((a - b.full_tensor()).abs().max() / a.abs().max().clamp_min(
            1e-30)) for a, b in zip(tree_leaves(g0), tree_leaves(g1))])

for arch in ("olmo_1b", "olmoe_1b_7b"):
    cfg, one, model, defs, params, batch, mb = setup(arch)
    ocfg = AdamWConfig()
    # one train step on the mesh
    state = distribute(init_train_state(defs, params, ocfg),
                       train_state_shardings(defs, ocfg, mesh))
    state, met = make_train_step(model, ocfg)(state, mb)
    res[arch + "/loss"] = np.array(float(met["loss"]))
    _, met = make_train_step(one, ocfg)(init_train_state(defs, params, ocfg),
                                        batch)
    res[arch + "/one_loss"] = np.array(float(met["loss"]))
    for i, x in enumerate(tree_leaves(state)):
        res[f"{arch}/state/{i}"] = full(x)
    if cfg.n_experts:
        p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        pd = {k: d.__class__(d.shape[1:], d.names[1:], d.init, d.scale,
                             d.dtype)
              for k, d in defs["blocks"]["moe"].items()}
        pm = distribute(p, param_shardings(pd, mesh))
        pm = tree_map(lambda t: t.detach().requires_grad_(), pm)
        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                             .astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                             .astype(np.float32))
        xs = NamedSharding(mesh, ("data", None, None))
        xm = distribute(x, xs).requires_grad_()
        with implicit_replication():
            y = moe_block(pm, xm, cfg, mesh)
            (y * distribute(w, xs)).sum().backward()
        res["moe/y"] = full(y.detach())
        res["moe/gx"] = full(xm.grad)
        for k in ("router", "wg", "wu", "wd"):
            res["moe/g_" + k] = full(pm[k].grad)
        for d in range(4):
            xt = x[d * B // 4:(d + 1) * B // 4].reshape(-1, cfg.d_model)
            for j, a in enumerate(_route(xt, p["router"], cfg)):
                res[f"moe/route/{d}/{j}"] = a.numpy()

# decode steps, mesh vs one device: the batch over "data" (8 rows), and 2
# rows (replicated) with the cache's sequence over "data"
from repro_torch.distributed.sharding import with_rules
from repro_torch.launch.dryrun import _cache_specs
for arch in json.loads(sys.argv[6]):
    cfg, one, model, defs, params, _, _ = setup(arch)
    p1 = distribute(params, param_shardings(defs, mesh))
    for b, rules in ((8, {}), (2, {"kv_seq": ("data",)})):
        rng = np.random.default_rng(5)
        c0 = {k: torch.from_numpy(rng.standard_normal(t.shape).astype(
                  np.float32)).to(t.dtype)
              for k, t in model.cache_shapes(b, 16).items()}
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b,)))
        with with_rules(**rules):
            specs = _cache_specs(model, mesh, model.cache_shapes(b, 16))
            c1 = distribute({k: t.clone() for k, t in c0.items()}, specs)
            y1, c1 = model.decode_step(p1, c1, distribute(
                toks, NamedSharding(mesh, ("data",) if b == 8 else (None,))),
                5)
        y0, c0 = one.decode_step(params, c0, toks, 5)
        tag = f"decode/{arch}/{b}"
        res[tag + "/y"] = np.stack([y0.numpy(), full(y1)])
        for k in c0:
            res[f"{tag}/{k}"] = np.stack([c0[k].float().numpy(),
                                          full(c1[k]).astype(np.float32)])

# the optimizer, mesh vs one device, on gradients that sum exactly
cfg = reduced(get_config("olmoe_1b_7b"))
defs = dict(build_model(cfg).defs(),
            wide=pdef((4, 64, 1024), ("layers", "fsdp", "ff")))
params = tree_from(defs, np_params(tree_leaves(defs), 3))
opts = [dict(), dict(moment_dtype="bfloat16"), dict(moment_dtype="int8"),
        dict(master_dtype="bfloat16", moment_dtype="int8", update_chunk=1),
        dict(master_dtype="bfloat16", update_chunk=2),
        dict(master_dtype="bfloat16", moment_dtype="int8")]
differ = []
for kw in opts:
    ocfg = AdamWConfig(**kw)
    s0 = init_train_state(defs, params, ocfg, seed=3)
    sh = train_state_shardings(defs, ocfg, mesh)
    s1 = distribute(tree_map(lambda t: t.clone(), s0), sh)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        g = tree_map(lambda q: torch.randint(-2, 3, q.shape, generator=gen)
                     .float() * 2.0 ** -12, params)
        adamw_update(g, s0["opt"], ocfg, rng=s0["rng"])
        adamw_update(distribute(g, sh["opt"]["master"]), s1["opt"], ocfg,
                     rng=s1["rng"])
    differ.append(sum(not torch.equal(a, b.full_tensor())
                      for a, b in zip(tree_leaves(s0), tree_leaves(s1))))
res["opt/differ"] = np.array(differ)
res["opt/leaves"] = np.array(len(tree_leaves(s0)))

# elastic restore: saved under (2, 4), restored under (4, 2)
mesh_a = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
ocfg = AdamWConfig(moment_dtype="int8")
state = init_train_state(defs, params, ocfg, seed=7)
save_checkpoint(ck, 1, distribute(state, train_state_shardings(
    defs, ocfg, mesh_a)))
dist.barrier()
_, back, _ = load_checkpoint(ck, state, shardings=train_state_shardings(
    defs, ocfg, mesh))
res["elastic/differ"] = np.array(sum(
    not torch.equal(a, b.full_tensor())
    for a, b in zip(tree_leaves(state), tree_leaves(back))))

# a mesh of another size than the world's
try:
    launch_train.train(launch_train.parse_args(
        ["--arch", "olmo-1b", "--reduced", "--steps", "1", "--device", "cpu",
         "--mesh", "2,2"]))
    res["launch/refused"] = np.array("")
except ValueError as e:
    res["launch/refused"] = np.array(str(e))
if rank == 0:
    np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
print("ok")
'''


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
                OMP_NUM_THREADS="1", **extra)


def _torchrun(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "8", "--master-port", str(_port()), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), **kw)


def _wait(proc, timeout: int = 500) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out[-2000:], err[-4000:])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    (d / "ref_step.py").write_text(textwrap.dedent(_JAX))
    (d / "port_step.py").write_text(textwrap.dedent(_PORT))
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, str(d / "ref_step.py"), str(B), str(S),
             str(d / "jax.npz")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
                "--xla_force_host_platform_device_count=8"))),
        "port": _torchrun([str(d / "port_step.py"), str(B), str(S),
                           str(d / "port.npz"), str(d / "elastic"),
                           json.dumps(F32_ARCHS), json.dumps(DECODE_ARCHS)]),
        "fail": _torchrun(["-m", "repro_torch.launch.train", *LAUNCH,
                           "--ckpt-dir", str(d / "fail"), "--fail-at", "3"]),
        "twin": _torchrun(["-m", "repro_torch.launch.train", *LAUNCH,
                           "--ckpt-dir", str(d / "twin")]),
    }
    try:
        out = {k: _wait(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(jax=dict(np.load(d / "jax.npz")),
                port=dict(np.load(d / "port.npz")), logs=out, dir=d)


def _close(got, want, rtol, atol_share=0.0):
    got, want = np.asarray(got), np.asarray(want)
    atol = atol_share * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_loss_matches_jax_mesh_step(runs, arch):
    j, p = runs["jax"], runs["port"]
    _close(p[arch + "/loss"], j[arch + "/loss"], rtol=1e-5)
    _close(p[arch + "/one_loss"], j[arch + "/one_loss"], rtol=1e-5)
    if arch == "olmoe_1b_7b":  # per-data-shard capacity drops other tokens
        assert abs(float(j[arch + "/loss"]) - float(j[arch + "/one_loss"])
                   ) > 1e-3
        assert abs(float(p[arch + "/loss"]) - float(p[arch + "/one_loss"])
                   ) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_state_matches_jax_mesh_step(runs, arch):
    j, p = runs["jax"], runs["port"]
    n = len([k for k in j if k.startswith(arch + "/state/")])
    assert n == len([k for k in p if k.startswith(arch + "/state/")]) > 10
    for i in range(n):
        key = f"{arch}/state/{i}"
        want, got = j[key], p[key]
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if want.dtype.kind in "iu" or want.ndim == 0:  # step, rng
            np.testing.assert_array_equal(got, want)
    # master first, then the moments, in sorted key order
    leaves = [f"{arch}/state/{i}" for i in range(n)]
    moments = [k for k in leaves if j[k].ndim and j[k].dtype.kind == "f"]
    half = len(moments) // 3
    for k in moments[:half]:  # master
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, atol=7.5e-6)
    for k in moments[half:]:  # m, v
        _close(p[k], j[k], rtol=2e-2, atol_share=2e-2)


@pytest.mark.parametrize("arch", F32_ARCHS)
def test_mesh_loss_and_grads_match_one_device(runs, arch):
    p = runs["port"]
    l0, l1 = p[arch + "/f32_loss"]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert float(p[arch + "/f32_grad_err"].max()) <= 2e-6


@pytest.mark.parametrize("arch", DECODE_ARCHS)
@pytest.mark.parametrize("batch", [8, 2])
def test_mesh_decode_step_matches_one_device(runs, arch, batch):
    """A decode step on the mesh (flash-decoding combine over the cache's
    sequence where the dry-run's kv_seq rule splits it) against one
    device on the same cache (the mesh model's: one kv head stored twice
    for kv1, ``_kv_repeat``): logits and the written caches, float32 sums
    in another order."""
    p = runs["port"]
    tag = f"decode/{arch}/{batch}"
    keys = [k for k in p if k.startswith(tag + "/")]
    assert len(keys) >= 3
    for k in keys:
        want, got = p[k]
        _close(got, want, rtol=1e-5, atol_share=1e-6)


def test_mesh_optimizer_is_bit_exact(runs):
    p = runs["port"]
    assert int(p["opt/leaves"]) > 50
    assert p["opt/differ"].tolist() == [0] * 6


def test_moe_block_matches_jax_ep(runs):
    j, p = runs["jax"], runs["port"]
    _close(p["moe/y"], j["moe/y"], rtol=1e-5, atol_share=1e-6)
    for k in ("gx", "g_router", "g_wg", "g_wu", "g_wd"):
        _close(p["moe/" + k], j["moe/" + k], rtol=1e-5, atol_share=1e-5)
    keys = [k for k in j if k.startswith("moe/route/")]
    assert len(keys) == 16
    for k in keys:
        if j[k].dtype.kind in "iu":
            np.testing.assert_array_equal(p[k], j[k])
        else:  # the gates
            _close(p[k], j[k], rtol=1e-5, atol_share=1e-6)


def test_elastic_restore_across_meshes(runs):
    p = runs["port"]
    assert int(p["elastic/differ"]) == 0


def test_launcher_refuses_a_mesh_of_another_size(runs):
    msg = str(runs["port"]["launch/refused"])
    assert "has 4 devices" in msg and "8 ranks" in msg


def _losses(log: str) -> list[tuple[int, str]]:
    return [(int(m.group(1)), m.group(2)) for m in
            re.finditer(r"^step\s+(\d+)\s+loss (\S+)", log, re.M)]


def test_launcher_restart_on_a_mesh_matches_twin(runs):
    fail, twin = runs["logs"]["fail"], runs["logs"]["twin"]
    assert "'restarts': 1" in fail and "'restarts': 0" in twin
    got, want = _losses(fail), dict(_losses(twin))
    # the failure follows step 3, before its log line; the run resumes
    # from the checkpoint after step 1
    assert [s for s, _ in got] == [0, 1, 2, 2, 3, 4, 5]
    assert len(want) == 6
    for s, loss in got:
        assert loss == want[s], (s, loss, want[s])
    final = [re.search(r"'final_loss': ([^,]+)", t).group(1)
             for t in (fail, twin)]
    assert final[0] == final[1]
    a, b = (runs["dir"] / k / "step_000000006" for k in ("fail", "twin"))
    files = sorted(f.name for f in a.glob("*.npy"))
    assert files == sorted(f.name for f in b.glob("*.npy")) and files
    for name in files:
        np.testing.assert_array_equal(np.load(a / name), np.load(b / name))
