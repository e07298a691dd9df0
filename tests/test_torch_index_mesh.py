"""The index's mesh steps (``index.engine.make_query_step``,
``index.builder.make_build_step`` over a ``DeviceMesh``), the kernels'
cost model (``kernels/cost.py``) and the custom ops the counter sees.

* The mesh query step on a (4, 2) mesh of 8 gloo ranks (``torchrun``, a
  child process) for p in {2, 1, 0.5}, on a host-code state with a dead
  tail: stop, n_checked and ids equal to the JAX package's
  ``make_query_step`` on a (4, 2) Auto-axes mesh of 8 forced host
  devices (another child), distances to rtol 1e-6 (p = 2 distances vary
  between XLA compilations; ROADMAP's parity contract), and everything bit
  for bit equal to the device-list engine at S = 8 and S = 1 on the CPU.
  Every rank gets the same answers, and rank r's rows start at r x n_loc.
* The mesh build step's codes inside the float64 window and equal to the
  one-device encode of the whole corpus; its vectors the corpus rows cast
  to float32 and to bfloat16, bit for bit.  ``build_state`` on the same
  8 ranks equal, shard by shard, to the state put together by hand from
  the build step and ``distribute_state``.
* ``cost.py`` against hand counts of each kernel's work and bytes.
* The counts of one step traced on meta tensors (the dry-run's
  ``lower_index``) equal those of the same step run for real on the CPU,
  on a (1, 1) mesh, for the build and the query step.
* The kernel wrappers are custom ops: meta tensors give their output
  shapes without running anything, and the counter sees one op a call.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.datagen import make_dataset, make_weight_set
from repro_torch.core.distances import radius_bounds
from repro_torch.core.families import hash_codes_np, sample_lp_family
from repro_torch.distributed import group_sharding as gs
from repro_torch.index.builder import _PAD_CODE
from repro_torch.index.config import IndexConfig
from repro_torch.index.engine import QueryState, query_step
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch.roofline import HW

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = (2.0, 1.0, 0.5)
# capacity 1,008 = 8 x 126 rows, 1,003 live: the last shard straddles
# n_valid; the JAX step scans each shard in one block of 126 rows
DIMS = dict(n=1008, d=16, beta=64, q_batch=12, k=5, c=3, n_levels=8)
N_VALID = 1003
_FIELDS = ("dists", "ids", "stop", "n_checked")


def _inputs(p: float, seed: int = 5) -> dict:
    """Seeded numpy inputs of one query step and one build step: host
    codes of an l_p family (Cauchy for p < 1: the level structure is what
    counts), half the queries near a live row."""
    n, d, beta, q, c = (DIMS[k] for k in ("n", "d", "beta", "q_batch", "c"))
    rng = np.random.default_rng(seed)
    data = make_dataset(N_VALID, d, value_range=100.0, seed=seed)
    weights = make_weight_set(8, d, n_subset=2, n_subrange=5, seed=seed + 1)
    p_fam = max(p, 1.0)
    r_min, r_max = radius_bounds(weights[0], 100.0, p_fam)
    fam = sample_lp_family(d, beta, p_fam, r_min, weights[0],
                           r_max / r_min, c, seed=seed + 2)
    near = data[rng.choice(N_VALID, q // 2, replace=False)]
    near = near + rng.normal(0, 1.0, near.shape)
    far = rng.uniform(0, 100, (q - q // 2, d))
    queries = np.concatenate([near, far]).astype(np.float32)
    wq = weights[rng.integers(0, len(weights), q)].astype(np.float32)
    beta_q = rng.integers(beta - 8, beta + 1, q).astype(np.int32)
    mu = np.array([rng.integers(b // 5, 3 * b // 5) for b in beta_q],
                  np.int32)
    points = np.zeros((n, d), np.float32)
    points[:N_VALID] = data
    codes = np.full((n, beta), _PAD_CODE, np.int32)
    codes[:N_VALID] = hash_codes_np(data, fam)
    folded = {k: np.ascontiguousarray(v) for k, v in dict(
        proj=(fam.proj.astype(np.float64) * fam.center_weight[:, None]
              / fam.width).astype(np.float32),
        b_int=fam.b_int.astype(np.int32),
        b_frac=fam.b_frac.astype(np.float32)).items()}
    return dict(
        # the family itself, for build_state to fold
        fam_proj=fam.proj, fam_b_int=fam.b_int, fam_b_frac=fam.b_frac,
        fam_center_weight=fam.center_weight, fam_width=np.float64(fam.width),
        fam_p=np.float64(fam.p), fam_levels_cap=np.int64(fam.levels_cap),
        codes=codes, points=points, n_valid=np.int32(N_VALID),
        queries=queries, codes_q=hash_codes_np(queries, fam),
        q_weight=wq, mu=mu, r_min=wq.min(axis=1).astype(np.float32),
        beta_q=beta_q,
        levels_q=rng.integers(DIMS["n_levels"] - 2, DIMS["n_levels"] + 1,
                              q).astype(np.int32),
        # the build step encodes a corpus of wider range (codes far from
        # 0) through the folded projection
        build_points=np.concatenate([data * 50, points[N_VALID:]]),
        **folded)


_JAX = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.distributed.group_sharding import state_shardings
from repro.index.config import IndexConfig
from repro.index.engine import QueryState, make_query_step

src, out, dims = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
for p in (2.0, 1.0, 0.5):
    a = dict(np.load(f"{src}/p{p}.npz"))
    cfg = IndexConfig(**dims, p=p, vec_dtype="float32")
    state = QueryState(
        codes=jnp.asarray(a["codes"]), points=jnp.asarray(a["points"]),
        proj=jnp.asarray(a["proj"]), b_int=jnp.asarray(a["b_int"]),
        b_frac=jnp.asarray(a["b_frac"]), width=jnp.float32(1.0),
        n_valid=jnp.int32(a["n_valid"]))
    state = jax.device_put(state, state_shardings(mesh, cfg))
    outs = make_query_step(mesh, cfg)(*[state] + [jnp.asarray(a[k]) for k in (
        "queries", "codes_q", "q_weight", "mu", "r_min", "beta_q",
        "levels_q")])
    for name, o in zip(("dists", "ids", "stop", "n_checked"), outs):
        res[f"{p}/{name}"] = np.asarray(o)
np.savez(out, **res)
print("ok")
"""

_PORT = """
import json, sys, warnings
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.group_sharding import (distribute_state,
    shard_row_offset, state_shardings)
from repro_torch.core.families import LpFamilyParams
from repro_torch.index.builder import build_state, make_build_step
from repro_torch.index.config import IndexConfig
from repro_torch.index.engine import QueryState, make_query_step

warnings.simplefilter("ignore")
torch.set_num_threads(1)
src, out, dims = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
dist.init_process_group("gloo")
rank = dist.get_rank()
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
res = {}
for p in (2.0, 1.0, 0.5):
    a = {k: torch.from_numpy(v) for k, v in np.load(f"{src}/p{p}.npz").items()}
    cfg = IndexConfig(**dims, p=p)
    state = distribute_state(QueryState(
        codes=a["codes"], points=a["points"], proj=a["proj"],
        b_int=a["b_int"], b_frac=a["b_frac"], width=torch.tensor(1.0),
        n_valid=int(a["n_valid"])), state_shardings(mesh, cfg))
    outs = make_query_step(mesh, cfg)(state, *[a[k] for k in (
        "queries", "codes_q", "q_weight", "mu", "r_min", "beta_q",
        "levels_q")])
    outs = [o.to_local().numpy() for o in outs]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, outs)
    res[f"{p}/same_on_every_rank"] = np.array(all(
        all(np.array_equal(x.view(np.int32), y.view(np.int32))
            for x, y in zip(outs, o)) for o in every))
    for name, o in zip(("dists", "ids", "stop", "n_checked"), outs):
        res[f"{p}/{name}"] = o
    for vec in ("float32", "bfloat16"):
        codes, vecs = make_build_step(mesh, IndexConfig(
            **dims, vec_dtype=vec))(a["build_points"], a["proj"], a["b_int"],
                                    a["b_frac"])
        if vec == "float32":
            codes_f32, vecs_f32 = codes, vecs
        res[f"{p}/build/{vec}/codes"] = codes.full_tensor().numpy()
        res[f"{p}/build/{vec}/bits"] = vecs.full_tensor().view(
            torch.int16 if vec == "bfloat16" else torch.int32).numpy()
    # build_state (which folds the family) against the hand-assembled
    # state: make_build_step's float32 build + distribute_state
    n_rows = len(a["build_points"])
    built = build_state(mesh, cfg, a["build_points"].numpy(), LpFamilyParams(
        proj=a["fam_proj"].numpy(), b_int=a["fam_b_int"].numpy(),
        b_frac=a["fam_b_frac"].numpy(), width=float(a["fam_width"]),
        p=float(a["fam_p"]), center_weight=a["fam_center_weight"].numpy(),
        levels_cap=int(a["fam_levels_cap"])))
    hand = distribute_state(QueryState(
        codes=codes_f32.full_tensor(), points=vecs_f32.full_tensor(),
        proj=a["proj"], b_int=a["b_int"], b_frac=a["b_frac"],
        width=torch.tensor(1.0), n_valid=n_rows), state_shardings(mesh, cfg))
    pairs = [(getattr(built, f), getattr(hand, f)) for f in (
        "codes", "points", "proj", "b_int", "b_frac", "width")]
    same = built.n_valid == hand.n_valid == n_rows and all(
        tuple(x.placements) == tuple(y.placements)
        and torch.equal(x.to_local(), y.to_local()) for x, y in pairs)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, same)
    res[f"{p}/build_state/same_on_every_rank"] = np.array(all(every))
    res[f"{p}/build_state/codes"] = built.codes.full_tensor().numpy()
offsets = [None] * dist.get_world_size()
dist.all_gather_object(offsets, shard_row_offset(mesh, dims["n"] // 8))
res["offsets"] = np.array(offsets)
if rank == 0:
    np.savez(out, **res)
    print("ok")
"""

# the dry-run's trace of a reduced index cell on meta tensors against the
# same step run on CPU tensors, both on a (1, 1) mesh of one rank
_COUNTS = """
import dataclasses, json, warnings
import torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.index.builder import build_input_specs
from repro_torch.index.engine import query_input_specs
from repro_torch.launch import dryrun

warnings.simplefilter("ignore")
cut = dataclasses.replace(get_config("wlsh_index"), vocab=2048, d_model=16,
                          d_ff=64)
mesh = dryrun._mesh("one", "cpu")
icfg = dryrun.index_config(cut, 1)
g = torch.Generator().manual_seed(0)

def real(t):
    if t.dtype == torch.int32:
        return torch.randint(-40, 40, t.shape, generator=g, dtype=torch.int32)
    return (torch.rand(t.shape, generator=g) * 8).to(t.dtype)

res = {}
for shape, kind in (("train_4k", "build"), ("prefill_32k", "query")):
    meta, _, _ = dryrun.lower_index(cut, SHAPES[shape], mesh)
    if kind == "build":
        inputs = {k: real(v) for k, v in build_input_specs(icfg).items()}
    else:
        inputs = query_input_specs(icfg)
        st = inputs["state"]
        inputs = {k: real(v) for k, v in inputs.items() if k != "state"}
        inputs["state"] = dataclasses.replace(st, **{f: real(getattr(st, f))
            for f in ("codes", "points", "proj", "b_int", "b_frac",
                      "width")})
        for k, v in (("beta_q", icfg.beta), ("mu", 20),
                     ("levels_q", icfg.n_levels)):
            inputs[k] = torch.full((icfg.q_batch,), v, dtype=torch.int32)
    cpu = dryrun.trace_index(icfg, kind, mesh, inputs, device="cpu")
    res[shape] = {"meta": meta, "cpu": cpu}
print(json.dumps(res))
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
                OMP_NUM_THREADS="1", **extra)


def _wait(proc, timeout: int = 300) -> str:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (out[-2000:], err[-4000:])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("index_mesh")
    inputs = {p: _inputs(p) for p in PS}
    for p, arrs in inputs.items():
        np.savez(d / f"p{p}.npz", **arrs)
    for name, code in (("ref_step.py", _JAX), ("port_step.py", _PORT)):
        (d / name).write_text(textwrap.dedent(code))
    dims = json.dumps(DIMS)
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, str(d / "ref_step.py"), str(d), str(d / "jax.npz"),
             dims], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
                "--xla_force_host_platform_device_count=8"))),
        "port": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "8", "--master-port", str(_port()),
             str(d / "port_step.py"), str(d), str(d / "port.npz"), dims],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env()),
        "counts": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_COUNTS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env()),
    }
    try:
        out = {k: _wait(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(inputs=inputs, jax=dict(np.load(d / "jax.npz")),
                port=dict(np.load(d / "port.npz")),
                counts=json.loads(out["counts"].strip().splitlines()[-1]))


def _device_list(a: dict, p: float, shards: int):
    """The device-list engine's answers on the CPU at ``shards`` shards."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    n_loc = DIMS["n"] // shards
    parts = [QueryState(
        codes=t["codes"][s * n_loc:(s + 1) * n_loc].contiguous(),
        points=t["points"][s * n_loc:(s + 1) * n_loc].contiguous(),
        proj=t["proj"], b_int=t["b_int"], b_frac=t["b_frac"],
        width=torch.tensor(1.0),
        n_valid=max(0, min(N_VALID - s * n_loc, n_loc)))
        for s in range(shards)]
    state = gs.sharded_state(parts, n_loc, N_VALID)
    cfg = IndexConfig(**DIMS, p=p, n_shards=shards)
    outs = query_step(state, *[t[k] for k in (
        "queries", "codes_q", "q_weight", "mu", "r_min", "beta_q",
        "levels_q")], cfg=cfg)
    return [o.numpy() for o in outs]


@pytest.mark.parametrize("p", PS)
def test_mesh_query_step_matches_jax(runs, p):
    port, want = runs["port"], runs["jax"]
    for f in ("ids", "stop", "n_checked"):
        np.testing.assert_array_equal(port[f"{p}/{f}"], want[f"{p}/{f}"],
                                      err_msg=f)
    np.testing.assert_allclose(port[f"{p}/dists"], want[f"{p}/dists"],
                               rtol=1e-6)
    stop = port[f"{p}/stop"]
    # the data exercise both stop rules and several levels
    assert len(set(stop.tolist())) >= 2, stop
    assert bool(port[f"{p}/same_on_every_rank"])


@pytest.mark.parametrize("shards", (8, 1))
@pytest.mark.parametrize("p", PS)
def test_mesh_query_step_equals_the_device_list_engine(runs, p, shards):
    got = [runs["port"][f"{p}/{f}"] for f in _FIELDS]
    for f, g, w in zip(_FIELDS, got,
                       _device_list(runs["inputs"][p], p, shards)):
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f)


def test_rows_start_at_rank_times_slice(runs):
    n_loc = DIMS["n"] // 8
    assert runs["port"]["offsets"].tolist() == [r * n_loc for r in range(8)]


@pytest.mark.parametrize("vec", ("float32", "bfloat16"))
def test_mesh_build_step_codes_and_vectors(runs, vec):
    a = runs["inputs"][2.0]
    x = torch.from_numpy(a["build_points"])
    proj, b_int, b_frac = (torch.from_numpy(a[k])
                           for k in ("proj", "b_int", "b_frac"))
    codes = torch.from_numpy(runs["port"][f"2.0/build/{vec}/codes"])
    ones = torch.ones(DIMS["d"])
    lo, hi = ref.hash_code_window(x, proj, b_frac, ones, 1.0)
    v = ref.unbias_codes(codes, b_int)
    assert int(((v < lo) | (v > hi)).sum()) == 0
    assert torch.equal(codes, ops.hash_encode(x, ones, proj, b_int, b_frac,
                                              1.0))
    bits = torch.from_numpy(runs["port"][f"2.0/build/{vec}/bits"])
    want = x.to(getattr(torch, vec)).view(
        torch.int16 if vec == "bfloat16" else torch.int32)
    assert torch.equal(bits, want)


@pytest.mark.parametrize("p", PS)
def test_build_state_on_8_ranks_equals_the_hand_assembled_state(runs, p):
    """``build_state`` on the (4, 2) gloo mesh: every rank's shard of every
    field equal to ``make_build_step`` + ``distribute_state`` over the
    family folded by hand, with the same placements and n_valid."""
    port = runs["port"]
    assert bool(port[f"{p}/build_state/same_on_every_rank"])
    np.testing.assert_array_equal(port[f"{p}/build_state/codes"],
                                  port[f"{p}/build/float32/codes"])


# ------------------------------------------------------------ cost model


def _hand(name):
    """(cost.py's Cost, the hand count) of one launch of ``name``."""
    n, beta, q, d, L = 1000, 64, 12, 16, 8
    if name == "fused_query_hist":  # bfloat16 rows
        return (cost.fused_query_hist(n, beta, q, d, L, vec_bytes=2),
                cost.Cost(f32_flops=2 * 2 * q * n * d, int32_ops=q * n * beta,
                          bytes_read=(n * beta * 4 + n * d * 2 + q * beta * 4
                                      + 2 * q * d * 4 + 4 * q * 4),
                          bytes_written=2 * q * (L + 3) * 4))
    if name == "fused_query_scores":  # p = 0.5: a sqrt a term
        return (cost.fused_query_scores(n, beta, q, d, p=0.5, tests=777),
                cost.Cost(f32_ops=3 * q * n * d, sfu_ops=q * n * d,
                          int32_ops=777,
                          bytes_read=(n * beta * 4 + n * d * 4 + q * beta * 4
                                      + 2 * q * d * 4 + 4 * q * 4),
                          bytes_written=q * n * 4))
    if name == "hash_encode":
        return (cost.hash_encode(n, d, beta),
                cost.Cost(f32_flops=2 * n * d * beta,
                          bytes_read=4 * (n * d + d + d * beta + beta + beta),
                          bytes_written=4 * n * beta))
    if name == "freq_level":
        return (cost.freq_level(n, beta, q),
                cost.Cost(int32_ops=q * n * beta,
                          bytes_read=4 * (n * beta + q * beta + q + q),
                          bytes_written=4 * q * n))
    return (cost.weighted_lp(q, n, d, 1.5),  # powf: log2 and exp2
            cost.Cost(f32_ops=3 * q * n * d, sfu_ops=2 * q * n * d,
                      bytes_read=4 * (n * d + q * d + d),
                      bytes_written=4 * q * n))


@pytest.mark.parametrize("name", ("fused_query_hist", "fused_query_scores",
                                  "hash_encode", "freq_level",
                                  "weighted_lp"))
def test_cost_model_equals_a_hand_count(name):
    got, want = _hand(name)
    assert got == want
    hw = HW()
    rates = (got.f32_flops / hw.f32_flops, got.f32_ops / hw.f32_ops,
             got.int32_ops / hw.int32_ops, got.sfu_ops / hw.sfu_ops)
    t, by = got.bound(hw)
    assert t == max(got.bytes / hw.hbm_bw, *rates)
    assert by == ("bytes" if got.bytes / hw.hbm_bw >= max(rates)
                  else "operations")


def test_cost_of_an_op_reads_its_shapes():
    m = torch.empty(0, device="meta")
    codes = m.new_empty((1000, 64), dtype=torch.int32)
    pts = m.new_empty((1000, 16), dtype=torch.bfloat16)
    qs = m.new_empty((12, 16))
    args = (codes, pts, m.new_empty((12, 64), dtype=torch.int32), qs)
    assert cost.of_op("fused_query_hist", args,
                      dict(n_levels=8, p=2.0)) == _hand("fused_query_hist")[0]
    assert cost.of_op("weighted_lp", (qs, m.new_empty((1000, 16)), None, 1.5),
                      {}) == _hand("weighted_lp")[0]


# ------------------------------------------------------ counts and ops


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k"))
def test_meta_trace_counts_equal_a_cpu_run(runs, shape):
    meta, cpu = (runs["counts"][shape][k] for k in ("meta", "cpu"))
    assert meta["kernels"] == cpu["kernels"]
    for key in ("flops", "bytes", "coll", "memory", "kernel_flops",
                "kernel_s"):
        assert meta[key] == cpu[key], key
    want = ({"hash_encode"} if shape == "train_4k"
            else {"fused_query_hist", "fused_query_scores"})
    assert set(meta["kernels"]) == want
    assert all(k["launches"] == 1 for k in meta["kernels"].values())


def test_wrappers_are_custom_ops_that_trace_on_meta():
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    m = torch.empty(0, device="meta")
    q, n, d, beta, L = 4, 300, 8, 32, 6
    codes = m.new_empty((n, beta), dtype=torch.int32)
    x = m.new_empty((n, d))
    with Ops():
        hf, hg = ops.fused_query_block(
            codes, x, m.new_empty((q, beta), dtype=torch.int32),
            m.new_empty((q, d)), m.new_empty((q, d)), 3, 1.0, beta, boff=0,
            n_valid=n, c=3, n_levels=L, p=2.0)
        enc = ops.hash_encode(x, m.new_empty((d,)), m.new_empty((d, beta)),
                              m.new_empty((beta,), dtype=torch.int32),
                              m.new_empty((beta,)), 1.0)
    assert hf.shape == (q, L + 2) and hf.dtype == torch.int32
    assert enc.shape == (n, beta) and enc.device.type == "meta"
    assert "repro_torch.fused_query_hist.default" in seen
    assert "repro_torch.hash_encode.default" in seen
    # the plain version's inner ops are the op's own: not seen
    assert not any("floor" in s or "mm" in s for s in seen), seen


def test_state_shardings_refuse_a_capacity_off_the_mesh():
    class Mesh:  # axis names and sizes are all the rules read
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 2}

    ok = gs.state_shardings(Mesh(), IndexConfig(**DIMS))
    assert ok.codes.spec == (("data", "model"), None)
    assert ok.proj.spec == (None, None)
    with pytest.raises(ValueError, match="strict"):
        gs.state_shardings(Mesh(), IndexConfig(**dict(DIMS, n=1003)))
