"""The port's dry-run layer (``launch/{estimate,roofline,dryrun}.py``)
against the JAX package's, and its counts against hand and analytic ones.

* ``active_params`` and ``model_flops`` equal JAX's for every arch x shape.
* ``RooflineResult`` given one ``HW`` gives JAX's dict.
* ``StepCounter`` (the collective recorder): the bytes of known
  redistributions on a (pod 2, data 2, model 2) mesh equal a hand count,
  the "pod" group's as DCN bytes.
* A miniature train cell of reduced olmoe-1b-7b (8 x 64 tokens) on a
  (4, 2) mesh: FLOPs > 0 and equal to an analytic count of its products on
  one device.
* The two-point depth extrapolation equals a direct count at depth 8.
* ``run_cell`` writes the reference's JSON keys (plus ``hw``, the card's
  constants), which ``benchmarks_torch.roofline`` and ``render_tables``
  read; an LM cell's compute term is its FLOPs at the bfloat16 peak, as
  before the kernels had rates of their own.
* The index cells (``wlsh_index``) on both production meshes: the build
  and query steps ``ok`` and the decode shapes skipped with the
  reference's reason; per-device state and argument bytes equal the
  local shards' (and, at a reduced cell on a (4, 2) mesh, JAX's
  per-device ``memory_analysis()``); the kernels priced at their own
  rates; one all-reduce and one all-gather for a query, none for a build.

Everything that needs a process group (a ``"fake"`` one, meta tensors)
runs in one child process; the reference's ``run_cell`` keys come from a
second child, which stubs the JAX package's lowering, and its index
steps' memory from a third, on 8 forced host devices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

import repro.launch.roofline as jax_roofline
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.launch.estimate import active_params as jax_active_params
from repro.launch.estimate import model_flops as jax_model_flops
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.estimate import active_params, model_flops
from repro_torch.launch.roofline import HW, RooflineResult

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", ARCHS)
def test_estimates_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if cfg.family != "index":
        assert active_params(cfg) == jax_active_params(jcfg)
    assert list(SHAPES) == list(JAX_SHAPES)
    for name in SHAPES:
        assert model_flops(cfg, SHAPES[name]) == jax_model_flops(
            jcfg, JAX_SHAPES[name]), name


def test_roofline_result_matches_jax(monkeypatch):
    hw = HW()
    jhw = jax_roofline.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                          link_bw=hw.link_bw, dcn_bw=hw.dcn_bw)
    # the reference's roofline_fraction reads its module's default HW
    monkeypatch.setattr(jax_roofline, "HW", lambda: jhw)
    kw = dict(arch="olmo_1b", shape="train_4k", mesh="single", chips=256,
              hlo_flops_per_chip=4.5e13, hlo_bytes_per_chip=2.7e12,
              coll_bytes_per_chip=1.4e11,
              coll_detail={"total": 1.4e11, "bytes": {}, "counts": {}},
              model_flops=7.4e15, memory={"total_bytes": 3.2e10})
    got = RooflineResult(**kw).finalize(hw).to_dict()
    want = jax_roofline.RooflineResult(**kw).finalize(jhw).to_dict()
    assert got == want
    assert got["bottleneck"] == "memory"


def test_dryrun_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k"])


# ------------------------------------------------------------ child runs

_PORT = """
import dataclasses, json, os, sys, warnings
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.configs import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world
from repro_torch.launch.roofline import StepCounter, collective_bytes
from repro_torch.models import build_model
from repro_torch.models.transformer import RunFlags
from repro_torch.training import AdamWConfig

warnings.simplefilter("ignore")
out_dir = sys.argv[1]
res = {}

# hand-counted redistributions on a (pod 2, data 2, model 2) mesh
init_fake_world(8)
m3 = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                mesh_dim_names=("pod", "data", "model"))
R = Replicate()
def dt(pl):
    return DTensor.from_local(torch.empty(4, 8, device="meta"), m3, pl,
                              run_check=False)
c = StepCounter(m3)
with c:
    dt([R, Shard(0), R]).redistribute(m3, [R, R, R])       # all-gather
    dt([R, R, Partial()]).redistribute(m3, [R, R, R])      # all-reduce
    dt([R, Partial(), R]).redistribute(m3, [R, Shard(0), R])  # r-scatter
    dt([Shard(0), R, R]).redistribute(m3, [R, R, R])       # over "pod"
res["hand"] = collective_bytes(c)

# the miniature cell and the extrapolation on a (4, 2) mesh
init_fake_world(8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                  mesh_dim_names=("data", "model"))
moe = reduced(get_config("olmoe_1b_7b"))
r = dryrun.trace_train(build_model(moe, mesh=mesh),
                       ShapeConfig("s", 64, 8, "train"), AdamWConfig())
res["mini"] = dict(flops=r["flops"], coll=r["coll"], memory=r["memory"])
dense = reduced(get_config("olmo_1b"))
pts = {}
for L in (2, 4, 8):
    model = build_model(dataclasses.replace(dense, n_layers=L), mesh=mesh,
                        flags=RunFlags(layer_groups=1))
    t = dryrun.trace_train(model, ShapeConfig("s", 64, 4, "train"),
                           AdamWConfig())
    pts[L] = {k: t[k] for k in ("flops", "bytes", "coll")}
res["depth"] = pts

# a reduced index cell on the (4, 2) mesh (held to JAX's memory_analysis)
small = dataclasses.replace(get_config("wlsh_index"), vocab=8192, d_model=16,
                            d_ff=32)
res["index_small"] = {s: dryrun.lower_index(small, SHAPES[s], mesh)[0]
                      for s in ("train_4k", "prefill_32k")}

# run_cell on the production mesh, its config and shape cut to size, and
# an index cell
cut = {"olmo_1b": reduced(get_config("olmo_1b"))}
dryrun.get_config = lambda a: cut.get(a) or get_config(a)
dryrun.SHAPES = dict(SHAPES, train_4k=ShapeConfig("train_4k", 512, 256,
                                                  "train"))
res["cell"] = dryrun.run_cell("olmo_1b", "train_4k", "single", out_dir,
                              force=True, device_type="cpu")
res["index"] = {f"{s}/{m}": dryrun.run_cell("wlsh_index", s, m, out_dir,
                                            force=True, device_type="cpu")
                for s in SHAPES for m in ("single", "multi")}
print(json.dumps(res))
"""

_JAX_KEYS = """
import json, sys, tempfile, types
import repro.launch.dryrun as D

class Compiled:
    def cost_analysis(self):
        return {"flops": 1.0, "bytes accessed": 2.0}
    def memory_analysis(self):
        return types.SimpleNamespace(
            argument_size_in_bytes=1, output_size_in_bytes=0,
            temp_size_in_bytes=2, generated_code_size_in_bytes=0)
    def as_text(self):
        return ""

D.lower_cell = lambda *a, **k: (None, Compiled(), 256, {})
D.analysis_terms = lambda *a, **k: {
    "flops": 1.0, "bytes": 2.0, "coll": 0.0, "coll_detail": {},
    "method": "stub"}
with tempfile.TemporaryDirectory() as d:
    r = D.run_cell("olmo_1b", "train_4k", "single", d, force=True)
print(json.dumps(sorted(r)))
"""


# the JAX index steps' per-device memory at the reduced cell, on a (4, 2)
# Auto-axes mesh of 8 forced host devices
_JAX_INDEX = """
import json
import jax
from jax.sharding import AxisType
from repro.index import IndexConfig, make_query_step, query_input_specs
from repro.index.builder import build_input_specs, make_build_step

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = IndexConfig(n=8192, d=16, beta=32)
q = query_input_specs(cfg)
b = build_input_specs(cfg)
out = {}
for shape, step, args in (
        ("prefill_32k", make_query_step, [q["state"]] + [q[k] for k in (
            "queries", "q_codes", "q_weight", "mu", "r_min", "beta_q",
            "levels_q")]),
        ("train_4k", make_build_step, [b[k] for k in (
            "points", "proj", "b_int", "b_frac")])):
    m = step(mesh, cfg).lower(*args).compile().memory_analysis()
    out[shape] = m.argument_size_in_bytes
print(json.dumps(out))
"""


def _spawn(code: str, args=(), env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _last_json(proc, timeout: int = 400):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun_torch"))
    jax_proc = _spawn(_JAX_KEYS, env_extra={"JAX_PLATFORMS": "cpu"})
    jax_index = _spawn(_JAX_INDEX, env_extra={
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    port = _last_json(_spawn(_PORT, (out_dir,)))
    return dict(port, ref_keys=_last_json(jax_proc),
                jax_index=_last_json(jax_index), out_dir=out_dir)


def test_recorder_bytes_equal_a_hand_count(runs):
    h = runs["hand"]
    # 4 x 8 float32 shards (128 bytes): the all-gathers write 8 x 8 (256
    # bytes) over "data" and over "pod"; the all-reduce 4 x 8, counted
    # twice; the reduce-scatter 2 x 8
    assert h["bytes"] == {"all-reduce": 256, "all-gather": 512,
                          "reduce-scatter": 64, "all-to-all": 0,
                          "collective-permute": 0}
    assert h["counts"]["all-gather"] == 2 and h["counts"]["all-reduce"] == 1
    assert h["total"] == 832 and h["dcn"] == 256


def _olmoe_products(cfg, batch: int, seq: int, data: int, model: int):
    """FLOPs of one train step's products on one device of a (data,
    model) mesh: each forward product runs 4 times (forward, the
    rematerialized forward, and two products in the backward pass)."""
    t = batch * seq // data  # tokens a device
    hd = cfg.n_heads * cfg.head_dim_
    e_loc = cfg.n_experts // model
    # moe.capacity(): ceil(t K / E * 1.25) rounded up to 8, with t K / E
    # whole here
    assert t * cfg.top_k % cfg.n_experts == 0
    cap = t * cfg.top_k // cfg.n_experts
    cap = max(8, -(-int(cap * cfg.capacity_factor) // 8) * 8)
    layer = (4 * 2 * t * cfg.d_model * hd // model  # q, k, v, o
             + 2 * 2 * (batch // data) * seq * seq * hd // model  # s, pv
             + 2 * t * cfg.d_model * cfg.n_experts  # router (replicated)
             + 3 * 2 * e_loc * cap * cfg.d_model * cfg.d_ff)  # experts
    head = 2 * t * cfg.d_model * cfg.vocab // model
    return 4 * (cfg.n_layers * layer + head)


def test_miniature_train_cell_flops_match_the_products(runs):
    from repro_torch.configs import reduced

    cfg = reduced(get_config("olmoe_1b_7b"))
    mini = runs["mini"]
    assert mini["flops"] > 0 and mini["coll"] > 0
    assert mini["flops"] == _olmoe_products(cfg, 8, 64, data=4, model=2)
    mem = mini["memory"]
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]


def test_depth_extrapolation_equals_a_direct_count(runs):
    pts = {int(k): v for k, v in runs["depth"].items()}
    for key in ("flops", "bytes", "coll"):
        slope = (pts[4][key] - pts[2][key]) / (4 - 2)
        extrapolated = pts[2][key] + slope * (8 - 2)
        assert extrapolated == pytest.approx(pts[8][key], rel=1e-12), key
        assert pts[8][key] > pts[4][key] > pts[2][key] > 0


def test_run_cell_writes_the_reference_keys(runs, monkeypatch):
    from benchmarks_torch import render_tables
    from benchmarks_torch import roofline as bench_roofline

    cell = runs["cell"]
    assert cell["status"] == "ok", cell.get("traceback")
    assert set(cell) - set(runs["ref_keys"]) == {"hw"}
    assert set(runs["ref_keys"]) <= set(cell)
    assert cell["hw"] == dataclasses.asdict(HW())
    assert cell["chips"] == 256 and cell["fits_hbm"]
    assert cell["analysis_method"].startswith("two-point")
    for mod in (render_tables, bench_roofline):
        monkeypatch.setattr(mod, "DRYRUN_DIR", runs["out_dir"])
    monkeypatch.setattr(bench_roofline, "save", lambda *a, **k: None)
    table = render_tables.markdown("single")
    assert "| olmo_1b | train_4k |" in table
    assert "| wlsh_index | prefill_32k |" in table
    summary = bench_roofline.run(mesh="single")
    # the LM cell and the index cells' build and query steps; the index's
    # two decode shapes skipped
    assert (summary["ok"], summary["skipped"], summary["errors"]) == (3, 2, 0)


def test_lm_cell_compute_term_is_its_flops_at_the_bf16_peak(runs):
    """The kernels' own rates leave an LM cell as it was: no kernel
    launched, so compute_s is its FLOPs over the bfloat16 peak exactly,
    and the JSON has no key beyond the reference's and ``hw``."""
    cell = runs["cell"]
    assert cell["compute_s"] == cell["hlo_flops_per_chip"] / HW().peak_flops
    assert "kernels" not in cell and "index_cfg" not in cell
    assert set(cell) - set(runs["ref_keys"]) == {"hw"}


_SHAPE_KINDS = {"train_4k": "build", "prefill_32k": "query",
                "decode_32k": None, "long_500k": None}
_INDEX_CELLS = [(s, m) for s in _SHAPE_KINDS for m in ("single", "multi")]
_STEP_CELLS = [(s, m) for s, m in _INDEX_CELLS if _SHAPE_KINDS[s]]


def _index_cell(runs, shape, mesh):
    return runs["index"][f"{shape}/{mesh}"]


@pytest.mark.parametrize("shape,mesh", _INDEX_CELLS)
def test_index_cells_run_or_skip_as_the_reference(runs, shape, mesh):
    r = _index_cell(runs, shape, mesh)
    if _SHAPE_KINDS[shape] is None:
        assert r["status"] == "skipped"
        assert r["reason"] == ("index has no decode semantics "
                               "(build/query only)")
        return
    assert r["status"] == "ok", r.get("traceback")
    chips = 512 if mesh == "multi" else 256
    assert r["chips"] == chips and r["fits_hbm"]
    icfg = r["index_cfg"]
    assert icfg["vec_dtype"] == "bfloat16" and icfg["n_shards"] == chips
    assert (icfg["n"], icfg["d"], icfg["beta"]) == (1 << 30, 128, 128)
    assert r["analysis_method"].startswith("direct (one ")


@pytest.mark.parametrize("shape,mesh", _STEP_CELLS)
def test_index_cell_bytes_are_the_local_shards(runs, shape, mesh):
    from repro_torch.index.config import IndexConfig

    r = _index_cell(runs, shape, mesh)
    icfg = IndexConfig(**r["index_cfg"])
    n_loc, d, beta, q = (icfg.n // icfg.n_shards, icfg.d, icfg.beta,
                         icfg.q_batch)
    family = 4 * (d * beta + 2 * beta)
    mem = r["memory"]
    if _SHAPE_KINDS[shape] == "build":
        assert mem["points_bytes"] == 4 * n_loc * d
        assert mem["argument_bytes"] == 4 * n_loc * d + family
        return
    # the port keeps n_valid on the host (a launch argument): 4 bytes of
    # state_nbytes that no device holds
    assert mem["state_bytes"] + 4 == icfg.state_nbytes
    assert mem["state_bytes"] == n_loc * (4 * beta + 2 * d) + family + 4
    if mesh == "single":
        assert mem["state_bytes"] == 3_221_292_036
    assert mem["argument_bytes"] == (mem["state_bytes"]
                                     + 4 * (2 * q * d + q * beta + 4 * q))
    # the score matrix, then the top-k's int64 keys over it
    assert mem["temp_bytes"] >= 12 * q * n_loc


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k"))
def test_reduced_index_cell_arguments_match_jax(runs, shape):
    """Per-device argument bytes of a reduced cell on a (4, 2) mesh equal
    JAX's ``memory_analysis()`` (per device: its build step's are the
    local rows and the family).  The JAX query step holds ``n_valid`` on
    the device and its jit drops the family, which the query step does
    not read."""
    mem = runs["index_small"][shape]["memory"]
    want = runs["jax_index"][shape]
    if shape == "train_4k":
        assert mem["argument_bytes"] == want
    else:
        family = 4 * (16 * 32 + 2 * 32) + 4  # proj, b_int, b_frac, width
        assert mem["argument_bytes"] - family + 4 == want


@pytest.mark.parametrize("shape,mesh", _STEP_CELLS)
def test_index_cell_prices_kernels_at_their_rates(runs, shape, mesh):
    from repro_torch.index.config import IndexConfig
    from repro_torch.kernels import cost

    r = _index_cell(runs, shape, mesh)
    icfg = IndexConfig(**r["index_cfg"])
    hw = HW()
    n_loc, d, beta, q = (icfg.n // icfg.n_shards, icfg.d, icfg.beta,
                         icfg.q_batch)
    if _SHAPE_KINDS[shape] == "build":
        want = {"hash_encode": cost.hash_encode(n_loc, d, beta)}
    else:
        want = {"fused_query_hist": cost.fused_query_hist(
                    n_loc, beta, q, d, icfg.n_levels, vec_bytes=2),
                "fused_query_scores": cost.fused_query_scores(
                    n_loc, beta, q, d, vec_bytes=2)}
    ks = r["kernels"]
    assert set(ks) == set(want)
    for name, c in want.items():
        assert ks[name]["launches"] == 1
        assert ks[name]["ops_s"] == c.ops_s(hw)
        assert ks[name]["f32_flops"] == c.f32_flops
        assert ks[name]["int32_ops"] == c.int32_ops
    k_flops = sum(c.flops for c in want.values())
    k_s = sum(c.ops_s(hw) for c in want.values())
    assert r["compute_s"] == pytest.approx(
        (r["hlo_flops_per_chip"] - k_flops) / hw.peak_flops + k_s,
        rel=1e-12)
    # at the bfloat16 peak the kernels' work would read >= 14x too short
    assert k_s >= 14 * k_flops / hw.peak_flops
    # the kernels' FLOPs: pass 1 and pass 2 each count the weighted norm
    # beside the cross term, so half of them are the model's
    useful = 1.0 if _SHAPE_KINDS[shape] == "build" else 0.5
    assert r["useful_fraction"] == pytest.approx(useful, rel=1e-6)


@pytest.mark.parametrize("shape,mesh", _STEP_CELLS)
def test_index_cell_collectives(runs, shape, mesh):
    r = _index_cell(runs, shape, mesh)
    c = r["coll_detail"]
    if _SHAPE_KINDS[shape] == "build":
        assert c["total"] == 0 and sum(c["counts"].values()) == 0
        return
    q, k, L = (r["index_cfg"][key] for key in ("q_batch", "k", "n_levels"))
    assert c["counts"] == {"all-reduce": 1, "all-gather": 1,
                           "reduce-scatter": 0, "all-to-all": 0,
                           "collective-permute": 0}
    # both (Q, L+2) int32 histograms in one all-reduce (counted twice:
    # reduce-scatter and all-gather); 8 bytes a survivor of every device
    assert c["bytes"]["all-reduce"] == 2 * (2 * q * (L + 2) * 4)
    assert c["bytes"]["all-gather"] == r["chips"] * q * k * 8
