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
  read; an index cell records an error naming ROADMAP.md.

Everything that needs a process group (a ``"fake"`` one, meta tensors)
runs in one child process; the reference's ``run_cell`` keys come from a
second child, which stubs the JAX package's lowering.
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

# run_cell on the production mesh, its config and shape cut to size, and
# an index cell
cut = {"olmo_1b": reduced(get_config("olmo_1b"))}
dryrun.get_config = lambda a: cut.get(a) or get_config(a)
dryrun.SHAPES = dict(SHAPES, train_4k=ShapeConfig("train_4k", 512, 256,
                                                  "train"))
res["cell"] = dryrun.run_cell("olmo_1b", "train_4k", "single", out_dir,
                              force=True, device_type="cpu")
res["index"] = dryrun.run_cell("wlsh_index", "train_4k", "single", out_dir,
                               force=True, device_type="cpu")
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
    port = _last_json(_spawn(_PORT, (out_dir,)))
    return dict(port, ref_keys=_last_json(jax_proc), out_dir=out_dir)


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
    summary = bench_roofline.run(mesh="single")
    assert summary["ok"] == 1 and summary["errors"] == 1


def test_index_cells_raise_naming_the_roadmap(runs):
    r = runs["index"]
    assert r["status"] == "error"
    assert "ROADMAP.md" in r["error"] and "NotImplementedError" in r["error"]
