"""Multi-pod dry-run: trace one step of every (arch x input-shape x mesh)
LM cell on the production meshes, check that it fits a card's memory, and
derive the roofline terms (launch/roofline.py) from what each device runs
(the port of the JAX package's ``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out experiments/dryrun_torch

Where the reference lowers and compiles for 512 placeholder devices, the
port runs the step once, eagerly, on ``device="meta"`` ``DTensor``s over a
``"fake"`` process group of 256 or 512 ranks in this one process: the
state is built from ``param_specs`` with each rank-0 shard's shape,
collectives carry no data, and a ``roofline.StepCounter`` counts what one
device runs (FLOPs, bytes, collective bytes, live memory).  Per-device
argument bytes are the local shards' bytes; the peak is that plus the
live-tensor peak of the step.  The fake group cannot share a process with
a real one: run the dry-run in a process of its own.  ``--device`` names
the mesh's device type (default ``cuda``, which needs a card; ``cpu``
without one); the tensors stay meta either way.

Results are cached to JSON (one file per cell, the reference's keys plus
``hw``, the card's constants); --force re-runs.

The index cells (``wlsh_index``) trace the index's mesh steps:
``train_4k`` the build step (``index.builder.make_build_step``: every
device encodes its 2^30 / chips rows), ``prefill_32k`` the query step
(``index.engine.make_query_step``: one scan of each device's rows that
keeps each (query, row)'s level and distance, one all-reduce of the
level histograms, a mask of the kept distances, one all-gather of the
survivors), with bfloat16 vectors and the rows over every device.  The
scan and the mask are one kernel launch each over the whole shard, so
the counts are direct: no scan to extrapolate.  The kernels' work is priced at their
own units' rates (``kernels/cost.py``), every other FLOP at the bfloat16
peak.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..configs.base import ARCHS, SHAPES, ModelConfig, ShapeConfig, get_config
from ..distributed.sharding import named_sharding, with_rules
from ..models import build_model, default_flags, input_specs
from ..models.params import (abstract_params, distribute, param_shardings,
                             tree_map)
from ..models.transformer import RunFlags
from ..training.optimizer import AdamWConfig
from ..training.train_loop import (batch_shardings, make_train_step,
                                   train_state_defs)
from .estimate import model_flops
from .mesh import make_production_mesh
from .roofline import (HW, StepCounter, analyze, collective_bytes,
                       kernel_terms)

HBM_PER_CHIP = 80 * 1024**3  # H100 80GB HBM3

# per-arch optimizer memory policy (the reference's): llama3-405b only
# fits a single 256-chip pod with bf16-SR master + int8 moments; everything
# else keeps full-precision state.
_OPT_POLICY: dict[str, AdamWConfig] = {
    "llama3_405b": AdamWConfig(master_dtype="bfloat16", moment_dtype="int8",
                               acc_dtype="bfloat16", update_chunk=2),
    "chameleon_34b": AdamWConfig(moment_dtype="int8", update_chunk=4),
}

# per-arch microbatch policy for train_4k (the reference's): gradient
# accumulation bounds the live-activation footprint.
_MICRO_POLICY: dict[str, int] = {
    "llama3_405b": 8,
    "chameleon_34b": 4,
    "moonshot_v1_16b_a3b": 2,
    "minicpm_2b": 2,  # 122k-vocab head
}


def _opt_cfg(arch: str) -> AdamWConfig:
    return _OPT_POLICY.get(arch, AdamWConfig())


def _microbatches(arch: str) -> int:
    return _MICRO_POLICY.get(arch, 1)


def skip_reason(arch: str, cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if cfg.family == "index":
        if shape.kind == "decode":
            return "index has no decode semantics (build/query only)"
        return None
    if shape.name == "long_500k" and cfg.full_attention:
        return ("pure full-attention arch: 500k-token decode needs a "
                "sub-quadratic cache (DESIGN.md Sec 5)")
    return None


def _bf16_defs(defs):
    """Serving params: all f32 leaves in bf16."""
    return tree_map(
        lambda d: dataclasses.replace(d, dtype="bfloat16")
        if d.dtype == "float32" else d,
        defs,
    )


def _cache_specs(model, mesh, cache_shapes):
    names_by_key = {
        "k": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v": ("layers", "batch", "kv_seq", "kv_heads", None),
        "ssm": ("layers", "batch", "heads", None, None),
        "conv": ("layers", "batch", None, "model"),
    }
    return {
        k: named_sharding(mesh, names_by_key[k], tuple(s.shape))
        for k, s in cache_shapes.items()
    }


def _mesh(mesh_name: str, device_type: str):
    """The production mesh of a cell; ``"one"`` is a (1, 1) mesh of one
    rank (the analysis of a one-card run)."""
    if mesh_name == "one":
        from torch.distributed.device_mesh import DeviceMesh

        from .mesh import init_fake_world

        init_fake_world(1)
        return DeviceMesh(device_type, torch.zeros((1, 1), dtype=torch.int64),
                          mesh_dim_names=("data", "model"))
    return make_production_mesh(multi_pod=mesh_name == "multi",
                                device_type=device_type)


def _count(counter: StepCounter, args: dict, run) -> dict:
    """Run ``run()`` under ``counter``; the counts of one device."""
    arg_bytes = {k: counter.register_args(v) for k, v in args.items()}
    with counter:
        run()
    memory = {
        "argument_bytes": int(sum(arg_bytes.values())),
        "output_bytes": 0,  # the step updates its arguments in place
        "temp_bytes": int(counter.peak),
        "code_bytes": 0,
        **{f"{k}_bytes": int(v) for k, v in arg_bytes.items()},
    }
    memory["total_bytes"] = memory["argument_bytes"] + memory["temp_bytes"]
    coll = collective_bytes(counter)
    out = {"flops": counter.flops, "bytes": counter.bytes,
           "coll": float(coll["total"]), "coll_detail": coll,
           "memory": memory}
    if counter.kernels:
        out.update(kernels=counter.kernels, **kernel_terms(counter))
    return out


def trace_train(model, shape: ShapeConfig, ocfg: AdamWConfig,
                microbatches: int = 1) -> dict:
    """The counts of one train step of ``model`` (on its mesh) at
    ``shape``, on meta tensors."""
    mesh = model.mesh
    sdefs = train_state_defs(model.defs(), ocfg)
    state = distribute(abstract_params(sdefs), param_shardings(sdefs, mesh))
    batch_abs = input_specs(model.cfg, shape)
    batch = distribute(batch_abs, batch_shardings(mesh, batch_abs))
    step = make_train_step(model, ocfg, microbatches=microbatches)
    return _count(StepCounter(mesh), {"state": state, "batch": batch},
                  lambda: step(state, batch))


def lower_cell(arch: str, shape_name: str, mesh_name: str,
               cfg_override: ModelConfig | None = None,
               flags: RunFlags | None = None, device_type: str = "cuda"):
    """Returns (traced, chips, extras) for one cell: the counts of one
    step on one device (``_count``'s dict)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    multi = mesh_name == "multi"
    mesh = _mesh(mesh_name, device_type)
    chips = mesh.size()

    if cfg.family == "index":
        return lower_index(cfg, shape, mesh)

    model = build_model(cfg, mesh=mesh, flags=flags or default_flags(cfg))
    defs = model.defs()

    if shape.kind == "train":
        traced = trace_train(model, shape, _opt_cfg(arch),
                             _microbatches(arch))
    elif shape.kind == "prefill":
        pdefs = _bf16_defs(defs)
        params = distribute(abstract_params(pdefs),
                            param_shardings(pdefs, mesh))
        batch_abs = input_specs(cfg, shape)
        batch = distribute(batch_abs, batch_shardings(mesh, batch_abs))

        def run():
            with torch.no_grad():
                model.prefill(params, batch)

        traced = _count(StepCounter(mesh),
                        {"params": params, "batch": batch}, run)
    else:  # decode
        data_size = chips // mesh.shape[mesh.mesh_dim_names.index("model")]
        rules = {}
        kv_axes = []
        if shape.global_batch % data_size != 0:
            # batch can't take the data axes -> cache sequence does
            kv_axes += ["pod", "data"] if multi else ["data"]
        eff_kv = cfg.n_kv_heads * model.kv_rep if cfg.n_kv_heads else 0
        model_size = mesh.shape[mesh.mesh_dim_names.index("model")]
        if eff_kv and eff_kv % model_size != 0:
            # MHA (G == 1, no kv replication possible): the head dim can't
            # shard over "model" -> the cache sequence does instead
            kv_axes.append("model")
        if kv_axes:
            rules["kv_seq"] = tuple(kv_axes)
        with with_rules(**rules):
            pdefs = _bf16_defs(defs)
            params = distribute(abstract_params(pdefs),
                                param_shardings(pdefs, mesh))
            cache_shapes = model.cache_shapes(shape.global_batch,
                                              shape.seq_len)
            cache = distribute(cache_shapes,
                               _cache_specs(model, mesh, cache_shapes))
            tok_abs = input_specs(cfg, shape)["tokens"]
            tokens = distribute(tok_abs, named_sharding(
                mesh, ("batch",), (shape.global_batch,)))

            def run():
                with torch.no_grad():
                    model.decode_step(params, cache, tokens,
                                      shape.seq_len // 2)

            traced = _count(StepCounter(mesh),
                            {"params": params, "cache": cache,
                             "tokens": tokens}, run)
    return traced, chips, {}


def index_config(cfg: ModelConfig, chips: int):
    """The index cell's ``IndexConfig``: ``vocab`` points of ``d_model``
    dimensions in ``d_ff`` tables, bfloat16 vectors (the JAX
    ``IndexConfig``'s default, so the cell is the reference's), the rows
    over all ``chips`` devices."""
    from ..index.config import IndexConfig

    return IndexConfig(n=cfg.vocab, d=cfg.d_model, beta=cfg.d_ff,
                       vec_dtype="bfloat16", n_shards=chips)


def trace_index(icfg, kind: str, mesh, inputs: dict | None = None,
                device="meta") -> dict:
    """The counts of one index step on ``mesh`` (``_count``'s dict): the
    build step (``kind="build"``) or the query step (``"query"``), on
    ``inputs`` (whole tensors, each rank keeping its shard: the state's
    fields and the step's arguments under the names of
    ``build_input_specs`` / ``query_input_specs``) or, without them, on
    meta tensors.  ``device`` is where the counted tensors lie."""
    from ..distributed.group_sharding import (distribute_state,
                                              state_shardings)
    from ..index.builder import build_input_specs, make_build_step
    from ..index.engine import make_query_step, query_input_specs, shardings
    from ..models.params import distribute

    layout = state_shardings(mesh, icfg)
    counter = StepCounter(mesh, device=device)
    if kind == "build":  # points, proj, b_int, b_frac: the state's fields
        spec = inputs or build_input_specs(icfg)
        args = {k: distribute(v, getattr(layout, k)) for k, v in spec.items()}
        step = make_build_step(mesh, icfg)
        return _count(counter, args, lambda: step(**args))
    spec = dict(inputs or query_input_specs(icfg))
    state = distribute_state(spec.pop("state"), layout)
    sh = shardings(mesh)
    args = {k: distribute(v, sh["queries" if v.ndim == 2 else "q_meta"])
            for k, v in spec.items()}
    step = make_query_step(mesh, icfg)

    def run():
        with torch.no_grad():
            step(state, **args)

    return _count(counter, {"state": vars(state), **args}, run)


def lower_index(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(traced, chips, extras) of an index cell on ``mesh``: the build
    step (train shapes) or the query step, traced once on meta
    ``DTensor``s."""
    chips = mesh.size()
    icfg = index_config(cfg, chips)
    kind = "build" if shape.kind == "train" else "query"
    traced = trace_index(icfg, kind, mesh)
    method = ("direct (one hash_encode launch over each device's rows)"
              if kind == "build" else
              "direct (one launch a pass over each device's rows)")
    return traced, chips, {"index_cfg": dataclasses.asdict(icfg),
                           "analysis_method": method,
                           "kernels": traced["kernels"]}


def _analysis_depths(cfg: ModelConfig) -> tuple[int, int]:
    if cfg.family == "hybrid":
        e = max(cfg.shared_block_every, 1)
        return e, 2 * e
    return 2, 4


def analysis_terms(arch: str, shape_name: str, mesh_name: str,
                   device_type: str = "cuda") -> dict:
    """Per-chip roofline inputs by the reference's two-point depth
    extrapolation: trace the step at two shallow depths L1 < L2 (one
    checkpoint a layer, ``layer_groups=1``), fit each term linear in depth
    and extrapolate to the real depth.  The port's eager counts are exactly
    linear in depth, so this reproduces a full-depth count (the test holds
    it to one) at the cost of two shallow traces; the full-depth trace in
    ``run_cell`` gives the memory, whose loop buffers a fit cannot see.
    """
    cfg = get_config(arch)
    L1, L2 = _analysis_depths(cfg)
    full_scan = cfg.n_layers - cfg.first_dense_layers
    flags = RunFlags(layer_groups=1)
    pts = []
    for Lk in (L1, L2):
        cfg_k = dataclasses.replace(
            cfg, n_layers=Lk + cfg.first_dense_layers
        )
        traced, _, _ = lower_cell(arch, shape_name, mesh_name,
                                  cfg_override=cfg_k, flags=flags,
                                  device_type=device_type)
        pts.append(traced)
    out = {}
    for key in ("flops", "bytes", "coll"):
        slope = (pts[1][key] - pts[0][key]) / (L2 - L1)
        out[key] = pts[0][key] + slope * (full_scan - L1)
    by0, by1 = (p["coll_detail"]["bytes"] for p in pts)
    out["coll_detail"] = {
        "by_kind": {k: by0[k] + (by1[k] - by0[k]) / (L2 - L1)
                    * (full_scan - L1) for k in by0},
        "per_layer_bytes": (pts[1]["coll"] - pts[0]["coll"]) / (L2 - L1),
        "base_bytes": pts[0]["coll_detail"]["bytes"],
        "counts_at_L1": pts[0]["coll_detail"]["counts"],
    }
    out["method"] = (
        f"two-point depth extrapolation L1={L1}, L2={L2} -> {full_scan}"
    )
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             force: bool = False, device_type: str = "cuda") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(arch, cfg, shape)
    t0 = time.time()
    if reason:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skipped", "reason": reason}
    else:
        try:
            traced, chips, extras = lower_cell(
                arch, shape_name, mesh_name, device_type=device_type
            )
            terms = (None if cfg.family == "index" else analysis_terms(
                arch, shape_name, mesh_name, device_type=device_type))
            rr = analyze(
                arch, shape_name, mesh_name, chips, traced,
                model_flops(cfg, shape), terms=terms,
            )
            mem_total = rr.memory.get("total_bytes", 0)
            result = {
                "status": "ok",
                "compile_s": round(time.time() - t0, 1),
                "fits_hbm": bool(mem_total <= HBM_PER_CHIP),
                "hbm_gb": round(mem_total / 1024**3, 2),
                "analysis_method": (terms or {}).get("method", "direct"),
                **rr.to_dict(),
                **extras,
                "hw": dataclasses.asdict(HW()),
            }
        except Exception as e:  # noqa: BLE001 — per-cell isolation
            result = {
                "arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
                "compile_s": round(time.time() - t0, 1),
            }
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def _fmt(result: dict) -> str:
    if result["status"] == "skipped":
        return (f"{result['arch']:22s} {result['shape']:12s} "
                f"{result['mesh']:6s} SKIP   {result['reason'][:60]}")
    if result["status"] == "error":
        return (f"{result['arch']:22s} {result['shape']:12s} "
                f"{result['mesh']:6s} ERROR  {result['error'][:80]}")
    return (
        f"{result['arch']:22s} {result['shape']:12s} {result['mesh']:6s} "
        f"ok {result['hbm_gb']:7.2f}GB/chip "
        f"c={result['compute_s']:.2e}s m={result['memory_s']:.2e}s "
        f"x={result['collective_s']:.2e}s -> {result['bottleneck']:10s} "
        f"useful={result['useful_fraction']:.2f} "
        f"[{result['compile_s']:.0f}s trace]"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the meshes' device type (default cuda, which "
                         "needs a card; cpu without one); tensors stay meta")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device; pass --device cpu "
                           "to trace on a host without a card")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    failures = 0
    for arch in archs:
        arch = arch.replace("-", "_").replace("1.2b", "1p2b")
        for shape_name in shapes:
            for mesh_name in meshes:
                result = run_cell(arch, shape_name, mesh_name, args.out,
                                  force=args.force, device_type=args.device)
                print(_fmt(result), flush=True)
                if result["status"] == "error":
                    failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
