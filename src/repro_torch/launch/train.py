"""Training launcher: config -> model -> train loop on one device or a
mesh, with the full fault-tolerance stack (checkpoint/restart, preemption
handling, straggler monitoring, bounded auto-restart supervision):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --reduced --steps 200 --global-batch 8 --seq-len 128 \
        --ckpt-dir /tmp/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch olmo-1b --reduced --mesh 4,2 --device cpu

The flags and the report are the JAX launcher's (``repro.launch.train``)
plus ``--device`` (default ``cuda``; ``--device cpu`` for the host).
``--mesh "4,2"`` trains on a (data, model) ``DeviceMesh`` over the
process group (``torchrun`` starts one process a device; the launcher
starts NCCL on ``cuda``, one card a process, and gloo on ``--device
cpu``; without ``torchrun`` it starts a group of one).  The mesh must
have one device a process; ``""`` and ``"1"`` train on one device without
a mesh.  Parameters are drawn from a ``torch.Generator`` seeded with
``--seed`` on the device (on a mesh, whole on every rank, which keeps its
shard); the data stream is the reference's numpy stream, so restart-resume
is exactly-once, and on a mesh a checkpoint holds whole leaves (rank 0
writes them) that resume under any mesh.  Rank 0 prints.

From Python, ``train(args, cfg=..., optimizer=...)`` also takes a model
config the flags cannot name and ``AdamWConfig`` fields that have no flag
(as in the reference): ``optimizer=dict(master_dtype="bfloat16",
moment_dtype="int8", update_chunk=4)`` trains with bfloat16 master weights
and int8 moments.  The report's ``steps`` lists every step run (restarts
included) with its data step, optimizer step, loss and milliseconds (CUDA
events on the card, the host clock elsewhere).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import get_config, reduced as reduce_cfg
from ..distributed.fault import (PreemptionHandler, RestartSupervisor,
                                 StragglerMonitor)
from ..kernels.platform import resolve_device
from ..models import abstract_params, build_model, init_params
from ..models.params import distribute
from ..training.checkpoint import CheckpointManager
from ..training.data import DataConfig, SyntheticStream
from ..training.optimizer import AdamWConfig
from ..training.train_loop import (batch_shardings, init_train_state,
                                   make_train_step, train_state_defs,
                                   train_state_shardings)

__all__ = ["train", "main", "parse_args"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_or_none(spec: str, dev: torch.device):
    """(mesh, device, whether this call started the process group): no
    mesh for ``""`` / ``"1"``; else a DeviceMesh of that shape with the
    reference's axis names over the process group, one device a rank."""
    from torch.distributed.device_mesh import init_device_mesh

    if not spec or spec == "1":
        return None, dev, False
    shape = tuple(int(x) for x in spec.split(","))
    names = ("data", "model")[: len(shape)]
    started = not dist.is_initialized()
    if started:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:  # torchrun
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
    n = dist.get_world_size()
    if int(np.prod(shape)) != n:
        if started:
            dist.destroy_process_group()
        raise ValueError(f"--mesh {spec!r} has {int(np.prod(shape))} "
                         f"devices; the process group has {n} ranks (one "
                         "device a rank)")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    mesh = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    return mesh, dev, started


class _StepTimer:
    """One train step's time: a pair of CUDA events on the card (read once
    the run has synchronized), the host clock elsewhere."""

    def __init__(self, dev):
        self.events = None
        if dev.type == "cuda":
            self.events = [torch.cuda.Event(enable_timing=True)
                           for _ in range(2)]
            self.events[0].record()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.events:
            self.events[1].record()
        else:
            self.ms = 1e3 * (time.perf_counter() - self.t0)

    def read(self) -> float:
        if self.events:
            return self.events[0].elapsed_time(self.events[1])
        return self.ms


def train(args, *, cfg=None, optimizer: dict | None = None) -> dict:
    """Run the launcher; ``cfg`` replaces the config ``--arch`` names and
    ``optimizer`` holds ``AdamWConfig`` fields that replace the launcher's
    (see the module docstring)."""
    dev = resolve_device(args.device)
    mesh, dev, started = _mesh_or_none(args.mesh, dev)
    try:
        return _train(args, cfg, optimizer, dev, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, optimizer, dev, mesh) -> dict:
    lead = mesh is None or dist.get_rank() == 0

    def say(*a, **k):
        if lead:
            print(*a, **k)

    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduce_cfg(cfg)
    model = build_model(cfg, mesh=mesh)
    ocfg = AdamWConfig(
        lr=args.lr,
        warmup_steps=max(10, args.steps // 20),
        total_steps=args.steps,
        schedule="wsd" if cfg.name.startswith("minicpm") else "cosine",
    )
    ocfg = dataclasses.replace(ocfg, **(optimizer or {}))
    stream = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
        seed=args.seed, mode="markov",
    ))
    step_fn = make_train_step(model, ocfg, microbatches=args.microbatches)
    sh = train_state_shardings(model.defs(), ocfg, mesh) if mesh else None

    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every,
                            keep=3) if args.ckpt_dir else None
    preempt = PreemptionHandler()
    straggler = StragglerMonitor(window=50, threshold=args.straggler_ratio)
    supervisor = RestartSupervisor(max_restarts=args.max_restarts)
    history: list[float] = []
    trace: list[tuple] = []  # (data step, optimizer step, timer) a step
    restored: dict = {}

    def fresh_state():
        params = init_params(
            model.defs(), torch.Generator(device=dev).manual_seed(args.seed),
            device=dev)
        state = init_train_state(model.defs(), params, ocfg)
        return distribute(state, sh) if mesh else state

    def resume_step() -> int:
        """The data step of the latest checkpoint (0 without one); its
        state is kept for the body, so a restart reads it once."""
        if mgr is None:
            return 0
        mgr.wait()  # a save still being written is the latest
        if mesh is not None:
            dist.barrier()  # rank 0 has written it
        template = abstract_params(train_state_defs(model.defs(), ocfg))
        got = mgr.restore_or_none(template, device=dev, shardings=sh)
        if got is None:
            return 0
        restored["state"] = got[1]
        return got[2].get("data_step", 0)

    def body(start_step: int):
        state = restored.pop("state", None) or fresh_state()
        loss = float("nan")
        for s in range(start_step, args.steps):
            straggler.start()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.global_batch(s).items()}
            if mesh is not None:
                batch = distribute(batch, batch_shardings(mesh, batch))
            timer = _StepTimer(dev)
            state, metrics = step_fn(state, batch)
            timer.stop()
            loss = float(metrics["loss"])  # synchronizes with the device
            history.append(loss)
            trace.append((s, metrics["step"], timer))
            rep = straggler.stop()
            if rep is not None:
                say(f"[straggler] step {s}: {rep.duration:.2f}s = "
                    f"{rep.ratio:.1f}x median", flush=True)
            if args.fail_at is not None and s == args.fail_at:
                args.fail_at = None  # fail exactly once
                raise RuntimeError("injected failure (--fail-at)")
            if s % args.log_every == 0:
                say(f"step {s:5d}  loss {loss:.4f}  "
                    f"lr {float(metrics['lr']):.2e}  "
                    f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
            if mgr is not None:
                mgr.maybe_save(s + 1, state, extra={"data_step": s + 1})
            if preempt.should_stop:
                say("[preempt] SIGTERM received: checkpoint + exit",
                    flush=True)
                if mgr is not None:
                    mgr.maybe_save(s + 1, state,
                                   extra={"data_step": s + 1}, force=True)
                    mgr.wait()
                break
        if mgr is not None:
            mgr.maybe_save(args.steps, state,
                           extra={"data_step": args.steps}, force=True)
            mgr.wait()
        return {"final_loss": loss, "steps_run": len(history),
                "restarts": supervisor.restarts,
                "stragglers": len(straggler.flagged)}

    t0 = time.time()
    try:
        out = supervisor.run(body, resume_step)
    finally:
        preempt.restore()
    out["wall_s"] = round(time.time() - t0, 1)
    out["loss_first"] = history[0] if history else float("nan")
    out["loss_last_avg"] = float(np.mean(history[-10:])) if history else None
    say(f"done: {out}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["steps"] = [dict(step=s, opt_step=int(n), loss=loss, ms=t.read())
                    for (s, n, t), loss in zip(trace, history)]
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the arch (smoke scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="",
                    help="data,model mesh shape, e.g. '4,2' (one device a "
                         "torchrun rank); '' or '1': one device, no mesh")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--straggler-ratio", type=float, default=3.0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject one failure at this step (restart demo)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the host)")
    return ap.parse_args(argv)


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
