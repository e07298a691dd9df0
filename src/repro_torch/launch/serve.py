"""Serving launcher: batched autoregressive generation behind the decode
step, on the card by default (``--device cpu`` for the host):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --reduced --batch 4 --prompt-len 16 --max-new 32

The flags are the JAX launcher's (``repro.launch.serve``) plus
``--device``.  Parameters are drawn from a ``torch.Generator`` seeded with
``--seed`` on the device; the prompts from numpy's generator with the
same seed, as the JAX launcher draws them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config, reduced as reduce_cfg
from ..kernels.platform import resolve_device
from ..models import build_model, init_params
from ..serving.decode import SamplerConfig, generate

__all__ = ["serve", "main", "parse_args"]


def serve(args) -> dict:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, mesh=None)
    params = init_params(model.defs(),
                         torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    out = generate(
        model, params, prompts,
        max_new_tokens=args.max_new,
        cache_len=args.prompt_len + args.max_new,
        sampler=SamplerConfig(temperature=args.temperature, top_k=args.top_k,
                              seed=args.seed),
        device=dev,
    )
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{cfg.name}: generated {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s incl. the prompt) on {where}")
    for b in range(min(args.batch, 2)):
        print(f"  seq {b}: {out[b][:16].tolist()} ...")
    return {"tokens": out, "tok_per_s": toks / dt}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
