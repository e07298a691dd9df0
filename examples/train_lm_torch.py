"""End-to-end training driver of the PyTorch port: an LM trained for a few
hundred steps on the deterministic markov stream, with checkpointing +
injected failure + automatic restart (the fault-tolerance path exercised
for real).

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
    PYTHONPATH=src python examples/train_lm_torch.py --hundredm

The port's copy of ``examples/train_lm.py``, through
``repro_torch.launch.train`` on the card (``--device cpu`` for the host).
The quick mode runs the reduced olmo-1b config (~1M params, 200 steps);
--hundredm scales d_model/layers to ~100M params with fewer steps — the
code path is identical.  It asserts what the JAX example asserts: one
restart, and the last steps' mean loss 0.3 below the first step's.
"""

import argparse
import dataclasses
import shutil
import tempfile

import repro_torch.launch.train as T
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import build_model, count_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundredm", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args_in = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="wlsh_train_lm_")
    try:
        args = T.parse_args([
            "--arch", "olmo-1b", "--reduced",
            "--steps", str(args_in.steps or (60 if args_in.hundredm else 200)),
            "--global-batch", "8",
            "--seq-len", "128",
            "--lr", "3e-3",
            "--ckpt-dir", ckpt,
            "--ckpt-every", "25",
            "--log-every", "10",
            "--fail-at", "40",  # injected failure -> restart from checkpoint
            "--device", args_in.device,
        ])
        if args_in.hundredm:
            # ~100M params on the same olmo family:
            # 12 layers x d_model 512 + 32k vocab ~= 1.1e8 params
            cfg = dataclasses.replace(
                reduced(get_config("olmo-1b")),
                name="olmo-100m", d_model=512, n_layers=12,
                n_heads=8, n_kv_heads=8, d_ff=2048, vocab=32_000,
                head_dim=64,
            )
            n = count_params(build_model(cfg).defs())
            print(f"config {cfg.name}: {n / 1e6:.1f}M params")
            out = T.train(args, cfg=cfg)
        else:
            out = T.train(args)
        assert out["restarts"] == 1, "injected failure must trigger a restart"
        assert out["loss_last_avg"] < out["loss_first"] - 0.3, (
            "model must learn the markov stream"
        )
        print("ok:", {k: v for k, v in out.items() if k != "steps"})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
