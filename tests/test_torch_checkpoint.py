"""The port's checkpointing (``repro_torch.training.checkpoint``) and the
train launcher's restart, and ``tests/test_checkpoint.py``'s semantics on
the port.

* A checkpoint the JAX package writes (a train state with bfloat16 master
  and int8 moments, whose bfloat16 leaves ``np.save`` stores as ``|V2``)
  loads into the port's template bit for bit, under the same
  ``keystr`` keys.
* bfloat16 and uint32 leaves round-trip bit for bit (bfloat16 stored as
  its uint16 bits under manifest dtype ``bfloat16``).
* An asynchronous save copies every leaf before it returns: a later
  in-place step does not reach the files.
* The JAX tests' semantics (round trip, keep-k, extra metadata, structure
  mismatch, crash atomicity, the manager, a load onto a named device in
  place of the elastic mesh, exactly-once resume — here also with
  bfloat16 master, whose stochastic rounding must repeat), and the
  launcher's injected-failure restart (``tests/test_serving_launch.py``),
  and its ``cfg=`` / ``optimizer=`` parameters with their per-step report.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.checkpoint import save_checkpoint as jax_save
from repro_torch.configs import get_config, reduced
from repro_torch.models import abstract_params, build_model, init_params
from repro_torch.models.params import from_numpy, tree_leaves, tree_map
from repro_torch.training import (AdamWConfig, CheckpointManager, DataConfig,
                                  SyntheticStream, init_train_state,
                                  latest_step, load_checkpoint,
                                  make_train_step, save_checkpoint,
                                  train_state_defs)

torch.set_num_threads(1)  # several xdist workers share the machine's cores


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
        "nest": {"b": torch.arange(10, dtype=torch.int32),
                 "c": torch.from_numpy(rng.normal(size=(3,)))},
    }


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_roundtrip(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = _tree(1)
    save_checkpoint(root, 7, tree)
    step, restored, extra = load_checkpoint(root, tree)
    assert step == 7
    assert _equal(tree, restored)


def test_bf16_and_uint32_leaves_roundtrip(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = {"w": torch.randn(5, 7).to(torch.bfloat16),
            "rng": torch.tensor([0, 2 ** 32 - 1], dtype=torch.uint32),
            "q": torch.tensor([-127, 0, 127], dtype=torch.int8)}
    save_checkpoint(root, 1, tree)
    d = os.path.join(root, "step_000000001")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["['q']", "['rng']", "['w']"]
    assert manifest["dtypes"] == ["int8", "uint32", "bfloat16"]
    assert np.load(os.path.join(d, "000002.npy")).dtype == np.uint16
    _, restored, _ = load_checkpoint(root, tree)
    assert _equal(tree, restored)


def test_jax_written_checkpoint_loads_bit_for_bit(tmp_path):
    """A JAX train state (bfloat16 master, int8 moments, uint32 rng) saved
    by the JAX package loads into the port's template unchanged."""
    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import build_model as jax_build_model
    from repro.models import init_params as jax_init_params
    from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
    from repro.training.train_loop import init_train_state as jax_init
    from repro.training.train_loop import make_train_step as jax_step

    kw = dict(master_dtype="bfloat16", moment_dtype="int8", warmup_steps=0)
    jm = jax_build_model(jax_reduced(jax_get_config("olmo_1b")))
    js = jax_init(jm.defs(), jax_init_params(jm.defs(),
                                             jax.random.PRNGKey(0)),
                  JaxAdamWConfig(**kw), seed=3)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.cfg.vocab, (2, 17)).astype(np.int32)
    js, _ = jax.jit(jax_step(jm, JaxAdamWConfig(**kw)))(
        js, {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])})
    root = str(tmp_path / "ckpt")
    jax_save(root, 1, js, extra={"data_step": 1})

    model = build_model(reduced(get_config("olmo_1b")))
    template = abstract_params(train_state_defs(model.defs(),
                                                AdamWConfig(**kw)))
    step, got, extra = load_checkpoint(root, template)
    assert step == 1 and extra == {"data_step": 1}
    flat = jax.tree_util.tree_flatten_with_path(js)[0]
    leaves = tree_leaves(got)
    assert len(flat) == len(leaves)
    for (path, a), b in zip(flat, leaves):
        a = np.asarray(a)
        want = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        have = (b.view(torch.int16).numpy().view(np.uint16)
                if b.dtype == torch.bfloat16 else b.numpy())
        assert b.dtype == getattr(torch, a.dtype.name), jax.tree_util.keystr(
            path)
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(have, want)


def test_from_numpy_carries_bfloat16_payloads():
    """``from_numpy``: ml_dtypes' bfloat16 (a JAX array's), a ``|V2`` or
    ``uint16`` payload named bfloat16, uint32, and 0-d leaves."""
    x = jnp.asarray(np.random.default_rng(9).normal(size=(3, 5)),
                    jnp.bfloat16)
    bits = np.asarray(x).view(np.uint16)
    tree = {"ml": np.asarray(x), "v2": bits.view("V2"), "u16": bits,
            "u32": np.array([0, 2 ** 32 - 1], np.uint32),
            "step": np.array(4, np.int32)}
    got = from_numpy(tree, {"ml": None, "v2": "bfloat16", "u16": "bfloat16",
                            "u32": None, "step": None})
    for k in ("ml", "v2", "u16"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy().view(np.uint16), bits)
    assert got["u32"].dtype == torch.uint32
    assert got["u32"].tolist() == [0, 2 ** 32 - 1]
    assert got["step"].shape == () and got["step"].item() == 4
    assert from_numpy({"u16": bits})["u16"].dtype == torch.uint16


def test_async_save_copies_before_return(tmp_path):
    """On the CPU a tensor's host copy would alias it: the saver copies,
    so the in-place step after an asynchronous save leaves the files."""
    root = str(tmp_path / "ckpt")
    tree = _tree(2)
    want = tree_map(torch.clone, tree)
    thread = save_checkpoint(root, 1, tree, async_write=True)
    for t in tree_leaves(tree):
        t.add_(1)
    thread.join()
    _, restored, _ = load_checkpoint(root, tree)
    assert _equal(want, restored)


def test_latest_and_keep_k(tmp_path):
    root = str(tmp_path / "ckpt")
    tree = _tree(2)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(root, s, tree, keep=3)
    assert latest_step(root) == 5
    kept = sorted(os.listdir(root))
    assert kept == ["step_000000003", "step_000000004", "step_000000005"]


def test_extra_metadata(tmp_path):
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, 1, _tree(), extra={"data_step": 41})
    _, _, extra = load_checkpoint(root, _tree())
    assert extra["data_step"] == 41


def test_structure_mismatch_rejected(tmp_path):
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, 1, _tree())
    with pytest.raises(ValueError):
        load_checkpoint(root, {"different": torch.zeros(3)})


def test_no_partial_checkpoint_on_crash(tmp_path):
    """Simulated crash mid-write must leave the old checkpoint intact."""
    root = str(tmp_path / "ckpt")
    tree = _tree(3)
    save_checkpoint(root, 1, tree)
    os.makedirs(os.path.join(root, ".tmp_000000002"))
    with open(os.path.join(root, ".tmp_000000002", "garbage"), "w") as f:
        f.write("partial")
    assert latest_step(root) == 1
    step, restored, _ = load_checkpoint(root, tree)
    assert step == 1
    save_checkpoint(root, 2, tree)
    assert latest_step(root) == 2


def test_manager_every_and_force(tmp_path):
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, every=10, keep=2, async_write=True)
    tree = _tree(4)
    assert not mgr.maybe_save(5, tree)
    assert mgr.maybe_save(10, tree)
    assert mgr.maybe_save(11, tree, force=True)
    mgr.wait()
    assert latest_step(root) == 11
    assert mgr.restore_or_none(tree) is not None
    assert CheckpointManager(str(tmp_path / "none")).restore_or_none(
        tree) is None


def test_restore_onto_a_named_device(tmp_path):
    """Saved from one device, restored onto the one named (the port's
    stand-in for the reference's restore under another mesh)."""
    root = str(tmp_path / "ckpt")
    tree = _tree(5)
    save_checkpoint(root, 3, tree)
    step, restored, _ = load_checkpoint(root, abstract_like(tree),
                                        device=torch.device("cpu"))
    assert step == 3
    assert all(t.device == torch.device("cpu") for t in tree_leaves(restored))
    assert _equal(tree, restored)


def abstract_like(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


@pytest.mark.parametrize("master", ["float32", "bfloat16"])
def test_train_resume_exactly_once(tmp_path, master):
    """Kill-and-resume mid-run reproduces the uninterrupted run exactly
    (deterministic data stream + checkpointed step counter; with bfloat16
    master, the stochastic-rounding bits repeat from (rng, step, leaf))."""
    cfg = reduced(get_config("olmo_1b"))
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant",
                       master_dtype=master,
                       moment_dtype="int8" if master == "bfloat16"
                       else "float32")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=16,
                                        global_batch=4))
    step_fn = make_train_step(model, ocfg)

    def fresh():
        params = init_params(model.defs(), torch.Generator().manual_seed(7),
                             device="cpu")
        return init_train_state(model.defs(), params, ocfg)

    def run(state, steps):
        for s in steps:
            b = {k: torch.from_numpy(v)
                 for k, v in stream.global_batch(s).items()}
            state, _ = step_fn(state, b)
        return state

    want = run(fresh(), range(6))
    root = str(tmp_path / "ckpt")
    save_checkpoint(root, 3, run(fresh(), range(3)), extra={"data_step": 3})
    template = abstract_params(train_state_defs(model.defs(), ocfg))
    _, state, extra = load_checkpoint(root, template)
    got = run(state, range(extra["data_step"], 6))
    assert _equal(want, got)


def test_train_launcher_restart_resume(tmp_path):
    """Injected failure at step 6 -> supervisor restarts from checkpoint,
    run completes, loss history continuous."""
    from repro_torch.launch.train import parse_args, train

    args = parse_args([
        "--arch", "olmo-1b", "--reduced", "--steps", "12",
        "--global-batch", "4", "--seq-len", "16",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3",
        "--log-every", "100", "--fail-at", "6", "--device", "cpu",
    ])
    out = train(args)
    assert out["restarts"] == 1
    assert out["steps_run"] == 13  # step 6 runs twice, from the step-6 save
    assert np.isfinite(out["final_loss"])


def test_train_launcher_takes_optimizer_fields_and_records_steps(tmp_path):
    """``train(args, cfg=, optimizer=)``: a config and AdamW fields the
    flags cannot name reach the run (the checkpoint holds bfloat16 master
    and int8 moments), and the report lists every step run, the repeated
    one after the restart included."""
    from repro_torch.launch.train import parse_args, train

    cfg = reduced(get_config("olmo-1b"))
    opt = dict(master_dtype="bfloat16", moment_dtype="int8", update_chunk=2)
    root = str(tmp_path / "ckpt")
    out = train(parse_args([
        "--steps", "4", "--global-batch", "2", "--seq-len", "16",
        "--ckpt-dir", root, "--ckpt-every", "2", "--log-every", "100",
        "--fail-at", "2", "--device", "cpu",
    ]), cfg=cfg, optimizer=opt)
    assert out["restarts"] == 1
    rows = out["steps"]
    assert [r["step"] for r in rows] == [0, 1, 2, 2, 3]
    assert [r["opt_step"] for r in rows] == [1, 2, 3, 3, 4]
    assert rows[-1]["loss"] == out["final_loss"]
    assert all(r["ms"] > 0 for r in rows)
    template = abstract_params(train_state_defs(
        build_model(cfg).defs(), AdamWConfig(**opt)))
    step, state, _ = load_checkpoint(root, template)
    assert step == 4 and int(state["opt"]["step"]) == 4
    assert {t.dtype for t in tree_leaves(state["opt"]["master"])} == {
        torch.bfloat16}
    wq = state["opt"]["moments"]["blocks"]["attn"]["wq"]
    assert wq["m"]["q"].dtype == wq["v"]["q"].dtype == torch.int8


def test_train_launcher_refuses_a_mesh_and_a_missing_card():
    from repro_torch.launch.train import parse_args, train

    # without torchrun the launcher starts a group of one process: a mesh
    # of 8 devices is refused
    with pytest.raises(ValueError, match="has 8 devices"):
        train(parse_args(["--reduced", "--mesh", "4,2", "--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(parse_args(["--reduced", "--steps", "1"]))
