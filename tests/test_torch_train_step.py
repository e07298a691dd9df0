"""The port's training loss, gradients and train step against the JAX
package's, and ``tests/test_models_smoke.py``'s train step on the port.

* ``Model.loss`` and every gradient leaf, float32, for each of the 10
  reduced archs on the JAX package's parameters (carried across by
  ``from_jax_params``) and a batch drawn with numpy from a seed: the loss
  to rtol 1e-5, each gradient leaf to rtol 1e-4 with atol 5e-6 x the
  leaf's largest magnitude.  XLA and torch order their float32 sums
  apart: the largest difference read was 2.4e-6 of a leaf's largest
  magnitude, and on two elements of all ten archs (moonshot's, zamba2's)
  it exceeded 1e-6 of it, at 1.5e-6 and 1.6e-6.
* Rematerialization changes no number: per-layer checkpoints and nested
  layer groups give the loss and gradients of a run with checkpointing
  bypassed (a test-local patch of ``transformer._remat``) bit for bit.
* One bfloat16 ``make_train_step`` from the same parameters: the loss
  within 2e-2 relative, the grad norm within 5e-2, the new float32 master
  correlated above 0.999 with JAX's (the bounds of the reference's own
  ``test_microbatch_accumulation_equivalence``).
* ``default_flags`` equals the reference's for every full config.
* The JAX smoke test's train step, per arch, on the port alone.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import LM_ARCHS, lm_pair
from repro.configs.base import get_config as jax_get_config
from repro.models.model import default_flags as jax_default_flags
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.train_loop import init_train_state as jax_init_state
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.models import (RunFlags, build_model, default_flags,
                                init_params, make_batch, transformer)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.training import (AdamWConfig, init_train_state,
                                  make_train_step)

torch.set_num_threads(1)  # several xdist workers share the machine's cores

B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol_share=5e-6)
_SMOKE_SHAPE = ShapeConfig("smoke", seq_len=32, global_batch=2, kind="train")


def _batches(cfg, seed: int):
    """(JAX batch, port batch) with labels, drawn with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        jb, pb = {"embeddings": jnp.asarray(x)}, {
            "embeddings": torch.from_numpy(x)}
    else:
        t = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        jb, pb = {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb["labels"] = jnp.asarray(lab)
    pb["labels"] = torch.from_numpy(lab)
    return jb, pb


def _loss_and_grads(model, params, batch):
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                materialize_grads=True)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, pm, pp = lm_pair(arch, "float32")
    jb, pb = _batches(pm.cfg, seed=5)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    pl, pg = _loss_and_grads(pm, pp, pb)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=LOSS_RTOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(pg)
    for a, b in zip(jleaves, pg):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == torch.float32
        np.testing.assert_allclose(
            b.numpy(), a, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol_share"] * float(np.abs(a).max()))


@pytest.mark.parametrize("arch", ["olmo_1b", "olmoe_1b_7b", "zamba2_1p2b"])
def test_remat_changes_no_number(arch, monkeypatch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    params = init_params(build_model(cfg).defs(),
                         torch.Generator().manual_seed(0), device="cpu")
    _, pb = _batches(cfg, seed=6)
    with monkeypatch.context() as m:  # no checkpoint: every activation kept
        m.setattr(transformer, "_remat", lambda fn: fn)
        runs = [_loss_and_grads(build_model(cfg), params, pb)]
    runs += [_loss_and_grads(build_model(cfg, flags=RunFlags(layer_groups=g)),
                             params, pb) for g in (1, 2)]
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        for a, b in zip(grads, runs[0][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m"])
def test_bf16_train_step_matches_jax(arch):
    jm, jp, pm, pp = lm_pair(arch)  # the config's own bfloat16 compute
    jb, pb = _batches(pm.cfg, seed=7)
    kw = dict(lr=1e-3, warmup_steps=0, schedule="constant")
    js = jax_init_state(jm.defs(), jp, JaxAdamWConfig(**kw))
    js, jmet = jax.jit(jax_train_step(jm, JaxAdamWConfig(**kw)))(js, jb)
    ocfg = AdamWConfig(**kw)
    ps = init_train_state(pm.defs(), tree_map(torch.clone, pp), ocfg)
    ps, pmet = make_train_step(pm, ocfg)(ps, pb)
    assert pmet["loss"].item() == pytest.approx(float(jmet["loss"]),
                                                rel=2e-2)
    assert pmet["grad_norm"].item() == pytest.approx(
        float(jmet["grad_norm"]), rel=5e-2)
    assert int(pmet["step"]) == int(jmet["step"]) == 1
    a = np.concatenate([np.ravel(x)
                        for x in jax.tree.leaves(js["opt"]["master"])])
    b = torch.cat([x.ravel() for x in tree_leaves(ps["opt"]["master"])])
    assert np.corrcoef(a, b.numpy())[0, 1] > 0.999


def test_default_flags_match_jax():
    for arch in LM_ARCHS:
        j = jax_default_flags(jax_get_config(arch))
        p = default_flags(get_config(arch))
        # the port always rematerializes, the reference's default
        assert j.remat == "full", arch
        assert (p.layer_groups, p.causal_block_skip) == (
            j.layer_groups, j.causal_block_skip), arch
        assert default_flags(reduced(get_config(arch))).layer_groups == 1
    assert default_flags(get_config("llama3_405b")).layer_groups > 1


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_runs_and_loss_finite(arch):
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = init_params(model.defs(), torch.Generator().manual_seed(0),
                         device="cpu")
    batch = make_batch(cfg, _SMOKE_SHAPE, seed=2, device="cpu")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_train_state(model.defs(), params, ocfg)
    state, metrics = make_train_step(model, ocfg)(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    # random tokens: loss ~= ln(vocab)
    assert 0.0 < loss < 2.0 * np.log(cfg.vocab)
    assert int(metrics["step"]) == 1
