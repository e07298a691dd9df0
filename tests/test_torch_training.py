"""The port's optimizer and train step (``repro_torch.training``) against
the JAX package's, and ``tests/test_training.py``'s semantics on the port.

* Same function as JAX, on inputs drawn with numpy from a seed:
  ``lr_schedule`` at every step of a 100-step run (rtol 1e-6: the cosine's
  ``cos`` differs in the last bit); ``_quantize`` codes and scales equal
  on a padded last dim, in both rounding modes; ``_sr_cast_bf16`` bit for
  bit given the bits ``jax.random.bits`` draws for the reference's key;
  ``adamw_update`` over three steps, each from the same state (JAX's,
  carried across) on the same gradients — float32
  master with float32 or bfloat16 moments to rtol 1e-6 (atol 1e-6 x the
  leaf's largest magnitude: XLA fuses a multiply-add where torch rounds
  twice, an ulp of the operand that a near-zero result inherits), int8
  moments with codes equal but at ties (a differing share of at most
  1e-3, each by one), bfloat16 moments likewise by their bits (a float32
  value one ulp apart can round to the neighbouring bfloat16); one step with bfloat16 master within one bfloat16 ulp of JAX's
  (both round the same float32 value, with other random bits);
  ``train_state_defs`` with the same keys, shapes and dtypes.
* ``update_chunk`` bit-equal to the unchunked update (float32 master),
  and the stochastic-rounding bits repeat from the same (rng, step, leaf).
* The JAX tests' semantics (descent, schedules, int8 round trip, unbiased
  rounding, convergence under each moment dtype, clipping, microbatch
  accumulation, learning a markov stream), on the port alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.params import ParamDef as JaxParamDef
from repro.training import optimizer as jopt
from repro.training.train_loop import train_state_defs as jax_state_defs
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.models import build_model, init_params, make_batch
from repro_torch.models.params import from_numpy, tree_leaves, tree_map
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticStream,
                                  adamw_init, adamw_update, init_train_state,
                                  lr_schedule, make_train_step,
                                  train_state_defs)
from repro_torch.training.optimizer import (_dequantize, _quantize,
                                            _sr_cast_bf16)

torch.set_num_threads(1)  # several xdist workers share the machine's cores

SCHEDULES = ("cosine", "wsd", "constant")
MOMENTS = ("float32", "bfloat16", "int8")
# float32 master vs JAX after three updates (both round every operation
# in float32; pow and cos differ in the last bit, and XLA fuses some
# multiply-adds): rtol, and atol as a share of the leaf's largest value
F32_RTOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=F32_RTOL * float(np.abs(want).max()))


# int8 codes and bfloat16 moments may differ at rounding ties, by one
# code or one bfloat16 ulp, in this share of their elements
TIE_SHARE = 1e-3


def _ties(got, want):
    diff = got.astype(np.int64) - want.astype(np.int64)
    assert np.abs(diff).max() <= 1
    assert np.mean(diff != 0) <= TIE_SHARE


def _tree(seed: int):
    """A small parameter-shaped tree: a stacked (4, 8, 300) leaf (padded
    to two 256-blocks), an embedding-like (200, 16) leaf whose leading
    axis makes more than ``_MAX_PIECES`` chunks of 2, a vector, and a
    nested matrix."""
    rng = np.random.default_rng(seed)
    return {"blocks": rng.normal(0, 0.02, (4, 8, 300)).astype(np.float32),
            "embed": rng.normal(0, 0.02, (200, 16)).astype(np.float32),
            "nest": {"v": rng.normal(0, 0.02, (700,)).astype(np.float32),
                     "w": rng.normal(0, 0.02, (16, 64)).astype(np.float32)}}


def _grads(seed: int, scale: float = 1.0):
    return tree_map(lambda a: a * np.float32(50.0 * scale), _tree(seed))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _cfgs(**kw):
    return jopt.AdamWConfig(**kw), AdamWConfig(**kw)


def _steps_both(kw, steps: int, seed: int = 0):
    """Each of ``steps`` updates run by both packages from the same state
    (the JAX state carried across) on the same gradients: yields (JAX
    state, JAX metrics, port state, port metrics) after each."""
    jc, pc = _cfgs(**kw)
    js = jopt.adamw_init(jax.tree.map(jnp.asarray, _tree(seed)), jc)
    for s in range(steps):
        g = _grads(seed + 1 + s)
        ps = from_numpy(jax.tree.map(np.asarray, js))
        js, _, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, g), js, jc)
        ps, pm = adamw_update(from_numpy(g), ps, pc)
        yield js, jm, ps, pm


# ------------------------------------------------------------ JAX parity


@pytest.mark.parametrize("sched", SCHEDULES)
def test_lr_schedule_matches_jax(sched):
    jc, pc = _cfgs(lr=3e-3, warmup_steps=10, total_steps=100,
                   schedule=sched, decay_frac=0.2, min_lr_frac=0.1)
    for s in range(101):
        want = np.float32(jopt.lr_schedule(jc, s))
        got = lr_schedule(pc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ceil", [False, True])
def test_quantize_matches_jax(ceil):
    x = np.random.default_rng(3).normal(0, 3.0, (6, 300)).astype(np.float32)
    x[0, :256] = 0.0  # an all-zero block: scale 0, codes 0
    jq, js, _ = jopt._quantize(jnp.asarray(x), ceil=ceil)
    pq, ps, shape = _quantize(torch.from_numpy(x), ceil=ceil)
    assert pq.dtype == torch.int8 and pq.shape == (6, 512)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        _dequantize(pq, ps, shape).numpy(),
        np.asarray(jopt._dequantize(jq, js, x.shape)))


def test_sr_cast_bf16_matches_jax_bits():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(0, 1, 4096), -rng.exponential(1, 4096),
                        [0.0, -0.0, 1.0 + 2.0 ** -10, 3.0e38, -3.0e38]])
    x = x.astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jopt._sr_cast_bf16(jnp.asarray(x), key))
    bits = jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF)
    got = _sr_cast_bf16(torch.from_numpy(x),
                        torch.from_numpy(np.asarray(bits).astype(np.int32)))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_adamw_update_matches_jax(moment_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moment_dtype=moment_dtype)
    for s, (js, jm, ps, pm) in enumerate(_steps_both(kw, steps=3)):
        assert int(ps["step"]) == int(js["step"]) == s + 1
        np.testing.assert_allclose(pm["lr"].item(), float(jm["lr"]),
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(pm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=F32_RTOL)
        for a, b in zip(jax.tree.leaves(js["master"]),
                        tree_leaves(ps["master"])):
            assert b.dtype == torch.float32
            _close(_np(b), _np(a))
        for a, b in zip(jax.tree.leaves(js["moments"]),
                        tree_leaves(ps["moments"])):
            if b.dtype == torch.bfloat16:
                _ties(b.view(torch.int16).numpy(),
                      np.asarray(a).view(np.int16))
            elif b.dtype == torch.int8:
                _ties(b.numpy(), np.asarray(a))
            else:
                _close(_np(b), _np(a))


def test_adamw_bf16_master_within_one_ulp():
    kw = dict(lr=1e-2, warmup_steps=0, schedule="constant",
              master_dtype="bfloat16", moment_dtype="int8")
    (js, _, ps, _), = _steps_both(kw, steps=1)
    for a, b in zip(jax.tree.leaves(js["master"]),
                    tree_leaves(ps["master"])):
        assert b.dtype == torch.bfloat16
        a16 = np.asarray(a).view(np.int16).astype(np.int64)
        b16 = b.view(torch.int16).numpy().astype(np.int64)
        # one ulp apart at most: adjacent bfloat16 bit patterns of the
        # same sign (a zero crossing would show as a sign flip)
        assert np.abs(a16 - b16).max() <= 1


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_train_state_defs_match_jax(moment_dtype):
    from repro.configs.base import get_config as jax_get_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import build_model as jax_build_model

    jdefs = jax_state_defs(
        jax_build_model(jax_reduced(jax_get_config("olmoe_1b_7b"))).defs(),
        jopt.AdamWConfig(moment_dtype=moment_dtype, master_dtype="bfloat16"))
    pdefs = train_state_defs(
        build_model(reduced(get_config("olmoe_1b_7b"))).defs(),
        AdamWConfig(moment_dtype=moment_dtype, master_dtype="bfloat16"))
    jl = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, JaxParamDef))[0]
    pl = tree_leaves(pdefs)
    assert len(jl) == len(pl)
    for (_, a), b in zip(jl, pl):
        assert (a.shape, a.names, a.init, a.dtype) == (
            b.shape, b.names, b.init, b.dtype)


# --------------------------------------------------- port-only semantics


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_update_chunk_bit_equal_to_unchunked(moment_dtype):
    outs = []
    for chunk in (0, 2):
        cfg = AdamWConfig(lr=1e-2, warmup_steps=1, moment_dtype=moment_dtype,
                          update_chunk=chunk)
        state = adamw_init(from_numpy(_tree(0)), cfg)
        for s in range(3):
            state, _ = adamw_update(from_numpy(_grads(1 + s)), state, cfg)
        outs.append(state)
    a, b = outs  # master, moments and step
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_sr_bits_repeat_from_the_same_key_and_step():
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, master_dtype="bfloat16",
                      update_chunk=2)
    rng = torch.tensor([0, 5], dtype=torch.uint32)
    base = adamw_init(from_numpy(_tree(0)), cfg)
    runs = []
    for key in (rng, rng, torch.tensor([0, 6], dtype=torch.uint32)):
        state = tree_map(torch.clone, base)
        state, _ = adamw_update(from_numpy(_grads(1)), state, cfg, rng=key)
        runs.append(state["master"]["blocks"])
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_adamw_descends_quadratic():
    """Minimize ||x - t||^2; AdamW must reduce the loss monotonically-ish."""
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      total_steps=100, schedule="constant")
    target = torch.tensor([1.0, -2.0, 3.0])
    opt = adamw_init({"x": torch.zeros(3)}, cfg)
    losses = []
    for _ in range(60):
        g = {"x": 2.0 * (opt["master"]["x"] - target)}
        opt, _ = adamw_update(g, opt, cfg)
        losses.append(float(torch.sum((opt["master"]["x"] - target) ** 2)))
    assert losses[-1] < 0.05 * losses[0]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_lr_schedule_shapes(sched):
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      schedule=sched, decay_frac=0.2, min_lr_frac=0.1)
    lr = np.array([float(lr_schedule(cfg, s)) for s in range(101)])
    assert np.all(np.diff(lr[:10]) > 0)
    assert lr[0] == 0.0
    if sched == "constant":
        np.testing.assert_allclose(lr[10:], 1.0)
    if sched == "wsd":
        np.testing.assert_allclose(lr[10:80], 1.0)
        assert lr[100] == pytest.approx(0.1, rel=1e-5)
        assert np.all(np.diff(lr[80:]) <= 1e-7)
    if sched == "cosine":
        assert lr[100] == pytest.approx(0.1, rel=1e-2)
        assert np.all(np.diff(lr[11:]) <= 1e-7)


def test_int8_quantization_roundtrip_error():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 3.0, (8, 700)).astype(np.float32))
    codes, scale, shape = _quantize(x)
    err = (_dequantize(codes, scale, shape) - x).abs()
    # blockwise int8: error bounded by scale/2 = blockmax/254
    assert float(err.max()) <= float(x.abs().max()) / 127.0
    assert float(err.norm() / x.norm()) < 0.01


def test_sr_cast_unbiased():
    x = torch.full((200_000,), 1.0 + 2.0 ** -10)  # between bf16 grid points
    gen = torch.Generator().manual_seed(1)
    rnd = torch.randint(0, 1 << 16, x.shape, generator=gen,
                        dtype=torch.int32)
    y = _sr_cast_bf16(x, rnd).float()
    assert abs(float(y.mean()) - float(x[0])) < 1e-4
    assert set(np.unique(y.numpy())).issubset(
        {np.float32(1.0), np.float32(1.0078125)})


@pytest.mark.parametrize("moment_dtype", MOMENTS)
def test_moment_dtypes_still_converge(moment_dtype):
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      schedule="constant", moment_dtype=moment_dtype)
    target = torch.tensor([0.5, -1.5, 2.5, 0.1] * 64)  # one 256-wide block
    opt = adamw_init({"x": torch.zeros(256)}, cfg)
    for _ in range(80):
        g = {"x": 2.0 * (opt["master"]["x"] - target)}
        opt, _ = adamw_update(g, opt, cfg)
    assert float(torch.sum((opt["master"]["x"] - target) ** 2)) < 5.0


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0,
                      warmup_steps=0, schedule="constant")
    opt = adamw_init({"x": torch.zeros(4)}, cfg)
    opt, metrics = adamw_update({"x": torch.full((4,), 1e6)}, opt, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert bool(torch.isfinite(opt["master"]["x"]).all())


def test_microbatch_accumulation_equivalence():
    """grad accumulation over 4 microbatches == single big batch."""
    cfg = reduced(get_config("olmo_1b"))
    model = build_model(cfg)
    params = init_params(model.defs(), torch.Generator().manual_seed(0),
                         device="cpu")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    batch = make_batch(cfg, ShapeConfig("s", 16, 8, "train"), seed=3,
                       device="cpu")
    s1 = init_train_state(model.defs(), params, ocfg)
    s4 = tree_map(torch.clone, s1)
    s1, m1 = make_train_step(model, ocfg, microbatches=1)(s1, batch)
    s4, m4 = make_train_step(model, ocfg, microbatches=4)(s4, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    a = torch.cat([x.ravel() for x in tree_leaves(s1["opt"]["master"])])
    b = torch.cat([x.ravel() for x in tree_leaves(s4["opt"]["master"])])
    assert np.corrcoef(a.numpy(), b.numpy())[0, 1] > 0.999


def test_loss_decreases_on_markov_data():
    """Tiny model must learn a markov stream in a few dozen steps."""
    cfg = reduced(get_config("olmo_1b"))
    model = build_model(cfg)
    params = init_params(model.defs(), torch.Generator().manual_seed(1),
                         device="cpu")
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=80,
                       schedule="constant")
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=8, mode="markov"))
    step = make_train_step(model, ocfg)
    state = init_train_state(model.defs(), params, ocfg)
    losses = []
    for s in range(60):
        b = {k: torch.from_numpy(v) for k, v in stream.global_batch(s).items()}
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    # markov chain with branching 4: optimal loss ~= ln 4 << ln 256 = 5.55
    assert np.mean(losses[-5:]) < np.mean(losses[:3]) - 0.5


def test_acc_dtype_bfloat16_accumulates_in_bfloat16():
    """``acc_dtype="bfloat16"`` carries the microbatch sum in bfloat16 and
    lands close to the float32 accumulator (relative ~ sqrt(K) 2^-8)."""
    cfg = reduced(get_config("olmo_1b"))
    model = build_model(cfg)
    params = init_params(model.defs(), torch.Generator().manual_seed(2),
                         device="cpu")
    batch = make_batch(cfg, ShapeConfig("s", 16, 8, "train"), seed=4,
                       device="cpu")
    out = {}
    for acc in ("float32", "bfloat16"):
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant",
                           acc_dtype=acc)
        state = init_train_state(model.defs(), params, ocfg)
        _, out[acc] = make_train_step(model, ocfg, microbatches=4)(state,
                                                                   batch)
    assert out["bfloat16"]["grad_norm"].item() == pytest.approx(
        out["float32"]["grad_norm"].item(), rel=2e-2)
    assert out["bfloat16"]["loss"].item() == out["float32"]["loss"].item()
