"""The port's LM substrate (``repro_torch.{configs,models}``) against the
JAX package's, in float32, and the JAX model tests' semantics on the
port.

* Same function as JAX: for each of the 10 reduced LM archs at
  ``dtype="float32"``, on the JAX package's parameters carried across by
  ``from_jax_params`` and inputs drawn with numpy from a seed,
  ``hidden_states``, ``prefill``, the logits of every decode step and
  every cache leaf after them equal the JAX ``mesh=None`` model's to
  ``F32_TOL``, and float8 caches (llama3's ``kv_dtype``) bit for bit.
  Both packages sum in float32; their products and exp/rsqrt differ in
  the last bits (observed at most 4e-6 on values of order 4).
  ``_route``'s integer outputs equal JAX's; ``mamba2_block`` and
  ``blockwise_attention`` (several blocks, sliding window,
  ``causal_block_skip``) match JAX's; ``count_params`` equals JAX's for
  every full config; the configs are the JAX package's.
* The JAX model tests' semantics (``tests/test_models_smoke.py``,
  ``tests/test_ssm.py``), on the port alone.

``tests/test_torch_models_bf16.py`` holds the same runs in bfloat16.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import (LM_ARCHS, from_jax_params, jax_np, lm_configs,
                       lm_outputs, lm_pair, port_np)
from repro.configs.base import ARCHS as JAX_ARCHS
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import count_params as jax_count_params
from repro.models import init_params as jax_init_params
from repro.models import input_specs as jax_input_specs
from repro.models.layers import blockwise_attention as jax_blockwise
from repro.models.moe import _route as jax_route
from repro.models.ssm import mamba2_block as jax_mamba2_block
from repro.models.ssm import ssm_defs as jax_ssm_defs
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config, reduced
from repro_torch.models import (abstract_params, build_model, count_params,
                                init_params, input_specs, make_batch,
                                tree_bytes)
from repro_torch.models.layers import blockwise_attention
from repro_torch.models.moe import _route, capacity
from repro_torch.models.params import tree_leaves
from repro_torch.models.ssm import (mamba2_block, mamba2_decode_step,
                                    ssm_defs, ssm_state_shape)

# float32 tolerance of every port-vs-JAX comparison below
F32_TOL = dict(rtol=1e-4, atol=5e-5)
OUTPUTS = ("hidden", "prefill", "decode")


def _close(got, want, **tol):
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert ARCHS == JAX_ARCHS
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))
    assert (dataclasses.asdict(reduced(get_config(arch)))
            == dataclasses.asdict(jax_reduced(jax_get_config(arch))))
    alias = arch.replace("_", "-")
    assert get_config(alias) is get_config(arch)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


# ------------------------------------------------------ same function as JAX


@pytest.mark.parametrize("out", OUTPUTS)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_decode_match_jax_f32(arch, out):
    want, got = lm_outputs(arch, "float32")[out]
    assert got.shape == want.shape
    _close(got, want, **F32_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_cache_matches_jax_f32(arch):
    outs = lm_outputs(arch, "float32")
    leaves = [k for k in outs if k.startswith("cache.")]
    assert leaves
    for name in leaves:
        want, got = outs[name]
        assert got.shape == want.shape, name
        if got.dtype == np.uint8:  # float8 storage: the same bits
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            _close(got, want, err_msg=name, **F32_TOL)


def test_float8_cache_bits_match_jax():
    """llama3 keeps ``kv_dtype="float8_e4m3fn"`` in its reduced config: the
    port's cache bits equal JAX's after the decode steps (float32
    compute)."""
    _, pcfg = lm_configs("llama3_405b", "float32")
    assert pcfg.kv_dtype == "float8_e4m3fn"
    outs = lm_outputs("llama3_405b", "float32")
    for name in ("cache.k", "cache.v"):
        want, got = outs[name]
        assert got.dtype == np.uint8
        assert np.count_nonzero(want) > 0
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonshot_v1_16b_a3b"])
def test_route_integers_match_jax(arch, dtype):
    """Expert order, token order and slot positions equal JAX's; the
    gates to float32 rounding."""
    jm, jp, _, pp = lm_pair(arch)
    cfg = get_config(arch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(96, 64)).astype(np.float32)
    x[1] = x[0]  # two tokens alike: the stable argsort keeps token order
    router = np.array(jp["blocks"]["moe"]["router"][0])
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax_route(jnp.asarray(x).astype(jdt),
                     jnp.asarray(router).astype(jdt), reduced(cfg))
    got = _route(torch.from_numpy(x).to(pdt),
                 torch.from_numpy(router).to(pdt), reduced(cfg))
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    _close(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-7)


def test_route_breaks_ties_toward_the_lower_expert():
    cfg = reduced(get_config("olmoe_1b_7b"))
    x = torch.ones((3, 4))
    router = torch.zeros((4, cfg.n_experts))  # every logit ties
    exp_sorted, tok_sorted, _, pos = _route(x, router, cfg)
    assert exp_sorted.tolist() == [0, 0, 0, 1, 1, 1]
    assert tok_sorted.tolist() == [0, 1, 2, 0, 1, 2]
    assert pos.tolist() == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("initial_state", [False, True])
def test_mamba2_block_matches_jax(initial_state):
    cfg = dataclasses.replace(reduced(get_config("mamba2_780m")),
                              ssm_chunk=8)
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("mamba2_780m")),
                               ssm_chunk=8)
    jp = jax_init_params(jax_ssm_defs(jcfg), jax.random.PRNGKey(0))
    pp = from_jax_params(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    B, S = 2, 32
    x = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
    s0 = None
    if initial_state:
        s0 = rng.normal(size=ssm_state_shape(cfg, B)["ssm"]).astype(
            np.float32)
    y_j, s_j = jax_mamba2_block(jp, jnp.asarray(x), jcfg, None,
                                initial_state=None if s0 is None
                                else jnp.asarray(s0))
    y_p, s_p = mamba2_block(pp, torch.from_numpy(x), cfg,
                            initial_state=None if s0 is None
                            else torch.from_numpy(s0))
    _close(y_p.numpy(), np.asarray(y_j), **F32_TOL)
    _close(s_p.numpy(), np.asarray(s_j), **F32_TOL)


@pytest.mark.parametrize("window,skip", [(0, False), (0, True), (24, False),
                                         (24, True)])
def test_blockwise_attention_matches_jax(window, skip):
    """Several 16-row blocks: the online softmax across kv blocks, the
    sliding-window mask and ``causal_block_skip``."""
    cfg = dataclasses.replace(reduced(get_config("olmo_1b")),
                              sliding_window=window, dtype="float32")
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("olmo_1b")),
                               sliding_window=window, dtype="float32")
    rng = np.random.default_rng(4)
    B, S, H, KVH, dh = 2, 64, 4, 2, 16
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KVH, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KVH, dh)).astype(np.float32)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jcfg, block_q=16, block_kv=16,
                         causal_block_skip=skip)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), cfg, block_q=16,
                              block_kv=16, causal_block_skip=skip)
    _close(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_count_params_match_jax_full_config(arch):
    """Defs only: nothing is allocated at full width."""
    n = count_params(build_model(get_config(arch)).defs())
    assert n == jax_count_params(
        jax_build_model(jax_get_config(arch), mesh=None).defs())
    metas = tree_leaves(abstract_params(build_model(get_config(arch)).defs()))
    assert sum(t.numel() for t in metas) == n
    assert all(t.device.type == "meta" for t in metas)


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_input_specs_match_jax(kind):
    for arch in ("olmo_1b", "musicgen_medium"):
        cfg = reduced(get_config(arch))
        got = input_specs(cfg, SHAPES[kind])
        want = jax_input_specs(jax_reduced(jax_get_config(arch)),
                               JAX_SHAPES[kind])
        assert sorted(got) == sorted(want)
        for name in got:
            assert tuple(got[name].shape) == tuple(want[name].shape)
            assert str(got[name].dtype).split(".")[-1] == str(
                want[name].dtype)


# --------------------------------------------------- the models' semantics


def _build(arch, dtype=None):
    cfg = reduced(get_config(arch))
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    return cfg, model, init_params(model.defs(), gen, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg, model, params = _build(arch)
    batch = make_batch(cfg, ShapeConfig("smoke", 32, 2, "train"), seed=1,
                       device="cpu")
    x = model.hidden_states(params, batch)
    assert x.shape == (2, 32, cfg.d_model)
    assert x.dtype == torch.bfloat16
    assert bool(torch.isfinite(x.float()).all())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_changes_cache(arch):
    cfg, model, params = _build(arch)
    B = 2
    cache = model.init_cache(B, 16, device="cpu")
    before = {k: port_np(v).copy() for k, v in cache.items()}
    logits, cache2 = model.decode_step(params, cache,
                                       torch.tensor([3, 5]), 0)
    assert cache2 is cache  # updated in place
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert any(not np.array_equal(before[k], port_np(cache[k]))
               for k in cache)


@pytest.mark.parametrize("arch", ["olmo_1b", "mamba2_780m", "zamba2_1p2b"])
def test_prefill_decode_consistency(arch):
    """Greedy next-token logits from prefill == decode steps one by one
    (same params; the JAX test's bfloat16 tolerance)."""
    cfg, model, params = _build(arch)
    B, S = 1, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    full = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(B, S + 1, device="cpu")
    logits = None
    for t in range(S):
        logits, cache = model.decode_step(params, cache, toks[:, t], t)
    _close(port_np(logits), port_np(full), rtol=0.06, atol=0.05)


def test_nonparametric_ln_olmo():
    cfg = get_config("olmo_1b")
    assert cfg.norm == "nonparametric_ln"
    defs = build_model(reduced(cfg)).defs()
    assert defs["final_norm"] == {}
    assert defs["blocks"]["ln1"] == {} and defs["blocks"]["ln2"] == {}


def test_swa_ring_buffer_window():
    """h2o-danube's SWA cache is window-sized, not seq-sized; its parity
    run decodes past the window (the ring buffer wraps)."""
    cfg = reduced(get_config("h2o_danube_3_4b"))
    assert cfg.sliding_window > 0
    shapes = build_model(cfg).cache_shapes(batch=2, cache_len=1_000)
    assert shapes["k"].shape[2] == cfg.sliding_window
    assert shapes["k"].device.type == "meta"
    want, got = lm_outputs("h2o_danube_3_4b", "float32")["decode"]
    assert got.shape[0] > cfg.sliding_window


def test_moe_capacity_and_sparsity():
    """Each token goes to exactly top_k distinct experts, and the capacity
    holds a balanced load."""
    cfg = reduced(get_config("olmoe_1b_7b"))
    assert cfg.n_experts == 8 and cfg.top_k == 2
    assert capacity(64, cfg) >= 64 * cfg.top_k // cfg.n_experts
    assert capacity(64, cfg) % 8 == 0
    _, _, _, pp = lm_pair("olmoe_1b_7b")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(64, 64)).astype(np.float32))
    exp_sorted, tok_sorted, gate_sorted, pos = _route(
        x, pp["blocks"]["moe"]["router"][0], cfg)
    assert exp_sorted.shape == (64 * cfg.top_k,)
    pairs = set(zip(tok_sorted.tolist(), exp_sorted.tolist()))
    assert len(pairs) == 64 * cfg.top_k  # distinct experts per token
    assert torch.bincount(tok_sorted.long()).tolist() == [cfg.top_k] * 64
    gsum = torch.zeros(64).index_add_(0, tok_sorted.long(), gate_sorted)
    _close(gsum.numpy(), np.ones(64, np.float32), rtol=1e-6)


@pytest.fixture(scope="module")
def ssm_setup():
    cfg = dataclasses.replace(reduced(get_config("mamba2_780m")),
                              ssm_chunk=8)
    gen = torch.Generator().manual_seed(0)
    return cfg, init_params(ssm_defs(cfg), gen, device="cpu")


def _stepwise(params, x, cfg, state):
    ys = []
    for t in range(x.shape[1]):
        y_t, state = mamba2_decode_step(params, x[:, t], cfg, state)
        ys.append(y_t)
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("split", [0, 16])
def test_chunked_ssd_equals_stepwise(ssm_setup, split):
    """The chunked SSD equals the recurrence token by token (split 0); and
    a prefix's final state plus its conv tail continues the sequence step
    by step exactly as one full pass (split 16)."""
    cfg, params = ssm_setup
    B, S = 2, 32
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)) * 0.5
    y_full, s_full = mamba2_block(params, x, cfg)
    shapes = ssm_state_shape(cfg, B)
    state = {"ssm": torch.zeros(shapes["ssm"]),
             "conv": torch.zeros(shapes["conv"])}
    if split:
        _, s_a = mamba2_block(params, x[:, :split], cfg)
        proj = x[:, :split] @ params["in_proj"]
        di, n = cfg.d_inner, cfg.ssm_state
        state = {"ssm": s_a, "conv": proj[:, -(cfg.conv_kernel - 1):,
                                          di:2 * di + 2 * n]}
    y_step, state = _stepwise(params, x[:, split:], cfg, state)
    _close(y_step.numpy(), y_full[:, split:].numpy(), rtol=2e-2, atol=2e-3)
    _close(state["ssm"].numpy(), s_full.numpy(), rtol=2e-2, atol=2e-3)


def test_state_shape_contract(ssm_setup):
    cfg, _ = ssm_setup
    shapes = ssm_state_shape(cfg, batch=3)
    assert shapes["ssm"] == (3, cfg.ssm_heads, cfg.ssm_state,
                             cfg.ssm_head_dim)
    assert shapes["conv"] == (3, cfg.conv_kernel - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)


def test_decay_clamp_no_nan(ssm_setup):
    """Long sequences with large dt must not overflow the decay kernel."""
    cfg, params = ssm_setup
    big = torch.randn((1, 64, cfg.d_model),
                      generator=torch.Generator().manual_seed(3)) * 20.0
    y, s = mamba2_block(params, big, cfg)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())


# ------------------------------------------------------------- parameters


def test_init_params_kinds_and_seed():
    """normal * scale, normal / sqrt(fan_in), zeros and ones, drawn from the
    generator: the same seed gives the same tree."""
    cfg = reduced(get_config("zamba2_1p2b"))
    defs = build_model(cfg).defs()
    a = init_params(defs, torch.Generator().manual_seed(4), device="cpu")
    b = init_params(defs, torch.Generator().manual_seed(4), device="cpu")
    c = init_params(defs, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["embed"]["tok"], b["embed"]["tok"])
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    assert abs(float(a["embed"]["tok"].std()) - 0.02) < 2e-3
    wq = a["shared"]["attn"]["wq"]
    assert abs(float(wq.std()) * math.sqrt(wq.shape[0]) - 1.0) < 0.05
    assert bool((a["blocks"]["ssm"]["conv_b"] == 0).all())
    assert bool((a["blocks"]["ssm"]["A_log"] == 1).all())
    assert all(t.dtype == torch.float32 for t in tree_leaves(a))
    n = count_params(defs)
    assert tree_bytes(a) == 4 * n


def test_from_jax_params_carries_every_leaf():
    jm, jp, pm, pp = lm_pair("moonshot_v1_16b_a3b")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(want) == len(tree_leaves(pp))
    for path, leaf in want:
        node = pp
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(port_np(node), jax_np(leaf))
