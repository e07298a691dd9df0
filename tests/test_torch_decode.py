"""The port's decode loop (``repro_torch.serving.decode``) and serve
launcher (``repro_torch.launch.serve``) on the CPU.

* Greedy ``generate`` on reduced olmo-1b in float32, on the JAX
  package's parameters carried across, gives the tokens of the JAX
  package's ``generate(temperature=0)``.
* Sampling: a seed fixes the tokens, another seed changes them; top-k
  draws only inside the top k; greedy takes the first maximal index and
  top-k keeps the lower index among equal logits, as ``jnp.argmax`` and
  ``lax.top_k`` do.
* ``launch.serve.main([... "--reduced", "--device", "cpu"])`` returns
  (B, max_new) tokens.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _torch_lm import lm_pair
from repro.serving.decode import SamplerConfig as JaxSampler
from repro.serving.decode import generate as jax_generate
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, init_params
from repro_torch.serving import SamplerConfig, generate, make_serve_step
from repro_torch.serving.decode import _sample

PROMPTS = np.array([[1, 2, 3, 4, 9, 17], [5, 6, 7, 8, 100, 200]], np.int32)


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config("olmo_1b"))
    model = build_model(cfg)
    params = init_params(model.defs(), torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, model, params


def test_greedy_tokens_match_jax_f32():
    jm, jp, pm, pp = lm_pair("olmo_1b", "float32")
    want = jax_generate(jm, jp, PROMPTS, max_new_tokens=10, cache_len=16,
                        sampler=JaxSampler(temperature=0.0))
    got = generate(pm, pp, PROMPTS, max_new_tokens=10, cache_len=16,
                   sampler=SamplerConfig(temperature=0.0), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(np.unique(got)) > 2  # not a degenerate constant run


def test_generate_shapes_and_determinism(tiny):
    cfg, model, params = tiny
    kw = dict(max_new_tokens=6, cache_len=16, device="cpu")
    a = generate(model, params, PROMPTS[:, :4], sampler=SamplerConfig(
        temperature=0.0), **kw)
    b = generate(model, params, PROMPTS[:, :4], sampler=SamplerConfig(
        temperature=0.0), **kw)
    assert a.shape == (2, 6)
    np.testing.assert_array_equal(a, b)  # greedy = deterministic
    assert np.all((a >= 0) & (a < cfg.vocab))


@pytest.mark.parametrize("top_k", [0, 5])
def test_sampled_run_fixed_by_seed(tiny, top_k):
    cfg, model, params = tiny
    prompts = PROMPTS[:1, :4]

    def run(seed):
        return generate(model, params, prompts, 8, 16,
                        SamplerConfig(temperature=1.0, top_k=top_k,
                                      seed=seed), device="cpu")

    np.testing.assert_array_equal(run(0), run(0))
    assert not np.array_equal(run(0), run(1))


def test_top_k_draws_only_inside_the_top_k():
    rng = np.random.default_rng(0)
    row = rng.normal(size=64).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (4_000, 1)))
    top = set(np.argsort(-row)[:3].tolist())
    gen = torch.Generator().manual_seed(0)
    got = _sample(logits, gen, SamplerConfig(temperature=2.0, top_k=3))
    assert got.dtype == torch.int32
    assert set(got.tolist()) == top  # only the top 3, and each of them


def test_ties_go_to_the_lower_index():
    logits = torch.tensor([[0.0, 2.0, 5.0, 5.0, 1.0],
                           [7.0, 7.0, 7.0, 7.0, 7.0]])
    gen = torch.Generator().manual_seed(0)
    greedy = _sample(logits, gen, SamplerConfig(temperature=0.0))
    assert greedy.tolist() == [2, 0]
    top1 = _sample(logits, gen, SamplerConfig(temperature=1.0, top_k=1))
    assert top1.tolist() == [2, 0]


def test_serve_step_updates_the_cache_in_place(tiny):
    cfg, model, params = tiny
    cache = model.init_cache(2, 8, device="cpu")
    k0 = cache["k"].clone()
    step = make_serve_step(model)
    logits, out = step(params, cache, torch.tensor([3, 5]), 0)
    assert out is cache and logits.shape == (2, cfg.vocab)
    assert not torch.equal(cache["k"], k0)
    assert torch.equal(cache["k"][:, :, 1:], k0[:, :, 1:])


@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b"])
def test_serve_launcher_runs(arch):
    out = launch_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                             "--prompt-len", "4", "--max-new", "4",
                             "--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    assert out["tok_per_s"] > 0
    assert launch_serve.parse_args([]).device == "cuda"
