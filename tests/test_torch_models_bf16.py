"""The port's LM substrate against the JAX package's in the configs' own
bfloat16, on the runs of ``tests/test_torch_models.py`` (the same
parameters and inputs).

Both packages compute in bfloat16 with float32 statistics and float32
attention products, but round in different places (XLA keeps fused
elementwise chains in float32; torch rounds after every operation), so
they agree only to bfloat16's precision:

* dense, audio, vlm, ssm and hybrid archs: every output within
  ``BF16_TOL`` elementwise and ``BF16_REL`` in relative Frobenius norm
  (observed at most 0.09 and 0.016 on values of order 4);
* moe archs: a one-ulp difference upstream of a router can flip a
  near-tied top-k choice, and that token's expert mix (and, through
  attention, later tokens) then differs by O(1).  The whole-model
  outputs are held to ``MOE_BF16_REL`` (observed at most 0.34, on
  olmoe's last-position logits; an unrelated function is off by about
  1.4), and ``moe_block`` alone, on
  the same bfloat16 input (so the same routing), to ``BF16_TOL``;
* float8 caches: the bfloat16 tolerance plus one float8 step (2^-3
  relative), as the stored keys and values are bfloat16 results rounded
  to float8.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import LM_ARCHS, MOE_ARCHS, jax_np, lm_outputs, lm_pair, rel_err
from repro.models.moe import moe_block as jax_moe_block
from repro_torch.configs import get_config, reduced
from repro_torch.models.moe import moe_block
from repro_torch.models.params import tree_map

BF16_TOL = dict(rtol=0.05, atol=0.15)
BF16_REL = 0.03
MOE_BF16_REL = 0.5
F8_STEP = 2.0 ** -3
OUTPUTS = ("hidden", "prefill", "decode")


def _f8_values(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits).view(torch.float8_e4m3fn).float().numpy()


def _hold(arch, got, want):
    if arch in MOE_ARCHS:
        assert rel_err(got, want) <= MOE_BF16_REL
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert rel_err(got, want) <= BF16_REL


@pytest.mark.parametrize("out", OUTPUTS)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_decode_match_jax_bf16(arch, out):
    want, got = lm_outputs(arch)[out]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    _hold(arch, got, want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_cache_matches_jax_bf16(arch):
    outs = lm_outputs(arch)
    for name in [k for k in outs if k.startswith("cache.")]:
        want, got = outs[name]
        assert got.shape == want.shape, name
        if got.dtype == np.uint8:  # float8 bits: compare the values
            got, want = _f8_values(got), _f8_values(want)
            np.testing.assert_allclose(
                got, want, rtol=BF16_TOL["rtol"] + F8_STEP,
                atol=BF16_TOL["atol"], err_msg=name)
        else:
            _hold(arch, got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax_bf16(arch):
    """The same bfloat16 input routes alike in both packages: the expert
    mix then agrees to bfloat16's precision."""
    jm, jp, pm, pp = lm_pair(arch)
    cfg = reduced(get_config(arch))
    x = np.random.default_rng(7).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    p_j = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    p_p = tree_map(lambda a: a[0], pp["blocks"]["moe"])
    want = jax_np(jax_moe_block(p_j, xj, jm.cfg, None))
    got = moe_block(p_p, torch.from_numpy(x).to(torch.bfloat16),
                    pm.cfg).float().numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert rel_err(got, want) <= BF16_REL
