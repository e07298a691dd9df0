"""Shared set-up of the port's LM substrate tests: one reduced model of an
arch built in both packages on the same parameters, and the outputs of
both on the same inputs.

``lm_pair(arch, dtype)`` builds the JAX package's reduced model
(``mesh=None``), draws its parameters with the JAX package's
``init_params`` and carries them across with ``from_jax_params``
(numpy leaves as CPU tensors, the same keys);
``lm_outputs(arch, dtype)`` runs ``hidden_states``, ``prefill`` and a run
of decode steps through both on inputs drawn with numpy from a seed and
returns every output as numpy arrays (float32 values, and the raw bits of
float8 caches).  Both are cached per (arch, dtype), so the tests of one
file share one build and one run of each model.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import build_model
from repro_torch.models.params import from_numpy

LM_ARCHS = [a for a in ARCHS if a != "wlsh_index"]
MOE_ARCHS = [a for a in LM_ARCHS if get_config(a).family == "moe"]
BATCH, SEQ = 2, 32
CACHE_LEN = 48
DECODE_STEPS = 3
_pairs: dict = {}
_outputs: dict = {}


def lm_configs(arch: str, dtype: str | None = None):
    """(JAX config, port config): the arch's reduced config in both
    packages, at ``dtype`` (None: the config's own, bfloat16)."""
    jcfg = jax_reduced(jax_get_config(arch))
    pcfg = reduced(get_config(arch))
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        pcfg = dataclasses.replace(pcfg, dtype=dtype)
    return jcfg, pcfg


def from_jax_params(tree):
    """The port's parameter tree of a JAX one: every leaf as a CPU tensor
    under the same keys (``repro_torch.models.params.from_numpy``)."""
    return from_numpy(jax.tree.map(np.asarray, tree))


def lm_pair(arch: str, dtype: str | None = None):
    """(JAX model, JAX params, port model, port params) on the CPU."""
    key = (arch, dtype)
    if key not in _pairs:
        jcfg, pcfg = lm_configs(arch, dtype)
        jm = jax_build_model(jcfg, mesh=None)
        jp = jax_init_params(jm.defs(), jax.random.PRNGKey(0))
        pm = build_model(pcfg)
        pp = from_jax_params(jax.tree.map(np.asarray, jp))
        _pairs[key] = (jm, jp, pm, pp)
    return _pairs[key]


def jax_np(x) -> np.ndarray:
    """A JAX array as numpy: float8 as its raw bytes, else float32 (ints
    stay ints)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.float8_e4m3fn:
        return np.asarray(x).view(np.uint8)
    if jnp.issubdtype(x.dtype, jnp.floating):
        return np.asarray(x.astype(jnp.float32))
    return np.asarray(x)


def port_np(x: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy, by the rules of ``jax_np``."""
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy()
    if x.dtype.is_floating_point:
        return x.float().numpy()
    return x.numpy()


def decode_steps(cfg) -> int:
    """Decode steps of the parity run: past the window for SWA (the ring
    buffer wraps), else ``DECODE_STEPS``."""
    return cfg.sliding_window + 4 if cfg.sliding_window else DECODE_STEPS


def lm_batch(cfg, seed: int):
    """(JAX batch, port batch) of ``BATCH`` x ``SEQ`` inputs drawn with
    numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        x = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
        return {"embeddings": jnp.asarray(x)}, {
            "embeddings": torch.from_numpy(x)}
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def lm_outputs(arch: str, dtype: str | None = None) -> dict:
    """{name: (JAX output, port output)} for hidden, prefill, the decode
    logits of every step (stacked) and each cache leaf after them."""
    key = (arch, dtype)
    if key not in _outputs:
        jm, jp, pm, pp = lm_pair(arch, dtype)
        cfg = pm.cfg
        jb, pb = lm_batch(cfg, seed=1)
        j_hid, j_pre = jax.jit(
            lambda p, b: (jm.hidden_states(p, b), jm.prefill(p, b)))(jp, jb)
        out = {"hidden": (jax_np(j_hid), port_np(pm.hidden_states(pp, pb))),
               "prefill": (jax_np(j_pre), port_np(pm.prefill(pp, pb)))}
        steps = decode_steps(cfg)
        toks = np.random.default_rng(2).integers(
            0, cfg.vocab, (steps, BATCH)).astype(np.int32)
        jdec = jax.jit(jm.decode_step)
        jc = jm.init_cache(BATCH, CACHE_LEN)
        pc = pm.init_cache(BATCH, CACHE_LEN, device="cpu")
        jl, pl = [], []
        for t in range(steps):
            lj, jc = jdec(jp, jc, jnp.asarray(toks[t]), jnp.int32(t))
            lp, pc = pm.decode_step(pp, pc, torch.from_numpy(toks[t]), t)
            jl.append(jax_np(lj))
            pl.append(port_np(lp))
        out["decode"] = (np.stack(jl), np.stack(pl))
        for name in sorted(pc):
            out[f"cache.{name}"] = (jax_np(jc[name]), port_np(pc[name]))
        _outputs[key] = out
    return _outputs[key]


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """Relative Frobenius error of ``got`` against ``want``."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
