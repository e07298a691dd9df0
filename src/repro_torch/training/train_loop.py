"""Train step assembly: mixed precision, microbatch accumulation, the train
state (the port of the JAX package's ``training/train_loop.py``, on one
device).

Flow per step (bfloat16 compute / float32-or-bfloat16-SR master):

    compute = cast(master, bfloat16)
    grads   = grad(loss)(compute, batch)   # torch.autograd.grad
    opt     = adamw_update(grads, opt)     # float32 math, quantized storage

The state's tensors are updated in place (see ``adamw_update``).  The
reference's ``train_state_shardings`` and ``batch_shardings`` place the
state on a mesh, which the port has no counterpart for.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.params import pdef, torch_dtype, tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update, moment_defs

__all__ = [
    "make_train_step",
    "train_state_defs",
    "init_train_state",
]


def _cast_compute(master):
    return tree_map(
        lambda p: p.to(torch.bfloat16) if p.is_floating_point() else p,
        master,
    )


def _value_and_grad(model, compute, batch):
    """(loss, grads) of ``model.loss`` at the tree ``compute`` (zeros for a
    leaf the loss does not read, as ``jax.grad`` gives)."""
    params = tree_map(lambda p: p.detach().requires_grad_(), compute)
    loss = model.loss(params, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params),
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(model, ocfg: AdamWConfig, microbatches: int = 1):
    """(state, batch) -> (state, metrics).  state = adamw opt_state + rng.

    ``state``'s tensors are updated in place and the same dict comes back
    (the counterpart of the reference's donated state): a caller that
    keeps the state before a step clones it first.  The batch's leading
    dim splits into ``microbatches`` slices whose gradients add up in
    ``ocfg.acc_dtype``, in the reference's order.
    """

    def step_fn(state, batch):
        with torch.no_grad():
            compute = _cast_compute(state["opt"]["master"])
        if microbatches == 1:
            loss, grads = _value_and_grad(model, compute, batch)
        else:
            acc_dt = torch_dtype(ocfg.acc_dtype)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), compute)
            loss = 0.0
            for i in range(microbatches):
                mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                                   *x.shape[1:])[i] if x.ndim >= 1 else x
                      for k, x in batch.items()}
                loss_i, g_i = _value_and_grad(model, compute, mb)
                with torch.no_grad():
                    for a, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                        a += g.to(acc_dt)
                loss = loss + loss_i
            loss = loss / microbatches
            with torch.no_grad():
                grads = tree_map(lambda g: g / microbatches, grads)

        del compute  # the update needs only the gradients and the master
        opt, metrics = adamw_update(grads, state["opt"], ocfg,
                                    rng=state["rng"])
        state["opt"] = opt
        # a copy: the state's counter moves on with the next step
        metrics = dict(metrics, loss=loss, step=opt["step"].clone())
        return state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# state defs / init
# ---------------------------------------------------------------------------


def train_state_defs(model_defs, ocfg: AdamWConfig):
    master = tree_map(lambda d: dataclasses.replace(d, dtype=ocfg.master_dtype),
                      model_defs)
    moments = tree_map(
        lambda d: {
            "m": moment_defs(d, ocfg.moment_dtype),
            "v": moment_defs(d, ocfg.moment_dtype),
        },
        model_defs,
    )
    return {
        "opt": {
            "step": pdef((), (), init="zeros", dtype="int32"),
            "master": master,
            "moments": moments,
        },
        "rng": pdef((2,), (None,), init="zeros", dtype="uint32"),
    }


def init_train_state(model_defs, params, ocfg: AdamWConfig, seed: int = 0):
    """The train state of ``params`` (on their device): the optimizer state
    and ``rng``, the two uint32 words of ``jax.random.PRNGKey(seed)``."""
    opt = adamw_init(params, ocfg)
    rng = torch.tensor([0, seed & 0xFFFFFFFF], dtype=torch.uint32,
                       device=opt["step"].device)
    return {"opt": opt, "rng": rng}
