"""Train step assembly: mixed precision, microbatch accumulation, the train
state and its shardings (the port of the JAX package's
``training/train_loop.py``), on one device or on a ``DeviceMesh``.

Flow per step (bfloat16 compute / float32-or-bfloat16-SR master):

    compute = cast(master, bfloat16)
    grads   = grad(loss)(compute, batch)   # torch.autograd.grad
    opt     = adamw_update(grads, opt)     # float32 math, quantized storage

The state's tensors are updated in place (see ``adamw_update``).  On a
mesh (``model.mesh``) the state is a tree of ``DTensor``s laid out by
``train_state_shardings`` (FSDP over the data axes, tensor parallel over
"model", step and rng replicated) and the batch by ``batch_shardings``
(``models.params.distribute`` places both).  The gradients are brought to
their master leaves' layout (a reduce-scatter of the data-parallel partial
sums) before the update, and the step's metrics come back as plain
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import NamedSharding, shard
from ..models.params import (param_shardings, pdef, torch_dtype,
                             tree_leaves, tree_map)
from .optimizer import AdamWConfig, adamw_init, adamw_update, moment_defs

__all__ = [
    "make_train_step",
    "train_state_defs",
    "init_train_state",
    "train_state_shardings",
    "batch_shardings",
]


def _cast_compute(master):
    return tree_map(
        lambda p: p.to(torch.bfloat16) if p.is_floating_point() else p,
        master,
    )


def _value_and_grad(model, compute, batch):
    """(loss, grads) of ``model.loss`` at the tree ``compute`` (zeros for a
    leaf the loss does not read, as ``jax.grad`` gives).  On a mesh each
    gradient comes back in its leaf's layout and the loss as a plain
    tensor."""
    params = tree_map(lambda p: p.detach().requires_grad_(), compute)
    with model.replicating():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    materialize_grads=True)
    if model.mesh is not None:
        with torch.no_grad():
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, tree_leaves(params))]
        loss = loss.full_tensor()
    grads = iter(grads)
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _plain(x):
    """A replicated ``DTensor``'s value as a plain tensor."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


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
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                             compute)
            loss = 0.0
            whole = batch
            if model.mesh is not None:
                # microbatch i is rows [i B/m, (i+1) B/m) of the whole
                # batch, as on one device: gather the (integer) batch, cut
                # it, and split each microbatch over the data axes again
                whole = {k: shard(x, model.mesh, *(None,) * x.ndim)
                         for k, x in batch.items()}
            for i in range(microbatches):
                mb = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                                   *x.shape[1:])[i] if x.ndim >= 1 else x
                      for k, x in whole.items()}
                if model.mesh is not None:
                    mb = {k: shard(x, model.mesh, "batch") if x.ndim
                          else x for k, x in mb.items()}
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
        return state, {k: _plain(v) for k, v in metrics.items()}

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


def train_state_shardings(model_defs, ocfg: AdamWConfig, mesh):
    """``NamedSharding``s of the train state's leaves on ``mesh``."""
    return param_shardings(train_state_defs(model_defs, ocfg), mesh)


def batch_shardings(mesh, batch_tree):
    """A batch's leaves split over the data axes by their leading dim
    (scalars replicated)."""
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    return {k: NamedSharding(mesh, (dp,) if x.ndim >= 1 else ())
            for k, x in batch_tree.items()}


def init_train_state(model_defs, params, ocfg: AdamWConfig, seed: int = 0):
    """The train state of ``params`` (on their device): the optimizer state
    and ``rng``, the two uint32 words of ``jax.random.PRNGKey(seed)``."""
    opt = adamw_init(params, ocfg)
    rng = torch.tensor([0, seed & 0xFFFFFFFF], dtype=torch.uint32,
                       device=opt["step"].device)
    return {"opt": opt, "rng": rng}
