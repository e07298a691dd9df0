"""Declarative parameter definitions (the port's copy of the JAX
package's ``models/params.py``).

A module describes its parameters once as ``ParamDef``s (shape + logical
dim names + init); from that single source we derive:

  * init_params(defs, generator, device) — materialized params
  * abstract_params(defs)                — meta-device tensors (no
                                           allocation)
  * param_specs(defs, mesh)              — PartitionSpec entries from the
                                           logical dim names (the rules of
                                           ``distributed.sharding``)

Stacked layers prepend a ("layers", L) dim with ``stack_defs``.  A
parameter tree is nested dicts of tensors keyed as the JAX package's, so
a JAX tree (as numpy arrays) carries across leaf by leaf (``from_numpy``).
``distribute`` places a tree on a ``DeviceMesh`` by its shardings (the
reference's ``jax.device_put`` with a ``NamedSharding``), real tensors and
meta tensors alike.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..distributed.sharding import NamedSharding, local_box, spec
from ..kernels.platform import resolve_device

__all__ = [
    "ParamDef",
    "pdef",
    "stack_defs",
    "init_params",
    "abstract_params",
    "param_specs",
    "param_shardings",
    "distribute",
    "tree_map",
    "tree_leaves",
    "tree_bytes",
    "count_params",
    "torch_dtype",
    "from_numpy",
]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    names: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    scale: float = 0.02
    dtype: str = "float32"


def pdef(shape, names, init="normal", scale=0.02, dtype="float32") -> ParamDef:
    assert len(shape) == len(names), (shape, names)
    return ParamDef(tuple(shape), tuple(names), init, scale, dtype)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("bfloat16", "float8_e4m3fn",
    ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of nested dicts, keys in
    sorted order (as JAX flattens a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def stack_defs(defs, n_layers: int):
    return tree_map(
        lambda d: ParamDef((n_layers, *d.shape), ("layers", *d.names),
                           d.init, d.scale, d.dtype),
        defs,
    )


def _init_one(d: ParamDef, generator, dev) -> torch.Tensor:
    dt = torch_dtype(d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=dev)
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    if d.init == "scaled":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return (x / math.sqrt(fan_in)).to(dt)
    return (x * d.scale).to(dt)


def init_params(defs, generator: torch.Generator, device="cuda"):
    """Materialized params drawn from ``generator`` (which must live on
    ``device``), leaf by leaf in sorted key order.  The init kinds are the
    JAX package's; the random bits are torch's, not JAX's PRNG."""
    dev = resolve_device(device)
    return tree_map(lambda d: _init_one(d, generator, dev), defs)


def abstract_params(defs):
    """Meta-device tensors of the params' shapes and dtypes."""
    return tree_map(
        lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype),
                              device="meta"),
        defs,
    )


def param_specs(defs, mesh):
    """The PartitionSpec entries of every leaf of ``defs`` on ``mesh``."""
    return tree_map(lambda d: spec(mesh, d.names, d.shape), defs)


def param_shardings(defs, mesh):
    """``NamedSharding``s of every leaf of ``defs`` on ``mesh``."""
    return tree_map(lambda sp: NamedSharding(mesh, sp),
                    param_specs(defs, mesh))


def _distribute_one(x: torch.Tensor, sh: NamedSharding):
    from torch.distributed.tensor import DTensor

    placements = sh.placements
    offs, size = local_box(tuple(x.shape), sh.mesh, placements)
    local = x[tuple(slice(o, o + n) for o, n in zip(offs, size))]
    return DTensor.from_local(local.clone(), sh.mesh, placements,
                              run_check=False)


def distribute(tree, shardings):
    """``DTensor``s of a tree of whole tensors (the same on every rank),
    laid out by a tree of ``NamedSharding``s under the same keys: each rank
    keeps a copy of its own shard.  Meta tensors give meta shards."""
    if isinstance(tree, dict):
        return {k: distribute(tree[k], shardings[k]) for k in sorted(tree)}
    return _distribute_one(tree, shardings)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors; of a ``DTensor``, this rank's shard."""
    return sum(_local(x).numel() * x.element_size()
               for x in tree_leaves(tree) if isinstance(x, torch.Tensor))


# dtypes numpy has no type of its own for, and the unsigned integer type
# of their width: their payloads cross as raw bits
_BITS = {"bfloat16": np.uint16}


def _leaf_from_numpy(a, name: str | None) -> torch.Tensor:
    a = np.asarray(a)
    # torch.from_numpy shares the buffer (np.ascontiguousarray would turn
    # a 0-d array into a 1-d one)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    name = name or a.dtype.name
    bits = _BITS.get(name)
    if bits is None:
        return torch.from_numpy(a)
    # ml_dtypes' type, or a |V2 / uint16 payload: the raw bits, retyped
    return torch.from_numpy(a.view(bits)).view(torch_dtype(name))


def from_numpy(tree, dtypes=None):
    """CPU tensors of a tree of numpy arrays, under the same keys.

    ``dtypes`` (optional) is a tree of the same keys naming each leaf's
    dtype; it is needed where an array carries a payload numpy cannot
    name: a bfloat16 leaf read back by ``np.load`` is ``|V2``, and a
    ``uint16`` array may hold bfloat16 bits.  Without it a leaf keeps its
    array's dtype, ``ml_dtypes.bfloat16`` (a JAX array's) included."""
    if isinstance(tree, dict):
        return {k: from_numpy(tree[k], None if dtypes is None else dtypes[k])
                for k in sorted(tree)}
    return _leaf_from_numpy(tree, dtypes)
