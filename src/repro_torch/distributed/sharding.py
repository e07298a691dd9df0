"""Logical-axis sharding rules (FSDP + TP + EP + SP) for the model zoo, over
``torch.distributed.tensor`` (the port of the JAX package's
``distributed/sharding.py``).

Every tensor dimension is tagged with a logical name; ``spec()`` maps names
to mesh axes with a divisibility fallback (a dimension that does not divide
by its mesh axes is replicated — e.g. musicgen's 24 heads on a 16-wide
model axis).  The fallback warns once per (name, shape) — a silently
replicated dimension multiplies the per-device footprint by the mesh size,
which for serving-state rows would turn an 8-way shard into 8 full
replicas; layers that cannot afford that pass ``strict=True`` to make
non-divisibility an error instead.  Rules:

  batch    -> ("pod", "data")     data parallel
  fsdp     -> ("pod", "data")     parameter/optimizer sharding (ZeRO-3)
  model    -> ("model",)          tensor parallel (Megatron column/row)
  heads/kv_heads/ff/vocab/experts -> ("model",)
  rows     -> ("pod", "data", "model")  serving-state point rows
  seq      -> ()                  (("pod","data") for seq-sharded KV caches)
  layers/None -> replicated

``with_rules`` overrides rules locally (e.g. long-context decode shards the
KV-cache sequence over the data axes because batch == 1).

``spec`` is pure: it takes anything with ``axis_names`` (or a
``DeviceMesh``'s ``mesh_dim_names``) and a shape per axis, and returns the
per-dimension entries a JAX ``PartitionSpec`` holds (``None``, an axis
name, or a tuple of them).  The rest maps those onto a ``DeviceMesh``:

  PartitionSpec        -> a list of placements (``to_placements``); a
                          dimension over ("pod", "data") is ``Shard(d)`` on
                          both mesh dims, major first — JAX's layout
  with_sharding_constraint -> ``shard`` (``DTensor.redistribute``)
  shard_map            -> ``shard_map_nocheck`` (``local_map``)
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Iterable

import torch

__all__ = [
    "spec",
    "shard",
    "as_dtensor",
    "shard_map_nocheck",
    "named_sharding",
    "NamedSharding",
    "to_placements",
    "with_rules",
    "current_rules",
    "implicit_replication",
    "axis_size",
    "mesh_axes",
    "local_box",
    "partial_over",
    "grad_in_layout",
    "pmax",
    "psum",
]


_DEFAULT_RULES: dict[str | None, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "model": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "rows": ("pod", "data", "model"),
    "seq": (),
    "act_seq": ("model",),  # Megatron-SP residual stream between layers
    "kv_seq": (),
    "layers": (),
    None: (),
}

_rules_stack: list[dict] = [dict(_DEFAULT_RULES)]


def current_rules() -> dict:
    return _rules_stack[-1]


@contextlib.contextmanager
def with_rules(**overrides):
    new = dict(current_rules())
    for k, v in overrides.items():
        new[k] = tuple(v) if isinstance(v, (list, tuple)) else (v,)
    _rules_stack.append(new)
    try:
        yield
    finally:
        _rules_stack.pop()


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of any object with
    ``axis_names`` and a ``shape`` mapping (a JAX mesh, a test's stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_size(mesh, axes: Iterable[str]) -> int:
    shape = mesh_axes(mesh)
    s = 1
    for a in axes:
        if a in shape:
            s *= shape[a]
    return s


# (name, shape) pairs whose divisibility fallback already warned once —
# the fallback is deliberate for a handful of model-zoo dims (e.g. 24
# heads on a 16-wide model axis) and warning per call would be noise, but
# *silent* replication hides an N-fold footprint blowup from whoever
# sized the mesh.
_replication_warned: set[tuple] = set()


def spec(mesh, names: tuple[str | None, ...],
         shape: tuple[int, ...] | None = None, *,
         strict: bool = False) -> tuple:
    """PartitionSpec entries from logical dim names, with divisibility
    fallback.

    A dimension whose size does not divide its mesh axes is replicated,
    with a once-per-(name, shape) ``UserWarning`` naming the footprint
    cost.  ``strict=True`` turns the fallback into a ``ValueError`` — the
    contract the group-sharding layer requests, where replicating the
    point rows would multiply the paging budget by the mesh size.
    """
    rules = current_rules()
    present = mesh_axes(mesh)
    parts = []
    for i, name in enumerate(names):
        axes = tuple(a for a in rules.get(name, ()) if a in present)
        if not axes:
            parts.append(None)
            continue
        if shape is not None:
            size = axis_size(mesh, axes)
            if shape[i] % size != 0:
                if strict:
                    raise ValueError(
                        f"dim {i} ({name!r}) of shape {tuple(shape)} does "
                        f"not divide mesh axes {axes} (size {size}); "
                        f"strict sharding refuses to replicate — pad the "
                        f"dimension to a multiple of {size}"
                    )
                key = (name, tuple(shape))
                if key not in _replication_warned:
                    _replication_warned.add(key)
                    warnings.warn(
                        f"replicating dim {i} ({name!r}) of shape "
                        f"{tuple(shape)}: size {shape[i]} does not divide "
                        f"mesh axes {axes} (size {size}) — every device "
                        f"holds a full copy ({size}x the sharded "
                        f"footprint)",
                        UserWarning,
                        stacklevel=2,
                    )
                # replicate instead of uneven-sharding stacked/scanned dims
                parts.append(None)
                continue
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, pspec) -> list:
    """The DTensor placements of PartitionSpec entries on ``mesh``: a mesh
    dim that shards tensor dim d is ``Shard(d)``, every other
    ``Replicate()``.  A dim over several axes must name them in mesh order
    (major first), which is the order DTensor nests its shards in."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    out = [Replicate() for _ in order]
    for d, entry in enumerate(pspec):
        axes = _entry_axes(entry)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in mesh order "
                             f"{tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh paired with PartitionSpec entries (the reference's
    ``jax.sharding.NamedSharding``); ``placements`` are the entries as
    DTensor placements."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return to_placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one device's shard of a global ``shape``."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            out[d] //= axis_size(self.mesh, _entry_axes(entry))
        return tuple(out)


def named_sharding(mesh, names, shape=None, *,
                   strict: bool = False) -> NamedSharding:
    return NamedSharding(mesh, spec(mesh, tuple(names), shape,
                                    strict=strict))


def local_box(shape, mesh, placements) -> tuple[tuple[int, ...],
                                                 tuple[int, ...]]:
    """(offsets, local shape) of this rank's shard of a tensor of global
    ``shape`` laid out by ``placements`` on a ``DeviceMesh``: each Shard
    splits the current chunk of its dim evenly, mesh dims in order (the
    layout ``to_placements`` gives; every sharded dim divides)."""
    from torch.distributed.tensor import Shard

    offs = [0] * len(shape)
    size = list(shape)
    coord = mesh.get_coordinate()
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(md)
            d = p.dim % len(shape)
            assert size[d] % n == 0, (shape, placements)
            size[d] //= n
            offs[d] += coord[md] * size[d]
    return tuple(offs), tuple(size)


@contextlib.contextmanager
def implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication`` that
    nests: plain tensors meet ``DTensor``s as replicated ones, and leaving
    restores the setting found on entry (the library's version resets it
    to off, which would end an enclosing one)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def as_dtensor(x, mesh):
    """``x`` as a ``DTensor`` on ``mesh``: a ``DTensor`` as it is, a plain
    tensor as replicated (every rank holds the same whole tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard(x, mesh, *names):
    """with_sharding_constraint by logical names (no-op without mesh): a
    DTensor ``redistribute`` to the placements of ``spec(names, x.shape)``.
    A plain tensor (an activation the model made itself) is taken as
    replicated first."""
    if mesh is None:
        return x
    x = as_dtensor(x, mesh)
    return x.redistribute(mesh, to_placements(
        mesh, spec(mesh, tuple(names), tuple(x.shape))))


def shard_map_nocheck(f, mesh, in_specs, out_specs, in_grad_specs=None):
    """``shard_map`` with replication checking off: ``local_map`` of ``f``
    with its inputs redistributed to ``in_specs`` (PartitionSpec entries,
    or ``None`` for a non-tensor argument) and its outputs taken as
    ``out_specs``: one spec for one output, a list of specs for a tuple
    of outputs (a list of placements is taken as it is).

    ``in_grad_specs`` gives, per input, the placements its gradient comes
    back in (default, or ``None``: the input's own).  JAX's transpose of a
    ``shard_map`` with checks off divides each output cotangent by the
    size of the axes its spec does not mention and ``psum``s each input
    cotangent over the axes its spec does not mention; here the output
    cotangent arrives whole and an input whose gradient is a per-shard
    partial sum declares ``Partial()`` on those axes (``partial_over``),
    which sums it where DTensor redistributes it.
    """
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import Placement

    def place(s):
        if s is None:
            return None
        if isinstance(s, list):
            if all(isinstance(e, Placement) for e in s):
                return s  # placements given directly
            return tuple(place(e) for e in s)  # one spec an output
        return to_placements(mesh, s)

    in_p = tuple(place(s) for s in in_specs)
    grad_p = (None if in_grad_specs is None
              else tuple(place(g if g is not None else s)
                         for s, g in zip(in_specs, in_grad_specs)))
    return local_map(f, out_placements=place(out_specs), in_placements=in_p,
                     in_grad_placements=grad_p, device_mesh=mesh,
                     redistribute_inputs=True)


def partial_over(mesh, pspec, axes: Iterable[str]) -> list:
    """The placements of ``pspec`` with ``Partial()`` on each of ``axes``
    (a gradient that is a per-shard partial sum over them)."""
    from torch.distributed.tensor import Partial

    out = to_placements(mesh, pspec)
    order = list(mesh_axes(mesh))
    for a in axes:
        if a in order:
            out[order.index(a)] = Partial()
    return out


class _GradInLayout(torch.autograd.Function):
    """The identity, whose backward brings the gradient to the input's
    placements (a reduce-scatter of a data-parallel ``Partial``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def grad_in_layout(x):
    """``x`` itself, but its gradient comes back in ``x``'s own layout as
    soon as the backward pass yields it: a parameter gathered for a
    product (FSDP) gets a partial sum the size of the gathered weight,
    which this reduces and scatters at once instead of letting, say, the
    stack of a stacked leaf's per-layer gradients hold every layer's."""
    if not hasattr(x, "device_mesh"):
        return x
    return _GradInLayout.apply(x)


class _AllReduce(torch.autograd.Function):
    """Sum over one mesh axis's process group (a functional collective, so
    the dry-run's recorder sees it); the backward passes the cotangent
    through (see ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def pmax(x, mesh, axis: str):
    """``jax.lax.pmax`` inside a ``shard_map_nocheck`` body (not
    differentiable: callers detach its input)."""
    from torch.distributed import _functional_collectives as funcol

    if mesh_axes(mesh)[axis] == 1:
        return x
    return funcol.wait_tensor(funcol.all_reduce(x, "max",
                                                mesh.get_group(axis)))


def psum(x, mesh, axis: str):
    """``jax.lax.psum(x, axis)`` inside a ``shard_map_nocheck`` body.

    The result is replicated over ``axis`` and the body's output is
    declared so; its cotangent then arrives whole on every shard and is
    each shard's cotangent of its summand.  That is JAX's transpose (the
    output cotangent divided by the axis size, then ``psum``ed) with the
    two steps cancelled, so no collective runs in the backward pass here.
    """
    if mesh_axes(mesh)[axis] == 1:
        return x
    return _AllReduce.apply(x, mesh.get_group(axis))
