"""Production and host meshes (the port of the JAX package's
``launch/mesh.py``) as ``torch.distributed`` ``DeviceMesh``es.

Functions, not module-level constants: importing this module starts no
process group.

  * ``make_production_mesh`` — the dry-run's (16, 16) and (2, 16, 16)
    meshes, with the reference's axis names, over a ``"fake"`` process
    group of 256 or 512 ranks in this one process (its collectives carry
    no data; the dry-run traces meta tensors through them).
  * ``make_host_mesh`` — a (data, model) mesh over the real group this
    process belongs to (``torchrun``: gloo ranks on the CPU, NCCL ranks on
    cards).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_host_mesh", "init_fake_world"]


def init_fake_world(world: int) -> None:
    """Start a ``"fake"`` process group of ``world`` ranks (this process is
    rank 0), or keep one of that size (one of another size is replaced);
    raise if a real group is up (a fake group cannot share a process with
    it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group of "
                f"{dist.get_world_size()} ranks is up; the production mesh "
                f"needs a 'fake' group of {world} ranks in a process of its "
                "own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()  # another fake world: start anew
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 chips per pod; 2 pods = 512 chips with a leading "pod"
    axis (DCN) for the multi-pod dry-run."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    init_fake_world(n)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(data: int | None = None, model: int = 1,
                   device_type: str | None = None):
    """A (data, model) mesh over the current process group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) has {data * model} "
                         f"devices, the process group {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
