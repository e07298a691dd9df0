"""Device resolution and per-device kernel paths.

Entry points take an explicit ``device``; the default is ``"cuda"``, and a
caller that wants the CPU says so (``device="cpu"``, as the tests do).  A
CUDA request on a machine without a CUDA device raises: nothing degrades
quietly to the CPU.

``resolve`` maps the one user-facing knob, ``use_kernels`` on
``IndexConfig`` / ``ServiceConfig`` / the launcher's ``--use-kernels``,
onto the concrete query pipeline for a device:

  ============  ==============================  ========================
  use_kernels   cuda                            cpu
  ============  ==============================  ========================
  "on"          fused, CUDA C++ kernels         fused, plain torch
                (kernels/csrc/fused_query.cu)   version of the same two
                                                passes
  "off"         unfused stages: the freq_level  the same stages with the
                CUDA kernel (kernels/csrc/      plain torch freq_level
                freq_level.cu), then per-query
                distances in torch (the norms
                expansion for p = 2), then
                torch histograms
  ============  ==============================  ========================

A plan without host codes is encoded through the ``hash_encode`` CUDA
kernel on the card (``kernels/csrc/hash_encode.cu``) on either route, and
through its plain torch version on the CPU.

Which version of a kernel runs is decided by the device of the tensors
a wrapper is given, never by a fallback: on a CUDA tensor a wrapper
launches its kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["KernelPath", "describe", "normalize", "resolve",
           "resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if CUDA is asked for
    and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; pass "
            "device='cpu' to run the plain torch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def normalize(use_kernels: bool | str) -> str:
    """Canonical knob value: "on" or "off" (True/False are accepted)."""
    if isinstance(use_kernels, bool):
        return "on" if use_kernels else "off"
    if use_kernels in ("on", "off"):
        return use_kernels
    raise ValueError(
        f"use_kernels must be 'on' or 'off' (or a bool), got "
        f"{use_kernels!r}"
    )


@dataclasses.dataclass(frozen=True)
class KernelPath:
    """Resolved query pipeline for one (``use_kernels``, device) pair.

    ``fused`` — both scan passes go through ``ops.fused_query_block``
                (``False``: the unfused stages, ``ops.freq_level`` first).
    ``cuda``  — the kernels of the route run as CUDA kernels (``False``:
                their plain torch versions, on the CPU).
    """

    fused: bool
    cuda: bool

    @property
    def label(self) -> str:
        """Short human name of the path."""
        if not self.fused:
            return "unfused"
        return "fused-cuda" if self.cuda else "fused-plain"


def resolve(use_kernels: bool | str, device: str | torch.device) -> KernelPath:
    """Map a ``use_kernels`` value and a device onto a ``KernelPath``."""
    cuda = torch.device(device).type == "cuda"
    return KernelPath(fused=normalize(use_kernels) == "on", cuda=cuda)


def describe(use_kernels: bool | str, device: str | torch.device) -> str:
    """One-line report of the resolved kernel path for the CLI."""
    path = resolve(use_kernels, device)
    dev = torch.device(device)
    where = str(dev)
    if dev.type == "cuda" and torch.cuda.is_available():
        where = torch.cuda.get_device_name(dev)
    if not path.fused:
        if not path.cuda:
            return f"unfused stages, plain torch versions, on {where}"
        return (f"unfused stages: freq_level CUDA C++ kernel (sm_90a), then "
                f"torch distances and histograms, on {where}")
    if not path.cuda:
        return f"fused query step, plain torch version, on {where}"
    return f"fused query step, CUDA C++ kernels (sm_90a), on {where}"
