"""Roofline terms of a traced step (the port of the JAX package's
``launch/roofline.py``), with the H100's constants.

Per (arch x shape x mesh):

    compute term    = FLOPs / (989 TFLOP/s dense bf16 a card), but each
                      launch of a retrieval kernel at the rates of its
                      own bound (float32 and int32 on the CUDA cores,
                      ``kernels/cost.py``)
    memory term     = bytes / (3.35 TB/s HBM3 a card)
    collective term = collective_wire_bytes / (450 GB/s NVLink a card)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collective bytes from the compiled HLO.  The port has no compiled program:
``StepCounter`` is a ``TorchDispatchMode`` that watches one step run on
``DTensor``s and counts what each device runs, on its local shards:

  * FLOPs — ``torch.utils.flop_counter``'s formulas (those
    ``FlopCounterMode`` applies) on every local op it has one for; a
    ``repro_torch`` op (a kernel wrapper, one op a call: the dispatcher
    hides its inner ops) is counted by ``kernels/cost.py`` instead, its
    floating-point operations in the FLOPs and its whole cost in
    ``kernels`` (launches, operations by unit, bytes, seconds at its
    units' rates);
  * bytes — each local op's tensor inputs read once and outputs written
    once, views excluded (an eager, unfused count: no two ops share a
    read);
  * collectives — every ``_c10d_functional`` collective DTensor or the
    model issues: its per-device output bytes by kind, x2 for all-reduce
    (ring reduce-scatter + all-gather), and the share whose group is the
    "pod" axis as DCN bytes;
  * live bytes — tensors the step allocates, by storage, from creation to
    the last tensor on it being freed: the peak above the step's inputs.

Ops on ``DTensor``s are handed on (``NotImplemented``) so the mode sees the
local ops DTensor runs; neither the fake tensors of DTensor's shape
propagation nor the host index tensors of its redistribution planning
are the step's, so only ops whose tensors lie on the step's device
(``device``, meta for a dry-run) are counted.  Per-device numbers need
no division by the mesh size: MODEL_FLOPS / (FLOPs x chips) is the
useful-compute fraction, which exposes remat recompute and replicated
work.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["HW", "StepCounter", "collective_bytes", "kernel_terms",
           "analyze", "RooflineResult"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's peak rates.  ``link_bw``: NVLink 4, 18 links x 25 GB/s a
    direction (a 256-card "pod" is one NVLink Switch domain, as in a DGX
    H100 SuperPOD); ``dcn_bw``: one 400 Gb/s InfiniBand NDR port a card
    between pods."""

    peak_flops: float = 989e12  # dense bf16 / card
    hbm_bw: float = 3.35e12  # bytes/s / card (HBM3)
    link_bw: float = 450e9  # bytes/s / card (NVLink, one direction)
    dcn_bw: float = 50e9  # bytes/s / card (inter-pod)
    name: str = "NVIDIA H100 80GB HBM3, 700 W"
    # the CUDA cores, where the retrieval kernels run (kernels/cost.py):
    # float32 FLOP/s (an FMA counts two), float32 instructions a second
    # (128 lanes an SM x 132 SMs x 1.98 GHz boost), int32 at 64 lanes an
    # SM, the special-function units (sqrt, log2, exp2) at 16 an SM
    f32_flops: float = 67e12
    f32_ops: float = 132 * 128 * 1.98e9
    int32_ops: float = 132 * 64 * 1.98e9
    sfu_ops: float = 132 * 16 * 1.98e9


_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def _collective_kind(op: str) -> str | None:
    if op.startswith("all_reduce"):
        return "all-reduce"
    if op.startswith("all_gather"):
        return "all-gather"
    if op.startswith("reduce_scatter"):
        return "reduce-scatter"
    if op.startswith("all_to_all"):
        return "all-to-all"
    if op == "broadcast":
        return "collective-permute"  # point to point, as XLA lowers it
    return None


# ops that return a view or metadata: no bytes move
_VIEWS = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "slice", "select", "unsqueeze", "squeeze", "split",
    "split_with_sizes", "unbind", "detach", "alias", "as_strided",
    "view_as_real", "view_as_complex", "_reshape_alias", "unfold",
    "diagonal", "chunk", "narrow", "lift_fresh", "_to_copy_view",
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts a step's local FLOPs, bytes, collectives and live memory (see
    the module docstring).  ``mesh`` names the process groups of its axes
    for the DCN share; ``register_args`` marks the step's inputs, whose
    storage is not the step's allocation."""

    def __init__(self, mesh=None, device="meta"):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.device = torch.device(device)
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = dict.fromkeys(_KINDS, 0)
        self.counts = dict.fromkeys(_KINDS, 0)
        self.dcn = 0
        self.kernels: dict = {}
        self.cur = 0
        self.peak = 0
        self._args: set = set()
        self._live: dict = {}
        self._group_axis = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._group_axis[mesh.get_group(i).group_name] = name

    def register_args(self, tree) -> int:
        """Mark the tensors of ``tree`` (DTensors by their local shards) as
        inputs; returns their bytes on this device."""
        total = 0
        for t in tree_flatten(tree)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            t = t.to_local() if hasattr(t, "to_local") else t
            key = t.untyped_storage()._cdata
            if key not in self._args:
                self._args.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _release(self, key) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.cur -= ent[0]
            del self._live[key]

    def _track(self, outs) -> None:
        for t in outs:
            if type(t) is not torch.Tensor:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args:
                continue
            ent = self._live.get(key)
            if ent is None:
                ent = self._live[key] = [st.nbytes(), 0]
                self.cur += ent[0]
                self.peak = max(self.peak, self.cur)
            ent[1] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs the local ops we count
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not all(t is torch.Tensor for t in types) or any(
                type(t) is not torch.Tensor or t.device != self.device
                for t in outs):
            return out  # not the step's (see the module docstring)
        packet = func._overloadpacket
        if func.namespace == "repro_torch":
            self._kernel(func._opname, args, kwargs)
        elif packet in self._registry:
            self.flops += float(self._registry[packet](*args, **kwargs,
                                                       out_val=out))
        comm = func.namespace == "_c10d_functional"
        kind = _collective_kind(func._opname) if comm else None
        if kind is not None:
            b = sum(_nbytes(t) for t in outs) * (2 if kind == "all-reduce"
                                                 else 1)
            self.coll[kind] += b
            self.counts[kind] += 1
            group = args[-1] if args and isinstance(args[-1], str) else None
            if self._group_axis.get(group) == "pod":
                self.dcn += b
        elif (not comm and func.namespace != "repro_torch"
              and func._opname not in _VIEWS):
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._track(outs)
        return out


    def _kernel(self, name: str, args, kwargs) -> None:
        from ..kernels import cost

        c = cost.of_op(name, args, kwargs)
        ent = self.kernels.setdefault(name, dict(
            launches=0, f32_flops=0.0, f32_ops=0.0, int32_ops=0.0,
            sfu_ops=0.0, bytes=0, ops_s=0.0))
        ent["launches"] += 1
        for k in ("f32_flops", "f32_ops", "int32_ops", "sfu_ops", "bytes"):
            ent[k] += getattr(c, k)
        ent["ops_s"] += c.ops_s(HW())
        self.flops += c.flops
        self.bytes += c.bytes


def kernel_terms(counter: StepCounter) -> dict:
    """The kernels' share of a step's compute: their floating-point
    operations (inside ``counter.flops``) and their seconds at their own
    units' rates."""
    ks = counter.kernels.values()
    return {"kernel_flops": sum(k["f32_flops"] + k["f32_ops"] for k in ks),
            "kernel_s": sum(k["ops_s"] for k in ks)}


def collective_bytes(counter: StepCounter) -> dict:
    """Per-device wire bytes by collective kind of a ``StepCounter``'s
    step, in the reference's layout (``total_raw`` equals ``total``: the
    reference's CPU-backend bf16 correction has no counterpart)."""
    total = int(sum(counter.coll.values()))
    return {"bytes": dict(counter.coll), "counts": dict(counter.counts),
            "total": total, "total_raw": total, "dcn": int(counter.dcn)}


@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_detail: dict
    model_flops: float  # global useful FLOPs (6*N*D style estimate)
    memory: dict  # per device: argument, temp (peak live), total bytes
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self, hw: HW = HW(), kernel_flops: float = 0.0,
                 kernel_s: float = 0.0):
        """The three terms; ``kernel_flops`` of the FLOPs are the
        retrieval kernels', which take ``kernel_s`` at their own rates
        instead of the bfloat16 peak."""
        self.compute_s = ((self.hlo_flops_per_chip - kernel_flops)
                          / hw.peak_flops + kernel_s)
        self.memory_s = self.hlo_bytes_per_chip / hw.hbm_bw
        self.collective_s = self.coll_bytes_per_chip / hw.link_bw
        return self

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        total_hlo = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful FLOPs/s at roofline step time vs peak (the MFU bound)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return (self.model_flops / t) / (self.chips * HW().peak_flops)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            bottleneck=self.bottleneck,
            useful_fraction=self.useful_fraction,
            step_time_s=self.step_time_s,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def analyze(
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    traced: dict,
    model_flops: float,
    hw: HW = HW(),
    terms: dict | None = None,
) -> RooflineResult:
    """``traced`` is the dry-run's count of one full-depth step (its
    ``flops``, ``bytes``, ``coll_detail`` and ``memory``, and the
    kernels' ``kernel_flops`` and ``kernel_s`` where a step launches
    any); ``terms`` overrides the first three with the two-point depth
    extrapolation of ``dryrun.analysis_terms``."""
    src = terms if terms is not None else traced
    coll = {"total": src["coll"], "bytes": src.get("coll_detail", {}),
            "counts": {}} if terms is not None else traced["coll_detail"]
    return RooflineResult(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_per_chip=float(src["flops"]),
        hlo_bytes_per_chip=float(src["bytes"]),
        coll_bytes_per_chip=float(coll["total"]),
        coll_detail=coll,
        model_flops=model_flops,
        memory=dict(traced["memory"]),
    ).finalize(hw, traced.get("kernel_flops", 0.0),
               traced.get("kernel_s", 0.0))
