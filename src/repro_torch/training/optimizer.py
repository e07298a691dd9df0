"""AdamW with memory-footprint controls (the port of the JAX package's
``training/optimizer.py``), on one device or on a ``DeviceMesh``:

  * moment quantization — m/v stored bfloat16 or *blockwise int8* (256-wide
    blocks on the last dim, per-block float32 scales): 8 -> 2 bytes/param
    of optimizer state;
  * bfloat16 master params with *stochastic rounding* (unbiased), halving
    the master copy;
  * decoupled weight decay, global-norm clipping;
  * WSD (warmup-stable-decay, MiniCPM) and cosine schedules.

The arithmetic is the reference's, operation for operation, in float32
tensors.  Two things differ by necessity: the stochastic-rounding bits
come from a ``torch.Generator`` seeded from (rng, step, leaf index), not
from JAX's threefry (``_sr_cast_bf16`` takes the bits as a tensor, so a
test can feed it JAX's), and ``adamw_update`` writes the state's tensors
in place (the counterpart of the reference's donated state) and returns
no bfloat16 compute copy of them.

On a mesh the state's leaves are ``DTensor``s.  Each leaf's update runs on
its local shard, in the leaf's own layout, except that int8 moments need
whole 256-wide blocks: where the last dim is sharded and a shard does not
hold whole blocks, that dim is gathered for the update and sliced back
after it.  The stochastic-rounding bits of a piece are drawn whole from the
leaf's generator on every rank and each rank takes its slice, so a mesh
update equals the one-device update bit for bit given the same gradients
and global norm.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.params import ParamDef, torch_dtype, tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule",
           "moment_defs"]

_QBLOCK = 256
# ``update_chunk`` runs a leaf's update in at most this many pieces: each
# is a Python iteration of ~30 kernel launches (the reference's lax.scan
# is one compiled loop), and olmo-1b's embedding in pieces of 4 of its
# 50,304 rows took 8.3 s a step on an H100
_MAX_PIECES = 16


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_dtype: str = "float32"  # float32 | bfloat16 (stochastic rounding)
    moment_dtype: str = "float32"  # float32 | bfloat16 | int8
    acc_dtype: str = "float32"  # microbatch grad-accumulator dtype; bfloat16
    # halves the accumulator (relative error ~ sqrt(K) * 2^-8 at K
    # microbatches)
    update_chunk: int = 0  # >0: apply the update chunk by chunk over the
    # leading (stacked-layers) axis of big leaves — bounds the float32
    # dequantize/update transients to one chunk instead of one whole leaf
    # (a leaf with more than _MAX_PIECES chunks takes bigger ones)
    schedule: str = "cosine"  # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1  # WSD: last fraction of steps decays
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` as a float32 0-d tensor (on the step
    tensor's device), computed in float32 as the reference does."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        frac = torch.ones_like(step)
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.decay_frac)
        t = torch.clamp(
            (step - decay_start) / max(cfg.total_steps - decay_start, 1.0),
            0.0, 1.0)
        frac = 1.0 - (1.0 - cfg.min_lr_frac) * t
    else:  # cosine
        t = torch.clamp(step / max(cfg.total_steps, 1), 0.0, 1.0)
        frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * frac


# ---------------------------------------------------------------------------
# blockwise int8 quantization
# ---------------------------------------------------------------------------


def _quantize(x, ceil: bool = False):
    """float32 -> (int8 codes, float32 per-block scales, shape), blockwise
    on the LAST dim (padded to a multiple of 256).

    ``ceil`` rounds magnitudes up (used for the second moment so quantized
    Adam denominators are conservative, never spuriously zero); otherwise
    ratios round half to even, as ``jnp.round``.
    """
    shape = x.shape
    last = shape[-1]
    pad = (-last) % _QBLOCK
    if pad:
        x = F.pad(x, (0, pad))
    nb = x.shape[-1] // _QBLOCK
    blocks = x.reshape(*shape[:-1], nb, _QBLOCK)
    amax = blocks.abs().amax(dim=-1)  # (..., nb)
    # a tensor divisor: CUDA multiplies by the reciprocal of a scalar one
    scale = amax / amax.new_full((), 127.0)
    ratio = blocks / torch.clamp_min(scale[..., None], 1e-30)
    if ceil:
        q = torch.sign(ratio) * torch.ceil(ratio.abs())
    else:
        q = torch.round(ratio)
    codes = torch.clamp(q, -127, 127).to(torch.int8)
    return codes.reshape(*shape[:-1], nb * _QBLOCK), scale, shape


def _dequantize(codes, scale, shape):
    nb = scale.shape[-1]
    blocks = codes.reshape(*shape[:-1], nb, _QBLOCK).to(torch.float32)
    out = (blocks * scale[..., None]).reshape(*shape[:-1], nb * _QBLOCK)
    return out[..., : shape[-1]]


def _moment_store(x, dtype: str, kind: str = "m"):
    """kind "m": linear int8.  kind "v": sqrt-domain + ceil rounding —
    direct int8 of v zeroes ~15% of entries, exploding m/sqrt(v);
    sqrt-domain storage has ~1.6% median error and the ceil keeps
    denominators conservative (the reference's measurements)."""
    if dtype == "int8":
        y = torch.sqrt(torch.clamp_min(x, 0.0)) if kind == "v" else x
        codes, scale, _ = _quantize(y, ceil=(kind == "v"))
        return {"q": codes, "s": scale}
    return x.to(torch_dtype(dtype))


def moment_defs(param_def: ParamDef, dtype: str):
    """ParamDef-level mirror of _moment_store (the state's defs)."""
    if dtype != "int8":
        return dataclasses.replace(param_def, dtype=dtype, init="zeros")
    shape = param_def.shape
    last = shape[-1]
    padded = last + ((-last) % _QBLOCK)
    q = ParamDef((*shape[:-1], padded), param_def.names, "zeros",
                 dtype="int8")
    s = ParamDef(
        (*shape[:-1], padded // _QBLOCK),
        (*param_def.names[:-1], None),
        "zeros",
        dtype="float32",
    )
    return {"q": q, "s": s}


def _moment_load(stored, shape, dtype: str, kind: str = "m"):
    if dtype == "int8":
        y = _dequantize(stored["q"], stored["s"], shape)
        return y * y if kind == "v" else y
    return stored.to(torch.float32)


def _sr_bits(shape, generator: torch.Generator, device) -> torch.Tensor:
    """16 random bits an element (int32 in [0, 0xFFFF]) from
    ``generator`` (uninitialized on the meta device, which a dry-run
    traces and which has no generator)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.int32, device=device)
    return torch.randint(0, 1 << 16, tuple(shape), generator=generator,
                         dtype=torch.int32, device=device)


def _sr_cast_bf16(x, rnd):
    """Stochastic-rounding cast float32 -> bfloat16 (unbiased), given 16
    random bits an element in ``rnd``: the reference's
    ``(bits + rnd) & 0xFFFF0000`` on the float32 bits.  It runs on their
    int32 view, whose sums equal the uint32 ones for every non-NaN input
    (a carry crosses the sign bit only from a NaN's bits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    top = (bits + rnd) & -0x10000  # 0xFFFF0000 as int32
    return top.view(torch.float32).to(torch.bfloat16)


def _leaf_generator(rng, step: int, leaf: int, device) -> torch.Generator:
    """The stochastic-rounding generator of one leaf at one step: seeded
    from (rng, step, leaf index), so a restart repeats its bits."""
    if torch.device(device).type == "meta":
        return None
    seq = np.random.SeedSequence([int(rng[0]), int(rng[1]), step, leaf])
    seed = int(seq.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# init / update
# ---------------------------------------------------------------------------


def adamw_init(params, cfg: AdamWConfig):
    """The optimizer state of ``params``: a step counter, the master copy
    (a fresh tensor even where ``params`` already has the master dtype:
    the update writes it in place) and the moments."""

    def one(p):
        # distinct buffers for m and v: both are written in place
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": _moment_store(z, cfg.moment_dtype),
                "v": _moment_store(z.clone(), cfg.moment_dtype)}

    dev = tree_leaves(params)[0].device
    master = tree_map(
        lambda p: p.detach().to(torch_dtype(cfg.master_dtype), copy=True),
        params)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": master,
        "moments": tree_map(one, params),
    }


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def _leaf_update(g, p, st, rnd, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf (or one chunk of its leading slices): updates ``p`` and the
    stored moments ``st`` in place; ``rnd`` holds the stochastic-rounding
    bits of a bfloat16 master."""
    g = g.to(torch.float32) * scale
    m = _moment_load(st["m"], g.shape, cfg.moment_dtype, "m")
    v = _moment_load(st["v"], g.shape, cfg.moment_dtype, "v")
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
    upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    pf = p.to(torch.float32)
    pf = pf - lr * (upd + cfg.weight_decay * pf)
    if cfg.master_dtype == "bfloat16":
        p.copy_(_sr_cast_bf16(pf, rnd))
    else:
        p.copy_(pf)
    for kind in ("m", "v"):
        new = _moment_store(m if kind == "m" else v, cfg.moment_dtype, kind)
        if cfg.moment_dtype == "int8":
            st[kind]["q"].copy_(new["q"])
            st[kind]["s"].copy_(new["s"])
        else:
            st[kind].copy_(new)


def _pieces(shape, cfg: AdamWConfig):
    """The [lo, hi) ranges of the leading dim that a leaf's update runs in
    turn: one for the whole leaf, or with ``update_chunk`` a stacked-layers
    leaf piece by piece, so the float32 dequantize/update transients stay
    piece-sized; a piece is `chunk` slices, or the fewest multiples of it
    that keep to _MAX_PIECES (the embedding's vocab axis).  ``None`` stands
    for the whole of a leaf that is not cut."""
    chunk = cfg.update_chunk
    lead = shape[0] if shape else 0
    if not (chunk and len(shape) >= 2 and lead > chunk and lead % chunk == 0):
        return [None]
    size = chunk * -(-lead // (chunk * _MAX_PIECES))
    return [(lo, min(lo + size, lead)) for lo in range(0, lead, size)]


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def _update_layout(p, cfg: AdamWConfig) -> list:
    """The placements a sharded leaf's update runs in: the leaf's own, but
    with its last dim gathered where int8 blocks would straddle shards."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, last = p.device_mesh, p.ndim - 1
    out = list(p.placements)
    on_last = [i for i, pl in enumerate(out)
               if isinstance(pl, Shard) and pl.dim % p.ndim == last]
    n = math.prod(mesh.size(i) for i in on_last)
    if cfg.moment_dtype == "int8" and p.shape[-1] % (n * _QBLOCK):
        for i in on_last:
            out[i] = Replicate()
    return out


def _sharded_leaf(g, p, st, gen, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """``_leaf_update`` of a ``DTensor`` leaf on this rank's shard (see the
    module docstring); the pieces and their bits are the one-device ones."""
    from torch.distributed.tensor import DTensor

    from ..distributed.sharding import local_box

    mesh = p.device_mesh
    lay = _update_layout(p, cfg)

    def to_lay(t):
        return t.redistribute(mesh, lay).to_local()

    gl, pl = to_lay(g), to_lay(p)
    stl = tree_map(to_lay, st)
    offs, size = local_box(tuple(p.shape), mesh, lay)
    box = tuple(slice(o, o + n) for o, n in zip(offs, size))
    scalars = [_local(x) for x in (scale, lr, bc1, bc2)]
    sr = cfg.master_dtype == "bfloat16"
    for piece in _pieces(tuple(p.shape), cfg):
        rnd = None  # a piece's bits go before the next piece's are drawn
        if piece is None:  # the whole leaf
            rnd = _sr_bits(p.shape, gen, pl.device)[box] if sr else None
            _leaf_update(gl, pl, stl, rnd, *scalars, cfg)
            continue
        lo, hi = piece  # leading (stacked-layers) rows
        rnd = _sr_bits((hi - lo, *p.shape[1:]), gen, pl.device) if sr \
            else None
        a, b = max(lo, offs[0]), min(hi, offs[0] + size[0])
        if a >= b:
            continue
        r = slice(a - offs[0], b - offs[0])
        if rnd is not None:
            rnd = rnd[(slice(a - lo, b - lo), *box[1:])]
        _leaf_update(gl[r], pl[r], tree_map(lambda t: t[r], stl), rnd,
                     *scalars, cfg)
    for stored, new in zip([p, *tree_leaves(st)], [pl, *tree_leaves(stl)]):
        back = DTensor.from_local(new, mesh, lay, run_check=False)
        stored.to_local().copy_(
            back.redistribute(mesh, stored.placements).to_local())


def _each_up_to(fn, tree, *others):
    """``fn(leaf, *subtrees)`` on the leaves of ``tree`` in sorted key
    order, each with the subtrees of ``others`` at its place (the
    reference's ``treedef.flatten_up_to``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _each_up_to(fn, tree[k], *(o[k] for o in others))
    else:
        fn(tree, *others)


@torch.no_grad()
def adamw_update(grads, opt_state, cfg: AdamWConfig, rng=None):
    """One AdamW step.  Returns (opt_state, metrics).

    The state's tensors (step, master, moments) are updated **in place**
    and ``opt_state`` itself is returned: a caller that keeps the state
    before the step clones it first.  The reference also returns a
    bfloat16 compute copy of the new master, which its train step drops
    (and its jit never builds); the port builds none, so a step allocates
    no second copy of the parameters.  ``rng`` is
    the train state's 2-word key (uint32); the stochastic-rounding bits of
    leaf i (in sorted key order) at step s come from a generator seeded
    from (rng, s, i).  Reading the step and ``rng`` for those seeds
    synchronizes with the device once a step (bfloat16 master only).
    """
    step_t = opt_state["step"]
    step_t += 1
    lr = lr_schedule(cfg, step_t)
    t = step_t.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    gnorm = _global_norm(grads)
    scale = torch.clamp(
        torch.full_like(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-12),
        max=1.0)

    sr = cfg.master_dtype == "bfloat16"
    if sr:
        # a mesh's step and rng are replicated: each rank reads its copy
        # (a dry-run's meta tensors hold no values and draw no bits)
        meta = step_t.device.type == "meta"
        key = ([0, 0] if rng is None or meta
               else _local(rng).cpu().tolist())
        step = 0 if meta else int(_local(step_t))
    leaf = itertools.count()

    def one(g, p, st):
        gen = _leaf_generator(key, step, next(leaf), p.device) if sr else None
        if hasattr(p, "device_mesh"):
            _sharded_leaf(g, p, st, gen, scale, lr, bc1, bc2, cfg)
            return
        for piece in _pieces(tuple(g.shape), cfg):
            rnd = None  # a piece's bits go before the next piece's are drawn
            if piece is None:
                rnd = _sr_bits(g.shape, gen, p.device) if sr else None
                _leaf_update(g, p, st, rnd, scale, lr, bc1, bc2, cfg)
                continue
            lo, hi = piece
            rnd = _sr_bits((hi - lo, *g.shape[1:]), gen, p.device) if sr \
                else None
            _leaf_update(g[lo:hi], p[lo:hi], tree_map(lambda a: a[lo:hi], st),
                         rnd, scale, lr, bc1, bc2, cfg)

    _each_up_to(one, grads, opt_state["master"], opt_state["moments"])
    return opt_state, {"grad_norm": gnorm, "lr": lr}
