"""Atomic, device-independent checkpointing (the port of the JAX package's
``training/checkpoint.py``, in its layout).

Layout (one directory per step):

    <root>/step_000123/
        manifest.json      {step, keys, shapes, dtypes, extra}
        000000.npy ...     one file per tree leaf

``keys`` are the reference's ``jax.tree_util.keystr`` paths
(``"['opt']['master']['blocks']['attn']['wq']"``) in sorted-key order,
so a checkpoint the JAX package wrote loads into the port's template and
the other way round.  bfloat16 leaves are written as their ``uint16``
bits under manifest dtype ``bfloat16``; the loader reads every leaf by
its manifest dtype, so it also takes the ``|V2`` payloads that ``np.save``
writes for the JAX package's bfloat16 arrays.

Properties:
  * atomic: written to ``<root>/.tmp_<step>`` then ``os.replace()``d — a
    crash mid-save never corrupts the latest checkpoint;
  * device-independent: leaves are whole host arrays; ``load_checkpoint``
    puts them on any ``device``;
  * elastic: a ``DTensor`` leaf is gathered whole (``full_tensor``, a
    collective every rank joins) and rank 0 writes; ``load_checkpoint(...,
    shardings=)`` lays each leaf out on any mesh, so a run saved under one
    mesh resumes under another;
  * keep-last-k pruning + find-latest for automatic restart;
  * async: every leaf is copied to host memory before ``save_checkpoint``
    returns (so a later in-place step cannot race the writer), and the
    file writes happen on a background thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..models.params import distribute, from_numpy, tree_leaves, tree_map

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _leaf_keys(tree, prefix: str = "") -> list[str]:
    """``jax.tree_util.keystr`` of every leaf of a tree of nested dicts,
    in sorted key order."""
    if isinstance(tree, dict):
        return [k for name in sorted(tree)
                for k in _leaf_keys(tree[name], f"{prefix}[{name!r}]")]
    return [prefix]


def _to_host(v) -> tuple[np.ndarray, str]:
    """(a host array of its own, the manifest dtype) of a leaf."""
    if not isinstance(v, torch.Tensor):
        a = np.array(v)
        return a, str(a.dtype)
    if hasattr(v, "full_tensor"):  # a DTensor: every rank gathers it
        v = v.full_tensor()
    # a copy even on the CPU, where .numpy() would share the tensor's
    # memory with the next in-place step
    t = v.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def save_checkpoint(root: str, step: int, tree, keep: int = 3,
                    extra: dict | None = None, async_write: bool = False):
    keys = _leaf_keys(tree)
    host = [_to_host(v) for v in tree_leaves(tree)]
    if dist.is_initialized() and dist.get_rank() != 0:
        return None  # rank 0 writes the gathered leaves
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".tmp_{step:09d}")
    final = os.path.join(root, f"step_{step:09d}")

    def write():
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {
            "step": int(step),
            "keys": keys,
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [name for _, name in host],
            "extra": extra or {},
        }
        for i, (a, _) in enumerate(host):
            np.save(os.path.join(tmp, f"{i:06d}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        _prune(root, keep)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _prune(root: str, keep: int):
    steps = sorted(
        int(m.group(1))
        for d in os.listdir(root)
        if (m := _STEP_RE.match(d))
    )
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(root)
        if (m := _STEP_RE.match(d))
    ]
    return max(steps) if steps else None


def load_checkpoint(root: str, template, step: int | None = None,
                    device=None, shardings=None):
    """Restore into the structure of ``template`` (values ignored; meta
    tensors do).

    Leaves come back as CPU tensors, or on ``device`` when given; the
    checkpoint may have been written from any device or mesh, or by the
    JAX package.  ``shardings`` (a tree of ``NamedSharding``s under the
    template's keys) lays the leaves out as ``DTensor``s on their mesh —
    the elastic path.  Returns (step, tree, extra).
    """
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    keys = _leaf_keys(template)
    if keys != manifest["keys"]:
        raise ValueError(
            "checkpoint structure mismatch: "
            f"{set(keys) ^ set(manifest['keys'])}"
        )
    vals = iter(np.load(os.path.join(d, f"{i:06d}.npy"))
                for i in range(len(keys)))
    names = iter(manifest["dtypes"])
    tree = from_numpy(tree_map(lambda _: next(vals), template),
                      tree_map(lambda _: next(names), template))
    if device is not None:
        tree = tree_map(lambda t: t.to(device), tree)
    if shardings is not None:
        tree = distribute(tree, shardings)
    return step, tree, manifest.get("extra", {})


@dataclasses.dataclass
class CheckpointManager:
    """save-every-N + auto-resume + preemption flush."""

    root: str
    every: int = 100
    keep: int = 3
    async_write: bool = True
    _pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree, extra=None, force: bool = False):
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        self._pending = save_checkpoint(
            self.root, step, tree, keep=self.keep, extra=extra,
            async_write=self.async_write,
        )
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_or_none(self, template, device=None, shardings=None):
        try:
            return load_checkpoint(self.root, template, device=device,
                                   shardings=shardings)
        except FileNotFoundError:
            return None
