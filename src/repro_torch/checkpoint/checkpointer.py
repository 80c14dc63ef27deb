"""Atomic, async, resumable checkpointing: the port of
``repro/checkpoint/checkpointer.py``, in the same layout, so a checkpoint
of either package restores in the other.

Layout:  <dir>/step_<N>/arrays.npz + meta.json ;  <dir>/LATEST
Guarantees:
  * atomicity — writes land in ``tmp_<N>`` and are renamed (POSIX atomic) only
    after fsync; a crash mid-save never corrupts the previous checkpoint;
  * exact resume — meta.json carries the data-pipeline step;
  * async — `AsyncCheckpointer` copies the tensors to the host synchronously
    and writes on a background thread, off the training critical path.

Arrays are keyed by their tree path (``"params|layers|attn|wq"``; list
indices as numbers), as ``jax.tree_util`` paths are joined in the JAX
package. npz has no bfloat16: bf16 is widened to float32 on save and cast
back to the target's dtype on restore (lossless). ZeRO-3 state is stored
as the global flat buffers (``b03_bfloat16``, ...); a checkpoint cut under
another layout imports through :func:`restore_fsdp_checkpoint`.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.overlap import fsdp_relayout, torch_dtype
from repro_torch.models.layers import leaf_paths, rebuild, tree_map

PyTree = Any
_SEP = "|"
# ZeRO-3 flat-buffer key shape (core.overlap.FsdpGroup.key): bucket + dtype
_BUCKET_KEY = re.compile(r"^b\d+_\w+$")


def _host(x) -> np.ndarray:
    """A host copy of one leaf as numpy (bf16 and other narrow floats
    widened to float32), never sharing memory with a live tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        dtype = (torch.float32 if x.is_floating_point() and x.itemsize < 4
                 else x.dtype)
        return x.to(device="cpu", dtype=dtype, copy=True).numpy()
    return np.asarray(x)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_SEP.join(str(p) for p in path): _host(leaf)
            for path, leaf in leaf_paths(tree).items()}


def _bucket_keys(keys) -> Tuple[str, ...]:
    """The FSDP flat-buffer names among `keys` (path segments like
    ``b03_bfloat16``): the part of the tree that is layout-dependent."""
    return tuple(sorted({seg for k in keys for seg in k.split(_SEP)
                         if _BUCKET_KEY.match(seg)}))


def _unflatten_into(target: PyTree,
                    arrays: Dict[str, np.ndarray]) -> PyTree:
    """`target`'s structure with each leaf read from `arrays`, as a tensor
    of the target leaf's dtype on its device."""
    paths = leaf_paths(target)
    want = [_SEP.join(str(p) for p in path) for path in paths]
    leaves = {}
    for key, (path, leaf) in zip(want, paths.items()):
        if key not in arrays:
            want_b, have_b = _bucket_keys(want), _bucket_keys(arrays)
            if want_b and have_b and want_b != have_b:
                raise ValueError(
                    f"checkpoint FSDP layout mismatch: the restore target "
                    f"expects flat buffers {list(want_b)} but the checkpoint "
                    f"holds {list(have_b)} — a grad_buckets / bucket_order / "
                    "mesh-size change re-cuts the layout. Import the "
                    "checkpoint with checkpoint.restore_fsdp_checkpoint "
                    "(unshards with the OLD FsdpLayout, reshards with the "
                    "new) instead of restoring it structurally.")
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = torch.from_numpy(arrays[key])
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        leaves[path] = t
    return rebuild(tree_map(lambda _: None, target), leaves)


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays = _flatten(tree)
    tmp = os.path.join(directory, f"tmp_{step}_{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": int(step), "extra": extra or {}}, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_", 1)[1]) for d in os.listdir(directory)
        if d.startswith("step_"))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_checkpoint(directory: str, target: PyTree,
                       step: Optional[int] = None
                       ) -> Tuple[int, PyTree, Dict]:
    """Restore into the structure of `target` (a tree of tensors: each
    restored leaf takes its target's dtype and device). Returns (step, tree
    of new tensors, extra)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return int(meta["step"]), _unflatten_into(target, arrays), meta.get(
        "extra", {})


def restore_fsdp_checkpoint(directory: str, old_layout, new_layout,
                            step: Optional[int] = None
                            ) -> Tuple[int, PyTree, Dict]:
    """Re-layout import path for ZeRO-3 trainer state: restore a checkpoint
    written under `old_layout` (some grad_buckets / bucket_order / mesh
    size) and re-cut its flat buffers — params AND float32 optimizer
    moments — into `new_layout` (``core.overlap.fsdp_relayout``: unshard
    with the OLD layout, reshard with the NEW). Bit-exact: only pad
    elements are dropped and re-added.

    Returns ``(step, {"params": flat, "opt": {"m", "v", "step"}}, extra)``,
    the global flat buffers keyed by the NEW layout, on the CPU (cut a
    rank's shard with ``core.overlap.shard_slice``)."""
    def flat_target(dtype=None):
        return {g.key: torch.empty(0, dtype=dtype or torch_dtype(g.dtype))
                for g in old_layout.groups}

    target = {"params": flat_target(),
              "opt": {"m": flat_target(torch.float32),
                      "v": flat_target(torch.float32),
                      "step": torch.empty(0, dtype=torch.int32)}}
    step, tree, extra = restore_checkpoint(directory, target, step)
    out = {"params": fsdp_relayout(tree["params"], old_layout, new_layout),
           "opt": {"m": fsdp_relayout(tree["opt"]["m"], old_layout,
                                      new_layout),
                   "v": fsdp_relayout(tree["opt"]["v"], old_layout,
                                      new_layout),
                   "step": tree["opt"]["step"]}}
    return step, out, extra


class AsyncCheckpointer:
    """Snapshot synchronously, write asynchronously (one in flight)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None) -> None:
        self.wait()
        arrays = _flatten(tree)   # device-to-host copies, before returning

        def work():
            try:
                save_checkpoint(self.directory, step, arrays, extra, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
