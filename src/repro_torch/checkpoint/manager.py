"""Step-atomic checkpoints (port of ``repro.checkpoint.manager``), in the
reference's on-disk format, so that either package restores what the
other wrote:

* ``step_%08d/`` holds ``manifest.json`` and ``shard_0.npz``, written
  under ``step_%08d.tmp<i>/`` and published by one atomic rename; a torn
  ``.tmp`` directory (or one without a manifest) is never restored;
* the npz holds the tree's leaves as ``leaf_<i>`` in the reference's
  flatten order (``models.params.tree_leaves``: dict keys sorted; for a
  ``TrainState`` the params, then ``mu``, ``nu`` and ``step``), and
  ``__dtypes__`` their dtype names; bf16 is stored as its uint16 bits;
* ``CheckpointManager`` keeps the ``keep_last`` newest steps.

Written with numpy alone: a bf16 tensor crosses through
``Tensor.view(torch.int16)``. ``restore`` puts each leaf on the device and
in the dtype of the template's leaf at its place.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_unflatten

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_MANIFEST = "manifest.json"
_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16",
          torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.int8: "int8",
          torch.bool: "bool", torch.float64: "float64"}


def _to_numpy(leaf) -> tuple:
    """(array as stored, dtype name): bf16 as its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _structure(tree) -> str:
    """A readable outline of the tree for the manifest (not read back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}[" + ", ".join(_structure(c) for c in tree) + "]"
    return "None" if tree is None else "*"


def save(directory: str, step: int, tree: Any, process_index: int = 0,
         n_processes: int = 1) -> str:
    """Write one checkpoint step atomically. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    stored = [_to_numpy(leaf) for leaf in tree_leaves(tree)]
    arrays = {f"leaf_{i}": arr for i, (arr, _) in enumerate(stored)}
    arrays["__dtypes__"] = np.array([name for _, name in stored])
    np.savez(os.path.join(tmp, f"shard_{process_index}.npz"), **arrays)
    if process_index == 0:
        manifest = {"step": step, "n_processes": n_processes, "treedef": _structure(tree),
                    "leaves": [{"shape": list(arr.shape), "dtype": name} for arr, name in stored]}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish (single-host path: one rename)
    return final


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETE checkpoint step (manifest present), else None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp0"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                try:
                    steps.append(int(name.split("_")[1].split(".")[0]))
                except ValueError:
                    continue
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore(directory: str, tree_like: Any, step: Optional[int] = None) -> Any:
    """The checkpoint at ``step`` (default: the newest complete one) in
    ``tree_like``'s structure, each leaf in the dtype and on the device of
    the template's leaf at its place."""
    step = latest_step(directory) if step is None else step
    assert step is not None, f"no complete checkpoint under {directory}"
    with np.load(os.path.join(directory, f"step_{step:08d}", "shard_0.npz")) as data:
        names = [str(d) for d in data["__dtypes__"]] if "__dtypes__" in data else None
        out = []
        for i, leaf in enumerate(tree_leaves(tree_like)):
            arr = data[f"leaf_{i}"]
            t = _from_numpy(arr, names[i] if names else str(arr.dtype))
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            out.append(t)
    return tree_unflatten(tree_like, out)


class CheckpointManager:
    """Retention + resume orchestration for the training loop."""

    def __init__(self, directory: str, keep_last: int = 3, every: int = 100):
        self.directory = directory
        self.keep_last = keep_last
        self.every = every

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        if step % self.every:
            return None
        path = save(self.directory, step, tree)
        self._cleanup()
        return path

    def _cleanup(self):
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.directory)
                       if n.startswith("step_") and "." not in n)
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def resume_or(self, init_tree: Any):
        """(tree, start_step): the newest checkpoint if there is one, else
        ``init_tree`` at step 0."""
        step = latest_step(self.directory)
        if step is None:
            return init_tree, 0
        return restore(self.directory, init_tree, step), step
