"""Carry weights across from the JAX package as plain numpy arrays.

``flat`` maps "/"-joined paths to arrays, the order and naming that
``jax.tree_util.tree_flatten_with_path`` gives a params tree:
``segments/0/mixer/attn/wq`` for a dense weight, and one leaf per
PackedLinear field for a packed one (``segments/0/mixer/attn/wq/codes``,
``.../scale``, ``.../s_max``, ``.../shifts``, ``.../lorc_a``,
``.../lorc_b``). bf16 arrays arrive as ``ml_dtypes.bfloat16`` and are
reinterpreted through a uint16 view. PackedLinear's static fields are not
leaves: the formats come from ``policy`` and the group size from the
shapes. The helper that produces ``flat`` imports jax and so lives with
the tests, not here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .api import build_def
from .layers import PackedLinear
from .params import ParamDef, tree_items

__all__ = ["from_numpy"]


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _packed(node: dict, policy) -> PackedLinear:
    codes, scale = node["codes"], node["scale"]
    return PackedLinear(
        codes=codes, scale=scale, s_max=node.get("s_max"), shifts=node.get("shifts"),
        lorc_a=node.get("lorc_a"), lorc_b=node.get("lorc_b"),
        w_fmt=policy.w_fmt if policy else "fp4_e2m1",
        a_fmt=policy.a_fmt if policy else "fp8_e4m3",
        group_size=codes.shape[-1] * 2 // scale.shape[-1])


def _build(node, policy):
    if isinstance(node, dict):
        if "codes" in node:
            return _packed(node, policy)
        keys = list(node)
        if keys and all(k.isdigit() for k in keys):
            return [_build(node[str(i)], policy) for i in range(len(keys))]
        return {k: _build(v, policy) for k, v in node.items()}
    return node


def from_numpy(flat: Dict[str, np.ndarray], cfg, device, policy=None):
    """The port's params tree (dense or packed) from ``flat`` on ``device``.
    ``policy`` (a QuantPolicy) names the packed weights' formats; None means
    PackedLinear's defaults (fp4_e2m1 weights, fp8_e4m3 activations)."""
    for path, d in tree_items(build_def(cfg), is_leaf=lambda x: isinstance(x, ParamDef)):
        if path in flat:
            if tuple(np.shape(flat[path])) != tuple(d.shape):
                raise ValueError(f"{path}: shape {np.shape(flat[path])}, want {d.shape}")
        elif path + "/codes" not in flat:
            raise KeyError(f"{path}: missing from flat (dense or packed)")
    root: dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(arr, device)
    return _build(root, policy)
