"""Parameter definition trees (port of ``repro.models.params``).

A model's parameters are described once as nested dicts/lists of
``ParamDef`` leaves (shape + dtype + logical axis names + init law) and
materialized by ``init_tree``. The port draws from a ``torch.Generator``,
so the values differ from ``jax.random``'s for the same seed; the tests
move weights across with ``models.bridge.from_numpy`` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamDef", "init_leaf", "init_tree", "tree_map", "tree_items", "tree_leaves",
           "tree_unflatten", "tree_zip"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical name per dim
    dtype: str = "bfloat16"
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: float = 1.0  # stddev multiplier for 'normal' (fan-in handled here)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_leaf(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    """Same laws as the reference: zeros / ones / N(0, 0.02 * scale) for
    embeddings / fan-in scaled N(0, scale / sqrt(shape[-1]))."""
    dtype = _DTYPES[d.dtype]
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    noise = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    # scaled in place: no second f32 copy of the leaf (11 GB at nemotron's MLP)
    if d.init == "embed":
        return noise.mul_(0.02 * d.scale).to(dtype)
    fan_in = d.shape[-1] if d.shape else 1
    return noise.mul_(float(d.scale / np.sqrt(max(fan_in, 1)))).to(dtype)


def _rebuild(node, children: list):
    """A list, tuple or NamedTuple of ``node``'s type holding ``children``."""
    return type(node)(*children) if hasattr(node, "_fields") else type(node)(children)


def tree_map(fn: Callable, tree, is_leaf: Callable = None):
    """Map ``fn`` over the leaves of nested dicts/lists (None stays None)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, is_leaf) for v in tree])
    if tree is None:
        return None
    return fn(tree)


def tree_items(tree, is_leaf: Callable = None, prefix: str = ""):
    """Yield ``("a/b/0/c", leaf)`` pairs in insertion order — the
    "/"-joined path convention of the reference's quantize_tree."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, is_leaf, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, is_leaf, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def _children(tree):
    """A node's children in the reference's flatten order: a dict's by
    sorted key (``jax.tree.leaves`` sorts them), a list's or tuple's
    (a NamedTuple's fields) in order."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples in the reference's
    flatten order (dict keys sorted; None and empty containers have
    none): the order of ``jax.tree.leaves`` on the same tree."""
    if isinstance(tree, (dict, list, tuple)):
        return [leaf for child in _children(tree) for leaf in tree_leaves(child)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves) -> object:
    """``like``'s structure (its dicts' insertion order, NamedTuple types
    included) with its leaves replaced, in ``tree_leaves`` order, by
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(c) for c in node])
        return None if node is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_zip(fn: Callable, tree, *others):
    """``fn(leaf, *the other trees' leaves at the same place)`` over trees
    of one structure (nested dicts and lists, None staying None)."""
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_zip(fn, v, *(o[i] for o in others))
                               for i, v in enumerate(tree)])
    if tree is None:
        return None
    return fn(tree, *others)


def init_tree(tree, seed: int, device) -> dict:
    """Materialize a ParamDef tree from one seeded generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda d: init_leaf(d, gen, device), tree,
                    is_leaf=lambda x: isinstance(x, ParamDef))
