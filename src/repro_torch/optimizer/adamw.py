"""AdamW with a configurable moment dtype (port of ``repro.optimizer.adamw``).

Functions over the same nested-dict params tree as the model, not
``torch.optim.AdamW``: the update clips by the global norm first, follows
a warmup + cosine schedule, decays only matrices (``ndim >= 2``) and keeps
its moments in ``moment_dtype``: f32, bf16, or ``fp8_sim`` (bf16 storage
of values on the paper's E4M3 grid, token-wise scaled, through
``core.quantize.fake_quantize_act``). Updates always compute in f32, each
op rounded as the reference's jitted step rounds it (scalars in f32, the
multiply-adds XLA fuses fused here too).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.quantize import fake_quantize_act
from repro_torch.models.params import tree_leaves, tree_map, tree_zip

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm", "lr_schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # 'float32' | 'bfloat16' | 'fp8_sim'
    warmup: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: object  # a tree like params
    nu: object
    step: torch.Tensor  # int32, 0-d, on the params' device


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "fp8_sim": torch.bfloat16}


def _store(x: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "fp8_sim":
        return fake_quantize_act(x, "fp8_e4m3").to(torch.bfloat16)
    return x.to(_DTYPES[dtype])


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` beside every leaf, step 0."""
    dt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as the fused multiply-add that XLA
    contracts ``a * b + c`` into: the product of two f32 values is exact
    in f64, and the f64 sum rounds to the same f32 (but for a tie after
    the f64 rounding, which a 2^-29 chance leaves aside)."""
    return (a.double() * b.double() + c.double()).float()


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to ``min_lr_frac``
    of it at ``total_steps``; f32, one rounding an op, as the reference's
    jitted step computes it: its Python constants folded in f64, then f32;
    a division by a constant as a product with its f32 reciprocal (XLA's
    rewrite); the cosine correctly rounded (XLA's f32 ``cos`` is its own
    approximation: the two differ by an ulp at a few steps, see
    tests/test_torch_train.py)."""
    s = step.to(torch.float32)
    dev = s.device
    c = lambda v: _f32(v).to(dev)
    warm = torch.minimum(s * c(1.0 / max(cfg.warmup, 1)), c(1.0))
    prog = torch.clamp((s - c(cfg.warmup)) * c(1.0 / max(cfg.total_steps - cfg.warmup, 1)),
                       0.0, 1.0)
    cos = c(0.5) * (c(1.0) + torch.cos((c(math.pi) * prog).double()).float())
    frac = _fma(c(1 - cfg.min_lr_frac), cos, c(cfg.min_lr_frac))
    return c(cfg.lr) * warm * frac


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves in
    the reference's order (``tree_leaves``), the sum from 0 as Python's."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Every leaf times min(1, max_norm / max(gnorm, 1e-9)) in f32, back
    in its own dtype. Returns (clipped grads, gnorm)."""
    gn = global_norm(grads)
    c = lambda v: _f32(v).to(gn.device)
    scale = torch.minimum(c(1.0), c(max_norm) / torch.maximum(gn, c(1e-9)))
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """Returns (new_params, new_state, {"lr", "grad_norm"}): gradients
    clipped by the global norm, moments updated in f32 and stored in the
    moment dtype, bias-corrected, the decoupled decay applied to matrices
    only, each new leaf in its own dtype. Functional: nothing is written
    in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    dev = lr.device
    c = lambda v: _f32(v).to(dev)
    sf = step.to(torch.float32)
    # b ** step correctly rounded, nearer XLA's f32 pow than torch's f32 pow
    power = lambda b: torch.pow(c(b).double(), sf.double()).float()
    b1c = c(1.0) - power(cfg.b1)
    b2c = c(1.0) - power(cfg.b2)
    b1, b2, ib1, ib2 = c(cfg.b1), c(cfg.b2), c(1 - cfg.b1), c(1 - cfg.b2)
    decay = _fma(-lr, c(cfg.weight_decay), c(1.0))

    # each a * b + c below is one fused multiply-add, as XLA contracts the
    # reference's update (its first product fused, the second rounded)
    def upd(p, g, m, v):
        g32 = g.float()
        m32 = _fma(b1, m.float(), ib1 * g32)
        v32 = _fma(b2, v.float(), ib2 * torch.square(g32))
        delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + c(cfg.eps))
        if p.dim() >= 2:  # decoupled decay on matrices only
            p_new = _fma(p.float(), decay, -(lr * delta))
        else:
            p_new = _fma(-lr, delta, p.float())
        return p_new.to(p.dtype), _store(m32, cfg.moment_dtype), _store(v32, cfg.moment_dtype)

    out = tree_zip(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda t: t[i], out, is_leaf=lambda x: isinstance(x, tuple))
    return pick(0), OptState(pick(1), pick(2), step), {"lr": lr, "grad_norm": gnorm}
