"""GPTQ — Hessian-guided one-shot weight quantization (port of
``repro.core.gptq``; paper §3).

As Frantar et al. (GPTQ) are used by ZeroQuant-FP:
  * H = 2 X X^T, a running mean over a calibration stream (X: layer inputs),
  * damped by lambda * mean(diag(H)) for stability,
  * columns quantized left to right in blocks; each column's rounding error
    is fed into the columns not yet quantized through the upper Cholesky
    factor of H^-1,
  * group-wise (FGQ) scales taken at each group boundary from the *current*
    (error-fed) weights,
  * any rounding grid of ``core.formats`` (INT4/8, E2M1, E3M0, E4M3 ...),
  * optional power-of-2 scale constraints (M1/M2) applied to each group
    scale as it is taken, so the error feedback absorbs the snap.

The reference is plain ``jax.numpy`` under ``jit``, and so is this port
plain PyTorch on either device (``torch.linalg`` runs cuSOLVER on the card
and LAPACK on the CPU), in the reference's order of operations. Its
matrix products run in full f32 whatever the caller's TF32 setting. Where
the bits are decided:
  * XLA turns ``absmax / grid_max`` into a multiply by the f32 reciprocal;
    the port multiplies by that reciprocal too (divisions by computed
    values stay divisions);
  * the damped inverse's Cholesky factor is taken in f64 and rounded to
    f32: an f32 factorization (LAPACK's, cuSOLVER's, XLA's) errs by many
    f32 ulps at an ill-conditioned Hessian (post-ReLU inputs), enough to
    flip codes between the card and the CPU; rounded from f64, their
    factors differ in a last bit at most;
  * a damped inverse that is not positive definite makes the reference's
    Cholesky factor NaN, and NaN flows on here too (no exception);
  * the sweep is a Python loop over columns, each a few small launches, so
    a column's rounding looks its grid value up (``_grid_rounding``: 4
    launches) where ``quantize_to_grid`` computes it (~17), to the same
    bits.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from .formats import FloatFormat, f32, get_format, pow2i, quantize_to_grid, value_grid
from .quantize import QuantizedTensor, _grid_max, _round_to_fmt
from .scales import apply_scale_constraint

__all__ = ["HessianState", "hessian_init", "hessian_update", "gptq_quantize", "full_f32"]


class HessianState(NamedTuple):
    h: torch.Tensor  # (in, in) running mean of 2 X^T X
    n: torch.Tensor  # f32 scalar: samples seen


@contextlib.contextmanager
def full_f32():
    """f32 matrix products in full f32 (no TF32) inside the block; the
    caller's setting comes back after it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def hessian_init(in_features: int, device) -> HessianState:
    return HessianState(
        h=torch.zeros((in_features, in_features), dtype=torch.float32, device=device),
        n=torch.zeros((), dtype=torch.float32, device=device))


def hessian_update(state: HessianState, x: torch.Tensor) -> HessianState:
    """Accumulate calibration inputs x (..., in_features)."""
    x = x.reshape(-1, x.shape[-1]).to(torch.float32)
    n = state.n + x.shape[0]
    with full_f32():
        xtx = x.T @ x
    return HessianState(h=state.h * (state.n / n) + (2.0 / n) * xtx, n=n)


def _invh_cholesky(h: torch.Tensor, damp: float) -> torch.Tensor:
    """The damped inverse Hessian's upper Cholesky factor U (H^-1 = U^T U).
    Where the reference's factorization fails (a singular H, or an inverse
    that is not positive definite) its factor is NaN on and above the
    diagonal and 0 below, and so is the port's."""
    d = h.shape[0]
    h = h + (damp * torch.mean(torch.diagonal(h)) + 1e-8) * torch.eye(
        d, dtype=h.dtype, device=h.device)
    hinv, info_inv = torch.linalg.inv_ex(h.double())
    hinv = 0.5 * (hinv + hinv.T)  # symmetrize before the Cholesky
    low, info = torch.linalg.cholesky_ex(hinv)
    ok = (info == 0) & (info_inv == 0)
    low = low.to(h.dtype)
    return torch.where(ok, low, torch.full_like(low, float("nan")).tril()).T


def _grid_rounding(fmt, device):
    """``_round_to_fmt`` onto ``fmt``'s grid, bit for bit, in 4 launches: a
    float grid's value is looked up by a search of the midpoints between
    its values (beyond the last, the largest: saturation), each midpoint
    sent to the neighbour ``quantize_to_grid`` sends it to. As there, a
    negative value that rounds to zero gives -0, a zero gives +0 and NaN
    stays NaN. Integer grids round as they are."""
    if not isinstance(fmt, FloatFormat):
        return lambda v: _round_to_fmt(v, fmt)
    grid = torch.from_numpy(value_grid(fmt.name)).to(device)
    mids = (grid[:-1] + grid[1:]) / 2  # exact: neighbours share their exponent or double
    up = quantize_to_grid(mids, fmt) == grid[1:]
    neg_inf = torch.full_like(mids, -float("inf"))
    bounds = torch.where(up, torch.nextafter(mids, neg_inf), mids)  # x == bound: lower bucket
    # the zero bucket splits at the negative float nearest zero: below it -0
    z = int((grid == 0).nonzero())
    tiny = torch.nextafter(torch.zeros(1, device=device), neg_inf[:1])
    bounds = torch.cat([bounds[:z], tiny, bounds[z:]])
    table = torch.cat([grid[:z], torch.full((1,), -0.0, device=device), grid[z:]])
    return lambda v: torch.where(torch.isnan(v), v, table[torch.bucketize(v, bounds)])


def _group_scale(wgrp: torch.Tensor, fmt, scale_mode: str, s_max=None) -> torch.Tensor:
    """One FGQ group's scale per output row from the current columns
    wgrp (out, group_size) -> (out, 1).

    Under M2 a row is the compute group (paper: "a (multiple) row(s) of a
    matrix"), so its S_max is needed before the column sweep: it comes
    from the initial full-row absmax (the k >= 0 clip saturates any later
    excess at S_max)."""
    absmax = torch.amax(wgrp.abs(), dim=-1, keepdim=True)
    s = torch.clamp(absmax * f32(1.0 / _grid_max(fmt)), min=1e-12)
    if scale_mode == "m1":
        s = apply_scale_constraint(s, "m1")
    elif scale_mode == "m2":
        ratio = torch.clamp(s_max / s, min=1.0)
        k = torch.clamp(torch.ceil(torch.log2(ratio)), 0, 31)
        s = s_max * pow2i(-k.to(torch.int32))
    return s


def gptq_quantize(w: torch.Tensor, hessian: torch.Tensor, fmt_name: str,
                  group_size: int = 256, scale_mode: str = "none", damp: float = 0.01,
                  block: int = 128):
    """GPTQ-quantize an (out, in) weight given its input Hessian (in, in),
    on the weight's device. Returns ``(w_hat, QuantizedTensor)``: the
    dequantized weight, and the on-grid values with their (M1/M2
    constrained) scales for packing."""
    in_f = w.shape[1]
    if group_size <= 0 or group_size > in_f:
        group_size = in_f
    block = min(block, group_size)
    qvals, scales = _gptq_core(w, hessian, fmt_name, group_size, scale_mode, damp, block)
    qt = QuantizedTensor(values=qvals, scale=scales, zero_point=None, group_size=group_size,
                         fmt_name=fmt_name)
    return qt.dequantize(), qt


@torch.no_grad()
def _gptq_core(w, hessian, fmt_name: str, group_size: int, scale_mode: str, damp: float,
               block: int):
    fmt = get_format(fmt_name)
    out_f, in_f = w.shape
    assert in_f % group_size == 0 and group_size % block == 0, (in_f, group_size, block)
    w = w.to(torch.float32).clone()  # the error-fed weights, finalized block by block
    hinv_u = _invh_cholesky(hessian.to(torch.float32), damp)
    s_max_row = torch.clamp(torch.amax(w.abs(), dim=-1, keepdim=True)
                            * f32(1.0 / _grid_max(fmt)), min=1e-12)
    qvals = torch.zeros_like(w)
    scales = torch.ones((out_f, in_f // group_size), dtype=torch.float32, device=w.device)
    round_col = _grid_rounding(fmt, w.device)
    with full_f32():
        for b0 in range(0, in_f, block):
            b1 = b0 + block
            g = b0 // group_size
            if b0 % group_size == 0:  # a group starts: its scale from the current weights
                scales[:, g:g + 1] = _group_scale(w[:, b0:b0 + group_size], fmt, scale_mode,
                                                  s_max_row)
            s = scales[:, g]
            wb = w[:, b0:b1].clone()
            ublk = hinv_u[b0:b1, b0:b1]
            qs, errs = [], []
            for i in range(block):
                col = wb[:, i]
                q = round_col(col / s)
                err = (col - q * s) / ublk[i, i]
                wb[:, i + 1:] -= torch.outer(err, ublk[i, i + 1:])  # feedback in the block
                qs.append(q)
                errs.append(err)
            qb, errb = torch.stack(qs, dim=1), torch.stack(errs, dim=1)
            qvals[:, b0:b1] = qb
            # the block's accumulated error into every later column
            w[:, b1:] -= errb @ hinv_u[b0:b1, b1:]
            w[:, b0:b1] = qb * s[:, None]
    return qvals, scales
