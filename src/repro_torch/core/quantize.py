"""Quantizers (port of ``repro.core.quantize``): FGQ group-wise weight
quantization over ``(out, in)`` matrices with groups of consecutive input
channels, and token-wise activation quantization over the last axis."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .formats import FloatFormat, IntFormat, f32, get_format, quantize_to_grid

__all__ = [
    "QuantizedTensor",
    "compute_scales",
    "quantize_weight",
    "dequantize_weight",
    "fake_quantize_weight",
    "quantize_act_tokenwise",
    "fake_quantize_act",
]

_EPS = 1e-12


class QuantizedTensor(NamedTuple):
    """Values on the target grid (pre-scale) plus per-group scales."""

    values: torch.Tensor  # (out, in) f32 on-grid
    scale: torch.Tensor  # (out, n_groups) for weights; (tokens, 1) for acts
    zero_point: Optional[torch.Tensor]
    group_size: int
    fmt_name: str

    def dequantize(self) -> torch.Tensor:
        return dequantize_weight(self)


def _grid_max(fmt) -> float:
    if isinstance(fmt, FloatFormat):
        return fmt.max_value
    return float(fmt.qmax)


def _round_to_fmt(x, fmt):
    if isinstance(fmt, FloatFormat):
        return quantize_to_grid(x, fmt)
    return torch.clamp(torch.round(x), fmt.qmin, fmt.qmax)


def compute_scales(w_groups: torch.Tensor, fmt, symmetric: bool = True):
    """Scales (and zero points) for grouped weights ``(..., group_size)``."""
    if symmetric or isinstance(fmt, FloatFormat):
        absmax = torch.amax(w_groups.abs(), dim=-1, keepdim=True)
        # the f32 reciprocal, multiplied: the reference's constant exactly
        scale = torch.clamp(absmax * f32(1.0 / _grid_max(fmt)), min=_EPS)
        return scale, None
    wmax = torch.amax(w_groups, dim=-1, keepdim=True)
    wmin = torch.amin(w_groups, dim=-1, keepdim=True)
    scale = torch.clamp((wmax - wmin) / fmt.levels, min=_EPS)
    zero = torch.round(-wmin / scale) + fmt.qmin
    return scale, zero


def quantize_weight(w: torch.Tensor, fmt_name: str, group_size: int = 256,
                    scale: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """FGQ quantization of a ``(out, in)`` weight; ``scale`` (out, n_groups)
    injects pre-constrained (M1/M2) scales."""
    fmt = get_format(fmt_name)
    out_f, in_f = w.shape
    if group_size <= 0 or group_size > in_f:
        group_size = in_f
    assert in_f % group_size == 0, (in_f, group_size)
    n_groups = in_f // group_size
    wg = w.reshape(out_f, n_groups, group_size).to(torch.float32)
    symmetric = not (isinstance(fmt, IntFormat) and not fmt.symmetric)
    if scale is None:
        s, z = compute_scales(wg, fmt, symmetric=symmetric)
    else:
        s = torch.clamp(scale.reshape(out_f, n_groups, 1).to(torch.float32), min=_EPS)
        z = None if symmetric else compute_scales(wg, fmt, symmetric=False)[1]
    if symmetric:
        q = _round_to_fmt(wg / s, fmt)
    else:
        q = torch.clamp(torch.round(wg / s) + z, fmt.qmin, fmt.qmax)
    return QuantizedTensor(
        values=q.reshape(out_f, in_f),
        scale=s.reshape(out_f, n_groups),
        zero_point=None if z is None else z.reshape(out_f, n_groups),
        group_size=group_size,
        fmt_name=fmt_name,
    )


def dequantize_weight(qt: QuantizedTensor) -> torch.Tensor:
    out_f, in_f = qt.values.shape
    n_groups = in_f // qt.group_size
    q = qt.values.reshape(out_f, n_groups, qt.group_size)
    if qt.zero_point is not None:
        q = q - qt.zero_point.reshape(out_f, n_groups, 1)
    return (q * qt.scale.reshape(out_f, n_groups, 1)).reshape(out_f, in_f)


def fake_quantize_weight(w, fmt_name: str, group_size: int = 256, scale=None):
    """quantize -> dequantize in one call."""
    if get_format(fmt_name) is None:
        return w
    return dequantize_weight(quantize_weight(w, fmt_name, group_size, scale))


def quantize_act_tokenwise(x: torch.Tensor, fmt_name: str):
    """Token-wise symmetric quantization over the last axis: returns
    ``(q_on_grid f32, scale (..., 1) f32)`` with x_hat = q * scale."""
    fmt = get_format(fmt_name)
    x = x.to(torch.float32)
    absmax = torch.amax(x.abs(), dim=-1, keepdim=True)
    scale = torch.clamp(absmax * f32(1.0 / _grid_max(fmt)), min=_EPS)
    return _round_to_fmt(x / scale, fmt), scale


def fake_quantize_act(x: torch.Tensor, fmt_name):
    """Token-wise quantize -> dequantize; identity for 'none'/None."""
    if get_format(fmt_name) is None:
        return x
    q, scale = quantize_act_tokenwise(x, fmt_name)
    return (q * scale).to(x.dtype)
