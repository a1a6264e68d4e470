"""Power-of-2 scale constraints (port of ``repro.core.scales``).

M1 snaps every scale to the power of two at or above it. M2 keeps one
full-precision ``s_max`` per compute group (a row) and snaps only the
ratios: ``S_hat_i = s_max * 2^-k_i``. With M2 the per-group scale apply is
an exponent add, and ``s_max`` multiplies once per row after the K loop —
the property that lets a Hopper GEMM turn FP4 codes into FP8 or bf16
operands without a per-group multiply (paper §3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .formats import pow2i

__all__ = ["M2Scales", "constrain_scales_m1", "constrain_scales_m2",
           "apply_scale_constraint"]


class M2Scales(NamedTuple):
    scales: torch.Tensor  # constrained real scales S_hat (input shape)
    s_max: torch.Tensor  # per compute group full-precision scale
    shifts: torch.Tensor  # int32 k_i >= 0 with S_hat_i = s_max * 2^-k_i


def constrain_scales_m1(scales: torch.Tensor) -> torch.Tensor:
    """M1: S_hat = 2^ceil(log2 S). Exact powers of two are kept."""
    n = torch.ceil(torch.log2(torch.clamp(scales.to(torch.float32), min=1e-30)))
    return pow2i(n.to(torch.int32))


def constrain_scales_m2(scales: torch.Tensor, group_axis: int = -1,
                        max_shift: int = 31, rounding: str = "ceil") -> M2Scales:
    """M2 along ``group_axis``. ``rounding='ceil'`` (paper) gives
    S_hat <= S; ``'floor'`` gives S_hat in [S, 2S) and never saturates —
    the mode the paged FP8 KV cache uses."""
    rnd = {"ceil": torch.ceil, "floor": torch.floor}[rounding]
    scales = scales.to(torch.float32)
    s_max = torch.amax(scales, dim=group_axis, keepdim=True)
    ratio = torch.clamp(s_max / torch.clamp(scales, min=1e-30), min=1.0)
    k = torch.clamp(rnd(torch.log2(ratio)), 0, max_shift).to(torch.int32)
    return M2Scales(scales=s_max * pow2i(-k), s_max=s_max, shifts=k)


def apply_scale_constraint(scales: torch.Tensor, mode, group_axis: int = -1):
    """mode in {'none', 'm1', 'm2'} -> constrained real scales."""
    if mode in (None, "none"):
        return scales
    if mode == "m1":
        return constrain_scales_m1(scales)
    if mode == "m2":
        return constrain_scales_m2(scales, group_axis=group_axis).scales
    raise ValueError(f"unknown scale constraint mode: {mode!r}")
