"""Python binding of the token-wise FP8 activation quantizer
(``csrc/act_quant.cu``).

``act_quant_cuda`` checks its operand, allocates the outputs and launches
the kernel on the current stream; it counts its launches in
``act_quant_cuda.launches``. CUDA tensors only: the plain version for the
CPU is ``ref.act_quant_ref`` (``ops.act_quant`` dispatches). The kernel
takes f32 or bf16 rows of any width onto the ``fp8_e4m3`` or ``fp8_e5m2``
grid; the wrapper refuses any other format.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import FORMATS

from . import build

__all__ = ["act_quant_cuda", "ACT_FORMATS"]

ACT_FORMATS = ("fp8_e4m3", "fp8_e5m2")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    fn = build.load("act_quant").act_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        fn.restype = _I
    return fn


def act_quant_cuda(x: torch.Tensor, fmt_name: str = "fp8_e4m3"):
    """x: (..., d) f32 or bf16 -> (values on the grid f32 (..., d), scale f32
    (..., 1)), bit-identical to ``ref.act_quant_ref``."""
    if fmt_name not in ACT_FORMATS:
        raise NotImplementedError(
            f"fmt_name={fmt_name!r}: the CUDA kernel quantizes onto {ACT_FORMATS} only")
    if x.device.type != "cuda":
        raise ValueError(f"act_quant_cuda takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"x: want contiguous f32 or bf16 (..., d), got {x.dtype} "
                         f"{tuple(x.shape)}{'' if x.is_contiguous() else ' (non-contiguous)'}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    q = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    grid = FORMATS[fmt_name]
    rc = _lib()(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, d,
                int(x.dtype == torch.bfloat16), grid.man_bits, grid.min_exp, grid.max_exp,
                grid.max_value, 1.0 / grid.max_value,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"act_quant kernel launch failed: CUDA error {rc}")
    act_quant_cuda.launches += 1
    return q, scale


act_quant_cuda.launches = 0
