"""Python binding of the fused W4A8 GEMM (``csrc/w4a8_fused.cu``).

``w4a8_fused_matmul_cuda`` checks its operands, allocates the output and
launches the kernel on the current stream; ``w4a8_fused_matmul_cuda.launches``
counts the launches. It takes CUDA tensors only: the plain version for
the CPU is ``ref.w4a8_matmul_ref`` (``ops.w4a8_matmul`` dispatches).
The kernel covers what the serving path runs: bf16 activations quantized
to FP8 E4M3 in-kernel and FP4 E2M1 weights, with or without M2 and LoRC;
the wrapper refuses any other variant.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.formats import FORMATS

from . import build

__all__ = ["w4a8_fused_matmul_cuda"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("w4a8_fused")
    fn = lib.w4a8_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _P]
        fn.restype = _I
    return fn


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ' (non-contiguous)'}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def w4a8_fused_matmul_cuda(x, codes, scale, s_max=None, shifts=None, lorc_a=None,
                           lorc_b=None, *, w_fmt: str = "fp4_e2m1",
                           a_fmt: Optional[str] = "fp8_e4m3", group_size: int = 256):
    """x: (M, K) bf16 raw activations (quantized to FP8 E4M3 in-kernel);
    codes: (N, K/2) uint8 E2M1 nibbles; scale: (N, G) f32; optional M2
    split s_max (N, 1) f32 + shifts (N, G) int8 and LoRC lorc_a (N, r) /
    lorc_b (r, K) bf16. Returns (M, N) bf16."""
    if w_fmt != "fp4_e2m1" or a_fmt != "fp8_e4m3":
        raise NotImplementedError(
            f"w_fmt={w_fmt!r}, a_fmt={a_fmt!r}: the CUDA kernel runs fp4_e2m1 weights with "
            "fp8_e4m3 activations only (ROADMAP queue 2: other W4A8 variants)")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"w4a8_fused_matmul_cuda takes CUDA tensors, got {dev}")
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x: want contiguous 2-D bf16, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    n = codes.shape[0]
    g = k // group_size
    if k % 2 or group_size <= 0 or k % group_size:
        raise ValueError(f"K={k} must be even and a multiple of group_size={group_size}")
    _check(codes, "codes", torch.uint8, (n, k // 2), dev)
    _check(scale, "scale", torch.float32, (n, g), dev)
    if (s_max is None) != (shifts is None):
        raise ValueError("s_max and shifts come together (M2) or not at all")
    if shifts is not None:
        _check(shifts, "shifts", torch.int8, (n, g), dev)
        _check(s_max, "s_max", torch.float32, (n, 1), dev)
    r = 0 if lorc_a is None else lorc_a.shape[-1]
    if r:
        if r > 32:
            raise ValueError(f"LoRC rank {r} > 32 (the kernel's epilogue bound)")
        _check(lorc_a, "lorc_a", torch.bfloat16, (n, r), dev)
        _check(lorc_b, "lorc_b", torch.bfloat16, (r, k), dev)
    grid = FORMATS[a_fmt]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    rc = _lib()(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), _ptr(shifts), _ptr(s_max),
                _ptr(lorc_a) if r else None, _ptr(lorc_b) if r else None, out.data_ptr(),
                m, n, k, group_size, r, grid.man_bits, grid.min_exp, grid.max_exp,
                grid.max_value, 1.0 / grid.max_value,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"w4a8_fused kernel launch failed: CUDA error {rc}")
    w4a8_fused_matmul_cuda.launches += 1
    return out


w4a8_fused_matmul_cuda.launches = 0
