"""Python binding of the split W4A8 GEMM (``csrc/w4a8_matmul.cu``).

``w4a8_matmul_cuda`` checks its operands, allocates the output and
launches the kernel on the current stream; it counts its launches in
``w4a8_matmul_cuda.launches``. CUDA tensors only: the plain version for the
CPU is ``ref.w4a8_split_matmul_ref`` (``ops.w4a8_matmul_split``
dispatches). The kernel takes bf16 activations that are already quantized,
FP4 E2M1 or E3M0 weights with M2 or plain f32 group scales, any M and N;
the wrapper refuses any other weight format.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .w4a8_fused import W_FORMATS as SPLIT_W_FORMATS, _check, _ptr, fitted_plan

__all__ = ["w4a8_matmul_cuda", "SPLIT_W_FORMATS"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    fn = build.load("w4a8_matmul").w4a8_split_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def w4a8_matmul_cuda(x_q, codes, scale, s_max: Optional[torch.Tensor] = None,
                     shifts: Optional[torch.Tensor] = None, *, w_fmt: str = "fp4_e2m1",
                     group_size: int = 256):
    """x_q: (M, K) bf16 quantized activations (values on the FP8 grid times
    their scale); codes: (N, K/2) uint8 nibbles; scale: (N, K/g) f32 (read
    without M2); optional M2 split s_max (N,) or (N, 1) f32 + shifts (N,
    K/g) int8. Returns (M, N) f32 = x_q . deq(W)^T."""
    if w_fmt not in SPLIT_W_FORMATS:
        raise NotImplementedError(
            f"w_fmt={w_fmt!r}: the split CUDA kernel decodes {SPLIT_W_FORMATS} weights only")
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"w4a8_matmul_cuda takes CUDA tensors, got {dev}")
    if x_q.dim() != 2 or x_q.dtype != torch.bfloat16 or not x_q.is_contiguous():
        raise ValueError(f"x_q: want contiguous 2-D bf16, got {x_q.dtype} {tuple(x_q.shape)}")
    m, k = x_q.shape
    n = codes.shape[0]
    if k % 2 or group_size <= 0 or k % group_size:
        raise ValueError(f"K={k} must be even and a multiple of group_size={group_size}")
    g = k // group_size
    _check(codes, "codes", torch.uint8, (n, k // 2), dev)
    _check(scale, "scale", torch.float32, (n, g), dev)
    if (s_max is None) != (shifts is None):
        raise ValueError("s_max and shifts come together (M2) or not at all")
    if shifts is not None:
        _check(shifts, "shifts", torch.int8, (n, g), dev)
        s_max = s_max.reshape(-1)
        _check(s_max, "s_max", torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = _lib()(x_q.data_ptr(), codes.data_ptr(), scale.data_ptr(), _ptr(shifts), _ptr(s_max),
                out.data_ptr(), m, n, k, group_size, int(w_fmt == "fp4_e3m0"),
                *fitted_plan(m, n, k, group_size, 0), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"w4a8_matmul kernel launch failed: CUDA error {rc}")
    w4a8_matmul_cuda.launches += 1
    return out


w4a8_matmul_cuda.launches = 0
