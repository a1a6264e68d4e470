"""Python binding of the flash-attention forward kernel
(``csrc/flash_attn.cu``).

``flash_attention_cuda`` checks its operands, allocates the output and
launches the kernel on the current stream; it counts its launches in
``flash_attention_cuda.launches``. CUDA tensors only: the plain version
for the CPU is ``ref.flash_attention_ref`` (``ops.flash_attention``
dispatches). The kernel takes q, k and v of one dtype, bf16 or f32, one
head count, head widths hd and dv up to 128; the wrapper refuses the rest.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["flash_attention_cuda", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    fn = build.load("flash_attn").flash_attn_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
        fn.restype = _I
    return fn


def flash_attention_cuda(q, k, v, causal: bool = True):
    """q: (B, S, H, hd), k: (B, T, H, hd), v: (B, T, H, dv), all bf16 or all
    f32 and contiguous. Returns (B, S, H, dv) in v's dtype: softmax(q k^T /
    sqrt(hd), masked k_pos > q_pos when ``causal``) v."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"dtype {q.dtype}: the kernel is built for bf16 and f32")
    b, s, h, hd = q.shape
    t_len, dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (b, t_len, h, hd) or tuple(v.shape[:3]) != (b, t_len, h):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "want (B, S, H, hd), (B, T, H, hd), (B, T, H, dv)")
    if not (0 < hd <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM) or t_len < 1:
        raise NotImplementedError(f"hd={hd}, dv={dv}, T={t_len}: the kernel takes head widths "
                                  f"1..{MAX_HEAD_DIM} and T >= 1")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got {dev}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != q.dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {q.dtype} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((b, s, h, dv), dtype=v.dtype, device=dev)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t_len, h, hd, dv,
                1.0 / float(hd) ** 0.5, int(causal), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
