"""Python binding of the paged decode attention kernel (``csrc/decode_attn.cu``).

``paged_decode_attn_cuda`` checks its operands, allocates the output and
launches the kernel on the current stream; ``paged_decode_attn_cuda.launches``
counts the launches. CUDA tensors only: the plain version for the CPU is
``ref.paged_decode_attn_ref`` (``ops.paged_decode_attn`` dispatches). Pools
with the packed-FP4 frozen region are not supported yet (ROADMAP queue 2).
The kernel covers what the serving path runs: bf16 queries over FP8 or bf16
pages whose K and V share the head width; the wrapper refuses the rest.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import page_format
from .w4a8_fused import _check

__all__ = ["paged_decode_attn_cuda"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    fn = build.load("decode_attn").paged_decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _F, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def paged_decode_attn_cuda(q, k_pages, v_pages, k_smax, k_shift, v_smax, v_shift,
                           page_table, kv_lens, fmt=None, window: int = 0, **frozen):
    """q: (B, H, hd) bf16; k/v_pages: (P+1, page, KV, hd) uint8 FP8
    codes (``fmt`` 'fp8_e4m3') or bf16 (``fmt`` None); k/v_smax (P+1,) f32
    and k/v_shift (P+1, KV) int32 (FP8 only); page_table (B, PP) int32;
    kv_lens (B,) int32. Returns (B, H, hd) f32."""
    if any(v is not None for v in frozen.values()):
        raise NotImplementedError(
            "paged decode over a packed-FP4 frozen region is not ported yet "
            "(ROADMAP queue 2: the frozen-FP4 decode variant)")
    pf = page_format(fmt)
    if pf.packed:
        raise NotImplementedError("packed FP4 active pages are not a writable pool format")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attn_cuda takes CUDA tensors, got {dev}")
    if q.dim() != 3 or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"q: want contiguous (B, H, hd) bf16, got {q.dtype} {tuple(q.shape)}")
    b, h, hd = q.shape
    p1, page, kv, _ = k_pages.shape
    pp = page_table.shape[1]
    if h % kv:
        raise ValueError(f"H={h} is not a multiple of KV={kv}")
    store = torch.uint8 if pf.quantized else torch.bfloat16
    _check(k_pages, "k_pages", store, (p1, page, kv, hd), dev)
    _check(v_pages, "v_pages", store, (p1, page, kv, hd), dev)
    _check(page_table, "page_table", torch.int32, (b, pp), dev)
    _check(kv_lens, "kv_lens", torch.int32, (b,), dev)
    if pf.quantized:
        for t, name in ((k_smax, "k_smax"), (v_smax, "v_smax")):
            _check(t, name, torch.float32, (p1,), dev)
        for t, name in ((k_shift, "k_shift"), (v_shift, "v_shift")):
            _check(t, name, torch.int32, (p1, kv), dev)
    f = pf.fmt
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if pf.quantized else None
    rc = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), int(pf.quantized),
                ptr(k_smax), ptr(k_shift), ptr(v_smax), ptr(v_shift), page_table.data_ptr(),
                kv_lens.data_ptr(), out.data_ptr(), b, h, kv, hd, page, pp, int(window),
                1.0 / float(hd) ** 0.5, f.exp_bits if f else 0, f.man_bits if f else 0,
                f.bias if f else 0, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode_attn kernel launch failed: CUDA error {rc}")
    paged_decode_attn_cuda.launches += 1
    return out


paged_decode_attn_cuda.launches = 0
