"""Kernel entry points of the model code (port of ``repro.kernels.ops``).

Dispatch is by device, not by a backend switch: CUDA tensors launch the
hand-written kernel (and a failed build or launch raises — there is no
fallback), CPU tensors take the plain PyTorch version in ``ref``.
"""
from __future__ import annotations

import torch

from . import ref

__all__ = ["w4a8_matmul", "paged_decode_attn"]


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel route for device {t.device}")


def w4a8_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x: (..., in); w: a 2-D PackedLinear. Returns (..., out) in x.dtype.
    On the card: the fused W4A8 kernel (in-kernel FP8 activation quant,
    packed FP4 decode, f32 accumulation, LoRC epilogue, one write)."""
    assert w.codes.dim() == 2, "stacked PackedLinear: take a layer first"
    if _route(x) == "cpu":
        return ref.w4a8_matmul_ref(x, w.codes, w.scale, w.lorc_a, w.lorc_b,
                                   w_fmt=w.w_fmt, a_fmt=w.a_fmt, group_size=w.group_size)
    from .w4a8_fused import w4a8_fused_matmul_cuda

    lead = x.shape[:-1]
    y = w4a8_fused_matmul_cuda(
        x.reshape(-1, x.shape[-1]).contiguous(), w.codes, w.scale, w.s_max, w.shifts,
        w.lorc_a, w.lorc_b, w_fmt=w.w_fmt, a_fmt=w.a_fmt, group_size=w.group_size)
    return y.reshape(*lead, -1)


def paged_decode_attn(q: torch.Tensor, pool_layer, page_table, kv_lens,
                      window: int = 0) -> torch.Tensor:
    """Paged decode attention over one layer's pool slice ({'k', 'v'} plus
    the FP8 scale leaves when the pages are uint8 codes). q: (B, H, hd);
    page_table: (B, PP) int32; kv_lens: (B,) int32. Returns (B, H, dv) f32."""
    if any(name.endswith("_fz") or name == "_fp4" for name in pool_layer):
        raise NotImplementedError("packed-FP4 pages are not ported yet (ROADMAP queue 2)")
    kp, vp = pool_layer["k"], pool_layer["v"]
    fmt = "fp8_e4m3" if kp.dtype == torch.uint8 else None
    scales = ((pool_layer["k_smax"], pool_layer["k_shift"], pool_layer["v_smax"],
               pool_layer["v_shift"]) if fmt else (None,) * 4)
    if _route(q) == "cpu":
        return ref.paged_decode_attn_ref(q, kp, vp, *scales, page_table, kv_lens,
                                         fmt=fmt, window=window)
    from .decode_attn import paged_decode_attn_cuda

    return paged_decode_attn_cuda(q.contiguous(), kp, vp, *scales, page_table, kv_lens,
                                  fmt=fmt, window=window)
