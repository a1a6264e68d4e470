"""Kernel entry points of the model code (port of ``repro.kernels.ops``).

Dispatch is by device, not by a backend switch: CUDA tensors launch the
hand-written kernel (and a failed build or launch raises — there is no
fallback), CPU tensors take the plain PyTorch version in ``ref``.
"""
from __future__ import annotations

import torch

from . import ref

__all__ = ["w4a8_matmul", "w4a8_matmul_batched", "dequant_packed", "paged_decode_attn",
           "paged_mla_decode_attn", "act_quant", "w4a8_matmul_split", "flash_attention"]


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


def dequant_packed(w) -> torch.Tensor:
    """A PackedLinear (2-D or batched) as dense weights: the bf16 decode
    of its codes and scales, plus the f32 LoRC term ``lorc_a @ lorc_b``
    when it has one (f32 then). Plain PyTorch on either device, as the
    reference computes it outside any kernel; no served GEMM reads it."""
    out = ref.dequant_packed_ref(w.codes, w.scale, w.w_fmt, w.group_size)
    if w.lorc_a is not None:
        out = out + torch.einsum("...or,...ri->...oi", w.lorc_a.float(), w.lorc_b.float())
    return out


def w4a8_matmul_batched(x: torch.Tensor, w, transpose_w: bool = False,
                        quantize_acts: bool = True) -> torch.Tensor:
    """x: (E, M, D); w: a batched PackedLinear (codes (E, out, in/2), e.g.
    ``layers.packed_head_view``). normal: D == in -> (E, M, out);
    transposed: D == out (contracting the weight's out rows, the MLA
    absorbed q path) -> (E, M, in). ``quantize_acts=False`` skips the FP8
    activation quantization. Returns f32. On the card: the batched /
    transposed variants of the fused W4A8 kernel (the batched one with
    in-kernel FP8 activation quantization for the MoE expert stacks)."""
    assert w.codes.dim() == 3, "a 2-D PackedLinear goes through w4a8_matmul"
    a_fmt = w.a_fmt if quantize_acts else None
    if _route(x) == "cpu":
        return ref.w4a8_batched_matmul_ref(x, w.codes, w.scale, w.lorc_a, w.lorc_b,
                                           w_fmt=w.w_fmt, a_fmt=a_fmt,
                                           group_size=w.group_size, transpose_w=transpose_w)
    from .w4a8_fused import w4a8_fused_batched_cuda

    return w4a8_fused_batched_cuda(x.contiguous(), w.codes, w.scale, w.s_max, w.shifts,
                                   w.lorc_a, w.lorc_b, w_fmt=w.w_fmt, a_fmt=a_fmt,
                                   group_size=w.group_size, transpose_w=transpose_w)


def _layer_formats(pool_layer, key: str = "k"):
    """The (active, frozen) page formats of a pool slice, from its leaves:
    the dtype of ``key`` picks bf16 or codes, the zero-size ``_fp4`` marker
    packed FP4 over FP8, and a ``<key>_fz`` leaf the packed frozen region."""
    if pool_layer[key].dtype != torch.uint8:
        name = None
    else:
        name = "fp4_e2m1" if "_fp4" in pool_layer else "fp8_e4m3"
    return name, ("fp4_e2m1" if key + "_fz" in pool_layer else None)


def _fz_operands(pool_layer, names=("k", "v")):
    """The frozen-region operands (all None for a homogeneous pool)."""
    return {name + suffix: pool_layer.get(name + suffix)
            for name in names for suffix in ("_fz", "_fz_smax", "_fz_shift")}


def paged_decode_attn(q: torch.Tensor, pool_layer, page_table, kv_lens,
                      window: int = 0) -> torch.Tensor:
    """Paged decode attention over one layer's pool slice ({'k', 'v'}, the
    scale leaves when the pages are codes, and the ``*_fz`` leaves of a
    mixed-precision pool, whose ids >= P+1 in ``page_table`` address the
    packed FP4 frozen region). q: (B, H, hd); page_table: (B, PP) int32;
    kv_lens: (B,) int32. Returns (B, H, dv) f32. On the card: the paged
    decode kernel, or its frozen-region variant for a mixed pool."""
    kp, vp = pool_layer["k"], pool_layer["v"]
    fmt, frozen = _layer_formats(pool_layer)
    scales = ((pool_layer["k_smax"], pool_layer["k_shift"], pool_layer["v_smax"],
               pool_layer["v_shift"]) if fmt else (None,) * 4)
    fz = _fz_operands(pool_layer)
    if _route(q) == "cpu":
        return ref.paged_decode_attn_ref(q, kp, vp, *scales, page_table, kv_lens, fmt=fmt,
                                         window=window, frozen=frozen, **fz)
    from .decode_attn import paged_decode_attn_cuda

    return paged_decode_attn_cuda(q.contiguous(), kp, vp, *scales, page_table, kv_lens,
                                  fmt=fmt, window=window, frozen=frozen, **fz)


def paged_mla_decode_attn(q_lat: torch.Tensor, q_rope: torch.Tensor, pool_layer, page_table,
                          kv_lens, scale: float) -> torch.Tensor:
    """MLA absorbed decode over one layer's latent pool slice ({'ckv',
    'krope'}, their scale leaves when the pages are codes, and the ``*_fz``
    leaves of a mixed-precision pool). q_lat: (B, H, r); q_rope: (B, H,
    dr); page_table: (B, PP) int32; kv_lens: (B,) int32; ``scale`` the
    softmax scale. KV is one head: k = concat(ckv, krope), v = ckv.
    Returns the latent context (B, H, r) f32. On the card: the MLA latent
    decode kernel, or its frozen-region variant for a mixed pool."""
    cp, rp = pool_layer["ckv"], pool_layer["krope"]
    fmt, frozen = _layer_formats(pool_layer, "ckv")
    scales = ((pool_layer["ckv_smax"], pool_layer["ckv_shift"], pool_layer["krope_smax"],
               pool_layer["krope_shift"]) if fmt else (None,) * 4)
    fz = _fz_operands(pool_layer, ("ckv", "krope"))
    if _route(q_lat) == "cpu":
        return ref.paged_mla_decode_attn_ref(q_lat, q_rope, cp, rp, *scales, page_table,
                                             kv_lens, scale, fmt=fmt, frozen=frozen, **fz)
    from .decode_attn import paged_mla_decode_attn_cuda

    return paged_mla_decode_attn_cuda(q_lat.contiguous(), q_rope.contiguous(), cp, rp,
                                      *scales, page_table, kv_lens, scale, fmt=fmt,
                                      frozen=frozen, **fz)


# -- the kernel API: entry points that no served path of the port reaches ------
def act_quant(x: torch.Tensor, fmt_name: str = "fp8_e4m3"):
    """Token-wise FP8 quantization: x (..., d) -> (values on the grid f32,
    scale f32 (..., 1)). On the card: the act_quant kernel."""
    if _route(x) == "cpu":
        return ref.act_quant_ref(x, fmt_name)
    from .act_quant import act_quant_cuda

    return act_quant_cuda(x.contiguous(), fmt_name)


def w4a8_matmul_split(x_q: torch.Tensor, w) -> torch.Tensor:
    """The split GEMM over already quantized activations: x_q (..., K)
    (values on the FP8 grid times their scale, e.g. from ``act_quant``);
    w: a 2-D PackedLinear, whose LoRC factors the caller applies. Returns
    (..., N) f32. On the card: the split W4A8 kernel."""
    assert w.codes.dim() == 2, "stacked PackedLinear: take a layer first"
    if _route(x_q) == "cpu":
        return ref.w4a8_split_matmul_ref(x_q, w.codes, w.scale, w.s_max, w.shifts,
                                         w_fmt=w.w_fmt, group_size=w.group_size)
    from .w4a8_matmul import w4a8_matmul_cuda

    lead = x_q.shape[:-1]
    y = w4a8_matmul_cuda(x_q.reshape(-1, x_q.shape[-1]).to(torch.bfloat16).contiguous(),
                         w.codes, w.scale, w.s_max, w.shifts, w_fmt=w.w_fmt,
                         group_size=w.group_size)
    return y.reshape(*lead, -1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k: (B, T, H, hd); v: (B, T, H, dv). Returns (B, S,
    H, dv) in v's dtype. On the card: the flash-attention kernel."""
    if _route(q) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    from .flash_attn import flash_attention_cuda

    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal)
