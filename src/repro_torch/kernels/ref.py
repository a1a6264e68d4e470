"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They define what the CUDA kernels compute, run on any device, and are the
path ``kernels.ops`` takes for CPU tensors. ``chip_smoke.py`` holds each
kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FORMATS, fp_decode, unpack_nibbles
from repro_torch.core.quantize import quantize_act_tokenwise

from .common import page_format

__all__ = ["dequant_packed_ref", "w4a8_matmul_ref", "paged_decode_attn_ref"]


def dequant_packed_ref(codes, scale, fmt_name: str = "fp4_e2m1", group_size: int = 256):
    """codes (..., out, in/2) packed nibbles, scale (..., out, n_groups) ->
    (..., out, in) bf16 weights (decode * per-group scale, rounded once)."""
    q = fp_decode(unpack_nibbles(codes), FORMATS[fmt_name])
    out_f, in_f = q.shape[-2], q.shape[-1]
    n_groups = scale.shape[-1]
    qg = q.reshape(*q.shape[:-1], n_groups, in_f // n_groups)
    w = qg * scale[..., None].to(torch.float32)
    return w.reshape(*q.shape[:-2], out_f, in_f).to(torch.bfloat16)


def w4a8_matmul_ref(x, codes, scale, lorc_a=None, lorc_b=None,
                    w_fmt: str = "fp4_e2m1", a_fmt="fp8_e4m3",
                    group_size: int = 256):
    """Token-wise FP8 activations x packed FP4 weights [+ LoRC side path].

    x: (..., in); codes: (out, in/2); scale: (out, G). The operands are
    bf16 values and their products accumulate in f32 (an f32 matmul of
    bf16-valued tensors forms exactly those products). Returns (..., out)
    in x.dtype."""
    if a_fmt:
        qx, sx = quantize_act_tokenwise(x, a_fmt)
        xq = (qx * sx).to(torch.bfloat16)
    else:
        xq = x.to(torch.bfloat16)
    w = dequant_packed_ref(codes, scale, w_fmt, group_size)
    xf = xq.float()
    y = torch.matmul(xf, w.float().t())
    if lorc_a is not None:
        xr = torch.matmul(xf, lorc_b.float().t()).to(torch.bfloat16)
        y = y + torch.matmul(xr.float(), lorc_a.float().t())
    return y.to(x.dtype)


def paged_decode_attn_ref(q, k_pages, v_pages, k_smax, k_shift, v_smax,
                          v_shift, page_table, kv_lens, fmt=None,
                          window: int = 0):
    """Paged decode attention, gathered and dequantized in full.

    q: (B, H, hd); k/v_pages: (P+1, page, KV, hd) uint8 codes (``fmt``
    quantized) or bf16; k/v_smax: (P+1,) f32; k/v_shift: (P+1, KV) int32;
    page_table: (B, PP) int32; kv_lens: (B,). Positions >= kv_lens[b] (and
    outside the sliding window) are masked with ``where`` before and after
    the softmax. Returns (B, H, dv) f32."""
    fmt = page_format(fmt)
    b, h, hd = q.shape
    _, page, kv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    pp = page_table.shape[1]
    g = h // kv
    pt = page_table.long()

    def dq(pages, smax, shift):
        gathered = pages[pt]  # (B, PP, page, KV, d)
        if not fmt.quantized:
            return gathered.float().reshape(b, pp * page, kv, -1)
        vals = fmt.decode(gathered, shift[pt][:, :, None, :, None], pages.shape[-1])
        vals = vals * smax[pt][:, :, None, None, None]
        return vals.reshape(b, pp * page, kv, -1)

    kf = dq(k_pages, k_smax, k_shift)
    vf = dq(v_pages, v_smax, v_shift)
    qg = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, kf) * (1.0 / float(hd) ** 0.5)
    pos = torch.arange(pp * page, device=q.device)[None, None, None, :]
    lens = kv_lens.to(q.device).long()[:, None, None, None]
    valid = pos < lens
    if window:  # the query sits at position kv_len - 1
        valid &= pos > lens - 1 - window
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.where(valid, torch.softmax(s, dim=-1), torch.zeros_like(s))
    # masked positions never enter the sum, even as 0 * (stale NaN)
    vf = torch.where(valid[:, 0, 0, :, None, None], vf, torch.zeros_like(vf))
    o = torch.einsum("bkgt,btkd->bkgd", p, vf)
    return o.reshape(b, h, dv)
