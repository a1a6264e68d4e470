"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They define what the CUDA kernels compute, run on any device, and are the
path ``kernels.ops`` takes for CPU tensors. ``chip_smoke.py`` holds each
kernel against them on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.formats import FORMATS, f32, fp_decode, pow2i, unpack_nibbles
from repro_torch.core.quantize import quantize_act_tokenwise

from .common import page_format

__all__ = ["act_quant_ref", "dequant_packed_ref", "w4a8_matmul_ref", "w4a8_batched_matmul_ref",
           "w4a8_split_matmul_ref", "paged_decode_attn_ref", "paged_mla_decode_attn_ref",
           "flash_attention_ref"]


def act_quant_ref(x, fmt_name: str = "fp8_e4m3"):
    """Token-wise FP8 quantization: x (..., d) -> (values on the grid f32
    (..., d), scale f32 (..., 1))."""
    return quantize_act_tokenwise(x, fmt_name)


_BATCH_WEIGHTS = 1 << 28  # weights of a stack decoded at once (1 GiB in f32)


def _slices(codes):
    """Slices of a stack's leading axis (codes (E, ..., In/2)) of at most
    ``_BATCH_WEIGHTS`` weights each (one slice at least): a stack such as
    DeepSeek-V3's 256 experts of 2048 x 7168 is decoded a chunk at a time,
    so its f32 copy and the decode's temporaries never exist whole."""
    step = max(1, _BATCH_WEIGHTS // (math.prod(codes.shape[1:]) * 2))
    return [slice(i, i + step) for i in range(0, codes.shape[0], step)]


def dequant_packed_ref(codes, scale, fmt_name: str = "fp4_e2m1", group_size: int = 256):
    """codes (..., out, in/2) packed nibbles, scale (..., out, n_groups) ->
    (..., out, in) bf16 weights (decode * per-group scale, rounded once).
    A stacked ``codes`` is decoded over ``_slices`` into one bf16 tensor."""
    parts = _slices(codes) if codes.dim() > 2 else []
    if len(parts) > 1:
        w = torch.empty(codes.shape[:-1] + (2 * codes.shape[-1],), dtype=torch.bfloat16,
                        device=codes.device)
        for sl in parts:
            w[sl] = dequant_packed_ref(codes[sl], scale[sl], fmt_name, group_size)
        return w
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


def w4a8_batched_matmul_ref(x, codes, scale, lorc_a=None, lorc_b=None,
                            w_fmt: str = "fp4_e2m1", a_fmt=None, group_size: int = 256,
                            transpose_w: bool = False):
    """The batched kernel's function (MLA absorbed heads, MoE expert
    stacks). x: (E, M, D); codes: (E, N, In/2); scale: (E, N, G).

    normal: D == In, y[e] = x[e] @ W[e]^T -> (E, M, N); transposed: D == N,
    y[e] = x[e] @ W[e] -> (E, M, In) (the MLA absorbed q path contracts the
    weight's out rows). LoRC is the same side path as the 2-D kernel's:
    xr = bf16(x A) then xr B when transposed, xr = bf16(x B^T) then xr A^T
    otherwise. Returns f32. A large stack is taken over ``_slices`` (each
    slice's result is its own either way)."""
    parts = _slices(codes)
    if len(parts) > 1:
        part = lambda t, sl: None if t is None else t[sl]
        return torch.cat([w4a8_batched_matmul_ref(
            x[sl], codes[sl], scale[sl], part(lorc_a, sl), part(lorc_b, sl), w_fmt, a_fmt,
            group_size, transpose_w) for sl in parts])
    if a_fmt:
        qx, sx = quantize_act_tokenwise(x, a_fmt)
        xq = (qx * sx).to(torch.bfloat16)
    else:
        xq = x.to(torch.bfloat16)
    w = dequant_packed_ref(codes, scale, w_fmt, group_size).float()  # (E, N, In)
    xf = xq.float()
    if transpose_w:
        y = torch.einsum("emn,eni->emi", xf, w)
        if lorc_a is not None:
            xr = torch.einsum("emn,enr->emr", xf, lorc_a.float()).to(torch.bfloat16)
            y = y + torch.einsum("emr,eri->emi", xr.float(), lorc_b.float())
    else:
        y = torch.einsum("emk,enk->emn", xf, w)
        if lorc_a is not None:
            xr = torch.einsum("emk,erk->emr", xf, lorc_b.float()).to(torch.bfloat16)
            y = y + torch.einsum("emr,enr->emn", xr.float(), lorc_a.float())
    return y


def w4a8_split_matmul_ref(x_q, codes, scale, s_max=None, shifts=None,
                          w_fmt: str = "fp4_e2m1", group_size: int = 256):
    """The split GEMM over quantized activations: y = bf16(x_q) .
    bf16(decode(codes) * gscale)^T in f32, gscale = 2^-shift with M2 (then
    s_max multiplies each output column after the sum) or the f32 group
    scale. x_q: (..., K); codes: (N, K/2); scale / shifts: (N, K/g);
    s_max: (N,) or (N, 1). Returns (..., N) f32."""
    q = fp_decode(unpack_nibbles(codes), FORMATS[w_fmt])  # (N, K)
    n, k = q.shape
    gscale = pow2i(-shifts.to(torch.int32)) if shifts is not None else scale.float()
    w = (q.reshape(n, k // group_size, group_size) * gscale[..., None]).reshape(n, k)
    y = torch.matmul(x_q.to(torch.bfloat16).float(), w.to(torch.bfloat16).float().t())
    return y * s_max.reshape(1, n).float() if shifts is not None else y


def paged_decode_attn_ref(q, k_pages, v_pages, k_smax, k_shift, v_smax,
                          v_shift, page_table, kv_lens, fmt=None,
                          window: int = 0, frozen=None, k_fz=None, v_fz=None,
                          k_fz_smax=None, k_fz_shift=None, v_fz_smax=None,
                          v_fz_shift=None):
    """Paged decode attention, gathered and dequantized in full.

    q: (B, H, hd); k/v_pages: (P+1, page, KV, hd) uint8 codes (``fmt``
    quantized) or bf16; k/v_smax: (P+1,) f32; k/v_shift: (P+1, KV) int32;
    page_table: (B, PP) int32; kv_lens: (B,). With ``frozen`` set, the
    ``*_fz`` operands hold the packed frozen region ((F+1, page, KV,
    ceil(hd/2)) codes, (F+1,) smax, (F+1, KV) shifts; row F is the dummy)
    and table ids >= P+1 address it: both regions are gathered with clamped
    ids (``min(pid, P)`` and ``clip(pid - (P+1), 0, F)``) and a ``where`` on
    the id class picks each page, the TPU kernel's dataflow. Positions >=
    kv_lens[b] (and outside the sliding window) are masked with ``where``
    before and after the softmax. Returns (B, H, dv) f32."""
    fmt = page_format(fmt)
    frozen = page_format(frozen) if frozen is not None else None
    b, h, hd = q.shape
    base, page, kv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    pp = page_table.shape[1]
    g = h // kv
    pt = page_table.long()

    def dq(pages, smax, shift, fpages, fsmax, fshift):
        apt = torch.clamp(pt, max=base - 1) if frozen is not None else pt
        gathered = pages[apt]  # (B, PP, page, KV, d)
        if not fmt.quantized:
            return gathered.float().reshape(b, pp * page, kv, -1)
        d = pages.shape[-1] * (2 if fmt.packed else 1)
        vals = fmt.decode(gathered, shift[apt][:, :, None, :, None], d)
        vals = vals * smax[apt][:, :, None, None, None]
        if frozen is not None:
            fpt = torch.clamp(pt - base, 0, fpages.shape[0] - 1)
            fvals = frozen.decode(fpages[fpt], fshift[fpt][:, :, None, :, None], pages.shape[-1])
            fvals = fvals * fsmax[fpt][:, :, None, None, None]
            vals = torch.where((pt >= base)[:, :, None, None, None], fvals, vals)
        return vals.reshape(b, pp * page, kv, -1)

    kf = dq(k_pages, k_smax, k_shift, k_fz, k_fz_smax, k_fz_shift)
    vf = dq(v_pages, v_smax, v_shift, v_fz, v_fz_smax, v_fz_shift)
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


def paged_mla_decode_attn_ref(q_lat, q_rope, ckv_pages, krope_pages, ckv_smax, ckv_shift,
                              krope_smax, krope_shift, page_table, kv_lens, scale: float,
                              fmt=None, frozen=None, ckv_fz=None, krope_fz=None,
                              ckv_fz_smax=None, ckv_fz_shift=None, krope_fz_smax=None,
                              krope_fz_shift=None):
    """MLA latent decode attention, gathered and dequantized in full.

    q_lat: (B, H, r) absorbed queries; q_rope: (B, H, dr); ckv_pages
    (P+1, page, r) / krope_pages (P+1, page, dr): uint8 codes (``fmt``
    quantized) or bf16; smax (P+1,) f32; shift (P+1, 1) int32 (the latent
    has a single scale "head"); page_table (B, PP) int32; kv_lens (B,).
    With ``frozen`` set the ``*_fz`` operands hold the packed FP4 latent
    region and ids >= P+1 address it, as in ``paged_decode_attn_ref``.
    Scores are the k = concat(ckv, krope) contraction times ``scale``, v is
    ckv. Positions >= kv_lens[b] are masked with ``where``. Returns the
    latent context (B, H, r) f32."""
    fmt = page_format(fmt)
    frozen = page_format(frozen) if frozen is not None else None
    b, h, r = q_lat.shape
    base, page, _ = ckv_pages.shape
    pp = page_table.shape[1]
    pt = page_table.long()

    def dq(pages, smax, shift, fpages, fsmax, fshift):
        apt = torch.clamp(pt, max=base - 1) if frozen is not None else pt
        gathered = pages[apt]  # (B, PP, page, d)
        if not fmt.quantized:
            return gathered.float().reshape(b, pp * page, -1)
        d = pages.shape[-1] * (2 if fmt.packed else 1)
        vals = fmt.decode(gathered, shift[apt][..., None], d) * smax[apt][:, :, None, None]
        if frozen is not None:
            fpt = torch.clamp(pt - base, 0, fpages.shape[0] - 1)
            fvals = frozen.decode(fpages[fpt], fshift[fpt][..., None], pages.shape[-1])
            fvals = fvals * fsmax[fpt][:, :, None, None]
            vals = torch.where((pt >= base)[:, :, None, None], fvals, vals)
        return vals.reshape(b, pp * page, -1)

    ckv = dq(ckv_pages, ckv_smax, ckv_shift, ckv_fz, ckv_fz_smax, ckv_fz_shift)
    kr = dq(krope_pages, krope_smax, krope_shift, krope_fz, krope_fz_smax, krope_fz_shift)
    s = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv)
         + torch.einsum("bhd,btd->bht", q_rope.float(), kr)) * scale
    valid = (torch.arange(pp * page, device=q_lat.device)[None, None, :]
             < kv_lens.to(q_lat.device).long()[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.where(valid, torch.softmax(s, dim=-1), torch.zeros_like(s))
    # masked positions never enter the sum, even as 0 * (stale NaN)
    ckv = torch.where(valid[:, 0, :, None], ckv, torch.zeros_like(ckv))
    return torch.einsum("bht,btr->bhr", p, ckv)


def flash_attention_ref(q, k, v, causal: bool = True):
    """Plain softmax attention. q: (B, S, H, hd); k: (B, T, H, hd); v: (B,
    T, H, dv). Scores in f32 times 1/sqrt(hd); causal adds -1e30 where
    k_pos > q_pos (no offset when T != S). Returns (B, S, H, dv) in v's
    dtype."""
    s, t = q.shape[1], k.shape[1]
    sc = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * f32(1.0 / float(q.shape[-1]) ** 0.5)
    if causal:
        pos_q = torch.arange(s, device=q.device)[:, None]
        pos_k = torch.arange(t, device=q.device)[None]
        sc = sc + torch.where(pos_k > pos_q, -1e30, 0.0)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, v.float()).to(v.dtype)
