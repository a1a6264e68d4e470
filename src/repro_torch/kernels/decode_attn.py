"""Python bindings of the paged decode attention kernels: GQA
(``csrc/decode_attn.cu``) and MLA's latent decode (``csrc/mla_decode_attn.cu``,
``paged_mla_decode_attn_cuda`` at the end of this module, planned by
``mla_decode_plan``).

``paged_decode_attn_cuda`` checks its operands, allocates the output and
the splits' workspace and launches the kernel (its split kernel and the
combine, by ``decode_attn_plan``) on the current stream. It counts its
calls by variant: ``paged_decode_attn_cuda.launches`` over FP8 or bf16
pages, ``paged_decode_attn_cuda.frozen_launches`` over FP8 pages with the
packed FP4 frozen region. CUDA tensors only: the plain version for the CPU
is ``ref.paged_decode_attn_ref`` (``ops.paged_decode_attn`` dispatches).
The kernel covers what the serving path runs: bf16 queries over FP8 or
bf16 pages (and the frozen region behind FP8 pages) whose K and V share
the head width, up to 512; the wrapper refuses the rest.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .common import page_format
from .w4a8_fused import SMS, _check

__all__ = ["DecodePlan", "MLAPlan", "decode_attn_plan", "mla_decode_plan",
           "paged_decode_attn_cuda", "paged_mla_decode_attn_cuda"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


THREADS = 128                # a split block's threads (csrc/decode_attn.cu)
BLOCK_BUDGET = 8 * SMS       # split blocks the card holds at once, about: 8 an SM
STAGE_BYTES = 96 << 10       # a split's staged K and V rows in shared memory, at most
MAX_HD = 512                 # 32 lanes of 16 dims hold a token row


class DecodePlan(NamedTuple):
    pps: int      # pages a split
    splits: int   # splits of a (row, KV head): ceil(PP / pps)
    group: int    # query heads a block, sharing each decoded K and V element
    threads: int  # threads a block


def decode_attn_plan(B: int, H: int, KV: int, hd: int, page: int, PP: int,
                     esize: int = 1) -> DecodePlan:
    """The launch plan of paged GQA decode attention, from shapes alone (no
    length is read, so a captured step replays it). Split s of a (row, KV
    head) takes pages [s * pps, (s + 1) * pps) of the table. A block serves
    ``group`` query heads of one KV head: 4 where H / KV is a multiple of 4,
    else 1. pps is the fewest pages that keep every split of the launch
    within one wave of BLOCK_BUDGET blocks (a block's life is a few
    dependent round trips, so a second wave would double the launch), and no
    more than STAGE_BYTES of staged K and V rows (``esize`` bytes an
    element: 1 for FP8 pages, 2 for bf16)."""
    g = H // KV
    group = 4 if g % 4 == 0 else 1
    heads = B * KV * (g // group)
    pps = max(1, -(-heads * PP // BLOCK_BUDGET))
    pps = min(pps, max(1, STAGE_BYTES // (2 * page * hd * esize)), max(PP, 1), THREADS)
    return DecodePlan(pps, max(1, -(-PP // pps)), group, THREADS)


def _lib():
    fn = build.load("decode_attn").paged_decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _F, _I, _I, _I, _I] + [_P] * 6 + [_I] * 5 + [_I] * 4 + [_P] * 3)
        fn.restype = _I
    return fn


def paged_decode_attn_cuda(q, k_pages, v_pages, k_smax, k_shift, v_smax, v_shift,
                           page_table, kv_lens, fmt=None, window: int = 0, frozen=None,
                           k_fz=None, v_fz=None, k_fz_smax=None, k_fz_shift=None,
                           v_fz_smax=None, v_fz_shift=None):
    """q: (B, H, hd) bf16; k/v_pages: (P+1, page, KV, hd) uint8 FP8
    codes (``fmt`` 'fp8_e4m3') or bf16 (``fmt`` None); k/v_smax (P+1,) f32
    and k/v_shift (P+1, KV) int32 (FP8 only); page_table (B, PP) int32;
    kv_lens (B,) int32. With ``frozen`` 'fp4_e2m1' (behind FP8 pages):
    k/v_fz (F+1, page, KV, ceil(hd/2)) uint8 packed codes, k/v_fz_smax
    (F+1,) f32, k/v_fz_shift (F+1, KV) int32, and table ids >= P+1 address
    them. Returns (B, H, hd) f32."""
    pf = page_format(fmt)
    fz = page_format(frozen) if frozen is not None else None
    if pf.packed:
        raise NotImplementedError("packed FP4 active pages are not a writable pool format")
    if fz is not None and (fz.name != "fp4_e2m1" or pf.name != "fp8_e4m3"):
        raise NotImplementedError(
            f"frozen region {fz.name!r} behind {pf.name!r} pages: the kernel reads only "
            "packed fp4_e2m1 frozen pages behind fp8_e4m3 pages")
    if fz is None and any(t is not None for t in (k_fz, v_fz, k_fz_smax, k_fz_shift,
                                                   v_fz_smax, v_fz_shift)):
        raise ValueError("frozen-region operands given without frozen='fp4_e2m1'")
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
    if hd > MAX_HD:
        raise NotImplementedError(f"head width {hd}: the kernel reads heads up to {MAX_HD}")
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
    nfz = 0
    if fz is not None:
        if any(t is None for t in (k_fz, v_fz, k_fz_smax, k_fz_shift, v_fz_smax, v_fz_shift)):
            raise ValueError("frozen='fp4_e2m1' needs all six k/v_fz operands")
        f1 = k_fz.shape[0]
        nfz = f1 - 1
        for t, name in ((k_fz, "k_fz"), (v_fz, "v_fz")):
            _check(t, name, torch.uint8, (f1, page, kv, fz.width(hd)), dev)
        for t, name in ((k_fz_smax, "k_fz_smax"), (v_fz_smax, "v_fz_smax")):
            _check(t, name, torch.float32, (f1,), dev)
        for t, name in ((k_fz_shift, "k_fz_shift"), (v_fz_shift, "v_fz_shift")):
            _check(t, name, torch.int32, (f1, kv), dev)
    f, ff = pf.fmt, fz.fmt if fz is not None else None
    plan = decode_attn_plan(b, h, kv, hd, page, pp, esize=1 if pf.quantized else 2)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, plan.splits, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, h, plan.splits, hd), dtype=torch.float32, device=dev)
    ptr = lambda t, on: t.data_ptr() if on else None
    rc = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), int(pf.quantized),
                ptr(k_smax, f), ptr(k_shift, f), ptr(v_smax, f), ptr(v_shift, f),
                page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), b, h, kv, hd, page,
                pp, int(window), 1.0 / float(hd) ** 0.5, f.exp_bits if f else 0,
                f.man_bits if f else 0, f.bias if f else 0, int(ff is not None),
                *(ptr(t, ff) for t in (k_fz, v_fz, k_fz_smax, k_fz_shift, v_fz_smax,
                                       v_fz_shift)),
                p1, nfz, ff.exp_bits if ff else 0, ff.man_bits if ff else 0,
                ff.bias if ff else 0, *plan, part_ml.data_ptr(), part_acc.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_decode_attn kernel launch failed: CUDA error {rc}")
    if ff is not None:
        paged_decode_attn_cuda.frozen_launches += 1
    else:
        paged_decode_attn_cuda.launches += 1
    return out


paged_decode_attn_cuda.launches = 0
paged_decode_attn_cuda.frozen_launches = 0


MLA_GROUP = 16               # query heads a block: one m16 tile (csrc/mla_decode_attn.cu)
MLA_SPAN = 64                # tokens a split: 16 for each of a block's 4 warps


class MLAPlan(NamedTuple):
    span: int     # tokens a split
    splits: int   # splits of a (row, head group): ceil(PP * page / span)
    group: int    # query heads a block, sharing each decoded latent row
    threads: int  # threads a block


def mla_decode_plan(B: int, H: int, r: int, dr: int, page: int, PP: int,
                    esize: int = 1) -> MLAPlan:
    """The launch plan of MLA latent decode, from shapes alone (no length
    is read, so a captured step replays it). Split s of a (row, group of
    ``group`` query heads) takes tokens [s * span, (s + 1) * span) of the
    row, whatever the page size: several small pages, one page of 64, part
    of a larger one. Only the context's length in pages (``PP * page``)
    sets the number of splits; the other shapes leave the plan as it is.
    At phase 3's B 4, H 40, PP 32 pages of 64 that is 4 x 3 x 32 = 384
    blocks."""
    return MLAPlan(MLA_SPAN, max(1, -(-PP * page // MLA_SPAN)), MLA_GROUP, THREADS)


def _mla_lib():
    fn = build.load("mla_decode_attn").mla_decode_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _F, _I, _I, _I, _I] + [_P] * 6 + [_I] * 5 + [_I] * 4 + [_P] * 3)
        fn.restype = _I
    return fn


def paged_mla_decode_attn_cuda(q_lat, q_rope, ckv, krope, ckv_smax, ckv_shift, krope_smax,
                               krope_shift, page_table, kv_lens, scale: float, fmt=None,
                               frozen=None, ckv_fz=None, krope_fz=None, ckv_fz_smax=None,
                               ckv_fz_shift=None, krope_fz_smax=None, krope_fz_shift=None):
    """MLA latent decode attention. q_lat: (B, H, r) bf16; q_rope: (B, H,
    dr) bf16; ckv (P+1, page, r) / krope (P+1, page, dr): uint8 FP8 codes
    (``fmt`` 'fp8_e4m3') or bf16 (``fmt`` None); their smax (P+1,) f32 and
    shift (P+1, 1) int32 (FP8 only); page_table (B, PP) int32; kv_lens (B,)
    int32; ``scale`` the softmax scale. With ``frozen`` 'fp4_e2m1' (behind
    FP8 pages): ckv/krope_fz (F+1, page, ceil(d/2)) uint8 packed codes,
    their smax (F+1,) f32 and shift (F+1, 1) int32, and table ids >= P+1
    address them. Returns (B, H, r) f32. Counts its launches apart:
    ``.launches`` over FP8 or bf16 pages, ``.frozen_launches`` with the
    frozen region."""
    pf = page_format(fmt)
    fz = page_format(frozen) if frozen is not None else None
    fz_ops = (ckv_fz, krope_fz, ckv_fz_smax, ckv_fz_shift, krope_fz_smax, krope_fz_shift)
    if pf.packed:
        raise NotImplementedError("packed FP4 active pages are not a writable pool format")
    if fz is not None and (fz.name != "fp4_e2m1" or pf.name != "fp8_e4m3"):
        raise NotImplementedError(
            f"frozen region {fz.name!r} behind {pf.name!r} pages: the kernel reads only "
            "packed fp4_e2m1 frozen pages behind fp8_e4m3 pages")
    if fz is None and any(t is not None for t in fz_ops):
        raise ValueError("frozen-region operands given without frozen='fp4_e2m1'")
    dev = q_lat.device
    if dev.type != "cuda":
        raise ValueError(f"paged_mla_decode_attn_cuda takes CUDA tensors, got {dev}")
    for t, name in ((q_lat, "q_lat"), (q_rope, "q_rope")):
        if t.dim() != 3 or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous (B, H, d) bf16, got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    if tuple(q_rope.shape[:2]) != (b, h):
        raise ValueError(f"q_rope {tuple(q_rope.shape)} does not match q_lat {(b, h, r)}")
    p1, page = ckv.shape[:2]
    pp = page_table.shape[1]
    store = torch.uint8 if pf.quantized else torch.bfloat16
    _check(ckv, "ckv", store, (p1, page, r), dev)
    _check(krope, "krope", store, (p1, page, dr), dev)
    _check(page_table, "page_table", torch.int32, (b, pp), dev)
    _check(kv_lens, "kv_lens", torch.int32, (b,), dev)
    if pf.quantized:
        for t, name in ((ckv_smax, "ckv_smax"), (krope_smax, "krope_smax")):
            _check(t, name, torch.float32, (p1,), dev)
        for t, name in ((ckv_shift, "ckv_shift"), (krope_shift, "krope_shift")):
            _check(t, name, torch.int32, (p1, 1), dev)
    nfz = 0
    if fz is not None:
        if any(t is None for t in fz_ops):
            raise ValueError("frozen='fp4_e2m1' needs all six ckv/krope_fz operands")
        f1 = ckv_fz.shape[0]
        nfz = f1 - 1
        _check(ckv_fz, "ckv_fz", torch.uint8, (f1, page, fz.width(r)), dev)
        _check(krope_fz, "krope_fz", torch.uint8, (f1, page, fz.width(dr)), dev)
        for t, name in ((ckv_fz_smax, "ckv_fz_smax"), (krope_fz_smax, "krope_fz_smax")):
            _check(t, name, torch.float32, (f1,), dev)
        for t, name in ((ckv_fz_shift, "ckv_fz_shift"), (krope_fz_shift, "krope_fz_shift")):
            _check(t, name, torch.int32, (f1, 1), dev)
    f, ff = pf.fmt, fz.fmt if fz is not None else None
    plan = mla_decode_plan(b, h, r, dr, page, pp, esize=1 if pf.quantized else 2)
    out = torch.empty((b, h, r), dtype=torch.float32, device=dev)
    part_ml = torch.empty((b, h, plan.splits, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, h, plan.splits, r), dtype=torch.float32, device=dev)
    ptr = lambda t, on: t.data_ptr() if on else None
    rc = _mla_lib()(q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), krope.data_ptr(),
                    int(pf.quantized), ptr(ckv_smax, f), ptr(ckv_shift, f),
                    ptr(krope_smax, f), ptr(krope_shift, f), page_table.data_ptr(),
                    kv_lens.data_ptr(), out.data_ptr(), b, h, r, dr, page, pp, float(scale),
                    f.exp_bits if f else 0, f.man_bits if f else 0, f.bias if f else 0,
                    int(ff is not None), *(ptr(t, ff) for t in fz_ops), p1, nfz,
                    ff.exp_bits if ff else 0, ff.man_bits if ff else 0, ff.bias if ff else 0,
                    *plan, part_ml.data_ptr(), part_acc.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"mla_decode_attn kernel launch failed: CUDA error {rc}")
    if ff is not None:
        paged_mla_decode_attn_cuda.frozen_launches += 1
    else:
        paged_mla_decode_attn_cuda.launches += 1
    return out


paged_mla_decode_attn_cuda.launches = 0
paged_mla_decode_attn_cuda.frozen_launches = 0
