"""Python bindings of the fused W4A8 GEMM (``csrc/w4a8_fused.cu``).

``w4a8_fused_matmul_cuda`` (the 2-D GEMM) and ``w4a8_fused_batched_cuda``
(its batched orientations) check their operands, allocate the output and
launch the kernel on the current stream. They count their launches:
``w4a8_fused_matmul_cuda.launches``, and
``w4a8_fused_batched_cuda.launches`` (normal, activations as they are) /
``w4a8_fused_batched_cuda.quant_launches`` (normal, FP8 activations) /
``w4a8_fused_batched_cuda.transposed_launches``. They take CUDA tensors
only: the plain versions for the CPU are ``ref.w4a8_matmul_ref`` and
``ref.w4a8_batched_matmul_ref`` (``ops`` dispatches). The kernel runs
every variant ``repro`` serves: FP4 E2M1 or E3M0 weights with or without
M2 and LoRC; bf16 activations quantized token-wise onto FP8 E4M3 or E5M2
in-kernel, or taken as they are (``a_fmt=None``), by the 2-D GEMM and the
batched normal orientation; taken as they are by the transposed one. The
wrappers refuse only the transposed orientation with quantized
activations, which no ``repro`` path runs.

``gemm_plan`` is the launch plan of every W4A8 GEMM launch (this kernel
and the split GEMM, ``csrc/w4a8_gemm.cuh``): the output channels of a
block and the number of blocks of a thread-block cluster that split K;
``fitted_plan`` raises its split where a launch's shared memory
(``smem_bytes``) would outgrow the card's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.formats import FORMATS

from . import build

__all__ = ["w4a8_fused_matmul_cuda", "w4a8_fused_batched_cuda", "gemm_plan", "fitted_plan",
           "smem_bytes", "chunk_ranges", "grid_args", "W_FORMATS", "A_FORMATS"]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

W_FORMATS = ("fp4_e2m1", "fp4_e3m0")
A_FORMATS = (None, "fp8_e4m3", "fp8_e5m2")
SMS = 132       # streaming multiprocessors of an H100 SXM
BK = 64         # the kernel's contraction chunk (csrc/w4a8_gemm.cuh)
TM = 64         # its rows of a block
MAX_KS = 8      # blocks of a cluster (the portable limit)
SLOTS = 2 * SMS  # blocks the card runs at once: two of 256 threads a streaming multiprocessor
# csrc/w4a8_gemm.cuh's shared-memory layout: cp.async ring depth, the
# mma.sync path's most rows, and the dynamic shared memory a block may take
STAGES, SKINNY, MAX_SMEM = 4, 32, 232448


def gemm_plan(m: int, n_out: int, k: int, e: int = 1):
    """The launch plan of x (e, m, k) -> (e, m, n_out): (bn, ks), the output
    channels of a block (128, 64 or 32, no wider than n_out needs) and the
    blocks of a cluster that split the k / 64 chunks. The widest tile that
    reaches SMS blocks with at most MAX_KS splits, then as many splits as
    fit one wave of SLOTS blocks (a block's lifetime is mostly latency, so
    fewer chunks a block is shorter; a second wave would double it). A
    decode step's weight is read by every SM; a stacked launch (the MoE
    experts) splits nothing."""
    chunks = -(-k // BK)
    row_tiles = -(-m // TM) * e
    widths = [bn for bn in (128, 64, 32) if bn <= max(32, -(-n_out // 32) * 32)]
    for bn in widths:
        tiles = -(-n_out // bn) * row_tiles
        if tiles * min(MAX_KS, chunks) >= SMS:
            break
    ks = max(1, min(MAX_KS, chunks, SLOTS // tiles))
    return bn, ks


def smem_bytes(m: int, bn: int, ks: int, k: int, gs: int, r: int, transpose: bool = False,
               n_out: int = 0) -> int:
    """The dynamic shared memory of one launch with plan (bn, ks), as
    ``launch`` / ``make_layout`` in csrc/w4a8_gemm.cuh compute it: the
    cp.async ring (or the partial sums over it), the decoded tile, the
    activation and LoRC staging, and the scale-factor table, which holds
    every group of a rank's K slice (transposed: of its output columns)."""
    kr = -(-(-(-k // BK)) // ks) * BK  # most contraction rows of one rank
    groups = (n_out if transpose else k) // gs
    tab_cols = min((-(-(bn if transpose else kr) // gs)) + 1, groups)
    tab = (kr if transpose else bn) * tab_cols
    rows = -(-m // 8) * 8 if m <= SKINNY else TM
    lc = 0 if r == 0 else (32 if m > SKINNY else -(-r // 16) * 16)
    lr = 0 if transpose else -(-r // 8) * 8
    stage = bn * BK // 2 + rows * BK * 2 + lr * BK * 2
    wdec = max(STAGES * stage, rows * (bn + lc + 4) * 4)
    lf = wdec + (bn + lc) * BK * 2 + rows * BK * 2
    ftab = lf + -(-(bn * r * 2) // 16) * 16 + bn * 4 + 5 * TM * 4 + 16
    return ftab + tab * 4


def fitted_plan(m: int, n_out: int, k: int, gs: int, r: int, transpose: bool = False,
                e: int = 1):
    """``gemm_plan``'s (bn, ks), with more blocks splitting K (then a
    narrower tile) until the launch's shared memory fits MAX_SMEM: a rank's
    scale table holds its whole K slice's groups, which outgrow it at K =
    73728 (nemotron-4-340b's MLP) on one rank. Every plan that fits is
    gemm_plan's own."""
    bn, ks = gemm_plan(m, n_out, k, e)
    top = min(MAX_KS, -(-k // BK))
    while smem_bytes(m, bn, ks, k, gs, r, transpose, n_out) > MAX_SMEM:
        if ks < top:
            ks += 1
        elif bn > 32:
            bn //= 2
        else:
            break  # the launcher refuses it
    return bn, ks


def chunk_ranges(k: int, ks: int):
    """The K chunks of each block of a cluster: rank q takes chunks
    [q * n // ks, (q + 1) * n // ks) of n = ceil(k / 64), as the kernel does."""
    n = -(-k // BK)
    return [range(q * n // ks, (q + 1) * n // ks) for q in range(ks)]


def _refuse(w_fmt, a_fmt, transpose_w=False):
    if w_fmt not in W_FORMATS or a_fmt not in A_FORMATS:
        raise NotImplementedError(
            f"w_fmt={w_fmt!r}, a_fmt={a_fmt!r}: the CUDA kernel runs {W_FORMATS} weights with "
            f"activations quantized onto {A_FORMATS[1:]} or taken as they are (None)")
    if a_fmt is not None and transpose_w:
        raise NotImplementedError(
            "the transposed orientation takes its activations as they are (a_fmt=None): no "
            "served path quantizes them there")


def grid_args(fmt_name):
    """(man_bits, min_exp, max_exp, max_value, 1 / max_value) of a grid for
    ``csrc/quant_common.cuh``'s ``round_to_grid``, which builds 2^(e -
    man_bits) and its inverse from f32 exponent bits for every e in [min_exp,
    max_exp]; refuses a grid whose steps leave the f32 normal range (the
    FP8 grids are far inside it; bf16's is not)."""
    g = FORMATS[fmt_name]
    fields = [127 + s * (e - g.man_bits) for s in (1, -1) for e in (g.min_exp, g.max_exp)]
    if not all(1 <= f <= 254 for f in fields):
        raise NotImplementedError(
            f"{fmt_name}: its grid steps 2^({g.min_exp} - {g.man_bits}) .. 2^({g.max_exp} - "
            f"{g.man_bits}) or their inverses are not f32 normals, as the CUDA rounding "
            "needs them")
    return g.man_bits, g.min_exp, g.max_exp, g.max_value, 1.0 / g.max_value


def _grid(a_fmt):
    return grid_args(a_fmt or "fp8_e4m3")


def _lib():
    lib = build.load("w4a8_fused")
    fn = lib.w4a8_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _F, _I, _I, _I, _I, _P]
        fn.restype = _I
    return fn


def _batched_lib():
    fn = build.load("w4a8_fused").w4a8_batched_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 6 + [_LL, _LL, _I, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                                             _P]
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
    """x: (M, K) bf16 raw activations (quantized onto ``a_fmt`` in-kernel,
    or taken as they are when it is None); codes: (N, K/2) uint8 ``w_fmt``
    nibbles; scale: (N, G) f32; optional M2 split s_max (N, 1) f32 + shifts
    (N, G) int8 and LoRC lorc_a (N, r) / lorc_b (r, K) bf16. Returns (M, N)
    bf16."""
    _refuse(w_fmt, a_fmt)
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
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    rc = _lib()(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), _ptr(shifts), _ptr(s_max),
                _ptr(lorc_a) if r else None, _ptr(lorc_b) if r else None, out.data_ptr(),
                m, n, k, group_size, r, *_grid(a_fmt), int(a_fmt is not None),
                int(w_fmt == "fp4_e3m0"), *fitted_plan(m, n, k, group_size, r),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"w4a8_fused kernel launch failed: CUDA error {rc}")
    w4a8_fused_matmul_cuda.launches += 1
    return out


w4a8_fused_matmul_cuda.launches = 0


def w4a8_fused_batched_cuda(x, codes, scale, s_max=None, shifts=None, lorc_a=None,
                            lorc_b=None, *, w_fmt: str = "fp4_e2m1", a_fmt: Optional[str] = None,
                            group_size: int = 256, transpose_w: bool = False):
    """Batched W4A8 over E stacked weights, bf16 activations, quantized
    token-wise onto ``a_fmt`` (FP8, normal orientation only) in-kernel or
    taken as they are (``a_fmt=None``). codes: (E, N, In/2) uint8 ``w_fmt``
    nibbles; scale: (E, N, G) f32; optional M2 split s_max (E, N, 1) f32 +
    shifts (E, N, G) int8, and LoRC lorc_a (E, N, r) / lorc_b (E, r, In)
    bf16 (lorc_b may be a stride-0 broadcast over E). Normal: x (E, M, In)
    -> (E, M, N) = x W^T; ``transpose_w``: x (E, M, N) -> (E, M, In) = x W.
    Returns f32."""
    _refuse(w_fmt, a_fmt, transpose_w)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"w4a8_fused_batched_cuda takes CUDA tensors, got {dev}")
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"x: want contiguous 3-D bf16, got {x.dtype} {tuple(x.shape)}")
    e, m, d = x.shape
    if codes.dim() != 3:
        raise ValueError(f"codes: want (E, N, In/2), got {tuple(codes.shape)}")
    n, in_f = codes.shape[1], 2 * codes.shape[2]
    g = in_f // group_size
    if group_size <= 0 or in_f % group_size:
        raise ValueError(f"In={in_f} must be a multiple of group_size={group_size}")
    if d != (n if transpose_w else in_f):
        raise ValueError(f"x: contraction width {d}, want {n if transpose_w else in_f} "
                         f"({'transposed' if transpose_w else 'normal'} orientation)")
    _check(codes, "codes", torch.uint8, (e, n, in_f // 2), dev)
    _check(scale, "scale", torch.float32, (e, n, g), dev)
    if (s_max is None) != (shifts is None):
        raise ValueError("s_max and shifts come together (M2) or not at all")
    if shifts is not None:
        _check(shifts, "shifts", torch.int8, (e, n, g), dev)
        _check(s_max, "s_max", torch.float32, (e, n, 1), dev)
    r = 0 if lorc_a is None else lorc_a.shape[-1]
    s_lb = 0
    if r:
        if r > 32:
            raise ValueError(f"LoRC rank {r} > 32 (the kernel's epilogue bound)")
        _check(lorc_a, "lorc_a", torch.bfloat16, (e, n, r), dev)
        # lorc_b: every slice row-major, slices contiguous or one broadcast factor
        s_lb = lorc_b.stride(0)
        if (lorc_b.dtype != torch.bfloat16 or tuple(lorc_b.shape) != (e, r, in_f)
                or lorc_b.device != dev or lorc_b.stride()[1:] != (in_f, 1)
                or s_lb not in (0, r * in_f)):
            raise ValueError(f"lorc_b: want bf16 (E, r, In) = {(e, r, in_f)} with row-major "
                             f"slices of stride r*In or 0, got {lorc_b.dtype} "
                             f"{tuple(lorc_b.shape)} strides {lorc_b.stride()}")
    n_out = in_f if transpose_w else n
    out = torch.empty((e, m, n_out), dtype=torch.float32, device=dev)
    rc = _batched_lib()(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), _ptr(shifts),
                        _ptr(s_max), _ptr(lorc_a) if r else None, _ptr(lorc_b) if r else None,
                        out.data_ptr(), e, m, n, in_f, group_size, r, n * r, s_lb,
                        int(transpose_w), int(a_fmt is not None), *_grid(a_fmt),
                        int(w_fmt == "fp4_e3m0"),
                        *fitted_plan(m, n_out, d, group_size, r, transpose_w, e),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"w4a8_fused batched kernel launch failed: CUDA error {rc}")
    if transpose_w:
        w4a8_fused_batched_cuda.transposed_launches += 1
    elif a_fmt is not None:
        w4a8_fused_batched_cuda.quant_launches += 1
    else:
        w4a8_fused_batched_cuda.launches += 1
    return out


w4a8_fused_batched_cuda.launches = 0
w4a8_fused_batched_cuda.quant_launches = 0
w4a8_fused_batched_cuda.transposed_launches = 0
