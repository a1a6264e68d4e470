"""Python binding of the token-wise FP8 activation quantizer
(``csrc/act_quant.cu``).

``act_quant_cuda`` checks its operand, allocates the outputs and launches
the kernel on the current stream by ``act_quant_plan``; it counts its
launches in ``act_quant_cuda.launches``. CUDA tensors only: the plain
version for the CPU is ``ref.act_quant_ref`` (``ops.act_quant``
dispatches). The kernel takes f32 or bf16 rows of any width onto the
``fp8_e4m3`` or ``fp8_e5m2`` grid; the wrapper refuses any other format.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from .w4a8_fused import SMS, grid_args

__all__ = ["act_quant_cuda", "act_quant_plan", "plan_of", "ActQuantPlan", "ACT_FORMATS"]

ACT_FORMATS = ("fp8_e4m3", "fp8_e5m2")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

MAX_THREADS = 1024       # threads of a block at most (csrc/act_quant.cu's launch bounds)
HELD = (1, 2, 4)         # vectors a thread holds in registers: the kernel's instantiations
MAX_CLUSTER = 8          # blocks of a row at most: the portable cluster size
THREAD_BUDGET = 512 * SMS  # threads the plan spreads a launch over before a thread holds more
VEC = 4                  # elements an access: 8 bytes of bf16, 16 of f32; 16 bytes of q


class ActQuantPlan(NamedTuple):
    vec: int             # elements of x an access: VEC, or 1 (x misaligned)
    threads: int         # threads a block, all of them on one row (or a cluster block's slice)
    cluster: int         # blocks of a row
    per_thread: int      # vectors a thread holds in registers (one of HELD)
    blocks: int          # blocks of the grid: rows x cluster

    @property
    def path(self) -> str:
        """'block' (a block a row) or 'cluster' (a cluster of blocks a row)."""
        return "cluster" if self.cluster > 1 else "block"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _held(n: int) -> int:
    """The fewest registers' worth of HELD that hold ``n`` vectors; past the
    largest the kernel reads the rest twice."""
    return next((h for h in HELD if h >= n), HELD[-1])


def act_quant_plan(rows: int, d: int, elem_bytes: int, aligned: bool,
                   per_thread: Optional[int] = None,
                   cluster: Optional[int] = None) -> ActQuantPlan:
    """The launch plan of (rows, d) elements of ``elem_bytes`` bytes, from
    shapes and alignment alone. VEC-element accesses when x is aligned to
    VEC elements and q to 16 bytes (``aligned``), else one element an
    access. A thread divides and rounds its elements one after another, so
    each thread holds as few vectors as keep the grid within THREAD_BUDGET
    threads (one at least, four at most: past that more waves cost less
    than longer threads). A row goes to one block of as many warps as hold
    it, or to a cluster of up to MAX_CLUSTER blocks when it needs more
    threads than a block has, or when fewer than SMS rows leave SMs idle
    and each block still gets 512 threads' worth. Past 8 x 1024 x 4 vectors
    a row (131072 elements) the kernel reads the rest twice. ``per_thread``
    and ``cluster``, where given, replace the plan's own choices (the
    threads a block follow them)."""
    rows = max(rows, 1)
    vec = VEC if aligned else 1
    nvec = _cdiv(d, vec)
    per = per_thread or _held(max(_cdiv(rows * nvec, THREAD_BUDGET),
                                  _cdiv(nvec, MAX_CLUSTER * MAX_THREADS)))
    c = cluster or min(MAX_CLUSTER, max(_cdiv(nvec, per * MAX_THREADS),
                                        min(SMS // rows, nvec // (per * 512))))
    if per not in HELD or not 1 <= c <= MAX_CLUSTER:
        raise ValueError(f"per_thread={per}, cluster={c}: the kernel holds {HELD} vectors a "
                         f"thread and splits a row over 1..{MAX_CLUSTER} blocks")
    threads = min(MAX_THREADS, 32 * _cdiv(_cdiv(_cdiv(nvec, c), per), 32))
    return ActQuantPlan(vec, threads, c, per, rows * c)


def plan_of(x: torch.Tensor) -> ActQuantPlan:
    """The plan ``act_quant_cuda`` launches contiguous ``x`` (..., d) with
    (q comes from the allocator, 16-byte aligned)."""
    d = x.shape[-1]
    return act_quant_plan(x.numel() // d, d, x.element_size(),
                          x.data_ptr() % (VEC * x.element_size()) == 0)


def _lib():
    fn = build.load("act_quant").act_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F] + [_I] * 5 + [_P]
        fn.restype = _I
    return fn


def act_quant_cuda(x: torch.Tensor, fmt_name: str = "fp8_e4m3"):
    """x: (..., d) f32 or bf16 -> (values on the grid f32 (..., d), scale f32
    (..., 1)), bit-identical to ``ref.act_quant_ref``."""
    if fmt_name not in ACT_FORMATS:
        raise NotImplementedError(
            f"fmt_name={fmt_name!r}: the CUDA kernel quantizes onto {ACT_FORMATS} only")
    if x.device.type != "cuda":
        raise ValueError(f"act_quant_cuda takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"x: want contiguous f32 or bf16 (..., d), got {x.dtype} "
                         f"{tuple(x.shape)}{'' if x.is_contiguous() else ' (non-contiguous)'}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    q = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    if rows == 0:
        return q, scale
    plan = plan_of(x)
    rc = _lib()(x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, d,
                int(x.dtype == torch.bfloat16), *grid_args(fmt_name), plan.vec, plan.threads,
                plan.cluster, plan.per_thread, plan.blocks,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"act_quant kernel launch failed: CUDA error {rc} (plan {plan})")
    act_quant_cuda.launches += 1
    return q, scale


act_quant_cuda.launches = 0
