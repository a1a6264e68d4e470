"""Shared quantization math of the kernels (port of ``repro.kernels.common``).

These functions define what the CUDA kernels compute element by element;
the plain versions in ``ref`` call them, and ``csrc/*.cu`` repeats the same
integer bit arithmetic on the card. FP8 codes are decoded by the integer
exponent add of ``decode_fp8`` — never through ``torch.float8_e4m3fn`` or
Hopper's cvt, whose E4M3 tops out at 448 with S.1111.111 = NaN, where this
grid's top code is the finite 480.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.formats import FORMATS, f32, pow2i, unpack_nibbles

__all__ = ["pow2i", "unpack_nibbles", "decode_e2m1", "decode_e3m0",
           "decode_fp8", "PageFormat", "page_format", "PAGE_FORMAT_NAMES",
           "token_scale", "round_to_grid", "quantize_rows"]


def decode_e2m1(code: torch.Tensor) -> torch.Tensor:
    """4-bit E2M1 code -> f32 {0, .5, 1, 1.5, 2, 3, 4, 6} with sign."""
    code = code.to(torch.int32)
    exp = (code >> 1) & 3
    manf = (code & 1).to(torch.float32)
    val = torch.where(exp == 0, 0.5 * manf, pow2i(exp - 1) * (1.0 + 0.5 * manf))
    return torch.where(((code >> 3) & 1) == 1, -val, val)


def decode_e3m0(code: torch.Tensor) -> torch.Tensor:
    """E3M0 bias 3: pure powers of two, exp field 1..7 -> 2^-2..2^4."""
    code = code.to(torch.int32)
    exp = code & 7
    val = torch.where(exp == 0, torch.zeros_like(exp, dtype=torch.float32),
                      pow2i(exp - 3))
    return torch.where(((code >> 3) & 1) == 1, -val, val)


def decode_fp8(code: torch.Tensor, fmt, exp_shift=0) -> torch.Tensor:
    """uint8 ExMy code -> f32 value times 2^-exp_shift, the shift applied as
    an integer add on the exponent (M2 scale apply); ``exp_shift``
    broadcasts against ``code``. The residual ``s_max`` multiply is the
    caller's, once per page."""
    code = code.to(torch.int32)
    man = code & (2**fmt.man_bits - 1)
    exp_field = (code >> fmt.man_bits) & (2**fmt.exp_bits - 1)
    sub = exp_field == 0
    e = torch.where(sub, torch.full_like(exp_field, fmt.min_exp),
                    exp_field - fmt.bias) - exp_shift
    manf = man.to(torch.float32) * f32(2.0**-fmt.man_bits)
    val = pow2i(e) * torch.where(sub, manf, 1.0 + manf)
    return torch.where(((code >> (fmt.exp_bits + fmt.man_bits)) & 1) == 1, -val, val)


@dataclasses.dataclass(frozen=True)
class PageFormat:
    """How one KV page payload decodes: ``name`` is a FORMATS key or None
    (bf16 pages, no scales); ``packed`` stores two codes per byte;
    ``scale_apply`` is 'exp_add' (per-(page, head) M2 shift inside
    ``decode_fp8``) or 'none'. Build through :func:`page_format`."""

    name: Optional[str]
    packed: bool = False
    scale_apply: str = "none"

    @property
    def quantized(self) -> bool:
        return self.name is not None

    @property
    def fmt(self):
        return FORMATS[self.name] if self.name is not None else None

    def decode(self, raw: torch.Tensor, shift, d: int) -> torch.Tensor:
        """Page bytes -> f32 values before the per-page s_max multiply."""
        if not self.quantized:
            return raw
        codes = unpack_nibbles(raw)[..., :d] if self.packed else raw
        return decode_fp8(codes, self.fmt, shift)


_PAGE_FORMATS = {
    None: PageFormat(None),
    "fp8_e4m3": PageFormat("fp8_e4m3", packed=False, scale_apply="exp_add"),
    "fp4_e2m1": PageFormat("fp4_e2m1", packed=True, scale_apply="exp_add"),
}

PAGE_FORMAT_NAMES = tuple(sorted(k for k in _PAGE_FORMATS if k is not None))


def page_format(spec) -> PageFormat:
    """Coerce a name (or None, or a PageFormat) to the registered
    PageFormat, failing fast with the allowed set."""
    key = spec.name if isinstance(spec, PageFormat) else spec
    if key not in _PAGE_FORMATS:
        raise ValueError(f"unknown KV page format {key!r}: expected one of "
                         f"{PAGE_FORMAT_NAMES} or None (bf16)")
    return _PAGE_FORMATS[key]


def token_scale(x: torch.Tensor, fmt) -> torch.Tensor:
    """Per-row scale absmax / fmt.max, floored at 1e-12: (..., d) -> (..., 1)."""
    absmax = torch.amax(x.abs(), dim=-1, keepdim=True)
    return torch.clamp(absmax * f32(1.0 / fmt.max_value), min=f32(1e-12))


def round_to_grid(xs: torch.Tensor, fmt) -> torch.Tensor:
    """RNE onto the saturating ExMy grid (f32 in and out) — the same math as
    ``core.formats.quantize_to_grid``."""
    ax = xs.abs()
    e = torch.clamp(torch.floor(torch.log2(torch.clamp(ax, min=f32(1e-38)))),
                    fmt.min_exp, fmt.max_exp)
    step = pow2i(e.to(torch.int32) - fmt.man_bits)
    q = torch.clamp(torch.round(xs / step) * step, -fmt.max_value, fmt.max_value)
    return torch.where(ax == 0, torch.zeros_like(q), q)


def quantize_rows(x: torch.Tensor, fmt):
    """x: (rows, d) f32 -> (values on the grid, scale (rows, 1))."""
    scale = token_scale(x, fmt)
    return round_to_grid(x / scale, fmt), scale
