"""Numeric formats for ZeroQuant-FP (port of ``repro.core.formats``).

Saturating ExMy floating-point grids (E4M3, E5M2 for FP8; E2M1, E3M0 for
FP4) and INT grids, with round-to-nearest-even quantization onto the exact
representable value set. Same conventions as the reference:

  * qtorch-style saturating grids: no inf/NaN codes, so E4M3's top value is
    480 (Hopper's ``float8_e4m3fn`` stops at 448 and makes S.1111.111 NaN —
    never decode these codes through the hardware type);
  * subnormals are exact;
  * ties round to even on the mantissa grid (``torch.round``).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "FloatFormat",
    "IntFormat",
    "FORMATS",
    "get_format",
    "f32",
    "pow2i",
    "quantize_to_grid",
    "fp_encode",
    "fp_decode",
    "value_grid",
    "pack_nibbles",
    "unpack_nibbles",
]


def f32(v: float) -> float:
    """``v`` rounded to float32 and returned as a Python float, so that a
    scalar multiplied into a float32 tensor carries exactly the float32
    constant the reference computes with (``jnp.float32(v)``)."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A saturating ExMy mini-float format (sign + exp_bits + man_bits)."""

    name: str
    exp_bits: int
    man_bits: int
    bias: int

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def min_exp(self) -> int:
        return 1 - self.bias

    @property
    def max_exp(self) -> int:
        return (2**self.exp_bits - 1) - self.bias

    @property
    def max_value(self) -> float:
        return float(2.0 ** self.max_exp * (2.0 - 2.0 ** (-self.man_bits)))

    @property
    def min_subnormal(self) -> float:
        return float(2.0 ** (self.min_exp - self.man_bits))


@dataclasses.dataclass(frozen=True)
class IntFormat:
    """A b-bit integer grid. Symmetric uses [-2^(b-1)+1, 2^(b-1)-1]."""

    name: str
    bits: int
    symmetric: bool = True

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def qmin(self) -> int:
        if self.symmetric:
            return -(2 ** (self.bits - 1) - 1)
        return -(2 ** (self.bits - 1))

    @property
    def levels(self) -> int:
        return 2**self.bits - 1 if self.symmetric else 2**self.bits


FORMATS = {
    "fp8_e4m3": FloatFormat("fp8_e4m3", exp_bits=4, man_bits=3, bias=7),
    "fp8_e5m2": FloatFormat("fp8_e5m2", exp_bits=5, man_bits=2, bias=15),
    "fp4_e2m1": FloatFormat("fp4_e2m1", exp_bits=2, man_bits=1, bias=1),
    "fp4_e3m0": FloatFormat("fp4_e3m0", exp_bits=3, man_bits=0, bias=3),
    "fp16": FloatFormat("fp16", exp_bits=5, man_bits=10, bias=15),
    "bf16": FloatFormat("bf16", exp_bits=8, man_bits=7, bias=127),
    "int8": IntFormat("int8", bits=8, symmetric=True),
    "int8_asym": IntFormat("int8_asym", bits=8, symmetric=False),
    "int4": IntFormat("int4", bits=4, symmetric=True),
    "int4_asym": IntFormat("int4_asym", bits=4, symmetric=False),
}


def get_format(name):
    if name in ("none", "fp32", None):
        return None
    return FORMATS[name]


def pow2i(k: torch.Tensor) -> torch.Tensor:
    """Exact 2**k for integer-valued k, clamped to the f32 normal range,
    built from the IEEE-754 bit pattern ((k + 127) << 23) — never from
    ``exp2``/``ldexp``, whose CPU lowerings are not exact everywhere."""
    k = torch.clamp(k.to(torch.int32), -126, 127)
    return ((k + 127) << 23).view(torch.float32)


def quantize_to_grid(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Round-to-nearest-even onto the saturating ExMy grid of ``fmt``;
    computes in f32 and returns ``x``'s dtype. The step at |x| in
    [2^e, 2^(e+1)) is 2^(e - man_bits); below the smallest normal it is
    the subnormal step."""
    orig = x.dtype
    x = x.to(torch.float32)
    absx = x.abs()
    e = torch.floor(torch.log2(torch.clamp(absx, min=f32(1e-38))))
    e = torch.clamp(e, fmt.min_exp, fmt.max_exp)
    step = pow2i(e.to(torch.int32) - fmt.man_bits)
    q = torch.round(x / step) * step
    q = torch.clamp(q, -fmt.max_value, fmt.max_value)
    q = torch.where(absx == 0, torch.zeros_like(q), q)
    return q.to(orig)


@lru_cache(maxsize=None)
def value_grid(name: str) -> np.ndarray:
    """All representable values of a float format, sorted (numpy, cached)."""
    fmt = FORMATS[name]
    vals = [0.0]
    for e in range(fmt.min_exp, fmt.max_exp + 1):
        for m in range(2**fmt.man_bits):
            vals.append(2.0**e * (1.0 + m / 2**fmt.man_bits))
    for m in range(1, 2**fmt.man_bits):
        vals.append(2.0**fmt.min_exp * (m / 2**fmt.man_bits))
    vals = sorted(set(vals))
    return np.array([-v for v in reversed(vals) if v] + vals, dtype=np.float32)


def fp_encode(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """On-grid floats -> uint8 codes laid out [sign | exp | man]."""
    x = x.to(torch.float32)
    sign = (x < 0) | ((x == 0) & torch.signbit(x))
    absx = x.abs()
    e = torch.floor(torch.log2(torch.clamp(absx, min=fmt.min_subnormal)))
    e = torch.clamp(e.to(torch.int32), fmt.min_exp, fmt.max_exp)
    sub = absx < 2.0**fmt.min_exp
    exp_field = torch.where(sub, torch.zeros_like(e), e + fmt.bias)
    scale = pow2i(torch.where(sub, torch.full_like(e, fmt.min_exp), e))
    frac = absx / scale
    man = torch.where(sub, torch.round(frac * 2**fmt.man_bits),
                      torch.round((frac - 1.0) * 2**fmt.man_bits)).to(torch.int32)
    carry = man >= 2**fmt.man_bits
    man = torch.where(carry, torch.zeros_like(man), man)
    exp_field = torch.clamp(torch.where(carry, exp_field + 1, exp_field),
                            0, 2**fmt.exp_bits - 1)
    code = ((sign.to(torch.int32) << (fmt.exp_bits + fmt.man_bits))
            | (exp_field << fmt.man_bits) | man)
    return code.to(torch.uint8)


def fp_decode(code: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Integer codes -> float32 values."""
    code = code.to(torch.int32)
    man = code & (2**fmt.man_bits - 1)
    exp_field = (code >> fmt.man_bits) & (2**fmt.exp_bits - 1)
    sign = (code >> (fmt.exp_bits + fmt.man_bits)) & 1
    sub = exp_field == 0
    e = torch.where(sub, torch.full_like(exp_field, fmt.min_exp),
                    exp_field - fmt.bias)
    manf = man.to(torch.float32) / 2**fmt.man_bits
    val = pow2i(e) * torch.where(sub, manf, 1.0 + manf)
    return torch.where(sign == 1, -val, val)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes (last dim even) two per byte: low nibble = even
    index, high nibble = odd index."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`."""
    nib = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
    return nib.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
