"""JAX's counter-based PRNG (threefry2x32) and the samplers the reference's
``sample_tokens`` draws from, on integer tensors of any device.

A sampled stream equals the reference's only if each draw sees JAX's exact
random bits, so this module repeats ``jax.random`` with the default
threefry implementation and ``jax_threefry_partitionable`` on (the default):

* ``threefry2x32``: Threefry-2x32, 20 rounds, the key schedule of
  ``jax._src.prng._threefry2x32_lowering``;
* ``seed_key``: ``PRNGKey(seed)`` for a 32-bit seed, the pair (0, seed);
* ``fold_in``: the hash of the key and the pair (0, data);
* ``random_bits``: 32 bits an element, the hash of the key and each
  element's flat index as a 64-bit counter (high word, low word), the two
  output words xor-ed;
* ``uniform``: the bits' top 23 as the mantissa of a float in [1, 2),
  less 1, scaled into [minval, maxval) by one fused multiply-add (as XLA
  contracts it) and clamped below at minval;
* ``gumbel`` (JAX's default mode ``"low"``): ``-log(-log(u))`` of a uniform
  in [tiny, 1), with ``xla_log``;
* ``categorical``: the first argmax of logits plus Gumbel noise.

Torch has no general uint32 arithmetic, so every word is an int64 tensor
holding a value in [0, 2^32), masked after each add and shift; every op
used (add, and, or, xor, shifts) is exact on the CPU and on CUDA, and no
``torch.Generator`` is involved. A key is an int64 tensor whose last axis
holds the two words; leading axes batch keys.

``xla_log`` is the f32 natural log as XLA compiles it for the CPU (the
reference's backend): Cephes' polynomial with XLA's fused multiply-adds,
denormal inputs flushed to zero. Torch's ``log`` differs from it in the
last bits of 14 % of the uniforms and, through the outer log, moves
Gumbel values near u = 1 by up to 2^21 ulp; ``xla_log`` matches it bit for
bit on every one of the 2^23 uniforms ``gumbel`` can draw, with IEEE ops
only, so the noise is also the same on both devices.
"""
from __future__ import annotations

import torch

__all__ = ["threefry2x32", "seed_key", "fold_in", "random_bits", "uniform", "gumbel",
           "categorical", "xla_log"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _words(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pairs (x1, x2) under the key (k1, k2):
    int64 tensors holding uint32 values, broadcast together. Returns the two
    output words."""
    k1, k2, x1, x2 = (_words(v) for v in (k1, k2, x1, x2))
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    # fresh full-shape words, updated in place from here on
    x1 = (x1 + ks[0]).expand(shape) & _M32
    x2 = (x2 + ks[1]).expand(shape) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(_M32)
            hi = x2 << r
            x2.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_and_(_M32).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x2.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x1, x2


def seed_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` of 32-bit seeds (a scalar or a tensor of
    them): (..., 2) keys (0, seed mod 2^32)."""
    lo = _words(seed, device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the pair (0, data mod
    2^32); ``data`` broadcasts against the keys' leading axes."""
    data = _words(data, key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, partitionable threefry) for
    each key of ``key``'s leading axes: (*leading, *shape) int64 words."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *([1] * len(shape)))
    k2 = key[..., 1].reshape(*lead, *([1] * len(shape)))
    y1, y2 = threefry2x32(k1, k2, (count >> 32).reshape(shape), (count & _M32).reshape(shape))
    return y1 ^ y2


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: (*leading, *shape) values in
    [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, mode "low"."""
    return -xla_log(-xla_log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key a
    row: the first argmax of ``logits`` plus the key's Gumbel noise."""
    return torch.argmax(gumbel(key, logits.shape[-1:]) + logits.float(), dim=-1)


# Cephes' logf polynomial, as XLA's CPU backend emits it
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in f32, rounded once as a fused multiply-add rounds it (the
    f64 product of two f32 values is exact)."""
    return (a.double() * (b.double() if torch.is_tensor(b) else _f32(b))
            + (c.double() if torch.is_tensor(c) else _f32(c))).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """The f32 natural log of ``x`` as XLA computes it on the CPU: 0 and
    denormals give -inf, negative values and NaN give NaN, +inf gives +inf."""
    x = x.float()
    bits = torch.clamp(x, min=_F32_TINY).view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    e = ((bits >> 23) - 126).float()
    low = m < _f32(_SQRT_HALF)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = m * m
    x3 = x2 * m
    y = _fma(_fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = _fma(_fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = _fma(_fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(_LOG_Q1))
    r = ((m - 0.5 * x2) + y) + e * _f32(_LOG_Q2)
    r = torch.where(x < _F32_TINY, torch.full_like(r, -torch.inf), r)
    r = torch.where((x < 0) | torch.isnan(x), torch.full_like(r, torch.nan), r)
    return torch.where(x == torch.inf, x, r)
