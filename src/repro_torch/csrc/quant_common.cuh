// Grid rounding and FP4 decode shared by the W4A8 GEMM (w4a8_gemm.cuh, built
// by w4a8_fused.cu and w4a8_matmul.cu) and the token-wise activation
// quantizer (act_quant.cu), so that all of them round and decode
// identically: the device half of kernels/common.py (round_to_grid,
// decode_e2m1, decode_e3m0). flash_attn.cu takes to_f32 and nan_max.
//
// The grid is the repo's saturating ExMy grid, not OCP's: its E4M3 tops out
// at 480, where the hardware __nv_fp8_e4m3 type (and torch.float8_e4m3fn)
// stop at 448. Nothing here uses the hardware FP8 conversions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

struct Grid {
  int man_bits, min_exp, max_exp;
  float max_value, inv_max;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// exact 2^k for integer k, clamped to the f32 normal range, built from the
// bit pattern as core/formats.pow2i does
__device__ __forceinline__ float pow2i(int k) {
  k = max(-126, min(127, k));
  return __int_as_float((k + 127) << 23);
}

// max that propagates NaN, as jnp.max / jnp.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// RNE onto the saturating ExMy grid. floor(log2|v|) is read from the f32
// exponent bits; where that differs from a rounded log2 (values a hair
// below a power of two) both steps round to the same grid point. v / step
// is taken as v * (1 / step): both are powers of two inside the f32 normal
// range (the exponent is clamped to the grid's), so the product is the
// quotient exactly, without a division.
__device__ __forceinline__ float round_to_grid(float v, const Grid& g) {
  if (v != v) return v;
  float a = fabsf(v);
  if (a == 0.f) return 0.f;
  int e = ((__float_as_int(fmaxf(a, 1e-38f)) >> 23) & 0xff) - 127;
  e = max(g.min_exp, min(g.max_exp, e));
  float q = rintf(v * pow2i(g.man_bits - e)) * pow2i(e - g.man_bits);
  return fminf(fmaxf(q, -g.max_value), g.max_value);
}

// 4-bit E2M1 code -> {0, .5, 1, 1.5, 2, 3, 4, 6} with sign
__device__ __forceinline__ float decode_e2m1(int c) {
  const int exp = (c >> 1) & 3;
  const float man = (float)(c & 1);
  const float val = exp == 0 ? 0.5f * man : pow2i(exp - 1) * (1.f + 0.5f * man);
  return (c >> 3) & 1 ? -val : val;
}

// 4-bit E3M0 code (bias 3) -> pure powers of two: exponent field 1..7 ->
// 2^-2..2^4, field 0 -> 0, with sign
__device__ __forceinline__ float decode_e3m0(int c) {
  const int exp = c & 7;
  const float val = exp == 0 ? 0.f : pow2i(exp - 3);
  return (c >> 3) & 1 ? -val : val;
}

}  // namespace
