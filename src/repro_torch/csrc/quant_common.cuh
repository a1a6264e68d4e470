// Grid rounding and FP4 decode shared by the W4A8 GEMM (w4a8_gemm.cuh, built
// by w4a8_fused.cu and w4a8_matmul.cu) and the token-wise activation
// quantizer (act_quant.cu), so that all of them round and decode
// identically: the device half of kernels/common.py (round_to_grid,
// decode_e2m1, decode_e3m0). flash_attn.cu takes to_f32 and nan_max. The
// streaming accesses at the end serve act_quant.cu.
//
// The grid is the repo's saturating ExMy grid, not OCP's: its E4M3 tops out
// at 480, where the hardware __nv_fp8_e4m3 type (and torch.float8_e4m3fn)
// stop at 448. Nothing here uses the hardware FP8 conversions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

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
// exponent bits (a zero or subnormal |v| reads -127, below every grid's
// min_exp); where that differs from a rounded log2 (values a hair below a
// power of two) both steps round to the same grid point. The step
// 2^(e - man_bits) and its inverse are built from their exponent bits: the
// exponent clamped to the grid's keeps both well inside the f32 normal
// range for the FP8 grids the kernels take (|man_bits - e| <= 16), so
// v / step is the product v * (1 / step) exactly, without a division. NaN
// stays v and zero is +0, by selects, so a run of calls is straight-line
// code the compiler can interleave.
__device__ __forceinline__ float round_to_grid(float v, const Grid& g) {
  const float a = fabsf(v);
  const int e = max(g.min_exp, min(g.max_exp, (__float_as_int(a) >> 23) - 127));
  const float inv_step = __int_as_float((127 + g.man_bits - e) << 23);
  const float step = __int_as_float((127 - g.man_bits + e) << 23);
  const float q = fminf(fmaxf(rintf(v * inv_step) * step, -g.max_value), g.max_value);
  return v != v ? v : a == 0.f ? 0.f : q;
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

// Streaming accesses for act_quant.cu: 8 bytes (4 bf16) or 16 bytes (4 f32)
// read once with a cache-streaming (evict-first) load, 4 f32 written with
// one 16-byte evict-first store. p is aligned to the access.
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  return __ldcs(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st_stream4(float* p, float a, float b, float c, float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// element i (0..3) of 4 bf16 packed in 8 bytes, exactly, as f32
__device__ __forceinline__ float bf16x4_at(const uint2& w, int i) {
  const uint32_t u = i < 2 ? w.x : w.y;
  return __uint_as_float(i & 1 ? u & 0xffff0000u : u << 16);
}

// nan_max of |x| over 4 bf16 packed in 8 bytes, exactly, as f32: the packed
// NaN-propagating max of the two bf16 pairs, then of the pair's halves
__device__ __forceinline__ float bf16x4_absmax(const uint2& w) {
  __nv_bfloat162 h[2];
  memcpy(h, &w, 8);  // register moves
  const __nv_bfloat162 m = __hmax2_nan(__habs2(h[0]), __habs2(h[1]));
  return nan_max(__low2float(m), __high2float(m));
}

// element i (0..3) of 4 f32 packed in 16 bytes
__device__ __forceinline__ float f32x4_at(const uint4& w, int i) {
  return __uint_as_float(i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w);
}

}  // namespace
