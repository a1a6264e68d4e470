// Fused W4A8 GEMM for Hopper (sm_90a): y = q8(x) . deq(W)^T [+ (q8(x) . B^T) . A^T]
//
// Replaces the TPU kernel repro/kernels/w4a8_fused.py:169
// (w4a8_fused_batched_pallas, 2-D normal orientation, reached through
// w4a8_fused_matmul_pallas at :272). Computes what that kernel computes:
//   * token-wise activation quantization of the full K row: per-row
//     scale = max(absmax * (1 / fmt_max), 1e-12), value = bf16(RNE-grid(x / s) * s);
//   * packed FP4 E2M1 weights (two nibbles per byte, low nibble = even k),
//     decoded by the closed form; with M2 the per-group scale
//     is the exact power of two 2^-shift (built from the f32 bit pattern)
//     and s_max multiplies each output column once after the K loop;
//     without M2 the f32 group scale multiplies the decoded value;
//   * bf16 products accumulated in f32 (tensor cores through WMMA);
//   * the LoRC epilogue: xr = bf16(xq . B^T) (f32 sums), then + xr . A^T,
//     then one write.
//
// What bounds it on the H100: at decode (M = slots, a handful of rows) the
// packed weight read, N*K/2 bytes, is all the traffic; at prefill (M of
// 64..256) the tensor-core work is still far below the card's 989 TFLOP/s,
// so the kernel is bound by bytes and by its own latency.
// What the design does about it: weights stay packed in device memory (4
// bits per value) and are decoded into shared memory right before use, so
// no dequantized copy ever exists in device memory; activations are read
// and quantized inside the same kernel (no separate quantize launch, no
// quantized copy). The Pallas kernel keeps the whole (BM, K) row slab in
// VMEM and quantizes it when program_id(2) == 0, relying on the sequential
// TPU grid; CUDA blocks run concurrently and K can reach 73728, so here
// every block computes the absmax of its own rows over the full K first
// (a read of BM*K activations, cheap next to the weights) and then streams
// K in BK chunks, quantizing each chunk as it is staged. Simple first:
// no TMA, no wgmma, no pipelining — those come with the performance work.
// Only what the serving path runs is compiled: bf16 activations and
// output, FP8 activation quantization always on, E2M1 weights (the Python
// wrapper refuses the rest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int LDS = BK + 8;   // bf16 pitch of the staged tiles (multiple of 8)
constexpr int LDC = BN + 4;   // f32 pitch of the epilogue tile (multiple of 4)
constexpr int MAX_R = 32;     // largest LoRC rank the epilogue holds
constexpr int XA = BM * BK / THREADS;        // activations staged per thread and chunk
constexpr int WB = BN * (BK / 2) / THREADS;  // packed weight bytes per thread and chunk
constexpr int LB = MAX_R * BK / THREADS;     // LoRC B entries per thread and chunk

struct Grid {
  int man_bits, min_exp, max_exp;
  float max_value, inv_max;
};

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
// below a power of two) both steps round to the same grid point.
__device__ __forceinline__ float round_to_grid(float v, const Grid& g) {
  if (v != v) return v;
  float a = fabsf(v);
  if (a == 0.f) return 0.f;
  int e = ((__float_as_int(fmaxf(a, 1e-38f)) >> 23) & 0xff) - 127;
  e = max(g.min_exp, min(g.max_exp, e));
  float step = pow2i(e - g.man_bits);
  float q = rintf(v / step) * step;
  return fminf(fmaxf(q, -g.max_value), g.max_value);
}

__device__ __forceinline__ float decode_e2m1(int c) {
  const int exp = (c >> 1) & 3;
  const float man = (float)(c & 1);
  const float val = exp == 0 ? 0.5f * man : pow2i(exp - 1) * (1.f + 0.5f * man);
  return (c >> 3) & 1 ? -val : val;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__global__ void __launch_bounds__(THREADS)
w4a8_fused_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale, const int8_t* __restrict__ shifts,
                  const float* __restrict__ smax, const __nv_bfloat16* __restrict__ lorc_a,
                  const __nv_bfloat16* __restrict__ lorc_b, __nv_bfloat16* __restrict__ out,
                  int M, int N, int K, int gs, int r, Grid grid) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ __nv_bfloat16 Ls[MAX_R * BK];
  __shared__ float xr[BM * MAX_R];
  __shared__ float row_scale[BM];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = K / gs;
  const int row_bytes = K / 2;  // packed codes per weight row

  // 1. per-row activation scale over the full K row
  for (int rr = warp; rr < BM; rr += THREADS / 32) {
    const int m = m0 + rr;
    float mx = 0.f;
    if (m < M) {
      const __nv_bfloat16* row = x + (size_t)m * K;
      int k = lane;
      for (; k + 96 < K; k += 128) {  // four loads in flight per lane
        const float a0 = fabsf(to_f32(row[k])), a1 = fabsf(to_f32(row[k + 32]));
        const float a2 = fabsf(to_f32(row[k + 64])), a3 = fabsf(to_f32(row[k + 96]));
        mx = nan_max(nan_max(nan_max(nan_max(a0, mx), a1), a2), a3);
      }
      for (; k < K; k += 32) mx = nan_max(fabsf(to_f32(row[k])), mx);
    }
    for (int o = 16; o; o >>= 1) mx = nan_max(__shfl_xor_sync(0xffffffffu, mx, o), mx);
    if (lane == 0) row_scale[rr] = nan_max(mx * grid.inv_max, 1e-12f);
  }
  for (int i = tid; i < BM * MAX_R; i += THREADS) xr[i] = 0.f;
  __syncthreads();

  // warp w owns rows [16*(w&1), +16) and columns [32*(w>>1), +32)
  const int wr = warp & 1, wc = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 2-3. Every global load of this chunk is issued before any is used:
    // a chunk then costs one memory latency, not one per element.
    float xv[XA];
    int cw[WB];
    float s0[WB], s1[WB];
    __nv_bfloat16 lb[LB];
#pragma unroll
    for (int it = 0; it < XA; ++it) {
      const int i = tid + it * THREADS, m = m0 + i / BK, k = k0 + i % BK;
      xv[it] = m < M && k < K ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < WB; ++it) {
      const int i = tid + it * THREADS, n = n0 + i / (BK / 2), k = k0 + 2 * (i % (BK / 2));
      cw[it] = 0;
      s0[it] = s1[it] = 0.f;
      if (n < N && k < K) {  // K is even, so k + 1 < K too
        cw[it] = codes[(size_t)n * row_bytes + k / 2];
        const int g0 = k / gs, g1 = (k + 1) / gs;
        if (shifts) {
          s0[it] = pow2i(-(int)shifts[(size_t)n * G + g0]);
          s1[it] = pow2i(-(int)shifts[(size_t)n * G + g1]);
        } else {
          s0[it] = scale[(size_t)n * G + g0];
          s1[it] = scale[(size_t)n * G + g1];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < LB; ++it) {
      const int i = tid + it * THREADS, k = k0 + i % BK;
      lb[it] = i < r * BK && k < K ? lorc_b[(size_t)(i / BK) * K + k] : __float2bfloat16_rn(0.f);
    }
    // the quantized activation chunk (BM x BK) as bf16
#pragma unroll
    for (int it = 0; it < XA; ++it) {
      const int i = tid + it * THREADS, rr = i / BK;
      float v = xv[it];
      if (m0 + rr < M) {
        const float sc = row_scale[rr];
        v = round_to_grid(v / sc, grid) * sc;
      }
      As[rr * LDS + i % BK] = __float2bfloat16_rn(v);
    }
    // the weight chunk (BN x BK), decoded from packed nibbles
#pragma unroll
    for (int it = 0; it < WB; ++it) {
      const int i = tid + it * THREADS, nn = i / (BK / 2), kb = i % (BK / 2);
      Bs[nn * LDS + 2 * kb] = __float2bfloat16_rn(decode_e2m1(cw[it] & 15) * s0[it]);
      Bs[nn * LDS + 2 * kb + 1] = __float2bfloat16_rn(decode_e2m1(cw[it] >> 4) * s1[it]);
    }
#pragma unroll
    for (int it = 0; it < LB; ++it) Ls[tid + it * THREADS] = lb[it];
    __syncthreads();

    // 4. LoRC projection of this chunk; each (row, j) has one owner thread
    for (int i = tid; i < BM * r; i += THREADS) {
      const int rr = i / r, j = i % r;
      float s = 0.f;
      for (int kk = 0; kk < BK; ++kk)
        s += __bfloat162float(As[rr * LDS + kk]) * __bfloat162float(Ls[j * BK + kk]);
      xr[rr * MAX_R + j] += s;
    }
    // 5. tensor-core products, f32 accumulation
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + (wr * 16) * LDS + kk, LDS);
      for (int t = 0; t < 2; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Bs + (wc * 32 + t * 16) * LDS + kk, LDS);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
    __syncthreads();
  }

  // 6. epilogue: s_max per column, LoRC correction, one write
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(Cs + (wr * 16) * LDC + wc * 32 + t * 16, acc[t], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int rr = i / BN, nn = i % BN, m = m0 + rr, n = n0 + nn;
    if (m >= M || n >= N) continue;
    float v = Cs[rr * LDC + nn];
    if (smax) v *= smax[n];
    if (r > 0) {
      float c = 0.f;
      for (int j = 0; j < r; ++j)
        c += __bfloat162float(__float2bfloat16_rn(xr[rr * MAX_R + j])) *
             __bfloat162float(lorc_a[(size_t)n * r + j]);
      v += c;
    }
    out[(size_t)m * N + n] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// x: (M, K) bf16 raw activations; out: (M, N) bf16.
// codes: (N, K/2) uint8 E2M1 nibbles; scale: (N, K/gs) f32 (read when
// shifts is null); shifts: (N, K/gs) int8 and smax: (N,) f32 for M2, else
// both null; lorc_a: (N, r) bf16, lorc_b: (r, K) bf16 when r > 0; the
// activation grid (a_*) is the FP8 format x is quantized onto.
// Returns cudaGetLastError() after the launch.
extern "C" int w4a8_fused_launch(const void* x, const void* codes, const void* scale,
                                 const void* shifts, const void* smax, const void* lorc_a,
                                 const void* lorc_b, void* out, int M, int N, int K, int gs,
                                 int r, int a_man_bits, int a_min_exp, int a_max_exp,
                                 float a_max_value, float a_inv_max, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (r > MAX_R || K % 2 || gs <= 0 || K % gs) return (int)cudaErrorInvalidValue;
  Grid grid{a_man_bits, a_min_exp, a_max_exp, a_max_value, a_inv_max};
  dim3 blocks((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4a8_fused_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale,
      (const int8_t*)shifts, (const float*)smax, (const __nv_bfloat16*)lorc_a,
      (const __nv_bfloat16*)lorc_b, (__nv_bfloat16*)out, M, N, K, gs, r, grid);
  return (int)cudaGetLastError();
}
