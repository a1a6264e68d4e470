// The W4A8 GEMM kernel of the port, shared by the fused GEMM (w4a8_fused.cu,
// TPU row 1 and its batched and transposed orientations) and the split GEMM
// (w4a8_matmul.cu, TPU row 5), so both run one K loop and one epilogue; what
// it computes, what bounds it and what its design does about it is set out
// at the head of w4a8_fused.cu. Template flags: QUANT_ACTS (token-wise FP8
// quantization of the activations in-kernel, else bf16 taken as it is),
// TRANSPOSE (contract the weight's out rows), OutT (bf16 or f32 out) and
// E3M0 (decode E3M0 nibbles, else E2M1).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "quant_common.cuh"  // Grid, to_f32, pow2i, nan_max, round_to_grid, decoders

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

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Operands of one launch. K is the contraction length, N_out the output
// width: normal, K = in columns of W and N_out = its out rows; transposed,
// K = out rows of W and N_out = its in columns. G groups of gs columns per
// W row in both. The s_* are per-slice strides in elements (s_lb may be 0).
template <typename OutT>
struct Args {
  const __nv_bfloat16* x;    // (E, M, K)
  const uint8_t* codes;      // (E, W rows, W cols / 2)
  const float* scale;        // (E, W rows, G), read without M2
  const int8_t* shifts;      // (E, W rows, G) with M2, else null
  const float* smax;         // (E, W rows) with M2, else null
  const __nv_bfloat16* lorc_a;  // (E, W rows, r)
  const __nv_bfloat16* lorc_b;  // (E, r, W cols)
  OutT* out;                 // (E, M, N_out)
  int M, K, N_out, gs, G, r;
  long long s_x, s_codes, s_scale, s_smax, s_la, s_lb;
  Grid grid;
};

template <bool E3M0>
__device__ __forceinline__ float decode_fp4(int c) {
  return E3M0 ? decode_e3m0(c) : decode_e2m1(c);
}

template <bool QUANT_ACTS, bool TRANSPOSE, typename OutT, bool E3M0>
__global__ void __launch_bounds__(THREADS) w4a8_gemm_kernel(Args<OutT> a) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ __nv_bfloat16 Ls[MAX_R * BK];
  __shared__ float xr[BM * MAX_R];
  __shared__ float row_scale[BM];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = a.M, K = a.K, N = a.N_out, G = a.G, gs = a.gs, r = a.r;
  const Grid grid = a.grid;
  const __nv_bfloat16* x = a.x + e * a.s_x;
  const uint8_t* codes = a.codes + e * a.s_codes;
  const float* scale = a.scale + e * a.s_scale;
  const int8_t* shifts = a.shifts ? a.shifts + e * a.s_scale : nullptr;
  const float* smax = a.smax ? a.smax + e * a.s_smax : nullptr;
  const __nv_bfloat16* lorc_a = r ? a.lorc_a + e * a.s_la : nullptr;
  const __nv_bfloat16* lorc_b = r ? a.lorc_b + e * a.s_lb : nullptr;
  OutT* out = a.out + (long long)e * M * N;
  const int row_bytes = (TRANSPOSE ? N : K) / 2;  // packed codes per W row

  // 1. per-row activation scale over the full K row
  if (QUANT_ACTS) {
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
    __nv_bfloat16 xv[XA];
    int cw[WB];
    float s0[WB], s1[WB];
    __nv_bfloat16 lb[LB];
#pragma unroll
    for (int it = 0; it < XA; ++it) {
      const int i = tid + it * THREADS, m = m0 + i / BK, k = k0 + i % BK;
      xv[it] = m < M && k < K ? x[(size_t)m * K + k] : __float2bfloat16_rn(0.f);
    }
#pragma unroll
    for (int it = 0; it < WB; ++it) {
      const int i = tid + it * THREADS;
      // one packed byte: W row wrow, W columns wcol and wcol + 1 (wcol even)
      int wrow, wcol;
      bool ok;
      if (TRANSPOSE) {  // rows along the contraction, columns along the output
        wrow = k0 + i / (BN / 2);
        wcol = n0 + 2 * (i % (BN / 2));
        ok = wrow < K && wcol < N;  // N is even, so wcol + 1 < N too
      } else {          // rows along the output, columns along the contraction
        wrow = n0 + i / (BK / 2);
        wcol = k0 + 2 * (i % (BK / 2));
        ok = wrow < N && wcol < K;  // K is even, so wcol + 1 < K too
      }
      cw[it] = 0;
      s0[it] = s1[it] = 0.f;
      if (ok) {
        cw[it] = codes[(size_t)wrow * row_bytes + wcol / 2];
        const int g0 = wcol / gs, g1 = (wcol + 1) / gs;
        if (shifts) {
          s0[it] = pow2i(-(int)shifts[(size_t)wrow * G + g0]);
          s1[it] = pow2i(-(int)shifts[(size_t)wrow * G + g1]);
          if (TRANSPOSE) {  // s_max varies along the contraction: fold it in here
            s0[it] *= smax[wrow];
            s1[it] *= smax[wrow];
          }
        } else {
          s0[it] = scale[(size_t)wrow * G + g0];
          s1[it] = scale[(size_t)wrow * G + g1];
        }
      }
    }
    if (r > 0) {  // uniform over the block: no LoRC, no staging of its factor
#pragma unroll
      for (int it = 0; it < LB; ++it) {  // the LoRC projection factor, (j, kk)
        const int i = tid + it * THREADS, j = i / BK, k = k0 + i % BK;
        lb[it] = __float2bfloat16_rn(0.f);
        if (j < r && k < K)
          lb[it] = TRANSPOSE ? lorc_a[(size_t)k * r + j] : lorc_b[(size_t)j * K + k];
      }
    }
    // the activation chunk (BM x BK) as bf16, quantized when QUANT_ACTS
#pragma unroll
    for (int it = 0; it < XA; ++it) {
      const int i = tid + it * THREADS, rr = i / BK;
      __nv_bfloat16 v = xv[it];
      if (QUANT_ACTS && m0 + rr < M) {
        const float sc = row_scale[rr];
        v = __float2bfloat16_rn(round_to_grid(to_f32(v) / sc, grid) * sc);
      }
      As[rr * LDS + i % BK] = v;
    }
    // the weight chunk as B[col][kk] (BN x BK), decoded from packed nibbles
#pragma unroll
    for (int it = 0; it < WB; ++it) {
      const int i = tid + it * THREADS;
      const __nv_bfloat16 lo = __float2bfloat16_rn(decode_fp4<E3M0>(cw[it] & 15) * s0[it]);
      const __nv_bfloat16 hi = __float2bfloat16_rn(decode_fp4<E3M0>(cw[it] >> 4) * s1[it]);
      if (TRANSPOSE) {
        const int kk = i / (BN / 2), cb = i % (BN / 2);
        Bs[(2 * cb) * LDS + kk] = lo;
        Bs[(2 * cb + 1) * LDS + kk] = hi;
      } else {
        const int nn = i / (BK / 2), kb = i % (BK / 2);
        Bs[nn * LDS + 2 * kb] = lo;
        Bs[nn * LDS + 2 * kb + 1] = hi;
      }
    }
    if (r > 0) {
#pragma unroll
      for (int it = 0; it < LB; ++it) Ls[tid + it * THREADS] = lb[it];
    }
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, As + (wr * 16) * LDS + kk, LDS);
      for (int t = 0; t < 2; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Bs + (wc * 32 + t * 16) * LDS + kk, LDS);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
    __syncthreads();
  }

  // 6. epilogue: s_max per column (normal orientation), LoRC correction, one write
  for (int t = 0; t < 2; ++t)
    wmma::store_matrix_sync(Cs + (wr * 16) * LDC + wc * 32 + t * 16, acc[t], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int rr = i / BN, nn = i % BN, m = m0 + rr, n = n0 + nn;
    if (m >= M || n >= N) continue;
    float v = Cs[rr * LDC + nn];
    if (!TRANSPOSE && smax) v *= smax[n];
    if (r > 0) {
      float c = 0.f;
      for (int j = 0; j < r; ++j) {
        const __nv_bfloat16 f = TRANSPOSE ? lorc_b[(size_t)j * N + n] : lorc_a[(size_t)n * r + j];
        c += __bfloat162float(__float2bfloat16_rn(xr[rr * MAX_R + j])) * __bfloat162float(f);
      }
      v += c;
    }
    store_out(out + (size_t)m * N + n, v);
  }
}

template <bool QUANT_ACTS, bool TRANSPOSE, bool E3M0 = false, typename OutT>
int launch(const Args<OutT>& a, int E, cudaStream_t stream) {
  dim3 blocks((a.N_out + BN - 1) / BN, (a.M + BM - 1) / BM, E);
  w4a8_gemm_kernel<QUANT_ACTS, TRANSPOSE, OutT, E3M0><<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
