// Fused W4A8 GEMM for Hopper (sm_90a): y = q8(x) . deq(W)^T [+ (q8(x) . B^T) . A^T],
// plus its batched and transposed orientations.
//
// Replaces the TPU kernel repro/kernels/w4a8_fused.py:169
// (w4a8_fused_batched_pallas) in every orientation the served models run:
//   * the 2-D normal orientation, reached through w4a8_fused_matmul_pallas
//     at :272 (every dense linear), FP8 activations, bf16 out;
//   * the batched normal orientation over E stacked weights, f32 out, with
//     a_fmt=None (MLA's absorbed wv_b, repro/models/mla.py:266-270) or with
//     the FP8 activation quantization of :87-94 (the MoE expert stacks,
//     repro/models/moe.py:105,107,111: wu, wg and wd of E experts, each
//     slab of M rows one row per token of the program, zero where the token
//     did not pick the expert);
//   * the batched transposed orientation with a_fmt=None (MLA's absorbed
//     wk_b, repro/models/mla.py:190-202).
// Computes what that kernel computes:
//   * QUANT_ACTS: token-wise activation quantization of the full K row:
//     per-row scale = max(absmax * (1 / fmt_max), 1e-12), value =
//     bf16(RNE-grid(x / s) * s); without it x is taken as bf16 as it is
//     (w4a8_fused.py:93-94). A row of zeros (an expert slab's row for a
//     token that did not pick the expert) has absmax 0, scale 1e-12 and
//     quantizes to zeros: nothing is masked by a multiply;
//   * packed FP4 E2M1 weights (two nibbles per byte, low nibble = even
//     column), decoded by the closed form. Normal orientation
//     (y[e] = x[e] W[e]^T, contracting W's in columns): with M2 the
//     per-group scale is the exact power of two 2^-shift (built from the
//     f32 bit pattern) and s_max multiplies each output column once after
//     the K loop; without M2 the f32 group scale multiplies the decoded
//     value. TRANSPOSE (y[e] = x[e] W[e], contracting W's out rows, the
//     output spanning W's in columns): each decoded row is scaled by
//     2^-shift[n, g] * s_max[n] before it enters the sum, since s_max
//     varies along the contraction (w4a8_fused.py:121-127);
//   * bf16 products accumulated in f32 (tensor cores through WMMA);
//   * the LoRC epilogue: xr = bf16(xq . B^T) then + xr . A^T (normal), or
//     xr = bf16(xq . A) then + xr . B (transposed), then one write.
//
// What bounds it on the H100: at decode (M = slots, a handful of rows) the
// packed weight read, N*K/2 bytes, is all the traffic; at prefill (M of
// 64..256) the tensor-core work is still far below the card's 989 TFLOP/s,
// so the kernel is bound by bytes and by its own latency. The MLA head
// projections are tiny (40 heads of 64 x 256 codes: 0.33 MB), so their
// launches are latency bound. An MoE expert launch at OLMoE-1B-7B (E = 64,
// 2048 -> 1024 or 1024 -> 2048) reads 67 MB of codes and 3.1 MB of LoRC
// factors: about 22 us at 3.35 TB/s at decode (M = 4, each token's row zero
// in 56 of the 64 slabs); at M = 260 (a mixed step) its 70 GFLOP take about
// 71 us at the bf16 peak, so bytes bound it at decode and operations at
// prefill. Zero rows are computed like any other (skipping them is later
// performance work).
// What the design does about it: weights stay packed in device memory (4
// bits per value) and are decoded into shared memory right before use, so
// no dequantized copy ever exists in device memory; activations are read
// and quantized inside the same kernel (no separate quantize launch, no
// quantized copy). The Pallas kernel keeps the whole (BM, K) row slab in
// VMEM and quantizes it when program_id(2) == 0, relying on the sequential
// TPU grid; CUDA blocks run concurrently and K can reach 73728, so here
// every block computes the absmax of its own rows over the full K first
// (a read of BM*K activations, cheap next to the weights) and then streams
// K in BK chunks, quantizing each chunk as it is staged. blockIdx.z picks
// the slice e; every operand has its own slice stride, and lorc_b may come
// with stride 0 (one factor broadcast over the MLA heads, never copied).
// Simple first: no TMA, no wgmma, no pipelining — those come with the
// performance work. Only what the serving path runs is compiled: bf16
// activations, E2M1 weights; the 2-D GEMM quantizes its activations onto
// FP8 E4M3 and writes bf16; the batched normal one quantizes them or takes
// them as they are and writes f32; the transposed one takes them as they
// are and writes f32 (the Python wrappers refuse the rest).

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

template <bool QUANT_ACTS, bool TRANSPOSE, typename OutT>
__global__ void __launch_bounds__(THREADS) w4a8_fused_kernel(Args<OutT> a) {
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
#pragma unroll
    for (int it = 0; it < LB; ++it) {  // the LoRC projection factor, (j, kk)
      const int i = tid + it * THREADS, j = i / BK, k = k0 + i % BK;
      lb[it] = __float2bfloat16_rn(0.f);
      if (j < r && k < K)
        lb[it] = TRANSPOSE ? lorc_a[(size_t)k * r + j] : lorc_b[(size_t)j * K + k];
    }
    // the activation chunk (BM x BK) as bf16, quantized when QUANT_ACTS
#pragma unroll
    for (int it = 0; it < XA; ++it) {
      const int i = tid + it * THREADS, rr = i / BK;
      float v = xv[it];
      if (QUANT_ACTS && m0 + rr < M) {
        const float sc = row_scale[rr];
        v = round_to_grid(v / sc, grid) * sc;
      }
      As[rr * LDS + i % BK] = __float2bfloat16_rn(v);
    }
    // the weight chunk as B[col][kk] (BN x BK), decoded from packed nibbles
#pragma unroll
    for (int it = 0; it < WB; ++it) {
      const int i = tid + it * THREADS;
      const __nv_bfloat16 lo = __float2bfloat16_rn(decode_e2m1(cw[it] & 15) * s0[it]);
      const __nv_bfloat16 hi = __float2bfloat16_rn(decode_e2m1(cw[it] >> 4) * s1[it]);
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

template <bool QUANT_ACTS, bool TRANSPOSE, typename OutT>
int launch(const Args<OutT>& a, int E, cudaStream_t stream) {
  dim3 blocks((a.N_out + BN - 1) / BN, (a.M + BM - 1) / BM, E);
  w4a8_fused_kernel<QUANT_ACTS, TRANSPOSE, OutT><<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
  Args<__nv_bfloat16> a{(const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale,
                        (const int8_t*)shifts, (const float*)smax,
                        (const __nv_bfloat16*)lorc_a, (const __nv_bfloat16*)lorc_b,
                        (__nv_bfloat16*)out, M, K, N, gs, K / gs, r, 0, 0, 0, 0, 0, 0,
                        Grid{a_man_bits, a_min_exp, a_max_exp, a_max_value, a_inv_max}};
  return launch<true, false>(a, 1, (cudaStream_t)stream);
}

// The batched orientations over E slices, f32 out. quant_acts = 1 (normal
// orientation only): each x row is quantized onto the activation grid
// (a_*) over its full In, as w4a8_fused_launch does; quant_acts = 0: the
// bf16 activations are taken as they are. W: codes (E, N, In/2) uint8 E2M1,
// scale / shifts (E, N, In/gs), smax (E, N) (M2: shifts and smax, else both
// null), lorc_a (E, N, r) and lorc_b (E, r, In) bf16 when r > 0, with
// per-slice strides s_la and s_lb (s_lb 0: one factor for every slice).
// transpose = 0: x (E, M, In), out (E, M, N) = x W^T.
// transpose = 1: x (E, M, N), out (E, M, In) = x W.
// Every operand but lorc_b is contiguous. Returns cudaGetLastError().
extern "C" int w4a8_batched_launch(const void* x, const void* codes, const void* scale,
                                   const void* shifts, const void* smax, const void* lorc_a,
                                   const void* lorc_b, void* out, int E, int M, int N, int In,
                                   int gs, int r, long long s_la, long long s_lb, int transpose,
                                   int quant_acts, int a_man_bits, int a_min_exp,
                                   int a_max_exp, float a_max_value, float a_inv_max,
                                   void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (r > MAX_R || In % 2 || gs <= 0 || In % gs || (quant_acts && transpose))
    return (int)cudaErrorInvalidValue;
  const int G = In / gs;
  const int K = transpose ? N : In, N_out = transpose ? In : N;
  Args<float> a{(const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale,
                (const int8_t*)shifts, (const float*)smax, (const __nv_bfloat16*)lorc_a,
                (const __nv_bfloat16*)lorc_b, (float*)out, M, K, N_out, gs, G, r,
                (long long)M * K, (long long)N * (In / 2), (long long)N * G, (long long)N,
                s_la, s_lb, Grid{a_man_bits, a_min_exp, a_max_exp, a_max_value, a_inv_max}};
  cudaStream_t s = (cudaStream_t)stream;
  if (transpose) return launch<false, true>(a, E, s);
  return quant_acts ? launch<true, false>(a, E, s) : launch<false, false>(a, E, s);
}
