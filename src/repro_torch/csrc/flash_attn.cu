// Flash-attention forward for Hopper (sm_90a): softmax(q k^T * scale [+ causal
// mask]) v with an online softmax, one pass over q, k and v.
//
// Replaces the TPU kernel repro/kernels/flash_attn.py:93 (flash_attention_
// pallas, body _kernel at :48, oracle :33). Computes what that kernel
// computes, for q (B, S, H, hd), k (B, T, H, hd), v (B, T, H, dv), bf16 or
// f32, hd and dv up to 128 (dv may differ from hd), out (B, S, H, dv) in
// v's dtype:
//   * scores (q * scale) . k in f32, scale = 1/sqrt(hd) (:52-54); on the
//     bf16 path the tensor cores form q . k exactly (bf16 products, f32
//     sums) and the scale multiplies the f32 score after the product;
//   * causal: k_pos > q_pos -> -1e30, with no offset when T != S (:67-70);
//   * the running max m, sum l and f32 accumulator acc carried over the KV
//     tiles: m' = max(m, rowmax s), p = exp(s - m'), l' = l e^(m - m') +
//     sum p, acc' = acc e^(m - m') + p . v with p cast to v's dtype first
//     (:75-77);
//   * out = acc / max(l, 1e-30) in v's dtype (:84).
//
// What bounds it on the H100: operations. Causal at S = T = 2048, H = 12,
// hd = 64 needs 2 * 2 * 2048^2 / 2 * 64 * 12 = 6.4 GFLOP of products
// (6.5 us at the bf16 peak) against 12.6 MB of q, k, v and out (3.8 us).
// What the design does about it: one block per (b * h, 64-query tile), four
// warps of 16 query rows each; the block walks the KV tiles of 64 keys in a
// loop (the Pallas kernel's fori_loop), staging each K and V tile once in
// shared memory for all four warps. QK^T and PV run on the tensor cores
// (WMMA 16x16x16, bf16 in, f32 accumulate) for bf16 inputs; f32 inputs take
// plain f32 FMAs (no TF32, which would miss the f32 bound). The score tile
// and acc stay in shared memory and are never written to device memory;
// each warp owns its rows' scores, softmax state and acc, so only the K/V
// staging needs the whole block. Under the causal mask the KV tiles wholly
// past a q tile's last row are skipped: their p is exactly 0 and their
// correction exactly 1, so skipping them changes no bit. Each K and V tile
// is staged with 16-byte loads, all of a thread's issued before any is
// stored, so a tile costs one memory latency, not one per element. S and
// T need not be multiples of the tiles: keys past T are left out of the max
// and the sum, query rows past S are computed and not written. Simple
// first: no TMA, no wgmma, no double buffering, the softmax one row at a
// time, 113 KB of shared memory a block at hd = dv = 128 (two blocks an SM).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "quant_common.cuh"  // to_f32, nan_max

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows a block
constexpr int BKV = 64;       // keys a KV tile
constexpr int THREADS = 128;  // four warps, 16 query rows each
constexpr int MAX_D = 128;    // largest hd and dv
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory layout of one block: pitches keep every WMMA pointer
// 32-byte aligned (a multiple of 8 bf16 / 4 f32, at 16-row offsets).
struct Layout {
  int lq, lv, ls, lp, lo;  // pitches (elements) of Q/K, V, S, P and acc
  size_t q, k, v, s, p, o, stat, bytes;  // byte offsets, total
  __host__ __device__ Layout(int hd, int dv, int esize) {
    lq = round16(hd) + 8;
    lv = round16(dv) + 8;
    ls = BKV + 4;
    lp = BKV + 8;
    lo = round16(dv) + 4;
    q = 0;
    k = q + align128((size_t)BQ * lq * esize);
    v = k + align128((size_t)BKV * lq * esize);
    s = v + align128((size_t)BKV * lv * esize);
    p = s + align128((size_t)BQ * ls * 4);
    o = p + align128((size_t)BQ * lp * esize);
    stat = o + align128((size_t)BQ * lo * 4);
    bytes = stat + 2 * BQ * 4;  // m and l of each row
  }
};

// rows [r0, r0 + rows) of a (len, H, d) slice with row stride H * d, staged
// as a (rows, d16) tile of pitch ld; zero past len and past d. ``mul`` scales
// the values (the f32 path's q * scale). Where a row is whole 16-byte
// vectors (d * sizeof(T) % 16 == 0, the slice 16-byte aligned) and nothing
// is scaled, each thread issues all its vector loads before it stores any
// (one memory latency a tile); otherwise one element at a time.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ src, size_t stride,
                                      int r0, int rows, int len, int d, float mul) {
  constexpr int V = 16 / sizeof(T);                      // elements a vector
  constexpr int VEC_IT = BQ * MAX_D / V / THREADS;       // vectors a thread, at most
  const int d16 = round16(d);
  if (d % V == 0 && mul == 1.f && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int vpr = d16 / V;  // vectors a staged row
    uint4 buf[VEC_IT];
#pragma unroll
    for (int it = 0; it < VEC_IT; ++it) {
      const int i = threadIdx.x + it * THREADS, rr = i / vpr, c = (i % vpr) * V, r = r0 + rr;
      buf[it] = make_uint4(0u, 0u, 0u, 0u);
      if (rr < rows && r < len && c < d)
        buf[it] = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    }
#pragma unroll
    for (int it = 0; it < VEC_IT; ++it) {
      const int i = threadIdx.x + it * THREADS, rr = i / vpr, c = (i % vpr) * V;
      if (rr < rows) *reinterpret_cast<uint4*>(dst + rr * ld + c) = buf[it];
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * d16; i += THREADS) {
    const int rr = i / d16, c = i % d16, r = r0 + rr;
    float val = 0.f;
    if (r < len && c < d) val = to_f32(src[(size_t)r * stride + c]) * mul;
    dst[rr * ld + c] = from_f32<T>(val);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int S, int Tk, int H, int hd, int dv, float scale,
                  int causal) {
  constexpr bool MMA = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(hd, dv, sizeof(T));
  T* Qs = (T*)(smem + L.q);
  T* Ks = (T*)(smem + L.k);
  T* Vs = (T*)(smem + L.v);
  float* Ss = (float*)(smem + L.s);
  T* Ps = (T*)(smem + L.p);
  float* Os = (float*)(smem + L.o);
  float* m_s = (float*)(smem + L.stat);
  float* l_s = m_s + BQ;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, w0 = warp * 16;
  const int hd16 = round16(hd), dv16 = round16(dv);
  const size_t sk = (size_t)H * hd, sv = (size_t)H * dv;
  const T* kb = k + ((size_t)b * Tk * H + h) * hd;
  const T* vb = v + ((size_t)b * Tk * H + h) * dv;

  // the f32 path scales q before the product, as the Pallas kernel does
  stage(Qs, L.lq, q + ((size_t)b * S * H + h) * hd, sk, q0, BQ, S, hd, MMA ? 1.f : scale);
  for (int i = threadIdx.x; i < BQ * dv16; i += THREADS) Os[(i / dv16) * L.lo + i % dv16] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  // causal: keys past the tile's last row are masked for every row
  const int kv_end = causal ? min(Tk, min(S, q0 + BQ)) : Tk;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's K and V are no longer read
    stage(Ks, L.lq, kb, sk, k0, BKV, Tk, hd, 1.f);
    stage(Vs, L.lv, vb, sv, k0, BKV, Tk, dv, 1.f);
    __syncthreads();

    // 1. this warp's 16 x 64 scores
    if constexpr (MMA) {
      for (int n = 0; n < BKV / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < hd16; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, (const __nv_bfloat16*)Qs + w0 * L.lq + kk, L.lq);
          wmma::load_matrix_sync(fb, (const __nv_bfloat16*)Ks + n * 16 * L.lq + kk, L.lq);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + w0 * L.ls + n * 16, acc, L.ls, wmma::mem_row_major);
      }
    } else {
      for (int i = lane; i < 16 * BKV; i += 32) {
        const int rr = i / BKV, c = i % BKV;
        const float* qr = (const float*)Qs + (w0 + rr) * L.lq;
        const float* kr = (const float*)Ks + c * L.lq;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc += qr[d] * kr[d];
        Ss[(w0 + rr) * L.ls + c] = acc;
      }
    }
    __syncwarp();

    // 2. the online softmax, one row at a time, two keys a lane; the row's
    //    acc is scaled by its correction here
    for (int rr = 0; rr < 16; ++rr) {
      const int row = w0 + rr, q_pos = q0 + row;
      float s[2];
      bool in[2];
      float mx = -INFINITY;
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, k_pos = k0 + c;
        in[j] = k_pos < Tk;
        s[j] = Ss[row * L.ls + c] * (MMA ? scale : 1.f);
        if (causal && k_pos > q_pos) s[j] = NEG;
        if (in[j]) mx = nan_max(s[j], mx);
      }
      for (int o = 16; o; o >>= 1) mx = nan_max(__shfl_xor_sync(0xffffffffu, mx, o), mx);
      const float m_old = m_s[row], m_new = nan_max(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < 2; ++j) {
        const float p = in[j] ? expf(s[j] - m_new) : 0.f;
        sum += p;
        Ps[row * L.lp + lane + 32 * j] = from_f32<T>(p);
      }
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_old - m_new);
      for (int c = lane; c < dv16; c += 32) Os[row * L.lo + c] *= corr;  // acc * corr
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + sum;
      }
    }
    __syncwarp();

    // 3. acc += p . v
    if constexpr (MMA) {
      for (int n = 0; n < dv16 / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + w0 * L.lo + n * 16, L.lo, wmma::mem_row_major);
        for (int kk = 0; kk < BKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, (const __nv_bfloat16*)Ps + w0 * L.lp + kk, L.lp);
          wmma::load_matrix_sync(fb, (const __nv_bfloat16*)Vs + kk * L.lv + n * 16, L.lv);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Os + w0 * L.lo + n * 16, acc, L.lo, wmma::mem_row_major);
      }
    } else {
      for (int i = lane; i < 16 * dv; i += 32) {
        const int rr = i / dv, c = i % dv;
        const float* pr = (const float*)Ps + (w0 + rr) * L.lp;
        float acc = 0.f;
        for (int j = 0; j < BKV; ++j) acc += pr[j] * to_f32(Vs[j * L.lv + c]);
        Os[(w0 + rr) * L.lo + c] += acc;
      }
    }
    __syncwarp();
  }

  // 4. out = acc / max(l, 1e-30), this warp's rows that exist
  for (int i = lane; i < 16 * dv; i += 32) {
    const int rr = i / dv, c = i % dv, row = w0 + rr, s_pos = q0 + row;
    if (s_pos >= S) continue;
    const float o = Os[row * L.lo + c] / fmaxf(l_s[row], 1e-30f);
    out[(((size_t)b * S + s_pos) * H + h) * dv + c] = from_f32<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
           int hd, int dv, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = Layout(hd, dv, sizeof(T)).bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((S + BQ - 1) / BQ, B * H);
  flash_attn_kernel<T><<<blocks, THREADS, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                           (T*)out, S, Tk, H, hd, dv, scale,
                                                           causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, S, H, hd), k: (B, T, H, hd), v: (B, T, H, dv), out: (B, S, H, dv),
// all contiguous, all bf16 (is_bf16 = 1) or all f32; hd, dv in 1..128;
// scale the softmax scale (1/sqrt(hd)); causal 0 or 1. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int T, int H, int hd, int dv, float scale, int causal,
                                 int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (T <= 0 || hd <= 0 || dv <= 0 || hd > MAX_D || dv > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, hd, dv, scale, causal, s)
                 : launch<float>(q, k, v, out, B, S, T, H, hd, dv, scale, causal, s);
}
