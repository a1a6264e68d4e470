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
// What bounds it on the H100: operations. Causal at S = T = 2048, H = 16,
// hd = dv = 128 needs 2 * 2048 * 2049 / 2 * 256 * 16 = 17.2 GFLOP of
// products (17 us at the bf16 peak) against 33.6 MB of q, k, v and out
// (10 us). What the design does about it: FlashAttention-2's dataflow on
// mma.sync, everything after the products in registers.
//  * A block takes one (b * h, q tile) and walks the KV tiles in a loop
//    (the Pallas kernel's fori_loop). Where the grid of 128-row q tiles
//    still gives each of the 132 SMs a block (phase 11's S = 2048 shapes),
//    a q tile is 128 rows: eight warps of one 16-row slab (hd 64 and 128)
//    or four of two slabs (hd 96, where each K and V fragment read once
//    then serves both), so every staged K and V tile serves 128 rows;
//    else (S = 512, H = 12: 48 such blocks) 64 rows, four warps. KV tiles
//    are 128 keys (64 with two slabs a warp), in a ring of three stages at
//    128 rows (two at 64). The launch shape of each width is `Cfg`, as
//    measured on the card (PERF.md).
//  * Q . K^T and P . V are mma.sync m16n8k16 (bf16 in, f32 accumulate),
//    their operands read by ldmatrix (.trans for V). A warp of one slab
//    loads its q rows into registers once (their shared memory is then
//    the last stage of the ring).
//  * The score fragments and the accumulator stay in registers for the
//    whole KV walk. The softmax runs on the fragments: a thread holds two
//    rows of each 16-row slab, the row max is a quad shuffle, the running
//    sum is kept per thread and summed over the quad once at the end, and
//    the correction scales the accumulator fragments in place; p =
//    2^(s * scale * log2 e - m * scale * log2 e) is one FMA and one ex2
//    after the product. The score C fragments, cast to bf16 pairs, are the
//    A fragments of P . V as they are (mma_sync.cuh): the reference's cast
//    of p to v's dtype, with no trip through shared memory.
//  * K and V tiles go through a ring of 16-byte cp.async copies: tiles j +
//    1 (and j + 2) are in flight while tile j is computed, behind one
//    barrier a tile. A thread's copies advance by constants from tile to
//    tile. Rows and dims past T, S, hd or dv are zero-filled by the copy
//    (hd 20, 40, 48, 96 and the other widths are padded inside the block to
//    32, 64, 96 or 128, never in device memory); a slice whose rows are not
//    whole 16-byte chunks is staged one element at a time instead.
//  * Only a tile that straddles the causal diagonal or holds keys past T
//    compares positions; the mask is applied before the max, keys past T
//    are left out of the max and the sum (exp of -inf is 0, no multiply by
//    0), and KV tiles wholly past a q tile's last row are never staged.
//  * Causal q tiles run longest first: blockIdx.y counts down the tiles,
//    and every (b, h)'s longest tile precedes any shorter one.
// The f32 instantiation (checked, not timed) keeps the structure (64-row q
// tiles, 64-key KV tiles) and does both products with f32 FMAs on the same
// fragment layout (q scaled before the product, as the Pallas kernel does;
// no TF32, which would miss the f32 bound); P reaches P . V by quad
// shuffles. No wgmma: a first version with both products on wgmma
// (register A, shared-memory B, each product waited for at once) was
// slower than this one at phase 11's shapes, and was not kept.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int MAX_D = 128;          // largest hd and dv
constexpr int SMS = 132;            // the H100's SMs: a grid below them takes the narrow block
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// The launch shape of a (dtype, padded hd, padded dv, BQ query rows a
// block): MS m16 slabs of query rows a warp, BKV keys a KV tile, STAGES
// tiles in the ring, at least MINB blocks an SM (caps the registers), and
// whether a warp keeps its q fragments in registers. Chosen on the H100 at
// phase 11's shapes (attn_ablate.py times the alternatives): two slabs a
// warp only at hd 96, where a K or V fragment read once serving both slabs
// outweighs their registers; 128-key tiles elsewhere on the bf16 path.
template <typename T, int HDP, int DVP, int BQ_>
struct Cfg {
  static constexpr bool MMA = sizeof(T) == 2;
  static constexpr int BQ = BQ_;
  static constexpr int MS = MMA && BQ == 128 && HDP == 96 ? 2 : 1;
  static constexpr int THREADS = 32 * BQ / (16 * MS);
  static constexpr int BKV = MMA && MS == 1 ? 128 : 64;
  static constexpr int STAGES = MMA && BQ == 128 ? 3 : 2;
  static constexpr int MINB = THREADS == 256 ? 1 : 2;
  static constexpr bool QREG = MMA && MS == 1;
};

struct Args {
  const void *q, *k, *v;
  void* out;
  int S, T, H, hd, dv, causal;
  int vq, vk, vv;  // 1: the slice's rows are whole 16-byte chunks (cp.async)
  float scale;
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2^x, one MUFU op; a result below 2^-126 flushes to 0 (p that small is
// below an f32 ulp of the row sum, which holds a 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The block's shared memory, in elements of T: a ring of STAGES (K: BKV x
// LK, V: BKV x LV) tiles, and q (BQ x LK), over the last stage's K tile
// when a warp keeps q in registers (read before a tile lands there), else
// after the ring. Rows carry one 16-byte chunk of padding, so ldmatrix's
// eight row addresses fall in distinct banks.
template <typename T, int HDP, int DVP, int BQ_>
struct Smem {
  using C = Cfg<T, HDP, DVP, BQ_>;
  static constexpr int LK = HDP + 16 / sizeof(T), LV = DVP + 16 / sizeof(T);
  static constexpr int STAGE = C::BKV * (LK + LV);
  static constexpr bool ALIAS = C::QREG && C::BQ <= C::BKV;
  static constexpr int QOFF = (C::STAGES - (ALIAS ? 1 : 0)) * STAGE;
  static constexpr size_t BYTES = sizeof(T) * (C::STAGES * STAGE + (ALIAS ? 0 : C::BQ * LK));
};

// Rows [r0, r0 + ROWS) of a (len, H, d) slice (row stride `stride`
// elements) as a (ROWS, DP) tile of pitch ld, zero past len and past d:
// 16-byte cp.async copies when `vec`, else one element at a time. On the
// vector path a thread copies chunk tid % CPR of rows tid / CPR + k * RSTEP,
// so its addresses advance by constants.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* __restrict__ src,
                                           size_t stride, int r0, int len, int d, int vec) {
  constexpr int V = 16 / sizeof(T), CPR = DP / V, RSTEP = THREADS / CPR;
  if (vec) {
    const int tid = threadIdx.x, c = (tid % CPR) * V, rr0 = tid / CPR;
    if (rr0 >= RSTEP) return;  // the threads past a whole number of rows
    const bool cin = c < d;
    const T* g = src + (size_t)(r0 + rr0) * stride + c;
    T* s = dst + rr0 * ld + c;
#pragma unroll
    for (int k = 0; k < (ROWS + RSTEP - 1) / RSTEP; ++k) {
      if (ROWS % RSTEP && rr0 + k * RSTEP >= ROWS) break;
      const bool in = cin && r0 + rr0 + k * RSTEP < len;
      cp_async16(s + k * RSTEP * ld, in ? g + (size_t)k * RSTEP * stride : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
      const int rr = i / DP, c = i % DP, r = r0 + rr;
      dst[rr * ld + c] = (r < len && c < d) ? src[(size_t)r * stride + c] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int HDP, int DVP, int BQ_>
__global__ void __launch_bounds__((Cfg<T, HDP, DVP, BQ_>::THREADS), (Cfg<T, HDP, DVP, BQ_>::MINB))
flash_attn_kernel(const Args a) {
  using C = Cfg<T, HDP, DVP, BQ_>;
  using L = Smem<T, HDP, DVP, BQ_>;
  constexpr bool MMA = C::MMA;
  constexpr int BKV = C::BKV, NST = C::STAGES, BQ = C::BQ, NT = C::THREADS, MS = C::MS;
  constexpr int NS = BKV / 8, NO = DVP / 8;  // n8 tiles of a score row, of an output row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int nq = gridDim.y;
  const int qt = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;  // longest first
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H, q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int w0 = warp * 16 * MS;  // the warp's first row in the tile
  const size_t sk = (size_t)a.H * a.hd, sv = (size_t)a.H * a.dv;
  const T* qb = (const T*)a.q + ((size_t)b * a.S * a.H + h) * a.hd;
  const T* kb = (const T*)a.k + ((size_t)b * a.T * a.H + h) * a.hd;
  const T* vb = (const T*)a.v + ((size_t)b * a.T * a.H + h) * a.dv;
  // causal: keys past the tile's last row are masked for every row
  const int kv_end = a.causal ? min(a.T, min(a.S, q0 + BQ)) : a.T;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  T* qs = smem + L::QOFF;
  auto kt = [&](int s) { return smem + s * L::STAGE; };
  auto vt = [&](int s) { return smem + s * L::STAGE + BKV * L::LK; };
  auto stage_kv = [&](int j, int s) {
    stage_tile<T, HDP, BKV, NT>(kt(s), L::LK, kb, sk, j * BKV, a.T, a.hd, a.vk);
    stage_tile<T, DVP, BKV, NT>(vt(s), L::LV, vb, sv, j * BKV, a.T, a.dv, a.vv);
  };

  stage_tile<T, HDP, BQ, NT>(qs, L::LK, qb, sk, q0, a.S, a.hd, a.vq);
  stage_kv(0, 0);
  cp_async_commit();
#pragma unroll
  for (int p = 1; p < NST - 1; ++p) {
    if (p < ntiles) stage_kv(p, p);
    cp_async_commit();
  }
  cp_async_wait<NST - 2>();  // q and tile 0 have landed
  __syncthreads();
  // slab ms's q rows as A fragments of dims [16 kk, 16 kk + 16)
  auto q_frag = [&](uint32_t (&f)[4], int ms, int kk) {
    ldsm_x4(f, qs + (w0 + 16 * ms + (lane & 15)) * L::LK + kk * 16 + ((lane >> 4) << 3));
  };
  uint32_t qf[C::QREG ? MS : 1][C::QREG ? HDP / 16 : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) q_frag(qf[ms][kk], ms, kk);
  }

  // a slab's n8 tile n is [4n, 4n + 4) of its fragments: row g (cols 2 t4,
  // + 1), row g + 8
  float o[MS][NO * 4], m[MS][2], l[MS][2];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) {
    m[ms][0] = m[ms][1] = NEG;
    l[ms][0] = l[ms][1] = 0.f;
#pragma unroll
    for (int i = 0; i < NO * 4; ++i) o[ms][i] = 0.f;
  }
  // softmax in base 2 on the MMA path: p = 2^(s * scale * log2e - m * scale
  // * log2e), the scale folded into one FMA after the product
  const float sl2 = MMA ? a.scale * LOG2E : 1.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<NST - 2>();  // tile j has landed; later tiles stay in flight
    __syncthreads();           // every warp is done with tile j - 1 (and with q)
    if (j + NST - 1 < ntiles) stage_kv(j + NST - 1, (j + NST - 1) % NST);
    cp_async_commit();
    const T* ks = kt(j % NST);
    const T* vs = vt(j % NST);
    const int k0 = j * BKV;

    // 1. this warp's (16 MS) x BKV scores, in registers; a K fragment
    //    serves the MS slabs
    float s[MS][NS * 4];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) s[ms][i] = 0.f;
    if constexpr (MMA) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t qa[MS][4];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          if constexpr (C::QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[ms][e] = qf[ms][kk][e];
          } else {
            q_frag(qa[ms], ms, kk);
          }
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4];  // keys np*16 + [0, 8) and [8, 16), dims kk*16 + [0, 8) and [8, 16)
          ldsm_x4(bk, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * L::LK + kk * 16 +
                          (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            mma_bf16(s[ms] + 8 * np, qa[ms], bk[0], bk[1]);
            mma_bf16(s[ms] + 8 * np + 4, qa[ms], bk[2], bk[3]);
          }
        }
      }
    } else {
      const float* kr = reinterpret_cast<const float*>(ks) + 2 * t4 * L::LK;
#pragma unroll
      for (int ms = 0; ms < MS; ++ms) {
        const float* qr = reinterpret_cast<const float*>(qs) + (w0 + 16 * ms + g) * L::LK;
        for (int d = 0; d < a.hd; ++d) {
          const float x0 = qr[d] * a.scale, x1 = qr[8 * L::LK + d] * a.scale;
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float kv = kr[(n * 8 + e) * L::LK + d];
              s[ms][4 * n + e] = fmaf(x0, kv, s[ms][4 * n + e]);
              s[ms][4 * n + 2 + e] = fmaf(x1, kv, s[ms][4 * n + 2 + e]);
            }
        }
      }
    }

    // 2. the mask (only on a tile that needs it), then the online softmax
    //    on the fragments: rows g and g + 8 of each slab. The max and the
    //    sum run over independent partials.
    const bool edge = (a.causal && k0 + BKV - 1 > q0 + w0) || k0 + BKV > a.T;
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      float* sm = s[ms];
      if (edge) {
#pragma unroll
        for (int i = 0; i < NS * 4; ++i) {
          const int kp = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
          const int qp = q0 + w0 + 16 * ms + g + 8 * ((i >> 1) & 1);
          sm[i] = kp >= a.T ? -INFINITY : (a.causal && kp > qp) ? NEG : sm[i];
        }
      }
      float mx[2][4] = {{-INFINITY, -INFINITY, -INFINITY, -INFINITY},
                        {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};
#pragma unroll
      for (int i = 0; i < NS * 4; ++i)
        mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] =
            fmaxf(mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)], sm[i]);
      float corr[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
        const float mn = fmaxf(m[ms][r], x);
        corr[r] = MMA ? ex2((m[ms][r] - mn) * sl2) : expf(m[ms][r] - mn);
        mb[r] = mn * sl2;
        m[ms][r] = mn;
      }
      float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) {
        const int r = (i >> 1) & 1;
        const float p = MMA ? ex2(fmaf(sm[i], sl2, -mb[r])) : expf(sm[i] - m[ms][r]);
        sm[i] = p;
        ls[r][(i >> 2) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[ms][r] = l[ms][r] * corr[r] + (ls[r][0] + ls[r][1]);
#pragma unroll
      for (int i = 0; i < NO * 4; ++i) o[ms][i] *= corr[(i >> 1) & 1];
    }

    // 3. acc += p . v; a V fragment serves the MS slabs
    if constexpr (MMA) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        // p cast to v's dtype: the C fragments of score tiles 2kk, 2kk + 1
        // are the A fragment of keys [16 kk, 16 kk + 16)
        uint32_t pa[MS][4];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[ms][e] = pack_bf16(s[ms][8 * kk + 2 * e], s[ms][8 * kk + 2 * e + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bv[4];  // keys kk*16 + [0, 8) and [8, 16), columns np*16 + [0, 8) and [8, 16)
          ldsm_x4_t(bv, vs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * L::LV +
                            np * 16 + ((lane >> 4) << 3));
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            mma_bf16(o[ms] + 8 * np, pa[ms], bv[0], bv[1]);
            mma_bf16(o[ms] + 8 * np + 4, pa[ms], bv[2], bv[3]);
          }
        }
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(vs) + 2 * t4;
#pragma unroll
      for (int ms = 0; ms < MS; ++ms)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 8; ++e) {  // key n*8 + e: element e & 1 of quad lane e / 2
            const int src = (lane & ~3) | (e >> 1);
            const float p0 = __shfl_sync(FULL, s[ms][4 * n + (e & 1)], src);
            const float p1 = __shfl_sync(FULL, s[ms][4 * n + 2 + (e & 1)], src);
            const float* vr = vf + (n * 8 + e) * L::LV;
#pragma unroll
            for (int c = 0; c < NO; ++c) {
              o[ms][4 * c] = fmaf(p0, vr[c * 8], o[ms][4 * c]);
              o[ms][4 * c + 1] = fmaf(p0, vr[c * 8 + 1], o[ms][4 * c + 1]);
              o[ms][4 * c + 2] = fmaf(p1, vr[c * 8], o[ms][4 * c + 2]);
              o[ms][4 * c + 3] = fmaf(p1, vr[c * 8 + 1], o[ms][4 * c + 3]);
            }
          }
    }
  }

  // 4. out = acc / max(l, 1e-30), the rows that exist
  T* ob = (T*)a.out + ((size_t)b * a.S * a.H + h) * a.dv;
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[ms][r];
      lr += __shfl_xor_sync(FULL, lr, 1);
      lr += __shfl_xor_sync(FULL, lr, 2);
      const int row = q0 + w0 + 16 * ms + g + 8 * r;
      if (row >= a.S) continue;
      const float den = fmaxf(lr, 1e-30f);
      T* orow = ob + (size_t)row * sv;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + 2 * t4;
        const float x0 = o[ms][4 * n + 2 * r] / den, x1 = o[ms][4 * n + 2 * r + 1] / den;
        if constexpr (MMA) {
          if (c + 1 < a.dv && !(a.dv & 1)) {  // a 4-byte aligned pair
            *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(x0, x1);
            continue;
          }
        }
        if (c < a.dv) orow[c] = from_f32<T>(x0);
        if (c + 1 < a.dv) orow[c + 1] = from_f32<T>(x1);
      }
    }
}

template <typename T, int HDP, int DVP, int BQ>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, HDP, DVP, BQ>::BYTES;
  if ((a.S + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = flash_attn_kernel<T, HDP, DVP, BQ>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B * a.H, (a.S + BQ - 1) / BQ), Cfg<T, HDP, DVP, BQ>::THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// 128 query rows a block when that still gives every SM a block: each
// staged K and V tile then serves twice the rows, which halves the L2
// traffic of the KV walk; else 64. The FMA path takes 64.
template <typename T, int HDP, int DVP>
int by_width(const Args& a, int B, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if ((long long)B * a.H * ((a.S + 127) / 128) >= SMS) return launch<T, HDP, DVP, 128>(a, B, s);
  }
  return launch<T, HDP, DVP, 64>(a, B, s);
}

// head widths padded to a multiple of 32 inside the block
template <typename T, int HDP>
int by_dv(const Args& a, int B, cudaStream_t s) {
  switch ((a.dv + 31) / 32) {
    case 1: return by_width<T, HDP, 32>(a, B, s);
    case 2: return by_width<T, HDP, 64>(a, B, s);
    case 3: return by_width<T, HDP, 96>(a, B, s);
    default: return by_width<T, HDP, 128>(a, B, s);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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
  const int V = is_bf16 ? 8 : 4;  // elements a 16-byte chunk
  const Args a{q, k, v, out, S, T, H, hd, dv, causal, hd % V == 0 && aligned16(q),
               hd % V == 0 && aligned16(k), dv % V == 0 && aligned16(v), scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) return by_dv<float, MAX_D>(a, B, s);  // FMA path: hd is a loop bound
  using bf16 = __nv_bfloat16;
  switch ((hd + 31) / 32) {
    case 1: return by_dv<bf16, 32>(a, B, s);
    case 2: return by_dv<bf16, 64>(a, B, s);
    case 3: return by_dv<bf16, 96>(a, B, s);
    default: return by_dv<bf16, 128>(a, B, s);
  }
}
