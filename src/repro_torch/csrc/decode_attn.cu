// Paged decode attention for Hopper (sm_90a): GQA flash-decoding over the
// paged FP8 (or bf16) KV pool.
//
// Replaces the TPU kernel repro/kernels/decode_attn.py:131
// (paged_decode_attn_pallas), with and without the packed-FP4 frozen region
// (its `frozen` branch, :86-100). For batch row b and KV head h, the g = H / KV query heads of
// the group attend the tokens of pages page_table[b, 0..PP) up to
// kv_lens[b] (and inside the sliding window when window > 0). FP8 codes are
// decoded by the integer exponent add of kernels/common.py::decode_fp8
// (value * 2^-shift[page, head] built from the f32 bit pattern), then one
// s_max[page] multiply: never through the hardware E4M3 type, which tops
// out at 448 and reads S.1111.111 as NaN where this grid's top code is 480.
//
// What bounds it on the H100: the KV read — 2 * ctx * hd bytes per (row,
// KV head) for FP8 pages — against a few FLOPs per byte, so bytes; at
// serving batch sizes the kernel is also latency bound, with B * KV blocks
// each walking its pages in sequence.
// What the design does about it: one block per (row, KV head) loads its own
// page ids and walks the pages in a loop (the loop takes the place of the
// Pallas innermost grid axis, whose m / l / acc scratch carried across
// grid steps; here they live in shared memory for the whole walk). Pages
// are decoded straight into shared memory; no dequantized cache ever
// exists in device memory. Pages past kv_lens, or wholly before the window,
// are skipped, and masked positions inside a page are never read into the
// sums: the mask is a select, never a multiply by 0, so a stale NaN in a
// recycled or null page cannot leak (0 * NaN = NaN).
// The frozen region (FROZEN = true, behind FP8 active pages): page ids >=
// base = P + 1 address the half-width packed FP4 E2M1 store, row
// min(pid - base, nfz), with its own s_max and shifts. The TPU kernel
// fetches both candidate pages through clamped index maps and selects per
// page; here the id class is uniform within a page, so a plain branch per
// page picks one store and reads only that one (no divergence inside a
// warp). The clamps of the plain version (min(pid, P) for the FP8 store,
// the dummy row nfz for ids past the region) are kept, so the kernel equals
// it on every table. FP4 rows are ceil(hd / 2) bytes per (token, head), low
// nibble first (core/formats.pack_nibbles); each byte is loaded once and
// both nibbles are decoded by the same integer exponent add, E2M1's
// subnormal (exponent field 0 -> 0.5 * m) included.
// Only what the serving path runs is compiled: bf16 queries, and K and V
// of one head width (the Python wrapper refuses the rest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

struct Grid {  // an ExMy code grid: FP8 E4M3 pages, FP4 E2M1 frozen pages
  int exp_bits, man_bits, bias;
};

__device__ __forceinline__ float pow2i(int k) {
  k = max(-126, min(127, k));
  return __int_as_float((k + 127) << 23);
}

__device__ __forceinline__ float decode_code(int code, int shift, const Grid& f) {
  const int man = code & ((1 << f.man_bits) - 1);
  const int ef = (code >> f.man_bits) & ((1 << f.exp_bits) - 1);
  const float manf = (float)man * pow2i(-f.man_bits);
  const float val = ef == 0 ? pow2i(1 - f.bias - shift) * manf
                            : pow2i(ef - f.bias - shift) * (1.f + manf);
  return (code >> (f.exp_bits + f.man_bits)) & 1 ? -val : val;
}

struct CodeDecode {  // one page's codes (FP8 bytes or FP4 nibbles) of one head -> values
  Grid fmt;
  int shift;
  float smax;
  __device__ float operator()(int c) const { return decode_code(c, shift, fmt) * smax; }
};

struct Bf16Decode {
  __device__ float operator()(__nv_bfloat16 v) const { return __bfloat162float(v); }
};

constexpr int IN_FLIGHT = 8;  // global loads each thread issues before it uses one

// dst[t * pitch + d] = f(src[t * stride + d]) for t < rows, d < width.
template <typename TS, typename F>
__device__ __forceinline__ void stage_rows(const TS* __restrict__ src, size_t stride, int rows,
                                           int width, float* dst, int pitch, F f) {
  const int n = rows * width;
  for (int i0 = threadIdx.x; i0 < n; i0 += IN_FLIGHT * THREADS) {
    TS raw[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) raw[u] = src[(size_t)(i / width) * stride + i % width];
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) dst[(i / width) * pitch + i % width] = f(raw[u]);
    }
  }
}

// Packed FP4 rows: dst[t * pitch + d] = f(nibble d of src row t), for
// t < rows, d < hd; a row holds ceil(hd / 2) bytes, nibble 2c in the low
// half of byte c. Each thread loads whole bytes and decodes both nibbles.
template <typename F>
__device__ __forceinline__ void stage_rows_fp4(const uint8_t* __restrict__ src, size_t stride,
                                               int rows, int hd, float* dst, int pitch, F f) {
  const int wb = (hd + 1) >> 1, n = rows * wb;
  for (int i0 = threadIdx.x; i0 < n; i0 += IN_FLIGHT * THREADS) {
    uint8_t raw[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) raw[u] = src[(size_t)(i / wb) * stride + i % wb];
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= n) continue;
      float* row = dst + (i / wb) * pitch;
      const int d = 2 * (i % wb);
      row[d] = f(raw[u] & 15);
      if (d + 1 < hd) row[d + 1] = f(raw[u] >> 4);
    }
  }
}

struct Frozen {                  // the packed FP4 region of a mixed-precision pool
  const uint8_t *k, *v;          // (nfz + 1, page, KV, ceil(hd / 2))
  const float *k_smax, *v_smax;  // (nfz + 1,)
  const int *k_shift, *v_shift;  // (nfz + 1, KV)
  int base, nfz;                 // first frozen logical id (P + 1); the dummy row
  Grid fmt;
};

template <bool FP8, bool FROZEN>
__global__ void __launch_bounds__(THREADS)
paged_decode_attn_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
                         const void* __restrict__ v_pages, const float* __restrict__ k_smax,
                         const int* __restrict__ k_shift, const float* __restrict__ v_smax,
                         const int* __restrict__ v_shift, const int* __restrict__ page_table,
                         const int* __restrict__ kv_lens, float* __restrict__ out, int H,
                         int KV, int hd, int page, int PP, int window, float scale,
                         Grid fmt, Frozen fz) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, g = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = THREADS / 32;
  const int kp = hd + 1;         // K pitch: the score loop reads a column of K
                                 // across threads, a stride of hd would hit one bank
  float* qs = smem;              // (g, hd)
  float* ks = qs + g * hd;       // (page, kp)
  float* vs = ks + page * kp;    // (page, hd)
  float* ps = vs + page * hd;    // (g, page) scores, then probabilities
  float* acc = ps + g * page;    // (g, hd)
  float* m_run = acc + g * hd;   // (g,)
  float* l_run = m_run + g;      // (g,)
  float* corr = l_run + g;       // (g,)

  for (int i = tid; i < g * hd; i += THREADS)
    qs[i] = __bfloat162float(q[((size_t)b * H + h * g) * hd + i]);
  for (int i = tid; i < g * hd; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < g; i += THREADS) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  const int len = kv_lens[b];
  __syncthreads();

  for (int j = 0; j < PP; ++j) {
    const int start = j * page;
    // valid positions of this page: [start + t_lo, start + t_hi)
    const int t_hi = min(page, len - start);
    const int t_lo = window ? max(0, len - window - start) : 0;
    if (t_hi <= 0) break;
    if (t_lo >= t_hi) continue;
    const int pid = page_table[(size_t)b * PP + j];

    // decode rows [0, t_hi) of this page's K / V for head h into shared memory
    const size_t stride = (size_t)KV;
    if (FROZEN && pid >= fz.base) {  // a frozen page: the packed FP4 store
      const int f = min(pid - fz.base, fz.nfz);
      const int wb = (hd + 1) >> 1;
      const size_t row0 = (size_t)f * page * KV + h;
      const CodeDecode kf{fz.fmt, fz.k_shift[(size_t)f * KV + h], fz.k_smax[f]};
      const CodeDecode vf{fz.fmt, fz.v_shift[(size_t)f * KV + h], fz.v_smax[f]};
      stage_rows_fp4(fz.k + row0 * wb, stride * wb, t_hi, hd, ks, kp, kf);
      stage_rows_fp4(fz.v + row0 * wb, stride * wb, t_hi, hd, vs, hd, vf);
    } else if (FP8) {
      const int a = FROZEN ? min(pid, fz.base - 1) : pid;
      const size_t row0 = (size_t)a * page * KV + h;
      const CodeDecode kf{fmt, k_shift[(size_t)a * KV + h], k_smax[a]};
      const CodeDecode vf{fmt, v_shift[(size_t)a * KV + h], v_smax[a]};
      stage_rows((const uint8_t*)k_pages + row0 * hd, stride * hd, t_hi, hd, ks, kp, kf);
      stage_rows((const uint8_t*)v_pages + row0 * hd, stride * hd, t_hi, hd, vs, hd, vf);
    } else {
      const size_t row0 = (size_t)pid * page * KV + h;
      stage_rows((const __nv_bfloat16*)k_pages + row0 * hd, stride * hd, t_hi, hd, ks, kp,
                 Bf16Decode{});
      stage_rows((const __nv_bfloat16*)v_pages + row0 * hd, stride * hd, t_hi, hd, vs, hd,
                 Bf16Decode{});
    }
    __syncthreads();

    // scores of the valid positions
    for (int i = tid; i < g * page; i += THREADS) {
      const int gi = i / page, t = i % page;
      if (t < t_lo || t >= t_hi) continue;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qs[gi * hd + d] * ks[t * kp + d];
      ps[i] = s * scale;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int gi = warp; gi < g; gi += nwarps) {
      float mx = NEG;
      for (int t = t_lo + lane; t < t_hi; t += 32) mx = fmaxf(mx, ps[gi * page + t]);
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[gi], mx);
      float sum = 0.f;
      for (int t = t_lo + lane; t < t_hi; t += 32) {
        const float p = expf(ps[gi * page + t] - m_new);
        ps[gi * page + t] = p;
        sum += p;
      }
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_run[gi] - m_new);
        corr[gi] = c;
        l_run[gi] = l_run[gi] * c + sum;
        m_run[gi] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * hd; i += THREADS) {
      const int gi = i / hd, d = i % hd;
      float a = acc[i] * corr[gi];
      for (int t = t_lo; t < t_hi; ++t) a += ps[gi * page + t] * vs[t * hd + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * hd; i += THREADS) {
    const int gi = i / hd;
    out[((size_t)b * H + h * g) * hd + i] = acc[i] / fmaxf(l_run[gi], 1e-30f);
  }
}

template <bool FP8, bool FROZEN>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_smax,
           const void* k_shift, const void* v_smax, const void* v_shift,
           const void* page_table, const void* kv_lens, void* out, int B, int H, int KV,
           int hd, int page, int PP, int window, float scale, Grid fmt, Frozen fz,
           cudaStream_t stream) {
  const int g = H / KV;
  const size_t bytes =
      sizeof(float) * ((size_t)g * hd + (size_t)page * (2 * hd + 1) + (size_t)g * page +
                       (size_t)g * hd + 3 * (size_t)g);
  auto kernel = paged_decode_attn_kernel<FP8, FROZEN>;
  if (bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, KV), THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q, k_pages, v_pages, (const float*)k_smax, (const int*)k_shift,
      (const float*)v_smax, (const int*)v_shift, (const int*)page_table, (const int*)kv_lens,
      (float*)out, H, KV, hd, page, PP, window, scale, fmt, fz);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, hd) bf16; k/v_pages: (P+1, page, KV, hd) uint8 codes (fp8 = 1)
// or bf16; k/v_smax: (P+1,) f32 and k/v_shift: (P+1, KV) int32 (read only
// for fp8 pages); page_table: (B, PP) int32; kv_lens: (B,) int32;
// out: (B, H, hd) f32. frozen = 1 (fp8 pages only): k/v_fz (nfz+1, page, KV,
// ceil(hd/2)) packed codes of the grid (fz_exp_bits, fz_man_bits, fz_bias),
// k/v_fz_smax (nfz+1,) f32, k/v_fz_shift (nfz+1, KV) int32; table ids >=
// P+1 address them. Returns cudaGetLastError().
extern "C" int paged_decode_attn_launch(const void* q, const void* k_pages,
                                        const void* v_pages, int fp8, const void* k_smax,
                                        const void* k_shift, const void* v_smax,
                                        const void* v_shift, const void* page_table,
                                        const void* kv_lens, void* out, int B, int H, int KV,
                                        int hd, int page, int PP, int window, float scale,
                                        int exp_bits, int man_bits, int bias, int frozen,
                                        const void* k_fz, const void* v_fz,
                                        const void* k_fz_smax, const void* k_fz_shift,
                                        const void* v_fz_smax, const void* v_fz_shift,
                                        int n_pages1, int nfz, int fz_exp_bits,
                                        int fz_man_bits, int fz_bias, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV || (frozen && (!fp8 || nfz < 0))) return (int)cudaErrorInvalidValue;
  const Grid fmt{exp_bits, man_bits, bias};
  const Frozen fz{(const uint8_t*)k_fz, (const uint8_t*)v_fz, (const float*)k_fz_smax,
                  (const float*)v_fz_smax, (const int*)k_fz_shift, (const int*)v_fz_shift,
                  n_pages1, nfz, Grid{fz_exp_bits, fz_man_bits, fz_bias}};
  cudaStream_t s = (cudaStream_t)stream;
  auto run = frozen ? &launch<true, true> : fp8 ? &launch<true, false> : &launch<false, false>;
  return run(q, k_pages, v_pages, k_smax, k_shift, v_smax, v_shift, page_table, kv_lens, out,
             B, H, KV, hd, page, PP, window, scale, fmt, fz, s);
}
