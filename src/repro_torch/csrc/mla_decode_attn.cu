// MLA latent decode attention for Hopper (sm_90a): absorbed flash-decoding
// over the paged latent pool (one KV "head" shared by every query head).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py:287
// (paged_mla_decode_attn_pallas, its _mla_kernel at :220), with and without
// the packed-FP4 frozen region. For batch row b, the query heads of one
// head group attend the tokens of pages page_table[b, 0..PP) up to
// kv_lens[b]: scores s[h, t] = (q_lat[h] . ckv[t] + q_rope[h] . krope[t]) *
// scale (k = concat(ckv, krope), never materialized), an online softmax in
// f32, and the context acc[h] = sum_t p[h, t] ckv[t] (v is the ckv view).
// FP8 codes are decoded by the integer exponent add of
// kernels/common.py::decode_fp8 (value * 2^-shift[page] built from the f32
// bit pattern; the latent has one shift per page, shift[pid, 0]), then one
// s_max[page] multiply: never through the hardware E4M3 type, which tops
// out at 448 and reads S.1111.111 as NaN where this grid's top code is 480.
//
// What bounds it on the H100: the latent read, (r + dr) bytes per token for
// FP8 pages (288 at MiniCPM3) against 2 * H * (r + dr) + 2 * H * r FLOPs per
// token, so bytes for the card (a few hundred FLOPs per byte is needed to
// be compute bound only at H in the hundreds); at serving batch sizes the
// kernel is latency bound too, with B * ceil(H / HG) blocks each walking its
// pages in sequence.
// What the design does about it: KV is one head shared by all H query
// heads, so a block takes a group of HG = 8 heads of one row and decodes
// each page once into shared memory for the whole group (ckv page x r and
// krope page x dr in f32: 73.7 KB at MiniCPM3, so the kernel opts into
// dynamic shared memory above 48 KB). The page loop takes the place of the
// Pallas innermost grid axis, whose m / l / acc scratch carried across grid
// steps; here per-head m, l and the (HG, r) accumulator live in shared
// memory for the block's whole walk. A page whose rows are a multiple of
// 16 bytes is staged with 16-byte loads, all of a thread's loads issued
// before any is used. Pages past kv_lens are never read, and positions at
// or past kv_lens inside a page never enter a sum: the mask is a bound on
// the loops, never a multiply by 0, so a stale NaN in a recycled or null
// page cannot leak (0 * NaN = NaN). Split-KV for small batches is not done
// yet: at B = 4 and H = 40 the launch has 20 blocks.
// The frozen region (FROZEN = true, behind FP8 active pages): page ids >=
// base = P + 1 address the half-width packed FP4 E2M1 store, row
// min(pid - base, nfz), with its own s_max and shift. The TPU kernel
// fetches both candidate pages through clamped index maps and selects per
// page; the id class is uniform within a page, so here a branch per page
// picks one store and reads only that one. The clamps of the plain version
// (min(pid, P) on the FP8 side, the dummy row nfz for ids past the region)
// are kept. Packed rows are ceil(d / 2) bytes, low nibble first: 128 bytes
// for r = 256, 16 for dr = 32; an odd width's pad nibble is never written.
// Instantiated for bf16 pages, FP8 pages and FP8 pages with the FP4 frozen
// region; bf16 queries only (the Python wrapper refuses the rest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HG = 8;          // query heads per block
constexpr int IN_FLIGHT = 8;   // global loads each thread issues before it uses one
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

enum Store { BF16 = 0, CODES8 = 1, PACKED4 = 2 };

// How one page's codes decode: each code times 2^-shift * smax.
struct PageDecode {
  Grid fmt;
  int shift;
  float smax;
  __device__ __forceinline__ float code(int c) const {
    return decode_code(c, shift, fmt) * smax;
  }
};

// Decode the bytes [byte, byte + n) of one row into dst[value index]:
// bf16 values (n even), one FP8 code per byte, or two FP4 codes per byte
// (low nibble first), skipping values at or past d (an odd packed width's pad).
template <Store KIND>
__device__ __forceinline__ void decode_bytes(const uint8_t* raw, int n, int byte, int d,
                                             float* dst, const PageDecode& f) {
  if (KIND == BF16) {
    for (int u = 0; u < n; u += 2) {
      const unsigned short bits = (unsigned short)(raw[u] | (raw[u + 1] << 8));
      dst[(byte + u) / 2] = __bfloat162float(__ushort_as_bfloat16(bits));
    }
  } else if (KIND == CODES8) {
    for (int u = 0; u < n; ++u) dst[byte + u] = f.code(raw[u]);
  } else {
    for (int u = 0; u < n; ++u) {
      const int v = 2 * (byte + u);
      dst[v] = f.code(raw[u] & 15);
      if (v + 1 < d) dst[v + 1] = f.code(raw[u] >> 4);
    }
  }
}

// Stage rows [0, rows) of one page (rows of rb bytes, contiguous) into
// dst[t * pitch + value], d values a row. Every load of a round is issued
// before any is decoded.
template <Store KIND>
__device__ void stage_page(const uint8_t* __restrict__ src, int rows, int rb, int d,
                           float* dst, int pitch, const PageDecode& f) {
  if (rb % 16 == 0 && ((uintptr_t)src & 15) == 0) {  // 16-byte loads
    const int per_row = rb / 16, n = rows * per_row;
    const uint4* s4 = (const uint4*)src;
    for (int i0 = threadIdx.x; i0 < n; i0 += IN_FLIGHT * THREADS) {
      uint4 raw[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n) raw[u] = s4[i];
      }
#pragma unroll 1
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n)
          decode_bytes<KIND>((const uint8_t*)&raw[u], 16, 16 * (i % per_row), d,
                             dst + (i / per_row) * pitch, f);
      }
    }
    return;
  }
  const int step = KIND == BF16 ? 2 : 1;  // one value's bytes, or one packed byte
  const int per_row = rb / step, n = rows * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += IN_FLIGHT * THREADS) {
    uint8_t raw[IN_FLIGHT][2];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) {
        const uint8_t* p = src + (size_t)(i / per_row) * rb + step * (i % per_row);
        raw[u][0] = p[0];
        raw[u][1] = step == 2 ? p[1] : 0;
      }
    }
#pragma unroll 1
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n)
        decode_bytes<KIND>(raw[u], step, step * (i % per_row), d, dst + (i / per_row) * pitch,
                           f);
    }
  }
}

struct Pages {  // one store of the latent pool: ckv and krope
  const uint8_t *ckv, *krope;        // (n + 1, page, row bytes)
  const float *ckv_smax, *krope_smax;  // (n + 1,)
  const int *ckv_shift, *krope_shift;  // (n + 1, 1)
  Grid fmt;
  int rb_c, rb_r;                    // row bytes of ckv and krope
};

// Rows [0, rows) of page ``row`` of one store: ckv into cs, krope into ks.
template <Store KIND>
__device__ __forceinline__ void stage_latents(const Pages& st, int row, int rows, int page,
                                              int r, int dr, float* cs, int cp, float* ks,
                                              int rp) {
  const bool codes = KIND != BF16;
  const PageDecode fc{st.fmt, codes ? st.ckv_shift[row] : 0, codes ? st.ckv_smax[row] : 1.f};
  const PageDecode fr{st.fmt, codes ? st.krope_shift[row] : 0,
                      codes ? st.krope_smax[row] : 1.f};
  stage_page<KIND>(st.ckv + (size_t)row * page * st.rb_c, rows, st.rb_c, r, cs, cp, fc);
  stage_page<KIND>(st.krope + (size_t)row * page * st.rb_r, rows, st.rb_r, dr, ks, rp, fr);
}

template <bool FP8, bool FROZEN>
__global__ void __launch_bounds__(THREADS)
mla_decode_attn_kernel(const __nv_bfloat16* __restrict__ q_lat,
                       const __nv_bfloat16* __restrict__ q_rope, Pages act, Pages fz,
                       const int* __restrict__ page_table, const int* __restrict__ kv_lens,
                       float* __restrict__ out, int H, int r, int dr, int page, int PP,
                       float scale, int base, int nfz) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h0 = blockIdx.y * HG, g = min(HG, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = THREADS / 32;
  const int cp = r + 1, rp = dr + 1;  // pitches: the score loop reads a column
                                      // across threads, a stride of r would hit one bank
  float* ql = smem;                   // (g, r)
  float* qr = ql + HG * r;            // (g, dr)
  float* cs = qr + HG * dr;           // (page, cp) decoded ckv
  float* ks = cs + page * cp;         // (page, rp) decoded krope
  float* ps = ks + page * rp;         // (g, page) scores, then probabilities
  float* acc = ps + HG * page;        // (g, r)
  float* m_run = acc + HG * r;        // (g,)
  float* l_run = m_run + HG;          // (g,)
  float* corr = l_run + HG;           // (g,)

  for (int i = tid; i < g * r; i += THREADS) {
    ql[i] = __bfloat162float(q_lat[((size_t)b * H + h0) * r + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g * dr; i += THREADS)
    qr[i] = __bfloat162float(q_rope[((size_t)b * H + h0) * dr + i]);
  for (int i = tid; i < g; i += THREADS) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  const int len = kv_lens[b];
  __syncthreads();

  for (int j = 0; j < PP; ++j) {
    const int t_hi = min(page, len - j * page);  // valid positions of this page: [0, t_hi)
    if (t_hi <= 0) break;
    const int pid = page_table[(size_t)b * PP + j];
    // the reference's clamps: frozen ids past the region read the dummy
    // row, FP8 ids past the active store the null page
    if (FROZEN && pid >= base)
      stage_latents<PACKED4>(fz, min(pid - base, nfz), t_hi, page, r, dr, cs, cp, ks, rp);
    else
      stage_latents<FP8 ? CODES8 : BF16>(act, FROZEN ? min(pid, base - 1) : pid, t_hi, page,
                                         r, dr, cs, cp, ks, rp);
    __syncthreads();

    // scores of the valid positions: k = concat(ckv, krope)
    for (int i = tid; i < g * page; i += THREADS) {
      const int gi = i / page, t = i % page;
      if (t >= t_hi) continue;
      float s = 0.f, s2 = 0.f;
      for (int c = 0; c < r; ++c) s += ql[gi * r + c] * cs[t * cp + c];
      for (int c = 0; c < dr; ++c) s2 += qr[gi * dr + c] * ks[t * rp + c];
      ps[i] = (s + s2) * scale;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int gi = warp; gi < g; gi += nwarps) {
      float mx = NEG;
      for (int t = lane; t < t_hi; t += 32) mx = fmaxf(mx, ps[gi * page + t]);
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[gi], mx);
      float sum = 0.f;
      for (int t = lane; t < t_hi; t += 32) {
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

    // v is the ckv view: the attention-weighted latent is the context
    for (int i = tid; i < g * r; i += THREADS) {
      const int gi = i / r, c = i % r;
      float a = acc[i] * corr[gi];
      for (int t = 0; t < t_hi; ++t) a += ps[gi * page + t] * cs[t * cp + c];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * r; i += THREADS)
    out[((size_t)b * H + h0) * r + i] = acc[i] / fmaxf(l_run[i / r], 1e-30f);
}

template <bool FP8, bool FROZEN>
int launch(const void* q_lat, const void* q_rope, const Pages& act, const Pages& fz,
           const void* page_table, const void* kv_lens, void* out, int B, int H, int r,
           int dr, int page, int PP, float scale, int base, int nfz, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ((size_t)HG * (r + dr) + (size_t)page * (r + 1) +
                                        (size_t)page * (dr + 1) + (size_t)HG * page +
                                        (size_t)HG * r + 3 * HG);
  auto kernel = mla_decode_attn_kernel<FP8, FROZEN>;
  if (bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, (H + HG - 1) / HG), THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)q_lat, (const __nv_bfloat16*)q_rope, act, fz,
      (const int*)page_table, (const int*)kv_lens, (float*)out, H, r, dr, page, PP, scale,
      base, nfz);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat: (B, H, r) bf16; q_rope: (B, H, dr) bf16; ckv: (P+1, page, r) and
// krope: (P+1, page, dr), uint8 FP8 codes (fp8 = 1, grid exp_bits /
// man_bits / bias) or bf16; ckv/krope_smax (P+1,) f32 and ckv/krope_shift
// (P+1, 1) int32 (read only for fp8 pages); page_table (B, PP) int32;
// kv_lens (B,) int32; out (B, H, r) f32. frozen = 1 (fp8 pages only):
// ckv/krope_fz (nfz+1, page, ceil(d/2)) packed codes of the grid (fz_*),
// their smax (nfz+1,) f32 and shift (nfz+1, 1) int32; table ids >= P+1
// address them. Every operand is contiguous. Returns cudaGetLastError().
extern "C" int mla_decode_attn_launch(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope, int fp8,
    const void* ckv_smax, const void* ckv_shift, const void* krope_smax,
    const void* krope_shift, const void* page_table, const void* kv_lens, void* out, int B,
    int H, int r, int dr, int page, int PP, float scale, int exp_bits, int man_bits, int bias,
    int frozen, const void* ckv_fz, const void* krope_fz, const void* ckv_fz_smax,
    const void* ckv_fz_shift, const void* krope_fz_smax, const void* krope_fz_shift,
    int n_pages1, int nfz, int fz_exp_bits, int fz_man_bits, int fz_bias, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (r <= 0 || dr <= 0 || page <= 0 || (frozen && (!fp8 || nfz < 0)))
    return (int)cudaErrorInvalidValue;
  const int es = fp8 ? 1 : 2;
  const Pages act{(const uint8_t*)ckv, (const uint8_t*)krope, (const float*)ckv_smax,
                  (const float*)krope_smax, (const int*)ckv_shift, (const int*)krope_shift,
                  Grid{exp_bits, man_bits, bias}, r * es, dr * es};
  const Pages fz{(const uint8_t*)ckv_fz, (const uint8_t*)krope_fz, (const float*)ckv_fz_smax,
                 (const float*)krope_fz_smax, (const int*)ckv_fz_shift,
                 (const int*)krope_fz_shift, Grid{fz_exp_bits, fz_man_bits, fz_bias},
                 (r + 1) / 2, (dr + 1) / 2};
  cudaStream_t s = (cudaStream_t)stream;
  auto run = frozen ? &launch<true, true> : fp8 ? &launch<true, false> : &launch<false, false>;
  return run(q_lat, q_rope, act, fz, page_table, kv_lens, out, B, H, r, dr, page, PP, scale,
             n_pages1, nfz, s);
}
