// Paged decode attention for Hopper (sm_90a): GQA split-KV (flash-decoding)
// over the paged FP8 (or bf16) KV pool.
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
// (`Placed` below folds the two into one multiply of the placed code
// bits, bit-identical where it is taken.)
//
// What bounds it on the H100: the KV read is 2 * ctx * hd bytes a (row, KV
// head) at ~4 f32 operations a byte, so bytes; but a decode step at 4 rows
// reads 1-20 MB, 0.3-6 us at 3.35 TB/s, so a launch lasts as long as its
// longest block's chain of dependent steps (global round trips, barriers,
// serial per-token work) plus the instructions of decoding every element.
// A block per (row, KV head) walking its row's pages one after another
// (the design this replaces) made that chain as long as the longest row.
// What the design does about it:
//  * The page walk is split. A block takes `pps` pages of one (row, KV
//    head, group of G query heads); the launch plan
//    (kernels/decode_attn.py::decode_attn_plan) picks pps from the shapes
//    alone, so a step's launch depends on no host read of kv_lens, and at
//    a decode step every page of the launch is read by blocks that are
//    resident at once. A split wholly past kv_lens[b], or wholly before the
//    window, exits at once.
//  * Two dependent round trips a block: the page ids (read while kv_lens is
//    read: they do not depend on it), then every valid row of every page of
//    the split, all issued as 16-byte cp.async copies into shared memory
//    before any is waited for. Rows past kv_lens or outside the window are
//    never copied, so a stale NaN in a recycled or null page is never read.
//  * Decode in registers, on all threads: a lane owns 16 dims of a token
//    row (one 16-byte FP8 vector, 8 bytes of FP4 with both nibbles of each
//    byte decoded, or 32 bytes of bf16), each code in four instructions
//    (shift, shift, mask, multiply: `Placed`); L = hd / 16 lanes hold a token,
//    128 / L tokens are in flight at once, and the L lanes sum the score by
//    shuffles. Each lane group keeps its own online softmax (m, l, acc) over
//    its tokens for the G query heads of the block, which share every
//    decoded K and V element; the groups merge by shuffles, the 4 warps
//    through shared memory, in a fixed order. hd 64 and 128 are template
//    widths; any other width takes the generic path (byte copies, the
//    lane's dims guarded), as does a page store not aligned to 16 bytes.
//  * The splits' (m, l, acc) go to a workspace the wrapper allocates; a
//    second kernel of the same call (split_combine.cuh) sums them in
//    split order: weight exp(m - M), then acc / max(l, 1e-30). No
//    atomics: repeated launches are bit-identical. A split that holds no valid token is never read;
//    a row with none returns 0, as the plain version does. The combine is
//    a programmatic dependent launch: its blocks start once every split
//    block has, read kv_lens, and wait for the split kernel only before
//    they read the workspace.
// Masks are selects (a masked token is skipped, never multiplied by 0).
// The frozen region (FROZEN, behind FP8 active pages): page ids >= base =
// P + 1 address the half-width packed FP4 E2M1 store, row min(pid - base,
// nfz), with its own s_max and shifts; other ids read the FP8 store at
// min(pid, P), the clamps of the plain version. The TPU kernel fetches
// both candidate pages and selects per page; here the id class is uniform
// within a page, so a branch per page reads only the store that holds it.
// FP4 rows are ceil(hd / 2) bytes per (token, head), low nibble first
// (core/formats.pack_nibbles); E2M1's subnormal (exponent field 0 ->
// 0.5 * m) is decoded by the same integer exponent add.
// Only what the serving path runs is compiled: bf16 queries, and K and V
// of one head width (the Python wrapper refuses the rest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_combine.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DL = 16;  // head dims a lane owns
constexpr float NEG = -1e30f;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into

enum Store { BF16 = 0, FP8 = 1, FROZEN = 2 };  // FROZEN: FP8 pages + the FP4 region

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

struct Frozen {                  // the packed FP4 region of a mixed-precision pool
  const uint8_t *k, *v;          // (nfz + 1, page, KV, ceil(hd / 2))
  const float *k_smax, *v_smax;  // (nfz + 1,)
  const int *k_shift, *v_shift;  // (nfz + 1, KV)
  int base, nfz;                 // first frozen logical id (P + 1); the dummy row
  Grid fmt;
};

struct Args {
  const __nv_bfloat16* q;        // (B, H, hd)
  const uint8_t *k, *v;          // (P + 1, page, KV, hd) codes or bf16
  const float *k_smax, *v_smax;  // (P + 1,)
  const int *k_shift, *v_shift;  // (P + 1, KV)
  const int *table, *lens;       // (B, PP), (B,)
  float *part_ml, *part_acc;     // (B, H, splits, 2) m and l; (B, H, splits, hd) acc
  int H, KV, hd, page, PP, window;
  int pps, splits, lanes;        // pages a split, splits a row, lanes a token (generic path)
  float scale;
  Grid fmt;
  Frozen fz;
};

struct Page {            // one page of a split, as its block stages it
  const uint8_t *k, *v;  // row 0 of head h in the store that holds the page
  float ksm, vsm;
  int ksh, vsh, fp4;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// A split block's shared memory: Page[pps] | the warps' merge (WARPS * G *
// (hd + 2) floats) | the staged rows (pps pages, K then V, page rows of rmax bytes).
struct Layout {
  size_t red, stage, bytes;
  __host__ __device__ Layout(int pps, int G, int hd, int page, int rmax) {
    red = align16(sizeof(Page) * pps);
    stage = align16(red + sizeof(float) * WARPS * G * (hd + 2));
    bytes = stage + (size_t)pps * 2 * page * rmax;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, rows) of one page and head (R bytes each, `stride` bytes apart in
// the store) into shared rows of rmax bytes: 16-byte cp.async copies (VPR a
// row) on the template widths, byte copies on the generic path.
template <int LT, int VPR>
__device__ __forceinline__ void stage_rows(uint8_t* dst, const uint8_t* src, size_t stride,
                                           int rows, int R, int rmax) {
  if constexpr (LT != 0) {
    const int n = rows * VPR;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int r = i / VPR, c = i % VPR;
      cp_async16(dst + (size_t)r * rmax + c * 16, src + r * stride + c * 16);
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += WARPS)
      for (int c = lane; c < R; c += 32) dst[(size_t)r * rmax + c] = src[r * stride + c];
  }
}

// A page's codes decoded by bit placement: the code's sign goes to bit 31
// and its exponent and mantissa fields to just below bit 23 (the mantissa's
// top bit at 22), which reads as 2^(127 - bias) times decode_code's value
// (its subnormals as f32 subnormals, which the non-FTZ multiply keeps
// exact); one multiply by c = 2^(127 - bias - shift) * s_max then rounds
// the same real product as decode_code(code, shift) * s_max. Exact, so
// taken only where decode_code's pow2i does not clamp and c is a normal
// product (or 0); a NaN or extreme s_max or shift takes decode_code.
struct Placed {
  float c;
  int sh, mask;  // arithmetic shift from the top of an int; sign | fields
  bool fast;
  __device__ Placed(const Grid& f, int shift, float smax) {
    const int k = 127 - f.bias - shift;
    fast = 1 - f.bias - shift >= -126 && (1 << f.exp_bits) - 1 - f.bias - shift <= 127 &&
           k >= -126 && k <= 127;
    c = fast ? __int_as_float((k + 127) << 23) * smax : 0.f;
    fast = fast && (c == 0.f || (fabsf(c) >= 1.17549435e-38f && fabsf(c) <= 3.40282347e38f));
    sh = 8 - f.exp_bits;
    mask = (int)(0x80000000u | (((1u << (f.exp_bits + f.man_bits)) - 1) << (23 - f.man_bits)));
  }
  // top: the code in the top bits of an int
  __device__ __forceinline__ float operator()(int top) const {
    return __int_as_float((top >> sh) & mask) * c;
  }
};

// The lane's dims [d0, d0 + 16) of one staged row, decoded (0 past hd).
template <bool VEC>
struct Fp8Dims {
  int shift, hd;
  float smax;
  Grid f;
  Placed pl;
  __device__ Fp8Dims(int shift_, int hd_, float smax_, const Grid& f_)
      : shift(shift_), hd(hd_), smax(smax_), f(f_), pl(f_, shift_, smax_) {}
  __device__ __forceinline__ void operator()(const uint8_t* row, int d0, float (&x)[DL]) const {
    if constexpr (VEC) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + d0);
      const unsigned ws[4] = {w.x, w.y, w.z, w.w};
      if (pl.fast) {
#pragma unroll
        for (int e = 0; e < DL; ++e) x[e] = pl((int)(ws[e >> 2] << (24 - 8 * (e & 3))));
      } else {
#pragma unroll
        for (int e = 0; e < DL; ++e)
          x[e] = decode_code((ws[e >> 2] >> (8 * (e & 3))) & 0xff, shift, f) * smax;
      }
    } else {
#pragma unroll
      for (int e = 0; e < DL; ++e)
        x[e] = d0 + e >= hd ? 0.f
               : pl.fast    ? pl((int)((unsigned)row[d0 + e] << 24))
                            : decode_code(row[d0 + e], shift, f) * smax;
    }
  }
};

template <bool VEC>
struct Fp4Dims {  // packed rows: dim d is nibble d & 1 of byte d / 2, low first
  int shift, hd;
  float smax;
  Grid f;
  Placed pl;
  __device__ Fp4Dims(int shift_, int hd_, float smax_, const Grid& f_)
      : shift(shift_), hd(hd_), smax(smax_), f(f_), pl(f_, shift_, smax_) {}
  __device__ __forceinline__ void operator()(const uint8_t* row, int d0, float (&x)[DL]) const {
    if constexpr (VEC) {
      const uint2 w = *reinterpret_cast<const uint2*>(row + (d0 >> 1));
      const unsigned ws[2] = {w.x, w.y};
      if (pl.fast) {  // nibble e of the lane's 16 is bits [4 (e % 8), + 4) of word e / 8
#pragma unroll
        for (int e = 0; e < DL; ++e) x[e] = pl((int)(ws[e >> 3] << (28 - 4 * (e & 7))));
      } else {
#pragma unroll
        for (int e = 0; e < DL; ++e)
          x[e] = decode_code((ws[e >> 3] >> (4 * (e & 7))) & 15, shift, f) * smax;
      }
    } else {
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        const int d = d0 + e;
        const int code = d < hd ? (d & 1 ? row[d >> 1] >> 4 : row[d >> 1] & 15) : 0;
        x[e] = d >= hd  ? 0.f
               : pl.fast ? pl((int)((unsigned)code << 28))
                         : decode_code(code, shift, f) * smax;
      }
    }
  }
};

template <bool VEC>
struct Bf16Dims {
  int hd;
  __device__ __forceinline__ void operator()(const uint8_t* row, int d0, float (&x)[DL]) const {
    if constexpr (VEC) {
      const uint4* p = reinterpret_cast<const uint4*>(row + 2 * d0);
      const uint4 a = p[0], b = p[1];
      const unsigned ws[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < DL; ++e)
        x[e] = __uint_as_float(e & 1 ? ws[e >> 1] & 0xffff0000u : ws[e >> 1] << 16);
    } else {
      const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(row);
#pragma unroll
      for (int e = 0; e < DL; ++e) x[e] = d0 + e < hd ? __bfloat162float(r[d0 + e]) : 0.f;
    }
  }
};

// The staged tokens [ua, ub) of one page into the lane group's online
// softmax. Every lane of a warp runs the same trips (the shuffles need
// them); a lane group past ub reads nothing and updates nothing.
template <int G, typename KD, typename VD>
__device__ __forceinline__ void attend(const uint8_t* kb, const uint8_t* vb, int rmax, int ua,
                                       int ub, int slot, int ns, int L, int d0, float scale,
                                       const KD& kd, const VD& vd, const float (&qv)[G][DL],
                                       float (&m)[G], float (&l)[G], float (&acc)[G][DL]) {
  for (int u0 = ua; u0 < ub; u0 += ns) {
    const int u = u0 + slot;
    const bool live = u < ub;
    float x[DL];
    if (live) {
      kd(kb + (size_t)u * rmax, d0, x);
    } else {
#pragma unroll
      for (int e = 0; e < DL; ++e) x[e] = 0.f;
    }
    float sc[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) s += qv[gi][e] * x[e];
      sc[gi] = s;
    }
    for (int o = L >> 1; o; o >>= 1) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi) sc[gi] += __shfl_xor_sync(0xffffffffu, sc[gi], o);
    }
    if (live) {
      vd(vb + (size_t)u * rmax, d0, x);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float z = sc[gi] * scale;
        const float mn = fmaxf(m[gi], z);
        const float c = expf(m[gi] - mn), p = expf(z - mn);
        l[gi] = l[gi] * c + p;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[gi][e] = acc[gi][e] * c + p * x[e];
        m[gi] = mn;
      }
    }
  }
}

// One split of one (row b, KV head h, group of G query heads): its (m, l,
// acc) into the workspace. LT: lanes a token on the template widths (hd =
// 16 LT), 0 for the generic path.
template <int LT, int G, int STORE>
__global__ void __launch_bounds__(THREADS) gqa_decode_split_kernel(const Args a) {
  constexpr bool VEC = LT != 0;
  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may start its prologue
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int chunks = gridDim.y / a.KV;  // groups of G query heads a KV head
  const int h = blockIdx.y / chunks, chunk = blockIdx.y - h * chunks;
  const int head0 = h * (a.H / a.KV) + chunk * G;
  const int j0 = s * a.pps, jn = min(a.pps, a.PP - j0);
  int pid = 0;
  if (tid < jn) pid = a.table[(size_t)b * a.PP + j0 + tid];  // beside kv_lens, not after it
  const int len = a.lens[b];
  const int span = a.pps * a.page, lenc = min(len, a.PP * a.page);
  const int lo = a.window ? max(0, len - a.window) : 0;
  const int t0 = max(s * span, lo), t1 = min(s * span + span, lenc);
  if (t0 >= t1) return;  // no valid token in this split

  const int L = VEC ? LT : a.lanes, ns = THREADS / L;
  const int slot = tid / L, sub = tid % L, d0 = sub * DL;
  float qv[G][DL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const __nv_bfloat16* qr = a.q + ((size_t)b * a.H + head0 + gi) * a.hd;
#pragma unroll
    for (int e = 0; e < DL; ++e)
      qv[gi][e] = (VEC || d0 + e < a.hd) ? __bfloat162float(qr[d0 + e]) : 0.f;
  }

  const int rmax = STORE == BF16 ? 2 * a.hd : a.hd;
  const Layout lay(a.pps, G, a.hd, a.page, rmax);
  Page* pages = reinterpret_cast<Page*>(smem);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  uint8_t* stage = smem + lay.stage;
  const int base_t = j0 * a.page;
  const int p_lo = (t0 - base_t) / a.page, p_hi = (t1 - 1 - base_t) / a.page + 1;
  const size_t KV = a.KV;

  // the split's pages: where each lives (thread p), its scales read now and
  // stored once the copies are in flight
  float ksm = 0.f, vsm = 0.f;
  int ksh = 0, vsh = 0;
  const bool owner = tid >= p_lo && tid < p_hi;
  if (owner) {
    Page& pg = pages[tid];
    if (STORE == FROZEN && pid >= a.fz.base) {
      const int f = min(pid - a.fz.base, a.fz.nfz);
      const size_t row0 = ((size_t)f * a.page * KV + h) * ((a.hd + 1) >> 1);
      pg.k = a.fz.k + row0;
      pg.v = a.fz.v + row0;
      pg.fp4 = 1;
      ksm = a.fz.k_smax[f];
      vsm = a.fz.v_smax[f];
      ksh = a.fz.k_shift[f * KV + h];
      vsh = a.fz.v_shift[f * KV + h];
    } else {
      const int p = STORE == FROZEN ? min(pid, a.fz.base - 1) : pid;
      const size_t row0 = ((size_t)p * a.page * KV + h) * a.hd * (STORE == BF16 ? 2 : 1);
      pg.k = a.k + row0;
      pg.v = a.v + row0;
      pg.fp4 = 0;
      if (STORE != BF16) {
        ksm = a.k_smax[p];
        vsm = a.v_smax[p];
        ksh = a.k_shift[p * KV + h];
        vsh = a.v_shift[p * KV + h];
      }
    }
  }
  __syncthreads();

  // every valid row of every page of the split, K then V, before any wait
  for (int p = p_lo; p < p_hi; ++p) {
    const Page& pg = pages[p];
    const int ua = max(t0 - base_t - p * a.page, 0), ub = min(t1 - base_t - p * a.page, a.page);
    uint8_t* dk = stage + ((size_t)2 * p * a.page + ua) * rmax;
    uint8_t* dv = dk + (size_t)a.page * rmax;
    if (STORE == FROZEN && pg.fp4) {
      const int R = (a.hd + 1) >> 1;
      const size_t stride = KV * R;
      stage_rows<LT, LT / 2>(dk, pg.k + ua * stride, stride, ub - ua, R, rmax);
      stage_rows<LT, LT / 2>(dv, pg.v + ua * stride, stride, ub - ua, R, rmax);
    } else {
      const int R = STORE == BF16 ? 2 * a.hd : a.hd;
      const size_t stride = KV * R;
      constexpr int VPR = STORE == BF16 ? 2 * LT : LT;
      stage_rows<LT, VPR>(dk, pg.k + ua * stride, stride, ub - ua, R, rmax);
      stage_rows<LT, VPR>(dv, pg.v + ua * stride, stride, ub - ua, R, rmax);
    }
  }
  if (owner) {
    Page& pg = pages[tid];
    pg.ksm = ksm;
    pg.vsm = vsm;
    pg.ksh = ksh;
    pg.vsh = vsh;
  }
  cp_async_wait_all();
  __syncthreads();

  float m[G], l[G], acc[G][DL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = NEG;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[gi][e] = 0.f;
  }
  for (int p = p_lo; p < p_hi; ++p) {
    const Page pg = pages[p];
    const int ua = max(t0 - base_t - p * a.page, 0), ub = min(t1 - base_t - p * a.page, a.page);
    const uint8_t* kb = stage + (size_t)2 * p * a.page * rmax;
    const uint8_t* vb = kb + (size_t)a.page * rmax;
    if (STORE == BF16) {
      const Bf16Dims<VEC> dd{a.hd};
      attend<G>(kb, vb, rmax, ua, ub, slot, ns, L, d0, a.scale, dd, dd, qv, m, l, acc);
    } else if (STORE == FROZEN && pg.fp4) {
      const Fp4Dims<VEC> kd{pg.ksh, a.hd, pg.ksm, a.fz.fmt}, vd{pg.vsh, a.hd, pg.vsm, a.fz.fmt};
      attend<G>(kb, vb, rmax, ua, ub, slot, ns, L, d0, a.scale, kd, vd, qv, m, l, acc);
    } else {
      const Fp8Dims<VEC> kd{pg.ksh, a.hd, pg.ksm, a.fmt}, vd{pg.vsh, a.hd, pg.vsm, a.fmt};
      attend<G>(kb, vb, rmax, ua, ub, slot, ns, L, d0, a.scale, kd, vd, qv, m, l, acc);
    }
  }

  // merge the lane groups of a warp (lanes o apart hold the same dims)
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], o);
      const float mn = fmaxf(m[gi], mo), wa = expf(m[gi] - mn), wb = expf(mo - mn);
      l[gi] = l[gi] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < DL; ++e)
        acc[gi][e] = acc[gi][e] * wa + __shfl_xor_sync(0xffffffffu, acc[gi][e], o) * wb;
      m[gi] = mn;
    }
  }
  // then the warps, in order, through shared memory
  const int warp = tid >> 5, lane = tid & 31;
  float* rm = red;                  // (WARPS, G)
  float* rl = red + WARPS * G;      // (WARPS, G)
  float* ra = red + 2 * WARPS * G;  // (WARPS, G, hd)
  if (lane < L) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (lane == 0) {
        rm[warp * G + gi] = m[gi];
        rl[warp * G + gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e)
        if (VEC || d0 + e < a.hd) ra[(size_t)(warp * G + gi) * a.hd + d0 + e] = acc[gi][e];
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * a.H + head0) * a.splits + s;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, rm[w * G + gi]);
    float wt[WARPS], ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      wt[w] = expf(rm[w * G + gi] - mx);
      ls += rl[w * G + gi] * wt[w];
    }
    const size_t idx = part + (size_t)gi * a.splits;
    for (int d = tid; d < a.hd; d += THREADS) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) o += ra[(size_t)(w * G + gi) * a.hd + d] * wt[w];
      a.part_acc[idx * a.hd + d] = o;
    }
    if (tid == 0) {
      a.part_ml[2 * idx] = mx;
      a.part_ml[2 * idx + 1] = ls;
    }
  }
}

template <int LT, int G, int STORE>
int launch_split(const Args& a, int B, int chunks, cudaStream_t stream) {
  const int rmax = STORE == BF16 ? 2 * a.hd : a.hd;
  const size_t bytes = Layout(a.pps, G, a.hd, a.page, rmax).bytes;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = gqa_decode_split_kernel<LT, G, STORE>;
  if (bytes > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.splits, a.KV * chunks, B), THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LT, int G>
int by_store(int store, const Args& a, int B, int chunks, cudaStream_t s) {
  return store == FROZEN ? launch_split<LT, G, FROZEN>(a, B, chunks, s)
       : store == FP8    ? launch_split<LT, G, FP8>(a, B, chunks, s)
                         : launch_split<LT, G, BF16>(a, B, chunks, s);
}

template <int LT>
int by_group(int G, int store, const Args& a, int B, int chunks, cudaStream_t s) {
  return G == 4 ? by_store<LT, 4>(store, a, B, chunks, s) : by_store<LT, 1>(store, a, B, chunks, s);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// q: (B, H, hd) bf16; k/v_pages: (P+1, page, KV, hd) uint8 codes (fp8 = 1)
// or bf16; k/v_smax: (P+1,) f32 and k/v_shift: (P+1, KV) int32 (read only
// for fp8 pages); page_table: (B, PP) int32; kv_lens: (B,) int32;
// out: (B, H, hd) f32. frozen = 1 (fp8 pages only): k/v_fz (nfz+1, page, KV,
// ceil(hd/2)) packed codes of the grid (fz_exp_bits, fz_man_bits, fz_bias),
// k/v_fz_smax (nfz+1,) f32, k/v_fz_shift (nfz+1, KV) int32; table ids >=
// P+1 address them. The launch plan (kernels/decode_attn.py::decode_attn_plan):
// pps pages a split, splits a row (ceil(PP / pps)), group query heads a
// block (1 or 4, dividing H / KV), threads a block (128); part_ml (B, H,
// splits, 2) and part_acc (B, H, splits, hd) f32 the splits' workspace.
// Launches the split kernel and the combine on `stream`; returns
// cudaGetLastError().
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
                                        int fz_man_bits, int fz_bias, int pps, int splits,
                                        int group, int threads, void* part_ml, void* part_acc,
                                        void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (KV <= 0 || H % KV || (frozen && (!fp8 || nfz < 0)) || hd <= 0 || hd > 32 * DL ||
      page <= 0 || pps <= 0 || pps > THREADS || splits <= 0 || (long long)pps * splits < PP ||
      (group != 1 && group != 4) || (H / KV) % group || threads != THREADS)
    return (int)cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes * DL < hd) lanes <<= 1;
  const Frozen fz{(const uint8_t*)k_fz, (const uint8_t*)v_fz, (const float*)k_fz_smax,
                  (const float*)v_fz_smax, (const int*)k_fz_shift, (const int*)v_fz_shift,
                  n_pages1, nfz, Grid{fz_exp_bits, fz_man_bits, fz_bias}};
  const Args a{(const __nv_bfloat16*)q, (const uint8_t*)k_pages, (const uint8_t*)v_pages,
               (const float*)k_smax, (const float*)v_smax, (const int*)k_shift,
               (const int*)v_shift, (const int*)page_table, (const int*)kv_lens,
               (float*)part_ml, (float*)part_acc, H, KV, hd, page, PP, window, pps, splits,
               lanes, scale, Grid{exp_bits, man_bits, bias}, fz};
  const int store = frozen ? FROZEN : fp8 ? FP8 : BF16;
  const bool vec = (hd == 64 || hd == 128) && aligned16(k_pages) && aligned16(v_pages) &&
                   (!frozen || (aligned16(k_fz) && aligned16(v_fz)));
  const int chunks = H / KV / group;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = !vec      ? by_group<0>(group, store, a, B, chunks, s)
               : hd == 64 ? by_group<4>(group, store, a, B, chunks, s)
                          : by_group<8>(group, store, a, B, chunks, s);
  if (rc) return rc;
  return launch_split_combine(part_ml, part_acc, kv_lens, out, B, H, hd, splits, pps * page, PP,
                              page, window, s);
}
