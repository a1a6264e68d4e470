// The W4A8 GEMM kernel of the port, shared by the fused GEMM (w4a8_fused.cu,
// TPU row 1 and its batched and transposed orientations) and the split GEMM
// (w4a8_matmul.cu, TPU row 5), so both run one K loop and one epilogue.
// Template flags: QUANT_ACTS (token-wise FP8 quantization of the activations
// in-kernel, else bf16 taken as it is), TRANSPOSE (contract the weight's out
// rows), OutT (bf16 or f32 out) and E3M0 (decode E3M0 nibbles, else E2M1).
// What it computes is set out at the head of w4a8_fused.cu.
//
// What bounds it on the H100, by regime:
//   * a few live rows (a decode step's M = 4, the MLA head projections, the
//     MoE slabs, most of whose rows are zero): the packed weight read, N*K/2
//     bytes (MiniCPM3-4B's 2560 -> 2560: 3.3 MB, 1 us at 3.35 TB/s), and,
//     measured, the latency chain of each block: its rows' absmax, a cluster
//     barrier, one pass a K chunk (copies issued, decode, products) and the
//     reduction across the cluster;
//   * many live rows (prefill chunks, M of 64..256): the tensor-core work
//     and the bytes are both small; the token-wise quantization each column
//     tile repeats for its rows (an IEEE division and a grid rounding an
//     element) is the largest part of a chunk.
// What the design does about it:
//   * blocks of 256 threads (two warpgroups); a ring of STAGES shared-memory
//     stages filled by 16-byte cp.async: the packed codes, the activation
//     rows and LoRC's B rows of chunks c + 1 .. c + 3 are in flight while
//     chunk c is decoded and multiplied; the group factors (2^-shift, or the
//     f32 group scale) are read once per block into a table, not per code;
//   * a 32-bit word of codes decodes to eight bf16 weights straight into the
//     core-matrix row the tensor cores read. Under M2 (normal orientation)
//     two codes at a time in packed bf16: their bits placed as bf16 (E2M1's
//     0.5 a subnormal, which bf16 multiplies keep) and one multiply by
//     2^(126 - shift) makes both exact; codes j and j + 4 share a 32-bit
//     half pair, so the K order inside each 8-column group is permuted, and
//     the activations and LoRC's rows are permuted alike. Otherwise in f32:
//     the exact value times the factor, rounded once to bf16 (as the plain
//     version rounds);
//   * K is split over the blocks of a thread-block cluster (ks <= 8; the
//     plan, kernels/w4a8_fused.py::gemm_plan, aims at one wave of two blocks
//     an SM with at least 132 blocks); each block's f32 partials of y and of
//     xr are summed through distributed shared memory in rank order:
//     deterministic, no workspace, no atomics, no second launch;
//   * QUANT_ACTS: the cluster's blocks each take the absmax of their K slice
//     of the block's rows and share it through distributed shared memory;
//     a block quantizes only its own K slice. A row whose absmax is exactly 0
//     is a zero row (its quantized values and its xr are 0, so its output is
//     0): the block multiplies only the other rows and writes zeros for the
//     rest; a slab of a stack (the MoE experts) reads its weights only once
//     it knows it has a live row, and gathers only those rows. A NaN absmax
//     is no zero;
//   * LoRC's r rows of B (normal orientation; A's columns, transposed) join
//     the decoded weight tile as extra output channels, so xr comes out of
//     the same tensor-core products in f32; the epilogue's LoRC factors and
//     s_max are copied into shared memory with the first chunk;
//   * at most SKINNY live rows: mma.sync m16n8k16 with the weights as the A
//     operand (output channels fill its 16 rows, tokens its 8 columns), so a
//     decode step wastes no tensor-core rows; more: wgmma m64n32k16, the
//     activations as A and the decoded weights as B, both from shared memory
//     in the canonical no-swizzle K-major layout (8 x 16-byte core matrices),
//     each warpgroup taking half of the block's output channels;
//   * shared memory is sized per launch for the rows a block can hold (a
//     decode step's few, or a wgmma tile's 64).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "quant_common.cuh"  // Grid, to_f32, pow2i, nan_max, round_to_grid

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;          // contraction chunk
constexpr int TM = 64;          // rows of a block: one wgmma M tile
constexpr int THREADS = 256;    // two warpgroups
constexpr int STAGES = 4;       // depth of the cp.async ring
constexpr int MAX_R = 32;       // largest LoRC rank
constexpr int MAX_KS = 8;       // blocks of a cluster (the portable limit)
constexpr int SKINNY = 32;      // at most this many live rows: the mma.sync path
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Operands of one launch. K is the contraction length, N_out the output
// width: normal, K = in columns of W and N_out = its out rows; transposed,
// K = out rows of W and N_out = its in columns. G groups of gs columns per
// W row in both. The s_* are per-slice strides in elements (s_lb may be 0).
// bn and ks are the launch plan (output channels of a block, blocks of a
// cluster); tab_cols the factor table's row length; vec_codes / vec_x /
// vec_epi say whether the codes / the activation and LoRC B rows / the
// epilogue's LoRC factors and s_max may be copied 16 bytes at a time (else
// byte by byte). The launcher fills the last four.
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
  int bn, ks, tab_cols, vec_codes, vec_x, vec_epi;
};

// Shared memory of one launch, in bytes, from its plan and its rows a slab
// (a decode step's few, or a wgmma tile's 64).
struct Layout {
  int rows;   // activation rows a block stages: M rounded up to 8, or TM above SKINNY
  int lc;     // LoRC channels of the weight tile: r rounded up to 16, 32 if wgmma may run
  int lr;     // LoRC B rows a stage holds (r rounded up to 8; 0 transposed)
  int rp;     // f32 pitch of the partial sums
  int acts, lorc, stage, wdec, xq, lf, smax, rowinfo, ftab, total;  // byte offsets (codes at 0)
};

__host__ __device__ inline Layout make_layout(int M, int bn, int r, bool transpose, int tab) {
  Layout l;
  l.rows = M <= SKINNY ? (M + 7) / 8 * 8 : TM;
  l.lc = r == 0 ? 0 : M > SKINNY ? 32 : (r + 15) / 16 * 16;
  l.lr = transpose ? 0 : (r + 7) / 8 * 8;
  l.rp = bn + l.lc + 4;
  l.acts = bn * BK / 2;
  l.lorc = l.acts + l.rows * BK * 2;
  l.stage = l.lorc + l.lr * BK * 2;
  const int region = STAGES * l.stage, red = l.rows * l.rp * 4;
  l.wdec = region > red ? region : red;
  l.xq = l.wdec + (bn + l.lc) * BK * 2;
  l.lf = l.xq + l.rows * BK * 2;                      // xr reuses xq: rows x MAX_R x 4 bytes
  l.smax = l.lf + (bn * r * 2 + 15) / 16 * 16;
  l.rowinfo = l.smax + bn * 4;
  l.ftab = l.rowinfo + 5 * TM * 4 + 16;
  l.total = l.ftab + tab * 4;
  return l;
}

// byte offset of (row, 8-column group q) in a tile of BK columns laid out as
// 8 x 16-byte core matrices: 8 rows of one group are 128 contiguous bytes,
// the next group along K follows (LBO 128), the next 8 rows 1024 bytes on
__device__ __forceinline__ int canon(int row, int q) {
  return (row >> 3) * (BK * 16) + q * 128 + (row & 7) * 16;
}
// Row and 8-column group of item i of such a tile: item i's 16 bytes lie at
// byte 16 * i, so a loop over i reads and writes contiguous shared memory.
__device__ __forceinline__ int item_row(int i) { return ((i >> 6) << 3) | (i & 7); }
__device__ __forceinline__ int item_group(int i) { return (i >> 3) & 7; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, the first `valid` of them read, the rest zero;
// asynchronous when vec (src 16-byte aligned), else byte by byte
__device__ __forceinline__ void copy16(void* dst, const void* src, int valid, bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid));
  } else {
    uint8_t* o = (uint8_t*)dst;
    const uint8_t* s = (const uint8_t*)src;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = i < valid ? s[i] : (uint8_t)0;
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// The bits of a 4-bit code (bits 0-3 of t) placed into an f32: E2M1's
// exponent and mantissa at bits 24-22 (0.5 a subnormal), E3M0's exponent at
// 25-23, the sign at 31. Times 2^126 (E2M1) or 2^124 (E3M0) that is the
// code's exact value.
template <bool E3M0>
__device__ __forceinline__ float fp4_bits(uint32_t t) {
  return __uint_as_float(((t & 8u) << 28) | ((t & 7u) << (E3M0 ? 23 : 22)));
}

// Eight codes (one 32-bit word, element j in bits 4j..4j+3) times their
// factors, rounded to bf16 pairs. folded: f already carries 2^126 or 2^124 (a
// power of two times a power of two, exact); else the exact value is made
// first and f multiplies it (one rounding, as the plain version rounds).
template <bool E3M0>
__device__ __forceinline__ uint4 decode8(uint32_t w, const float* f, bool folded) {
  constexpr float S = E3M0 ? 0x1p124f : 0x1p126f;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float lo = fp4_bits<E3M0>(w >> (8 * j)), hi = fp4_bits<E3M0>(w >> (8 * j + 4));
    if (!folded) {
      lo *= S;
      hi *= S;
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo * f[2 * j], hi * f[2 * j + 1]);
    o[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Eight codes decoded two at a time in packed bf16 (the folded M2 path):
// codes j and j + 4 of the word fill the two halves of word j of the result
// (the K order inside each 8-column group is permuted the same way for the
// activations, so every product meets its partner), their bits placed as a
// bf16 (E2M1's 0.5 a subnormal, which bf16 multiplies keep) and one packed
// multiply by 2^(126 - shift) (E3M0: 2^(124 - shift)) makes both exact.
template <bool E3M0>
__device__ __forceinline__ uint4 decode8_pairs(uint32_t w, __nv_bfloat162 f) {
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // code j to bits 6-8 (E3M0 7-9) and 15, code j + 4 to + 16
    const int se = (E3M0 ? 7 : 6) - 4 * j, ss = 12 - 4 * j;
    const uint32_t m = se >= 0 ? w << se : w >> -se, sg = ss >= 0 ? w << ss : w >> -ss;
    const uint32_t v = (m & (E3M0 ? 0x03800380u : 0x01C001C0u)) | (sg & 0x80008000u);
    const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v), f);
    o[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}
// The same K permutation applied to eight bf16 values in natural order.
__device__ __forceinline__ uint4 pair_halves(uint4 v) {
  return make_uint4(__byte_perm(v.x, v.z, 0x5410), __byte_perm(v.x, v.z, 0x7632),
                    __byte_perm(v.y, v.w, 0x5410), __byte_perm(v.y, v.w, 0x7632));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wgmma shared-memory descriptor: no swizzle, K-major, LBO 128 bytes (the
// next 8 columns), SBO BK * 16 bytes (the next 8 rows)
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((BK * 16) >> 4) << 32);
}
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// The shared state of one block: where its tiles lie and what it covers.
struct Tile {
  Layout l;
  uint8_t *smem, *wdec, *xq, *lf;
  float *smax, *amax_part, *amax, *rscale, *rrcp, *ftab;
  int* ridx;
  int n0, m0, bn, rows, live, cpad, c0, k_lo, k_hi, g_lo, tid;
  bool gather;  // the stage holds the live rows only (else every row of the tile)
  bool folded;  // the factor table carries 2^126 / 2^124 (normal orientation, M2)
};

// Issue the copies of chunk ch into stage s: the codes and LoRC's B rows
// (normal orientation) when `weights`, the live rows' activations when `acts`.
// Stage layouts: normal codes, item i = W row ((i >> 4) << 3 | i & 7), half
// (i >> 3) & 1 of its 32 bytes; transposed codes, item i = W row (k) i & 63,
// 16-byte piece i >> 6 of the tile's bn / 2 bytes; activations and LoRC's B
// rows canonical. Every item is 16 bytes at 16 * i.
template <bool TRANSPOSE, typename OutT>
__device__ __forceinline__ void load_chunk(const Args<OutT>& a, const Tile& t,
                                           const __nv_bfloat16* x, const uint8_t* codes,
                                           const __nv_bfloat16* lorc_b, int ch, int s,
                                           bool weights, bool acts) {
  uint8_t* st = t.smem + s * t.l.stage;
  const int K = a.K, N = a.N_out, kc = ch * BK, bn = t.bn;
  if (weights) {
    if (!TRANSPOSE) {
      for (int i = t.tid; i < 2 * bn; i += THREADS) {
        const int nn = t.n0 + (((i >> 4) << 3) | (i & 7)), kb = kc / 2 + 16 * ((i >> 3) & 1);
        const int valid = nn < N ? max(0, min(16, K / 2 - kb)) : 0;
        copy16(st + 16 * i, valid ? codes + (size_t)nn * (K / 2) + kb : codes, valid,
               a.vec_codes);
      }
      for (int i = t.tid; i < t.l.lr * 8; i += THREADS) {  // LoRC's B rows (zero past r)
        const int j = item_row(i), k = kc + 8 * item_group(i);
        const int valid = j < a.r ? max(0, min(16, 2 * (K - k))) : 0;
        copy16(st + t.l.lorc + 16 * i, valid ? lorc_b + (size_t)j * K + k : lorc_b, valid,
               a.vec_x);
      }
    } else {
      for (int i = t.tid; i < BK * (bn / 32); i += THREADS) {
        const int k = kc + (i & (BK - 1)), nb = t.n0 / 2 + 16 * (i / BK);
        const int valid = k < K ? max(0, min(16, N / 2 - nb)) : 0;
        copy16(st + 16 * i, valid ? codes + (size_t)k * (N / 2) + nb : codes, valid,
               a.vec_codes);
      }
    }
  }
  if (acts) {  // the live rows (gather) or every row of the tile, in order
    const int n_rows = t.gather ? t.live : t.rows;
    for (int i = t.tid; i < t.l.rows * 8; i += THREADS) {
      const int ir = item_row(i), k = kc + 8 * item_group(i);
      if (ir >= n_rows) continue;
      const int valid = k < K ? min(16, 2 * (K - k)) : 0;
      const int m = t.m0 + (t.gather ? t.ridx[ir] : ir);
      copy16(st + t.l.acts + 16 * i, valid ? x + (size_t)m * K + k : x, valid, a.vec_x);
    }
  }
}

// The factors of eight consecutive codes along W's columns from column c0
// (c0 a multiple of 8): fr is the table row of their W row, groups counted
// from g_lo; one lookup when a group holds whole words (gs % 8 == 0).
__device__ __forceinline__ void factors8(float* f, const float* fr, int c0, int gs, int g_lo,
                                         int tc, int c_max) {
  if (gs % 8 == 0) {
    const float v = fr[max(0, min(tc - 1, c0 / gs - g_lo))];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = v;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = fr[max(0, min(tc - 1, min(c0 + j, c_max) / gs - g_lo))];
  }
}

// Chunk ch, landed in stage s: the weights decoded into the wdec tile (rows
// [0, bn) the output channels, [bn, bn + lc) LoRC's), the live rows'
// activations quantized (QUANT_ACTS) or copied into the xq tile.
template <bool QUANT_ACTS, bool TRANSPOSE, bool E3M0, typename OutT>
__device__ __forceinline__ void stage_chunk(const Args<OutT>& a, const Tile& t,
                                            const __nv_bfloat16* lorc_a, int ch, int s) {
  const uint8_t* st = t.smem + s * t.l.stage;
  const int K = a.K, N = a.N_out, kc = ch * BK, bn = t.bn, gs = a.gs, tc = a.tab_cols;
  if (!TRANSPOSE) {
    // item i: one word (8 codes) of W row item_row(i), 8-column group
    // item_group(i); it lands at byte 16 * i of the canonical weight tile
    const bool whole = gs % BK == 0;  // the chunk lies in one group of every row
    const int g_chunk = max(0, min(tc - 1, kc / gs - t.g_lo));
    for (int i = t.tid; i < 8 * bn; i += THREADS) {
      const int n = item_row(i), q = item_group(i), p = ((n >> 3) << 4) | ((q >> 2) << 3) | (n & 7);
      const uint32_t w = *reinterpret_cast<const uint32_t*>(st + 16 * p + 4 * (q & 3));
      const float* fr = t.ftab + n * tc;
      uint4 v;
      if (t.folded && gs % 8 == 0) {
        const int g = whole ? g_chunk : max(0, min(tc - 1, (kc + 8 * q) / gs - t.g_lo));
        v = decode8_pairs<E3M0>(w, __float2bfloat162_rn(fr[g]));
      } else {
        float f[8];
        factors8(f, fr, kc + 8 * q, gs, t.g_lo, tc, K - 1);
        v = decode8<E3M0>(w, f, t.folded);
        if (t.folded) v = pair_halves(v);
      }
      reinterpret_cast<uint4*>(t.wdec)[i] = v;
    }
    // LoRC's B rows, already bf16: rows bn.. of the weight tile
    const uint4* sl = reinterpret_cast<const uint4*>(st + t.l.lorc);
    uint4* dl = reinterpret_cast<uint4*>(t.wdec + bn * BK * 2);
    for (int i = t.tid; i < t.l.lr * 8; i += THREADS) dl[i] = t.folded ? pair_halves(sl[i]) : sl[i];
  } else {
    for (int i = t.tid; i < BK * (bn / 32); i += THREADS) {
      const int kk = i & (BK - 1), p = i / BK, k = kc + kk;
      const uint4 w = *reinterpret_cast<const uint4*>(st + 16 * i);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      const float* fr = t.ftab + max(0, min(k, t.k_hi - 1) - t.k_lo) * tc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nb = 32 * p + 8 * q;  // the word's first channel in the tile
        float f[8];
        factors8(f, fr, t.n0 + nb, gs, t.g_lo, tc, N - 1);
        const uint4 v = decode8<E3M0>(words[q], f, t.folded);
        const uint16_t* h16 = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint16_t*>(t.wdec + canon(nb + j, kk >> 3) + (kk & 7) * 2) = h16[j];
      }
    }
    for (int i = t.tid; i < t.l.lc * BK; i += THREADS) {  // LoRC's A columns, row bn + j
      const int j = i % t.l.lc, kk = i / t.l.lc, k = kc + kk;
      const __nv_bfloat16 v = j < a.r && k < K ? lorc_a[(size_t)k * a.r + j]
                                               : __float2bfloat16_rn(0.f);
      *reinterpret_cast<__nv_bfloat16*>(t.wdec + canon(bn + j, kk >> 3) + (kk & 7) * 2) = v;
    }
  }
  const uint8_t* sa = st + t.l.acts;
  // the live rows only (the tile's rows past them are zero). v / sc is
  // taken correctly rounded without a division: y = RN(1 / sc), then
  // Markstein's correction of RN(v * y) by its exact remainder gives the
  // IEEE quotient (an infinite or NaN scale takes the division itself)
  const auto quant = [&](float v, float sc, float y) {
    float q;
    if (y != 0.f && isfinite(y)) {
      const float q0 = __fmul_rn(v, y);
      q = fmaf(fmaf(-sc, q0, v), y, q0);
    } else {
      q = v / sc;
    }
    return __float2bfloat16_rn(round_to_grid(q, a.grid) * sc);
  };
  if (QUANT_ACTS && t.cpad == TM) {  // wgmma's 64 rows: 8 elements an item
    for (int i = t.tid; i < TM * 8; i += THREADS) {
      const int ir = i & (TM - 1), q8 = i / TM;
      if (ir >= t.live) continue;
      const int m = t.ridx[ir];
      const float sc = t.rscale[m], y = t.rrcp[m];
      uint4 v = *reinterpret_cast<const uint4*>(sa + canon(t.gather ? ir : m, q8));
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = quant(__bfloat162float(e[j]), sc, y);
      *reinterpret_cast<uint4*>(t.xq + canon(ir, q8)) = t.folded ? pair_halves(v) : v;
    }
  } else if (QUANT_ACTS) {  // a decode step's few rows: one element a thread
    for (int e = t.tid; e < t.live * BK; e += THREADS) {
      const int ir = e / BK, k = e & (BK - 1), e8 = k & 7, m = t.ridx[ir];
      const float v = __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(sa)[canon(t.gather ? ir : m, k >> 3) / 2 + e8]);
      const int pos = t.folded ? 2 * (e8 & 3) + (e8 >> 2) : e8;  // the weights' K order
      reinterpret_cast<__nv_bfloat16*>(t.xq)[canon(ir, k >> 3) / 2 + pos] =
          quant(v, t.rscale[m], t.rrcp[m]);
    }
  } else {  // every row is live, in order
    for (int i = t.tid; i < t.cpad * 8; i += THREADS) {
      if (item_row(i) >= t.live) continue;
      const uint4 v = reinterpret_cast<const uint4*>(sa)[i];
      reinterpret_cast<uint4*>(t.xq)[i] = t.folded ? pair_halves(v) : v;
    }
  }
}

// The K loop over this block's chunks, then its f32 partial sums written to
// red[live row][channel] (channels bn.. the LoRC projection xr). BIG: wgmma
// over 64 rows; else mma.sync with the channels as rows and <= 32 tokens.
template <bool BIG, bool QUANT_ACTS, bool TRANSPOSE, bool E3M0, typename OutT>
__device__ __forceinline__ void k_loop(const Args<OutT>& a, const Tile& t, const __nv_bfloat16* x,
                                       const uint8_t* codes, const __nv_bfloat16* lorc_a,
                                       const __nv_bfloat16* lorc_b, int nloc) {
  const int warp = t.tid >> 5, lane = t.tid & 31, bn = t.bn, rp = t.l.rp, nw = THREADS / 32;
  // skinny: channel tiles of 16 (LoRC's lc / 16), warp w takes w, w + nw, w + 2 nw
  const int ct = (bn + t.l.lc) / 16, nt = (t.live + 7) / 8;
  // BIG: warpgroup wg takes the n32 blocks wg and wg + 2 (acc[0], acc[1]),
  // warpgroup 1 also LoRC's (accl); else acc[u] is [token tile x 4] of
  // channel tile warp + nw * u
  const int wg = t.tid >> 7;
  float acc[BIG ? 2 : 3][16];
  float accl[BIG ? 16 : 1];
#pragma unroll
  for (int u = 0; u < (BIG ? 2 : 3); ++u)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[u][i] = 0.f;
#pragma unroll
  for (int i = 0; i < (BIG ? 16 : 1); ++i) accl[i] = 0.f;

  for (int it = 0; it < nloc; ++it) {
    if (it == 0) cp_wait_all(); else cp_wait<STAGES - 2>();
    __syncthreads();  // chunk it landed for all; stage (it - 1) % STAGES and the tiles are free
    {
      const int nx = it + STAGES - 1;
      if (nx < nloc)
        load_chunk<TRANSPOSE>(a, t, x, codes, lorc_b, t.c0 + nx, nx % STAGES, true, true);
      cp_commit();
    }
    stage_chunk<QUANT_ACTS, TRANSPOSE, E3M0>(a, t, lorc_a, t.c0 + it, it % STAGES);
    if constexpr (BIG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if constexpr (BIG) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        const uint64_t da = gmma_desc(t.xq + 256 * s);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = wg + 2 * u;
          if (j < bn / 32) wgmma_n32(acc[u], da, gmma_desc(t.wdec + j * 32 * 128 + 256 * s));
        }
        if (a.r && wg == 1) wgmma_n32(accl, da, gmma_desc(t.wdec + bn * 128 + 256 * s));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 16; ++i) fence_operand(acc[u][i]);
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_operand(accl[i]);
    } else {
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        uint32_t b[4][2];
#pragma unroll
        for (int n8 = 0; n8 < 4; ++n8)
          if (n8 < nt) ldsm_x2(b[n8], t.xq + canon(8 * n8 + (lane & 7), 2 * s + ((lane >> 3) & 1)));
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int tile = warp + nw * u;
          if (tile < ct) {
            uint32_t af[4];
            ldsm_x4(af, t.wdec + canon(16 * tile + (lane & 7) + 8 * ((lane >> 3) & 1),
                                       2 * s + (lane >> 4)));
#pragma unroll
            for (int n8 = 0; n8 < 4; ++n8)
              if (n8 < nt) mma16816(&acc[u][4 * n8], af, b[n8]);
          }
        }
      }
    }
  }
  cp_wait_all();
  __syncthreads();  // every stage quiet and read: red may overwrite them
  float* red = reinterpret_cast<float*>(t.smem);
  const int g = lane >> 2, q = lane & 3;
  if constexpr (BIG) {  // wgmma D: row 16 * (warp % 4) + g (+ 8), column 8 * blk + 2q (+ 1)
    const int r0 = 16 * (warp & 3) + g;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const bool lorc = u == 2;
      if (lorc ? a.r == 0 || wg != 1 : wg + 2 * u >= bn / 32) continue;
      const float* d = lorc ? accl : acc[u];
      const int cbase = lorc ? bn : 32 * (wg + 2 * u);
#pragma unroll
      for (int blk = 0; blk < 4; ++blk) {
        const int col = cbase + 8 * blk + 2 * q;
        red[r0 * rp + col] = d[4 * blk];
        red[r0 * rp + col + 1] = d[4 * blk + 1];
        red[(r0 + 8) * rp + col] = d[4 * blk + 2];
        red[(r0 + 8) * rp + col + 1] = d[4 * blk + 3];
      }
    }
  } else {  // mma C: channel 16 * tile + g (+ 8), token 8 * n8 + 2q (+ 1)
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int tile = warp + nw * u;
      if (tile >= ct) continue;
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8) {
        if (n8 >= nt) continue;
        const int ch = 16 * tile + g, tok = 8 * n8 + 2 * q;
        red[tok * rp + ch] = acc[u][4 * n8];
        red[(tok + 1) * rp + ch] = acc[u][4 * n8 + 1];
        red[tok * rp + ch + 8] = acc[u][4 * n8 + 2];
        red[(tok + 1) * rp + ch + 8] = acc[u][4 * n8 + 3];
      }
    }
  }
}

// red[at] summed over the cluster's blocks in rank order: every load issued
// before the first add
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* red, int at,
                                             int ks) {
  float v[MAX_KS];
#pragma unroll
  for (int q = 0; q < MAX_KS; ++q) v[q] = q < ks ? cluster.map_shared_rank(red, q)[at] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < MAX_KS; ++q) s += v[q];
  return s;
}

template <bool QUANT_ACTS, bool TRANSPOSE, typename OutT, bool E3M0>
__global__ void __launch_bounds__(THREADS, 2)
    w4a8_gemm_kernel(const __grid_constant__ Args<OutT> a) {
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ks = a.ks, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = a.M, K = a.K, N = a.N_out, bn = a.bn, r = a.r, e = blockIdx.z;

  Tile t;
  t.l = make_layout(M, bn, r, TRANSPOSE, 0);
  t.smem = smem;
  t.wdec = smem + t.l.wdec;
  t.xq = smem + t.l.xq;
  t.lf = smem + t.l.lf;
  t.smax = reinterpret_cast<float*>(smem + t.l.smax);
  t.amax_part = reinterpret_cast<float*>(smem + t.l.rowinfo);
  t.amax = t.amax_part + TM;
  t.rscale = t.amax + TM;
  t.rrcp = t.rscale + TM;
  t.ridx = reinterpret_cast<int*>(t.rrcp + TM);
  int* live = t.ridx + TM;
  t.ftab = reinterpret_cast<float*>(smem + t.l.ftab);
  t.tid = tid;
  t.bn = bn;
  t.n0 = (blockIdx.x / ks) * bn;
  t.m0 = blockIdx.y * TM;
  const int rows = t.rows = min(TM, M - t.m0);
  const int nchunks = (K + BK - 1) / BK;
  t.c0 = rank * nchunks / ks;
  const int nloc = (rank + 1) * nchunks / ks - t.c0;
  t.k_lo = t.c0 * BK;
  t.k_hi = min(t.k_lo + nloc * BK, K);
  t.g_lo = TRANSPOSE ? t.n0 / a.gs : t.k_lo / a.gs;

  const __nv_bfloat16* x = a.x + e * a.s_x;
  const uint8_t* codes = a.codes + e * a.s_codes;
  const float* scale = a.scale + e * a.s_scale;
  const int8_t* shifts = a.shifts ? a.shifts + e * a.s_scale : nullptr;
  const float* smax = a.smax ? a.smax + e * a.s_smax : nullptr;
  const __nv_bfloat16* lorc_a = r ? a.lorc_a + e * a.s_la : nullptr;
  const __nv_bfloat16* lorc_b = r ? a.lorc_b + e * a.s_lb : nullptr;
  OutT* out = a.out + (long long)e * M * N;
  t.folded = !TRANSPOSE && shifts != nullptr;
  const int cols = min(bn, N - t.n0);  // output channels of this tile inside N

  // What a block reads before it knows its rows: the first chunks' weights,
  // and for the epilogue its columns' s_max (normal, M2) and LoRC factors
  // (normal: lorc_a's rows, [channel][j]; transposed: lorc_b's columns,
  // [j][channel]); the raw factor-table entries of its first pass.
  const int tc = a.tab_cols, n_tab = TRANSPOSE ? (t.k_hi - t.k_lo) * tc : bn * tc;
  int at[4], rsh[4];
  float rsc[4], rsm[4];
  auto prefetch = [&]() {
    if (!TRANSPOSE && smax) {
      for (int i = tid; 16 * i < 4 * cols; i += THREADS)
        copy16(t.smax + 4 * i, smax + t.n0 + 4 * i, min(16, 4 * cols - 16 * i), a.vec_epi);
    }
    if (r && !TRANSPOSE) {
      const int bytes = cols * r * 2;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(lorc_a + (size_t)t.n0 * r);
      for (int i = tid; 16 * i < bytes; i += THREADS)
        copy16(t.lf + 16 * i, src + 16 * i, min(16, bytes - 16 * i), a.vec_epi);
    } else if (r) {
      const int per = bn / 8;  // 16-byte pieces of a row
      for (int i = tid; i < r * per; i += THREADS) {
        const int j = i / per, pc = i % per, valid = max(0, min(16, 2 * cols - 16 * pc));
        const uint8_t* src = reinterpret_cast<const uint8_t*>(lorc_b + (size_t)j * N + t.n0);
        copy16(t.lf + j * bn * 2 + 16 * pc, valid ? src + 16 * pc : src, valid, a.vec_epi);
      }
    }
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nloc) load_chunk<TRANSPOSE>(a, t, x, codes, lorc_b, t.c0 + s, s, true, true);
      cp_commit();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // four loads in flight; the factors are made at the store
      const int i = u * THREADS + tid, row = i / tc, g = t.g_lo + i % tc;
      const int wrow = (TRANSPOSE ? t.k_lo : t.n0) + row;
      at[u] = i < n_tab && g < a.G && wrow < (TRANSPOSE ? K : N) ? wrow * a.G + g : -1;
      rsh[u] = shifts && at[u] >= 0 ? shifts[at[u]] : 0;
      rsc[u] = !shifts && at[u] >= 0 ? scale[at[u]] : 0.f;
      rsm[u] = TRANSPOSE && shifts && at[u] >= 0 ? smax[wrow] : 1.f;
    }
  };
  auto factor = [&](int sh, float sc, float sm) {  // folded 2^(126 - shift), 2^-shift * s_max
    if (!shifts) return sc;
    if (TRANSPOSE) return pow2i(-sh) * sm;
    return pow2i((E3M0 ? 124 : 126) - sh);
  };
  // a stack of slabs whose rows may all be zero (the MoE experts) waits for
  // its rows: a slab that no token picked reads no weight byte, and the
  // others gather only their live rows. Any other launch reads every row of
  // its tile from the start, the row list still unknown.
  const bool early = !QUANT_ACTS || gridDim.z == 1;
  t.gather = !early;
  if (early) prefetch();

  // The live rows: every row (non-QUANT_ACTS), or the rows whose full-K
  // absmax, shared across the cluster, is not exactly 0.
  if (QUANT_ACTS) {
    // |x| over this block's K slice, whose part the cluster's blocks share;
    // 8 elements an item (one if unaligned), folded into the row's maximum
    // as integers: non-negative floats order as their bits do, and a NaN's
    // bits lie above them all, so a NaN element makes the row's maximum NaN
    const int k_from = t.k_lo, k_to = t.k_hi;
    int* part = reinterpret_cast<int*>(t.amax_part);
    for (int i = tid; i < rows; i += THREADS) part[i] = 0;
    __syncthreads();
    const int per = a.vec_x ? (k_to - k_from + 7) / 8 : k_to - k_from;
#pragma unroll 4
    for (int i0 = tid - lane; i0 < rows * per; i0 += THREADS) {  // a whole warp each pass
      const int i = i0 + lane, row = i < rows * per ? i / per : -1, c = i - row * per;
      float mx = 0.f;
      if (row >= 0) {
        const __nv_bfloat16* src = x + (size_t)(t.m0 + row) * K + k_from;
        if (a.vec_x) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + 8 * c);
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = nan_max(fabsf(__bfloat162float(h[j])), mx);
        } else {
          mx = fabsf(to_f32(src[c]));
        }
      }
      const unsigned same = __match_any_sync(0xffffffffu, row);
      const int m = __reduce_max_sync(same, __float_as_int(mx));
      if (row >= 0 && lane == __ffs(same) - 1) atomicMax(part + row, m);
    }
    cluster.sync();
    if (tid < rows) {
      float mx = 0.f;
      for (int q = 0; q < ks; ++q) mx = nan_max(cluster.map_shared_rank(t.amax_part, q)[tid], mx);
      t.amax[tid] = mx;
      t.rscale[tid] = nan_max(mx * a.grid.inv_max, 1e-12f);
      t.rrcp[tid] = __frcp_rn(t.rscale[tid]);
    }
    __syncthreads();
  }
  if (warp == 0) {  // the live rows in order
    int base = 0;
    for (int i0 = 0; i0 < rows; i0 += 32) {
      const int i = i0 + lane;
      const bool on = i < rows && (!QUANT_ACTS || !(t.amax[i] == 0.f));
      const unsigned b = __ballot_sync(0xffffffffu, on);
      if (on) t.ridx[base + __popc(b & ((1u << lane) - 1u))] = i;
      base += __popc(b);
    }
    if (lane == 0) live[0] = base;
  }
  __syncthreads();
  t.live = live[0];
  if (QUANT_ACTS) {  // zero rows come out 0; rank q writes rows i with i % ks == q
    for (int i = rank; i < rows; i += ks) {
      if (!(t.amax[i] == 0.f)) continue;
      for (int n = tid; n < cols; n += THREADS)
        store_out(out + (size_t)(t.m0 + i) * N + t.n0 + n, 0.f);
    }
    if (t.live == 0) {  // no live row: nothing more to read (the whole cluster agrees)
      cp_wait_all();
      cluster.sync();  // its blocks have read each other's absmax parts
      return;
    }
  }
  const bool big = t.live > SKINNY;
  t.cpad = big ? TM : (t.live + 7) / 8 * 8;
  if (!early) prefetch();
  // the LoRC rows past those a chunk copies, and the activation rows past
  // the live ones, stay zero throughout
  for (int i = tid; i < (t.l.lc - t.l.lr) * 8 && !TRANSPOSE; i += THREADS)
    reinterpret_cast<uint4*>(t.wdec + (bn + t.l.lr) * BK * 2)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < t.cpad * 8; i += THREADS)
    if (item_row(i) >= t.live) reinterpret_cast<uint4*>(t.xq)[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u * THREADS + tid < n_tab) t.ftab[u * THREADS + tid] = factor(rsh[u], rsc[u], rsm[u]);
  for (int i = 4 * THREADS + tid; i < n_tab; i += THREADS) {
    const int row = i / tc, g = t.g_lo + i % tc, wrow = (TRANSPOSE ? t.k_lo : t.n0) + row;
    const bool ok = g < a.G && wrow < (TRANSPOSE ? K : N);
    const size_t idx = (size_t)wrow * a.G + g;
    t.ftab[i] = !ok ? 0.f : factor(shifts ? shifts[idx] : 0, shifts ? 0.f : scale[idx],
                                   TRANSPOSE && shifts ? smax[wrow] : 1.f);
  }
  if (big)
    k_loop<true, QUANT_ACTS, TRANSPOSE, E3M0>(a, t, x, codes, lorc_a, lorc_b, nloc);
  else
    k_loop<false, QUANT_ACTS, TRANSPOSE, E3M0>(a, t, x, codes, lorc_a, lorc_b, nloc);

  // The cluster's partial sums, in rank order; rank q finishes live rows
  // [q * live / ks, (q + 1) * live / ks).
  __syncthreads();
  cluster.sync();
  float* red = reinterpret_cast<float*>(smem);
  const int rp = t.l.rp, bs = __ffs(bn) - 1;
  const int i_lo = rank * t.live / ks, i_hi = (rank + 1) * t.live / ks;
  float* xr = reinterpret_cast<float*>(t.xq);  // [live row][j], bf16-rounded
  const __nv_bfloat16* lf = reinterpret_cast<const __nv_bfloat16*>(t.lf);
  if (r) {
    for (int i = tid; i < (i_hi - i_lo) * r; i += THREADS) {
      const int il = i_lo + i / r, j = i % r;
      xr[il * MAX_R + j] = __bfloat162float(__float2bfloat16_rn(
          cluster_sum(cluster, red, il * rp + bn + j, ks)));
    }
    __syncthreads();
  }
  for (int i = tid; i < (i_hi - i_lo) << bs; i += THREADS) {
    const int il = i_lo + (i >> bs), n = i & (bn - 1), nn = t.n0 + n;
    if (n >= cols) continue;
    float v = cluster_sum(cluster, red, il * rp + n, ks);
    if (!TRANSPOSE && smax) v *= t.smax[n];
    if (r) {
      float c = 0.f;
      for (int j = 0; j < r; ++j)
        c += xr[il * MAX_R + j] * __bfloat162float(lf[TRANSPOSE ? j * bn + n : n * r + j]);
      v += c;
    }
    store_out(out + (size_t)(t.m0 + t.ridx[il]) * N + nn, v);
  }
  cluster.sync();  // every rank's partial sums are read: the cluster may leave
}

// Launch x (E, M, K) -> out (E, M, N_out) with the plan (a.bn, a.ks).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan or shape the kernel does not take.
template <bool QUANT_ACTS, bool TRANSPOSE, bool E3M0 = false, typename OutT>
int launch(Args<OutT> a, int E, cudaStream_t stream) {
  const int nchunks = (a.K + BK - 1) / BK;
  if (a.r < 0 || a.r > MAX_R || a.ks < 1 || a.ks > MAX_KS || a.ks > nchunks ||
      !(a.bn == 32 || a.bn == 64 || a.bn == 128) || a.gs <= 0 || a.G <= 0)
    return (int)cudaErrorInvalidValue;
  const int kr = (nchunks + a.ks - 1) / a.ks * BK;  // most contraction rows of one rank
  a.tab_cols = TRANSPOSE ? (a.bn + a.gs - 1) / a.gs + 1 : (kr + a.gs - 1) / a.gs + 1;
  a.tab_cols = min(a.tab_cols, a.G);
  const Layout l = make_layout(a.M, a.bn, a.r, TRANSPOSE, (TRANSPOSE ? kr : a.bn) * a.tab_cols);
  if (l.total > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = w4a8_gemm_kernel<QUANT_ACTS, TRANSPOSE, OutT, E3M0>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err) return (int)err;
    attr = true;
  }
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int code_row = (TRANSPOSE ? a.N_out : a.K) / 2;  // bytes of a W row
  a.vec_codes = code_row % 16 == 0 && a.s_codes % 16 == 0 && aligned(a.codes);
  a.vec_x = a.K % 8 == 0 && a.s_x % 8 == 0 && aligned(a.x) &&
            (!a.r || TRANSPOSE || (a.s_lb % 8 == 0 && aligned(a.lorc_b)));
  a.vec_epi = (!a.smax || TRANSPOSE || (a.s_smax % 4 == 0 && aligned(a.smax))) &&
              (!a.r || (TRANSPOSE ? a.N_out % 8 == 0 && a.s_lb % 8 == 0 && aligned(a.lorc_b)
                                  : a.s_la % 8 == 0 && aligned(a.lorc_a)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N_out + a.bn - 1) / a.bn * a.ks, (a.M + TM - 1) / TM, E);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.ks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err ? (int)err : (int)cudaGetLastError();
}

}  // namespace
