// MLA latent decode attention for Hopper (sm_90a): absorbed flash-decoding
// over the paged latent pool (one KV "head" shared by every query head),
// split over the pages of each row and combined.
//
// Replaces the TPU kernel repro/kernels/decode_attn.py:287
// (paged_mla_decode_attn_pallas, its _mla_kernel at :220), with and without
// the packed-FP4 frozen region. For batch row b, the query heads attend the
// tokens of pages page_table[b, 0..PP) up to kv_lens[b]: scores s[h, t] =
// (q_lat[h] . ckv[t] + q_rope[h] . krope[t]) * scale (k = concat(ckv,
// krope), never materialized), a softmax in f32, and the context acc[h] =
// sum_t p[h, t] ckv[t] (v is the ckv view), out = acc / max(l, 1e-30) in
// f32. FP8 codes are worth their grid value times 2^-shift[page] (the
// integer exponent add of kernels/common.py::decode_fp8; the latent has one
// shift per page, shift[pid, 0]) times s_max[page]: never through the
// hardware E4M3 type, which tops out at 448 and reads S.1111.111 as NaN
// where this grid's top code is 480.
//
// What bounds it on the H100: the latent read, (r + dr) bytes a token for
// FP8 pages (288 at MiniCPM3), 1.06 MB at phase 3's contexts (0.32 us),
// against 2 H (2 r + dr) = 46 kFLOP a token on the tensor cores (0.16 us).
// At a decode step a launch lasts as long as its blocks' chains of
// dependent steps (page ids, the copies, two barriers, the combine), as
// in decode_attn.cu, which this design follows.
//  * Split-KV from shapes alone: a block takes `span` = 64 tokens of one
//    (row, group of G = 16 query heads), tokens [s * span, (s + 1) * span)
//    of the row, whatever the page size: several pages of 16, one of 64,
//    half of one of 128, or the tail of one page and the head of the next.
//    kernels/decode_attn.py::mla_decode_plan reads no length, so a captured
//    step replays the launch. At B = 4, H = 40, PP = 32 pages of 64 it is
//    4 x 3 x 32 = 384 blocks, one wave at three blocks an SM. A split
//    wholly past kv_lens[b] exits at once.
//  * A staged page serves 16 heads (the old kernel: 8). G = 16 is one m16
//    tile of query rows; all 40 in one block would leave B * splits = 64
//    blocks at the served PP = 16 for 132 SMs, so the grid's second axis
//    takes the three head groups (16, 16, 8), each staging the page again
//    from L2. Shared memory at r = 256, dr = 32, page 64: the raw FP8 rows
//    (18 KB), their bf16 operands (64 x 296 x 2 = 37 KB), q (9 KB), p in
//    three bf16 pieces (7 KB): 72 KB, three blocks an SM (bf16 pages: no
//    raw rows, 54 KB).
//  * The copies: the page ids are read beside kv_lens, then every valid
//    row of the split (and q) is issued as 16-byte cp.async copies before
//    any is waited for. Rows past kv_lens are never copied, so a stale NaN
//    in a recycled or null page (or the frozen dummy row) is never read;
//    the operand rows past them are zero.
//  * Placed decode, once a block: every thread turns 16 FP8 codes (or 32
//    FP4 codes) into bf16 operands, each code's fields placed under an
//    f32's (decode_attn.cu's `Placed`) and one multiply by 2^(127 - bias):
//    the code's grid value, exact in bf16 (at most 4 significant bits).
//    Where 2^-shift s_max would not be a normal product, or decode_code's
//    pow2i would clamp, the operand is decode_code(code, shift) (also exact
//    in bf16) and s_max alone is left for after the product.
//  * Scores on the tensor cores: mma.sync m16n8k16 with the 16 heads as M,
//    a warp's 16 tokens as N and the 256 + 32 dims as K (q and the
//    operands by ldmatrix); bf16 products are exact and sum in f32. Then
//    s = (q.ckv_op * post_c + q.krope_op * post_r) * scale, post = 2^-shift
//    s_max of the token's page and store, after the product: one rounding
//    apart from the plain version's q . (code s_max).
//  * p f32-accurate in P . V: p * post_c in f32, split into three bf16
//    pieces (hi, mid, lo: 24 bits, so a one-token row returns its latent
//    to an f32 rounding; two pieces would leave post_c off by 2^-17),
//    three mma.sync a k-step over the ckv operands (ldmatrix .trans), a
//    warp owning 64 of the 256 columns (a quarter of them at any width,
//    at most 128 columns a pass). The softmax of a split: its max
//    through shared memory (one barrier), exp in f32, the sum l per warp.
//  * The splits' (m, l, acc) go to a workspace the wrapper allocates; a
//    second kernel of the same call (split_combine.cuh) sums them in
//    split order: weight exp(m - M), then acc / max(l, 1e-30). No
//    atomics: repeated launches are bit-identical. A split that holds no valid token is never read;
//    a row with none returns 0, as the plain version does. The combine is
//    a programmatic dependent launch, as decode_attn.cu's.
// Masks are loop bounds or selects (a masked token's score is -inf, its p
// a selected 0, its operand row 0), never a multiply by 0.
// The frozen region (FROZEN, behind FP8 active pages): page ids >= base =
// P + 1 address the half-width packed FP4 E2M1 store, row min(pid - base,
// nfz), with its own s_max and shift; other ids read the FP8 store at
// min(pid, P), the clamps of the plain version. The id class is uniform
// within a page, so each page reads only the store that holds it. Packed
// rows are ceil(d / 2) bytes, low nibble first: 128 bytes for r = 256, 16
// for dr = 32; an odd width's pad nibble is never read into an operand.
// r = 256 and dr = 32 (MiniCPM3) are the template widths; any other width,
// or a store not aligned to 16 bytes, takes the generic path (operands
// decoded one element at a time, dims padded to 16 with zeros). Widths and
// page sizes are limited only by a block's shared memory (q and a split's
// operands, 160 (r + dr) bytes and ~8 KB besides: r + dr up to ~1350);
// past it the launch returns cudaErrorInvalidValue.
// Instantiated for bf16 pages, FP8 pages and FP8 pages with the FP4 frozen
// region; bf16 queries only (the Python wrapper refuses the rest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "split_combine.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G = 16;      // query heads a block: the M of one m16 tile
constexpr int TILE = 64;   // tokens a split, at most: 16 a warp
constexpr int PIECES = 3;  // bf16 pieces of p * post_c
constexpr float NEG = -1e30f;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may opt into
constexpr unsigned FULL = 0xffffffffu;

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

struct Pages {  // one store of the latent pool: ckv and krope
  const uint8_t *ckv, *krope;          // (n + 1, page, row bytes)
  const float *ckv_smax, *krope_smax;  // (n + 1,)
  const int *ckv_shift, *krope_shift;  // (n + 1, 1)
  Grid fmt;
  int rb_c, rb_r;                      // row bytes of ckv and krope
};

struct Args {
  const __nv_bfloat16 *q_lat, *q_rope;  // (B, H, r), (B, H, dr)
  Pages act, fz;
  const int *table, *lens;              // (B, PP), (B,)
  float *part_ml, *part_acc;            // (B, H, splits, 2) m and l; (B, H, splits, r) acc
  int H, r, dr, page, PP, span, splits;
  int base, nfz;                        // first frozen id (P + 1); the dummy row
  float scale;
};

// How one page of a split becomes operands, [0] ckv and [1] krope: its row
// 0 in the store that holds it, that store's row bytes, the page's shift,
// whether the placed decode applies, and the factor after the product.
struct PageOp {
  const uint8_t* row0[2];
  float post[2];
  int rb[2], shift[2], fast[2], fp4;
};

// A page's codes -> bf16 operands, exactly: placed fields times
// 2^(127 - bias) (the code's grid value) when fast, else decode_code.
struct Operand {
  Grid f;
  float c;
  int sh, mask, bits, shift, fast;
  __device__ Operand(const Grid& g, int shift_, int fast_) : f(g), shift(shift_), fast(fast_) {
    c = __int_as_float((254 - g.bias) << 23);  // 2^(127 - bias)
    sh = 8 - g.exp_bits;
    mask = (int)(0x80000000u | (((1u << (g.exp_bits + g.man_bits)) - 1) << (23 - g.man_bits)));
    bits = 1 + g.exp_bits + g.man_bits;
  }
  // top: the code in the top bits of an int
  __device__ __forceinline__ float operator()(int top) const {
    return fast ? __int_as_float((top >> sh) & mask) * c
                : decode_code((int)((unsigned)top >> (32 - bits)), shift, f);
  }
};

// The pages a split of at most TILE tokens touches, at most.
__host__ __device__ inline int max_pages(int page) {
  const int n = (page + TILE - 2) / page + 1;
  return n < TILE ? n : TILE;
}

// The block's shared memory: PageOp[max_pages] | post_c, post_r of each token |
// the warps' max and sum (WARPS x G each) | q (G x LP bf16) | p's pieces
// (PIECES x G x PP_LD bf16) | the operands (TILE x LP bf16: ckv dims [0, RP),
// krope dims [RP, RP + DRP)) | the raw rows (TILE x RAWP bytes; FP8 stores
// on the template widths only).
constexpr int PP_LD = TILE + 8;
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }
struct Layout {
  size_t post, red, q, p, opnd, raw, bytes;
  __host__ __device__ Layout(int npages, int lp, int rawp) {
    post = align16(sizeof(PageOp) * npages);
    red = post + sizeof(float) * 2 * TILE;
    q = align16(red + sizeof(float) * 2 * WARPS * G);
    p = q + sizeof(__nv_bfloat16) * G * lp;
    opnd = align16(p + sizeof(__nv_bfloat16) * PIECES * G * PP_LD);
    raw = opnd + sizeof(__nv_bfloat16) * TILE * lp;
    bytes = raw + (size_t)TILE * rawp;
  }
};

// One split of one (row b, group of G query heads): its (m, l, acc) into the
// workspace. R, DR: the template widths (r, dr), 0 for the generic path.
template <int R, int DR, int STORE>
__global__ void __launch_bounds__(THREADS) mla_decode_split_kernel(const Args a) {
  constexpr bool VEC = R != 0;
  constexpr int MAX_TPW = VEC ? R / 32 : 16;  // n8 column tiles a warp and pass
  asm volatile("griddepcontrol.launch_dependents;\n");  // the combine may start its prologue
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.x, h0 = blockIdx.y * G, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = s * a.span, jp0 = t0 / a.page;  // the split's first token and its page
  const int jn = min((t0 + a.span - 1) / a.page + 1, a.PP) - jp0;  // pages the split touches
  int pid = 0;
  if (tid < jn) pid = a.table[(size_t)b * a.PP + jp0 + tid];  // beside kv_lens, not after it
  const int len = a.lens[b];
  const int lenc = min(len, a.PP * a.page);
  const int n = min(a.span, lenc - t0);  // valid tokens of the split: [0, n)
  if (n <= 0) return;

  const int r = VEC ? R : a.r, dr = VEC ? DR : a.dr;
  const int RP = (r + 15) & ~15, DRP = (dr + 15) & ~15, LP = RP + DRP + 8;
  const int rawp = (VEC && STORE != BF16) ? R + DR : 0;
  const Layout lay(max_pages(a.page), LP, rawp);
  PageOp* pages = reinterpret_cast<PageOp*>(smem);
  float* post = reinterpret_cast<float*>(smem + lay.post);  // (2, TILE)
  float* red_m = reinterpret_cast<float*>(smem + lay.red);  // (WARPS, G)
  float* red_l = red_m + WARPS * G;                         // (WARPS, G)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(smem + lay.opnd);
  uint8_t* raw = smem + lay.raw;
  const int gh = min(G, a.H - h0);  // real heads of this group

  // the split's pages with a valid token: where each lives (thread p).
  // Token t of the split is row (t0 + t) % page of pages[(t0 + t) / page - jp0].
  const int npv = (t0 + n - 1) / a.page - jp0 + 1;
  if (tid < npv) {
    PageOp& pg = pages[tid];
    const bool frozen = STORE == FROZEN && pid >= a.base;
    const int row = frozen ? min(pid - a.base, a.nfz) : STORE == FROZEN ? min(pid, a.base - 1) : pid;
    const Pages& st = frozen ? a.fz : a.act;
    pg.fp4 = frozen;
    pg.rb[0] = st.rb_c;
    pg.rb[1] = st.rb_r;
    pg.row0[0] = st.ckv + (size_t)row * a.page * st.rb_c;
    pg.row0[1] = st.krope + (size_t)row * a.page * st.rb_r;
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      if (STORE == BF16) {
        pg.post[part] = 1.f;
        pg.shift[part] = 0;
        pg.fast[part] = 1;
        continue;
      }
      const int sh = (part ? st.krope_shift : st.ckv_shift)[row];
      const float sm = (part ? st.krope_smax : st.ckv_smax)[row];
      const float pf = __int_as_float((127 - max(-127, min(126, sh))) << 23) * sm;  // 2^-shift s_max
      const int top = (1 << st.fmt.exp_bits) - 1 - st.fmt.bias - sh;
      const bool fast = 1 - st.fmt.bias - sh >= -126 && top <= 127 && sh <= 126 && sh >= -127 &&
                        (pf == 0.f || (fabsf(pf) >= 1.17549435e-38f && fabsf(pf) <= 3.40282347e38f));
      pg.post[part] = fast ? pf : sm;
      pg.shift[part] = sh;
      pg.fast[part] = fast;
    }
  }
  __syncthreads();

  // every valid row of the split (and q) before any wait
  if constexpr (VEC) {
    constexpr int QC = R / 8, QRC = DR / 8;  // 16-byte chunks of a q_lat and a q_rope row
    for (int i = tid; i < G * (QC + QRC); i += THREADS) {
      const int hh = i / (QC + QRC), c = i % (QC + QRC), head = min(h0 + hh, a.H - 1);
      const __nv_bfloat16* src = c < QC ? a.q_lat + ((size_t)b * a.H + head) * R + c * 8
                                        : a.q_rope + ((size_t)b * a.H + head) * DR + (c - QC) * 8;
      cp_async16(qs + hh * LP + (c < QC ? c * 8 : R + (c - QC) * 8), src, hh < gh);
    }
    constexpr int CC8 = R / 16, CR8 = DR / 16;  // 16-byte chunks of an FP8 ckv / krope row
    if (STORE == BF16) {
      constexpr int CC = R / 8, CR = DR / 8;
      for (int i = tid; i < n * (CC + CR); i += THREADS) {
        const int t = i / (CC + CR), c = i % (CC + CR), j = (t0 + t) / a.page;
        const PageOp& pg = pages[j - jp0];
        const int u = t0 + t - j * a.page;
        cp_async16(op + t * LP + (c < CC ? c * 8 : R + (c - CC) * 8),
                   c < CC ? pg.row0[0] + (size_t)u * pg.rb[0] + c * 16
                          : pg.row0[1] + (size_t)u * pg.rb[1] + (c - CC) * 16);
      }
      for (int i = tid; i < (TILE - n) * (CC + CR); i += THREADS) {
        const int t = n + i / (CC + CR), c = i % (CC + CR);
        *reinterpret_cast<uint4*>(op + t * LP + (c < CC ? c * 8 : R + (c - CC) * 8)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int i = tid; i < n * (CC8 + CR8); i += THREADS) {
        const int t = i / (CC8 + CR8), c = i % (CC8 + CR8), j = (t0 + t) / a.page;
        const PageOp& pg = pages[j - jp0];
        const int u = t0 + t - j * a.page;
        const int cc = pg.fp4 ? CC8 / 2 : CC8, cr = pg.fp4 ? CR8 / 2 : CR8;  // FP4: half
        if (c >= cc + cr) continue;
        cp_async16(raw + t * rawp + c * 16, c < cc ? pg.row0[0] + (size_t)u * pg.rb[0] + c * 16
                                                   : pg.row0[1] + (size_t)u * pg.rb[1] + (c - cc) * 16);
      }
    }
  } else {  // generic widths: q and the operands one element at a time
    for (int i = tid; i < G * (RP + DRP); i += THREADS) {
      const int hh = i / (RP + DRP), c = i % (RP + DRP);
      float v = 0.f;
      if (hh < gh) {
        if (c < r) v = __bfloat162float(a.q_lat[((size_t)b * a.H + h0 + hh) * r + c]);
        else if (c >= RP && c - RP < dr)
          v = __bfloat162float(a.q_rope[((size_t)b * a.H + h0 + hh) * dr + c - RP]);
      }
      qs[hh * LP + c] = __float2bfloat16_rn(v);
    }
  }
  for (int t = tid; t < TILE; t += THREADS) {  // each token's factors after the product
    const PageOp* pg = t < n ? &pages[(t0 + t) / a.page - jp0] : nullptr;
    post[t] = pg ? pg->post[0] : 0.f;
    post[TILE + t] = pg ? pg->post[1] : 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the operands, decoded once for the block's G heads
  if constexpr (STORE != BF16 && VEC) {
    constexpr int CC8 = R / 16, CR8 = DR / 16, CH = CC8 + CR8;
    for (int i = tid; i < TILE * CH; i += THREADS) {
      const int t = i / CH, c = i % CH;
      __nv_bfloat16* row = op + t * LP;
      if (t >= n) {  // zero rows past the valid tokens (P . V reads them at p = 0)
        uint4* d = reinterpret_cast<uint4*>(row + (c < CC8 ? c * 16 : R + (c - CC8) * 16));
        d[0] = d[1] = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const PageOp& pg = pages[(t0 + t) / a.page - jp0];
      const uint4 w = *reinterpret_cast<const uint4*>(raw + t * rawp + c * 16);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      if (STORE == FROZEN && pg.fp4) {  // 32 nibbles: dim 2m is byte m's low nibble
        if (c >= (CC8 + CR8) / 2) continue;
        const int part = c < CC8 / 2 ? 0 : 1;
        const Operand dec(a.fz.fmt, pg.shift[part], pg.fast[part]);
        uint32_t o[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          o[e] = pack_bf16(dec((int)(ws[e >> 2] << (28 - 8 * (e & 3)))),
                           dec((int)(ws[e >> 2] << (24 - 8 * (e & 3)))));
        uint4* d = reinterpret_cast<uint4*>(row + (part ? R : c * 32));
#pragma unroll
        for (int k = 0; k < 4; ++k) d[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
      } else {  // 16 bytes, one code each
        const int part = c < CC8 ? 0 : 1;
        const Operand dec(a.act.fmt, pg.shift[part], pg.fast[part]);
        uint32_t o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = pack_bf16(dec((int)(ws[e >> 1] << (24 - 16 * (e & 1)))),
                           dec((int)(ws[e >> 1] << (16 - 16 * (e & 1)))));
        uint4* d = reinterpret_cast<uint4*>(row + (part ? R + (c - CC8) * 16 : c * 16));
        d[0] = make_uint4(o[0], o[1], o[2], o[3]);
        d[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncthreads();
  } else if constexpr (!VEC) {
    for (int i = tid; i < TILE * (RP + DRP); i += THREADS) {
      const int t = i / (RP + DRP), c = i % (RP + DRP);
      const int part = c < RP ? 0 : 1, dim = part ? c - RP : c, d = part ? dr : r;
      float v = 0.f;
      if (t < n && dim < d) {
        const int j = (t0 + t) / a.page;
        const PageOp& pg = pages[j - jp0];
        const uint8_t* src = pg.row0[part] + (size_t)(t0 + t - j * a.page) * pg.rb[part];
        if (STORE == BF16) {
          v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(src)[dim]);
        } else if (STORE == FROZEN && pg.fp4) {
          const int code = dim & 1 ? src[dim >> 1] >> 4 : src[dim >> 1] & 15;
          v = Operand(a.fz.fmt, pg.shift[part], pg.fast[part])((int)((unsigned)code << 28));
        } else {
          v = Operand(a.act.fmt, pg.shift[part], pg.fast[part])((int)((unsigned)src[dim] << 24));
        }
      }
      op[t * LP + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
  }

  // scores of this warp's 16 tokens for the G heads, on the tensor cores
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3, w0 = warp * 16;
  float sc[2][4];
  float mx[2] = {-INFINITY, -INFINITY};
  if (w0 < n) {
    float ac[2][4] = {}, ar[2][4] = {};
    const __nv_bfloat16* qa = qs + (lane & 15) * LP + ((lane >> 4) << 3);
    const __nv_bfloat16* kb = op + (w0 + (lane & 7) + ((lane >> 4) << 3)) * LP + (((lane >> 3) & 1) << 3);
#pragma unroll 4
    for (int kk = 0; kk < RP / 16; ++kk) {
      uint32_t qf[4], kf[4];
      ldsm_x4(qf, qa + kk * 16);
      ldsm_x4(kf, kb + kk * 16);
      mma_bf16(ac[0], qf, kf[0], kf[1]);
      mma_bf16(ac[1], qf, kf[2], kf[3]);
    }
#pragma unroll
    for (int kk = 0; kk < DRP / 16; ++kk) {
      uint32_t qf[4], kf[4];
      ldsm_x4(qf, qa + RP + kk * 16);
      ldsm_x4(kf, kb + RP + kk * 16);
      mma_bf16(ar[0], qf, kf[0], kf[1]);
      mma_bf16(ar[1], qf, kf[2], kf[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = w0 + 8 * j + 2 * t4 + (e & 1);
        const float x = (ac[j][e] * post[t] + ar[j][e] * post[TILE + t]) * a.scale;
        sc[j][e] = t < n ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
  }
  if (t4 == 0) {
    red_m[warp * G + g] = mx[0];
    red_m[warp * G + g + 8] = mx[1];
  }
  __syncthreads();

  // the split's max of each head, p = exp(s - m) in f32, its sum, and
  // p * post_c in three bf16 pieces for P . V
  float m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m[i] = fmaxf(m[i], red_m[w * G + g + 8 * i]);
  }
  if (w0 < n) {
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t pw[PIECES][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x[2], pc[PIECES][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = w0 + 8 * j + 2 * t4 + e;
          const float p = t < n ? expf(sc[j][2 * i + e] - m[i]) : 0.f;
          ls[i] += p;
          x[e] = p * post[t];
#pragma unroll
          for (int k = 0; k < PIECES; ++k) {
            const __nv_bfloat16 piece = __float2bfloat16_rn(x[e]);
            pc[k][e] = __bfloat162float(piece);
            x[e] -= pc[k][e];
          }
        }
#pragma unroll
        for (int k = 0; k < PIECES; ++k) pw[k][i] = pack_bf16(pc[k][0], pc[k][1]);
      }
#pragma unroll
      for (int k = 0; k < PIECES; ++k) {
        __nv_bfloat16* pr = ps + (k * G + g) * PP_LD + w0 + 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(pr) = pw[k][0];
        *reinterpret_cast<uint32_t*>(pr + 8 * PP_LD) = pw[k][1];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ls[i] += __shfl_xor_sync(FULL, ls[i], 1);
      ls[i] += __shfl_xor_sync(FULL, ls[i], 2);
    }
    if (t4 == 0) {
      red_l[warp * G + g] = ls[0];
      red_l[warp * G + g + 8] = ls[1];
    }
  } else if (t4 == 0) {
    red_l[warp * G + g] = red_l[warp * G + g + 8] = 0.f;
  }
  __syncthreads();

  // acc = (p * post_c) . ckv_op: this warp's column tiles, MAX_TPW at a
  // pass, every valid k-step; then the split's partials of the real heads
  // (one pass of R / 32 tiles a warp on the template widths)
  const int nt = RP / 8, tpw = VEC ? MAX_TPW : (nt + WARPS - 1) / WARPS, nk = (n + 15) >> 4;
  const int c_end = VEC ? (warp + 1) * MAX_TPW : min(nt, (warp + 1) * tpw);
  for (int c0 = warp * tpw; c0 < c_end; c0 += MAX_TPW) {
    const int nc = VEC ? MAX_TPW : min(MAX_TPW, c_end - c0);
    float o[MAX_TPW][4];
#pragma unroll
    for (int c = 0; c < MAX_TPW; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
    for (int kk = 0; kk < nk; ++kk) {
      uint32_t pa[PIECES][4];
#pragma unroll
      for (int k = 0; k < PIECES; ++k)
        ldsm_x4(pa[k], ps + (k * G + (lane & 15)) * PP_LD + kk * 16 + ((lane >> 4) << 3));
      const __nv_bfloat16* vb = op + (kk * 16 + (lane & 15)) * LP;
#pragma unroll
      for (int c = 0; c < MAX_TPW; ++c) {
        if (c >= nc) break;
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, vb + (c0 + c) * 8);
#pragma unroll
        for (int k = 0; k < PIECES; ++k) mma_bf16(o[c], pa[k], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hh = g + 8 * i;
      if (hh >= gh) continue;
      float* acc = a.part_acc + (((size_t)b * a.H + h0 + hh) * a.splits + s) * r;
#pragma unroll
      for (int c = 0; c < MAX_TPW; ++c) {
        if (c >= nc) break;
        const int col = (c0 + c) * 8 + 2 * t4;
        if (col < r) acc[col] = o[c][2 * i];
        if (col + 1 < r) acc[col + 1] = o[c][2 * i + 1];
      }
    }
  }
  if (warp == 0 && t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hh = g + 8 * i;
      if (hh >= gh) continue;
      const size_t idx = ((size_t)b * a.H + h0 + hh) * a.splits + s;
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l += red_l[w * G + hh];
      a.part_ml[2 * idx] = m[i];
      a.part_ml[2 * idx + 1] = l;
    }
  }
}

template <int R, int DR, int STORE>
int launch_split(const Args& a, int B, cudaStream_t stream) {
  const int RP = (a.r + 15) & ~15, DRP = (a.dr + 15) & ~15;
  const size_t bytes =
      Layout(max_pages(a.page), RP + DRP + 8, (R != 0 && STORE != BF16) ? R + DR : 0).bytes;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = mla_decode_split_kernel<R, DR, STORE>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(a.splits, (a.H + G - 1) / G, B), THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R, int DR>
int by_store(int store, const Args& a, int B, cudaStream_t s) {
  return store == FROZEN ? launch_split<R, DR, FROZEN>(a, B, s)
       : store == FP8    ? launch_split<R, DR, FP8>(a, B, s)
                         : launch_split<R, DR, BF16>(a, B, s);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// q_lat: (B, H, r) bf16; q_rope: (B, H, dr) bf16; ckv: (P+1, page, r) and
// krope: (P+1, page, dr), uint8 FP8 codes (fp8 = 1, grid exp_bits /
// man_bits / bias) or bf16; ckv/krope_smax (P+1,) f32 and ckv/krope_shift
// (P+1, 1) int32 (read only for fp8 pages); page_table (B, PP) int32;
// kv_lens (B,) int32; out (B, H, r) f32. frozen = 1 (fp8 pages only):
// ckv/krope_fz (nfz+1, page, ceil(d/2)) packed codes of the grid (fz_*),
// their smax (nfz+1,) f32 and shift (nfz+1, 1) int32; table ids >= P+1
// address them. The launch plan (kernels/decode_attn.py::mla_decode_plan):
// span tokens a split (at most 64), splits a row (ceil(PP * page / span)),
// group query heads a block (16), threads a block (128); part_ml
// (B, H, splits, 2) and part_acc (B, H, splits, r) f32 the splits'
// workspace. Every operand is contiguous. Launches the split kernel and the
// combine on `stream`; returns cudaGetLastError().
extern "C" int mla_decode_attn_launch(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope, int fp8,
    const void* ckv_smax, const void* ckv_shift, const void* krope_smax,
    const void* krope_shift, const void* page_table, const void* kv_lens, void* out, int B,
    int H, int r, int dr, int page, int PP, float scale, int exp_bits, int man_bits, int bias,
    int frozen, const void* ckv_fz, const void* krope_fz, const void* ckv_fz_smax,
    const void* ckv_fz_shift, const void* krope_fz_smax, const void* krope_fz_shift,
    int n_pages1, int nfz, int fz_exp_bits, int fz_man_bits, int fz_bias, int span, int splits,
    int group, int threads, void* part_ml, void* part_acc, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  if (r <= 0 || dr <= 0 || page <= 0 || PP <= 0 || span <= 0 || span > TILE || splits <= 0 ||
      (long long)span * splits < (long long)PP * page || group != G || threads != THREADS ||
      (frozen && (!fp8 || nfz < 0)))
    return (int)cudaErrorInvalidValue;
  const int es = fp8 ? 1 : 2;
  const Pages act{(const uint8_t*)ckv, (const uint8_t*)krope, (const float*)ckv_smax,
                  (const float*)krope_smax, (const int*)ckv_shift, (const int*)krope_shift,
                  Grid{exp_bits, man_bits, bias}, r * es, dr * es};
  const Pages fz{(const uint8_t*)ckv_fz, (const uint8_t*)krope_fz, (const float*)ckv_fz_smax,
                 (const float*)krope_fz_smax, (const int*)ckv_fz_shift,
                 (const int*)krope_fz_shift, Grid{fz_exp_bits, fz_man_bits, fz_bias},
                 (r + 1) / 2, (dr + 1) / 2};
  const Args a{(const __nv_bfloat16*)q_lat, (const __nv_bfloat16*)q_rope, act, fz,
               (const int*)page_table, (const int*)kv_lens, (float*)part_ml, (float*)part_acc,
               H, r, dr, page, PP, span, splits, n_pages1, nfz, scale};
  const int store = frozen ? FROZEN : fp8 ? FP8 : BF16;
  const bool vec = r == 256 && dr == 32 && aligned16(q_lat) && aligned16(q_rope) &&
                   aligned16(ckv) && aligned16(krope) &&
                   (!frozen || (aligned16(ckv_fz) && aligned16(krope_fz)));
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = vec ? by_store<256, 32>(store, a, B, s) : by_store<0, 0>(store, a, B, s);
  if (rc) return rc;
  return launch_split_combine(part_ml, part_acc, kv_lens, out, B, H, r, splits, span, PP, page, 0,
                              s);
}
