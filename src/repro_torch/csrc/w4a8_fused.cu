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
//     quantizes to zeros, so its output is 0: the kernel writes that 0
//     without multiplying the row (a NaN row is no zero row);
//   * packed FP4 weights (two nibbles per byte, low nibble = even column),
//     decoded exactly (quant_common.cuh's closed forms, as bit patterns). Normal orientation
//     (y[e] = x[e] W[e]^T, contracting W's in columns): with M2 the
//     per-group scale is the exact power of two 2^-shift (built from the
//     f32 bit pattern) and s_max multiplies each output column once after
//     the K loop; without M2 the f32 group scale multiplies the decoded
//     value. TRANSPOSE (y[e] = x[e] W[e], contracting W's out rows, the
//     output spanning W's in columns): each decoded row is scaled by
//     2^-shift[n, g] * s_max[n] before it enters the sum, since s_max
//     varies along the contraction (w4a8_fused.py:121-127);
//   * bf16 products accumulated in f32 on the tensor cores;
//   * the LoRC epilogue: xr = bf16(xq . B^T) then + xr . A^T (normal), or
//     xr = bf16(xq . A) then + xr . B (transposed), then one write.
// Weights are FP4 E2M1 or E3M0 (the E3M0 template flag; repro's
// PRESETS["w4a8_e3m0_fp"]). The 2-D GEMM quantizes its activations onto
// the FP8 grid it is given (E4M3 or E5M2) or takes them as they are
// (a_fmt=None) and writes bf16; the batched normal orientation does the
// same and writes f32; the transposed one takes them as they are and writes
// f32 (no repro path quantizes there; the Python wrappers refuse it).
//
// What bounds it on the H100, by regime:
//   * decode (M = slots, a handful of rows): the packed weight read, N*K/2
//     bytes, all the traffic (MiniCPM3-4B's 2560 -> 6400: 8.2 MB, 2.4 us at
//     3.35 TB/s), and the latency of reaching it from few blocks;
//   * the MoE expert stacks (E = 64 slabs, 2048 -> 1024 or 1024 -> 2048, 67
//     MB of codes): at a decode step each token's row is nonzero in 8 of the
//     64 slabs, so about 26 slabs hold any live row; at a mixed step of 260
//     rows about 33 rows a slab are live: bytes bound both (about 20 us for
//     the touched slabs), and the zero rows are no work at all;
//   * prefill (M of 64..256 live rows): the tensor-core work (2*M*N*K) and
//     the bytes together, both small, so the per-chunk latency and the
//     quantization each column block repeats for its rows.
// What the design does about it (w4a8_gemm.cuh): weights stay packed in
// device memory (4 bits per value) and are decoded in shared memory right
// before use, straight into the tensor cores' operand layout; the codes,
// the activation rows and LoRC's factor move by 16-byte cp.async through a
// 4-stage ring; K is split over a thread-block cluster and the partial sums
// of y and xr meet in distributed shared memory in rank order (the plan,
// kernels/w4a8_fused.py::gemm_plan, puts at least 132 blocks in flight at
// decode for every weight of 1 MB or more); a block quantizes only its own K
// slice, from its rows' full-K absmax shared across the cluster, multiplies
// only the rows whose absmax is not 0 and writes 0 for the others (a slab
// with no live row reads no weight byte); LoRC's factor joins the weight
// tile as extra output channels. A decode step's few rows run mma.sync with
// the output channels as the tensor cores' rows; 33..64 live rows run
// wgmma. blockIdx.z picks the slice e; every operand has its own slice
// stride, and lorc_b may come with stride 0 (one factor broadcast over the
// MLA heads, never copied).

#include "w4a8_gemm.cuh"  // Args, Grid, MAX_R, launch<QUANT_ACTS, TRANSPOSE, E3M0>

// x: (M, K) bf16 raw activations; out: (M, N) bf16.
// codes: (N, K/2) uint8 nibbles, E2M1 (e3m0 = 0) or E3M0 (e3m0 = 1); scale:
// (N, K/gs) f32 (read when shifts is null); shifts: (N, K/gs) int8 and smax:
// (N,) f32 for M2, else both null; lorc_a: (N, r) bf16, lorc_b: (r, K) bf16
// when r > 0; quant_acts = 1: x is quantized onto the activation grid (a_*,
// FP8 E4M3 or E5M2), 0: taken as it is. bn, ks: the launch plan
// (kernels/w4a8_fused.py::gemm_plan). Returns cudaGetLastError() after the
// launch.
extern "C" int w4a8_fused_launch(const void* x, const void* codes, const void* scale,
                                 const void* shifts, const void* smax, const void* lorc_a,
                                 const void* lorc_b, void* out, int M, int N, int K, int gs,
                                 int r, int a_man_bits, int a_min_exp, int a_max_exp,
                                 float a_max_value, float a_inv_max, int quant_acts, int e3m0,
                                 int bn, int ks, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (r > MAX_R || K % 2 || gs <= 0 || K % gs) return (int)cudaErrorInvalidValue;
  Args<__nv_bfloat16> a{(const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale,
                        (const int8_t*)shifts, (const float*)smax,
                        (const __nv_bfloat16*)lorc_a, (const __nv_bfloat16*)lorc_b,
                        (__nv_bfloat16*)out, M, K, N, gs, K / gs, r, 0, 0, 0, 0, 0, 0,
                        Grid{a_man_bits, a_min_exp, a_max_exp, a_max_value, a_inv_max},
                        bn, ks, 0, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (quant_acts)
    return e3m0 ? launch<true, false, true>(a, 1, s) : launch<true, false, false>(a, 1, s);
  return e3m0 ? launch<false, false, true>(a, 1, s) : launch<false, false, false>(a, 1, s);
}

// The batched orientations over E slices, f32 out. quant_acts = 1 (normal
// orientation only): each x row is quantized onto the activation grid
// (a_*) over its full In, as w4a8_fused_launch does; quant_acts = 0: the
// bf16 activations are taken as they are. W: codes (E, N, In/2) uint8 E2M1
// (e3m0 = 0) or E3M0 (e3m0 = 1),
// scale / shifts (E, N, In/gs), smax (E, N) (M2: shifts and smax, else both
// null), lorc_a (E, N, r) and lorc_b (E, r, In) bf16 when r > 0, with
// per-slice strides s_la and s_lb (s_lb 0: one factor for every slice).
// transpose = 0: x (E, M, In), out (E, M, N) = x W^T.
// transpose = 1: x (E, M, N), out (E, M, In) = x W.
// Every operand but lorc_b is contiguous. bn, ks: the launch plan
// (kernels/w4a8_fused.py::gemm_plan). Returns cudaGetLastError().
extern "C" int w4a8_batched_launch(const void* x, const void* codes, const void* scale,
                                   const void* shifts, const void* smax, const void* lorc_a,
                                   const void* lorc_b, void* out, int E, int M, int N, int In,
                                   int gs, int r, long long s_la, long long s_lb, int transpose,
                                   int quant_acts, int a_man_bits, int a_min_exp,
                                   int a_max_exp, float a_max_value, float a_inv_max, int e3m0,
                                   int bn, int ks, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (r > MAX_R || In % 2 || gs <= 0 || In % gs || (quant_acts && transpose))
    return (int)cudaErrorInvalidValue;
  const int G = In / gs;
  const int K = transpose ? N : In, N_out = transpose ? In : N;
  Args<float> a{(const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale,
                (const int8_t*)shifts, (const float*)smax, (const __nv_bfloat16*)lorc_a,
                (const __nv_bfloat16*)lorc_b, (float*)out, M, K, N_out, gs, G, r,
                (long long)M * K, (long long)N * (In / 2), (long long)N * G, (long long)N,
                s_la, s_lb, Grid{a_man_bits, a_min_exp, a_max_exp, a_max_value, a_inv_max},
                bn, ks, 0, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (transpose)
    return e3m0 ? launch<false, true, true>(a, E, s) : launch<false, true, false>(a, E, s);
  if (quant_acts)
    return e3m0 ? launch<true, false, true>(a, E, s) : launch<true, false, false>(a, E, s);
  return e3m0 ? launch<false, false, true>(a, E, s) : launch<false, false, false>(a, E, s);
}
