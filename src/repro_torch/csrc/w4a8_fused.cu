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
// are and writes f32 (the Python wrappers refuse the rest). The kernel
// itself is w4a8_gemm.cuh's, which the split GEMM (w4a8_matmul.cu) shares.

#include "w4a8_gemm.cuh"  // Args, Grid, MAX_R, launch<QUANT_ACTS, TRANSPOSE, E3M0>

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
