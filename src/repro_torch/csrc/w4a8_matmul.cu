// Split W4A8 GEMM for Hopper (sm_90a): y = x_q . deq(W)^T over activations
// that arrive already quantized.
//
// Replaces the TPU kernel repro/kernels/w4a8_matmul.py:79
// (w4a8_matmul_pallas, body _kernel at :41): the second pass of the split
// pipeline (act_quant -> device memory -> this GEMM -> LoRC matmuls outside)
// that the fused kernel (w4a8_fused.cu) is measured against. Computes what
// that kernel computes:
//   * x_q (M, K) bf16: values on the FP8 grid times their token scale, as
//     act_quant.cu and one bf16 cast produce them; taken as they are;
//   * packed FP4 weights, E2M1 or E3M0 (two nibbles per byte, low nibble =
//     even column), decoded by the closed forms of quant_common.cuh. Each
//     decoded value is scaled by its group's scale and rounded to bf16
//     (w4a8_matmul.py:60): with M2 the scale is the exact power of two
//     2^-shift built from the f32 bit pattern, and s_max multiplies each
//     output column once after the K loop (:70-74); without M2 it is the f32
//     group scale;
//   * bf16 products accumulated in f32 on the tensor cores, f32 out.
// No activation quantization and no LoRC inside: the split pipeline does
// those outside, as the kernel microbench does.
//
// What bounds it on the H100: at decode (M of a few rows) the packed weight
// read, N*K/2 bytes, is all the traffic (768 -> 3072: 1.2 MB, 0.35 us at
// 3.35 TB/s) and the latency of reaching it; at M = 256 the x_q read and
// the f32 output join it and the tensor-core work (2*M*N*K, 1.2 GFLOP at
// 768 -> 3072, 1.2 us at the bf16 peak) is of the same size, so bytes,
// operations and the chunk loop's latency all count.
// What the design does about it: this is the fused GEMM's kernel
// (w4a8_gemm.cuh) with the in-kernel quantization off (QUANT_ACTS = false,
// so every row is live), no LoRC (r = 0), one slice and f32 out: the same
// cp.async ring, exact decode into the tensor cores' layout, cluster split
// of K and epilogue, so split and fused differ only by what the fused
// kernel adds (the absmax, the quantization, LoRC's channels). Few rows run
// mma.sync, 33..64 rows a block wgmma. Any M and N: the ragged edges are
// zero-filled by the copies and masked at the write (the Pallas kernel
// clamps its tiles to divisors instead).

#include "w4a8_gemm.cuh"  // Args, Grid, launch<QUANT_ACTS, TRANSPOSE, E3M0>

// x: (M, K) bf16 quantized activations; out: (M, N) f32. codes: (N, K/2)
// uint8 nibbles, E2M1 (e3m0 = 0) or E3M0 (e3m0 = 1); scale: (N, K/gs) f32
// (read when shifts is null); shifts: (N, K/gs) int8 and smax: (N,) f32 for
// M2, else both null. bn, ks: the launch plan
// (kernels/w4a8_fused.py::gemm_plan). Every operand contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int w4a8_split_launch(const void* x, const void* codes, const void* scale,
                                 const void* shifts, const void* smax, void* out, int M, int N,
                                 int K, int gs, int e3m0, int bn, int ks, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K % 2 || gs <= 0 || K % gs || (shifts == nullptr) != (smax == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args<float> a{(const __nv_bfloat16*)x, (const uint8_t*)codes, (const float*)scale,
                      (const int8_t*)shifts, (const float*)smax, nullptr, nullptr,
                      (float*)out, M, K, N, gs, K / gs, 0, 0, 0, 0, 0, 0, 0,
                      Grid{0, 0, 0, 0.f, 0.f}, bn, ks, 0, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return e3m0 ? launch<false, false, true>(a, 1, s) : launch<false, false, false>(a, 1, s);
}
