// Token-wise activation quantization onto a saturating FP8 grid, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/act_quant.py:41 (act_quant_pallas;
// its body _kernel at :33 is kernels/common.py:200, quantize_rows). Computes
// what that kernel computes, per row of x (rows, d), d of any width:
//   scale = max(absmax * (1 / fmt_max), 1e-12)   (the f32 reciprocal, multiplied)
//   q     = RNE-grid(x / scale)                   (a true division)
// and writes q as f32 (rows, d) and the scale as f32 (rows, 1). x is f32 or
// bf16 (read as f32). The grid is the repo's ExMy grid through
// quant_common.cuh's round_to_grid, the same rounding the fused W4A8 GEMM
// applies inside its tiles: E4M3 tops out at 480, not OCP's 448, so the
// hardware FP8 conversions are never used, and floor(log2|v|) is read from
// the exponent bits. E5M2 runs the same code with its own Grid. A NaN in a
// row propagates into its scale and every value of the row (nan_max), as
// jnp.max propagates it. The build has no --use_fast_math: the division
// and the grid step are IEEE-exact, so the result is bit-identical to the
// plain version (kernels/ref.act_quant_ref).
//
// What bounds it on the H100: bytes. Each element is read (2 or 4 bytes)
// and written as f32 (4 bytes) with a handful of operations in between;
// at 256 tokens of 6400 features that is 9.8 MB, about 3 us at 3.35 TB/s.
// At a decode step's 4 rows the launch latency is all there is.
// What the design does about it: one block per row, its threads striding
// over the full d with neighbouring threads on neighbouring addresses
// (coalesced), so any d works without a tile limit; a block-wide NaN-
// propagating max reduction (warp shuffles, then one warp over the warps'
// maxima) gives the scale; the second pass re-reads the row (from L2 at
// these sizes), divides, rounds and writes. The Pallas kernel held a whole
// row block in VMEM; a 73728-wide f32 row does not fit a block's shared
// memory, so nothing is staged. Simple first: no vector loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_common.cuh"  // Grid, to_f32, nan_max, round_to_grid

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
act_quant_kernel(const T* __restrict__ x, float* __restrict__ q, float* __restrict__ scale,
                 int d, Grid grid) {
  __shared__ float red[WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* row = x + (size_t)blockIdx.x * d;
  float* out = q + (size_t)blockIdx.x * d;

  float mx = 0.f;
  for (int k = tid; k < d; k += THREADS) mx = nan_max(fabsf(to_f32(row[k])), mx);
  for (int o = 16; o; o >>= 1) mx = nan_max(__shfl_xor_sync(0xffffffffu, mx, o), mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < WARPS ? red[lane] : 0.f;
    for (int o = 16; o; o >>= 1) mx = nan_max(__shfl_xor_sync(0xffffffffu, mx, o), mx);
    if (lane == 0) red[0] = nan_max(mx * grid.inv_max, 1e-12f);
  }
  __syncthreads();
  const float sc = red[0];
  for (int k = tid; k < d; k += THREADS) out[k] = round_to_grid(to_f32(row[k]) / sc, grid);
  if (tid == 0) scale[blockIdx.x] = sc;
}

}  // namespace

// x: (rows, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); q: (rows,
// d) f32; scale: (rows,) f32. The grid (man_bits, min_exp, max_exp,
// max_value and the f32 reciprocal inv_max) is the FP8 format's. Returns
// cudaGetLastError() after the launch.
extern "C" int act_quant_launch(const void* x, void* q, void* scale, int rows, int d,
                                int is_bf16, int man_bits, int min_exp, int max_exp,
                                float max_value, float inv_max, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaGetLastError();
  const Grid g{man_bits, min_exp, max_exp, max_value, inv_max};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    act_quant_kernel<__nv_bfloat16><<<rows, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (float*)q, (float*)scale, d, g);
  else
    act_quant_kernel<float><<<rows, THREADS, 0, s>>>((const float*)x, (float*)q,
                                                     (float*)scale, d, g);
  return (int)cudaGetLastError();
}
