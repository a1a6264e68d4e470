// The combine of the split-KV decode-attention kernels (decode_attn.cu, GQA;
// mla_decode_attn.cu, MLA's latent decode): the second kernel of each one's
// C entry point, launched as a programmatic dependent launch of the split
// kernel.
//
// out[b, head] = sum_s exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s,
// 1e-30) over the splits of row b that hold a valid token (the split
// kernels' own test: split s holds tokens [s * span, (s + 1) * span) of
// [max(0, len - window) when window > 0, min(len, PP * page))), in split
// order; 0 for a row with none. No atomics: repeated launches are
// bit-identical. The splits' m and l are read at once into shared memory,
// their weights computed once.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int COMBINE_THREADS = 128;

__global__ void __launch_bounds__(COMBINE_THREADS)
split_combine_kernel(const float* __restrict__ ml, const float* __restrict__ acc,
                     const int* __restrict__ lens, float* __restrict__ out, int H, int hd,
                     int splits, int span, int PP, int page, int window) {
  extern __shared__ float wsm[];  // (splits,) weights, then (splits,) l
  const int bh = blockIdx.x, b = bh / H, tid = threadIdx.x;
  const int len = lens[b], lenc = min(len, PP * page);
  const int lo = window ? max(0, len - window) : 0;
  int s_lo = 0, s_hi = 0;
  if (lo < lenc) {
    s_lo = lo / span;
    s_hi = (lenc + span - 1) / span;
  }
  const int n = s_hi - s_lo;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel's writes
  const float* mlr = ml + ((size_t)bh * splits + s_lo) * 2;
  float* wl = wsm + splits;
  for (int i = tid; i < n; i += COMBINE_THREADS) {
    wsm[i] = mlr[2 * i];
    wl[i] = mlr[2 * i + 1];
  }
  __syncthreads();
  float mx = -1e30f;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, wsm[i]);
  __syncthreads();
  for (int i = tid; i < n; i += COMBINE_THREADS) wsm[i] = expf(wsm[i] - mx);
  __syncthreads();
  float ls = 0.f;
  for (int i = 0; i < n; ++i) ls += wl[i] * wsm[i];
  const float den = fmaxf(ls, 1e-30f);
  const float* ar = acc + ((size_t)bh * splits + s_lo) * hd;
  for (int d = tid; d < hd; d += COMBINE_THREADS) {
    float o = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) o += ar[(size_t)i * hd + d] * wsm[i];
    out[(size_t)bh * hd + d] = o / den;
  }
}

// The combine of B * H (row, head) outputs of hd floats from the splits'
// workspace (ml (B, H, splits, 2), acc (B, H, splits, hd)) on `stream`,
// right after the split kernel. Returns a CUDA error code, 0 on success.
inline int launch_split_combine(const void* ml, const void* acc, const void* lens, void* out,
                                int B, int H, int hd, int splits, int span, int PP, int page,
                                int window, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * 2 * (size_t)splits;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;  // the opt-in shared memory limit
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // a programmatic dependent launch: the combine's blocks are scheduled
  // once every split block has started, and wait for the split kernel's
  // completion (griddepcontrol.wait) only after their own prologue
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, split_combine_kernel, (const float*)ml,
                                           (const float*)acc, (const int*)lens, (float*)out, H,
                                           hd, splits, span, PP, page, window);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace
