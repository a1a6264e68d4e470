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
// plain version (kernels/ref.act_quant_ref). A max is exact, so the order
// in which the absmax is reduced does not change a bit.
//
// What bounds it on the H100: bytes, and at a few hundred rows the latency
// of one pass. Each element is read (2 or 4 bytes) and written as f32 (4
// bytes) with ~30 instructions in between (the IEEE division, which the
// compiler expands with its own reciprocal and a slow-path branch, and the
// grid rounding); at 2048 tokens of 6400 features that is 78.7 MB, 23.5 us
// at 3.35 TB/s. At a decode step's 4 rows the launch latency is all there
// is.
//
// What the design does about it: one pass over HBM. Each row (or each
// cluster block's slice of it) is loaded into registers four elements an
// access (8 bytes of bf16, 16 of f32; every load of a thread issued before
// the first is used), its absmax is reduced from the registers (bf16 pairs
// by the packed NaN-propagating max), and the values are divided, rounded
// and streamed out from the registers four f32 a 16-byte evict-first
// store, so every warp access covers contiguous bytes (with 8 bf16 a
// thread, each 16-byte store of a warp would half-fill 32-byte sectors
// 32 bytes apart: measured slower). A thread divides and rounds its
// elements one after another, so the host's launch plan
// (kernels/act_quant.py::act_quant_plan, from shapes and x's alignment
// alone) gives each thread as few vectors as the card has threads for (one
// or two at a few hundred rows, at most four), and picks one of two paths:
//   * block: a block of as many warps as hold the row, up to 1024 threads
//     (opt-125m's 768, OLMoE-1B-7B's 2048 and MiniCPM3-4B's 6400; one warp
//     where its registers hold the row), the warp maxima folded through
//     shared memory by every warp;
//   * cluster: a row too wide for one block, or too few rows to fill the
//     card, split over a thread-block cluster of up to 8 blocks (the
//     portable limit); each block holds its slice, the blocks' maxima are
//     exchanged through distributed shared memory between two cluster
//     barriers, and each block quantizes its slice from its registers.
// A row wider than a whole cluster's registers (more than 8 x 1024 x 4
// vectors, 131072 elements) reads the vectors past the registers a second
// time; no documented width comes near it. The vector accesses need x
// aligned to 4 elements and q to 16 bytes: then each row reads a scalar
// head up to its first 4-element boundary and a scalar tail after its last,
// so any d works. A misaligned x (a contiguous view such as big[1:]) runs
// the same paths with one-element accesses. A plan whose threads, cluster
// or blocks the kernel cannot take, or vector accesses the pointers do not
// allow, is refused before the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "quant_common.cuh"  // Grid, to_f32, nan_max, round_to_grid, streaming accesses

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;  // threads of a block at most
constexpr int MAX_CLUSTER = 8;     // blocks of a row at most (the portable cluster size)

struct Args {
  const void* x;
  float* q;
  float* scale;
  int rows, d;
  int cluster;  // blocks of a row, 1..MAX_CLUSTER
  Grid g;
};

// V consecutive elements of x read by one access: 4 elements (8 bytes of
// bf16, 16 of f32) on the vector path, one on the scalar path
template <typename T, int V>
struct Chunk;

template <typename T>
struct Chunk<T, 1> {
  T v;
  __device__ __forceinline__ void load(const T* p) { v = p[0]; }
  __device__ __forceinline__ float at(int) const { return to_f32(v); }
  __device__ __forceinline__ float absmax() const { return fabsf(to_f32(v)); }
};

template <>
struct Chunk<__nv_bfloat16, 4> {
  uint2 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { w = ld_stream8(p); }
  __device__ __forceinline__ float at(int i) const { return bf16x4_at(w, i); }
  __device__ __forceinline__ float absmax() const { return bf16x4_absmax(w); }
};

template <>
struct Chunk<float, 4> {
  uint4 w;
  __device__ __forceinline__ void load(const float* p) { w = ld_stream16(p); }
  __device__ __forceinline__ float at(int i) const { return f32x4_at(w, i); }
  __device__ __forceinline__ float absmax() const {  // nan_max of |x|, as a tree
    return nan_max(nan_max(fabsf(at(0)), fabsf(at(1))), nan_max(fabsf(at(2)), fabsf(at(3))));
  }
};

// V quantized values to q (16-byte aligned when V == 4)
template <int V>
__device__ __forceinline__ void store(float* q, const float (&o)[V]) {
  if constexpr (V == 1)
    __stcs(q, o[0]);
  else
    st_stream4(q, o[0], o[1], o[2], o[3]);
}

template <typename T, int V>
__device__ __forceinline__ void chunk_quantize(const Chunk<T, V>& c, float sc, const Grid& g,
                                               float* q) {
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = round_to_grid(c.at(k) / sc, g);
  store<V>(q, o);
}

// the cluster barrier split in its two halves: a block arrives once it has
// read the others' shared memory and waits before it exits, so no block's
// shared memory goes while another may still read it
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A row is a scalar head of h elements up to its first element whose index
// in x is a multiple of V, nb vectors of V elements, and a scalar tail. Its nb vectors are cut
// into `cluster` equal parts, one a block; this is the part [lo, lo + n) of
// block `rank`. The head goes to the first part, the tail to the last.
template <typename T>
struct RowPart {
  const T* x;  // the row
  float* q;
  int h, nb, tail, lo, n;
  bool first, last;
};

template <typename T, int V>
__device__ __forceinline__ RowPart<T> row_part(const Args& a, int row, int rank) {
  RowPart<T> p;
  const size_t e0 = (size_t)row * a.d;
  p.h = V > 1 ? min(a.d, (int)((V - e0 % V) % V)) : 0;
  p.nb = (a.d - p.h) / V;
  p.tail = a.d - p.h - p.nb * V;
  const int pv = (p.nb + a.cluster - 1) / a.cluster;
  p.lo = min(p.nb, rank * pv);
  p.n = min(p.nb, p.lo + pv) - p.lo;
  p.x = static_cast<const T*>(a.x) + e0;
  p.q = a.q + e0;
  p.first = rank == 0;
  p.last = rank == a.cluster - 1;
  return p;
}

// Thread t's share of a row part, of the G threads that share it: the
// part's vectors t, t + G, t + 2G, ..., the first NV of them held in
// registers (the plan's per_thread; a row wider than that reads the rest
// twice), head element t and tail element t.
template <typename T, int V, int NV>
struct Share {
  Chunk<T, V> c[NV];
  float hv, tv;

  // every load issued before any is used
  __device__ __forceinline__ void load(const RowPart<T>& p, int t, int G) {
    const T* xv = p.x + p.h + (size_t)p.lo * V;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (t + i * G < p.n) c[i].load(xv + (size_t)(t + i * G) * V);
    hv = p.first && t < p.h ? to_f32(p.x[t]) : 0.f;
    tv = p.last && t < p.tail ? to_f32(p.x[p.h + p.nb * V + t]) : 0.f;
  }

  __device__ __forceinline__ float absmax(const RowPart<T>& p, int t, int G) const {
    float mx = nan_max(fabsf(hv), fabsf(tv));
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (t + i * G < p.n) mx = nan_max(c[i].absmax(), mx);
    const T* xv = p.x + p.h + (size_t)p.lo * V;
    for (int j = t + NV * G; j < p.n; j += G) {
      Chunk<T, V> r;
      r.load(xv + (size_t)j * V);
      mx = nan_max(r.absmax(), mx);
    }
    return mx;
  }

  __device__ __forceinline__ void quantize(const RowPart<T>& p, int t, int G, float sc,
                                           const Grid& g) const {
    const T* xv = p.x + p.h + (size_t)p.lo * V;
    float* qv = p.q + p.h + (size_t)p.lo * V;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (t + i * G < p.n) chunk_quantize(c[i], sc, g, qv + (size_t)(t + i * G) * V);
    for (int j = t + NV * G; j < p.n; j += G) {
      Chunk<T, V> r;
      r.load(xv + (size_t)j * V);
      chunk_quantize(r, sc, g, qv + (size_t)j * V);
    }
    if (p.first && t < p.h) p.q[t] = round_to_grid(hv / sc, g);
    if (p.last && t < p.tail) p.q[p.h + p.nb * V + t] = round_to_grid(tv / sc, g);
  }
};

__device__ __forceinline__ float warp_max(float mx) {
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = nan_max(__shfl_xor_sync(0xffffffffu, mx, o), mx);
  return mx;
}

// The two paths of the plan (kernels/act_quant.py::act_quant_plan), block
// b of the grid serving row b / cluster:
//   * cluster == 1 (block): a block a row;
//   * cluster > 1: a cluster a row, the blocks' maxima exchanged through
//     distributed shared memory.
template <typename T, int V, int NV>
__global__ void __launch_bounds__(MAX_THREADS) act_quant_kernel(const __grid_constant__ Args a) {
  __shared__ float red[MAX_THREADS / 32];  // the warps' maxima
  __shared__ float part;                   // this block's absmax, read by the cluster
  const int t = threadIdx.x, lane = t & 31, G = blockDim.x, C = a.cluster;
  const int row = blockIdx.x / C;
  const RowPart<T> p = row_part<T, V>(a, row, blockIdx.x % C);
  Share<T, V, NV> s;
  s.load(p, t, G);
  float mx = warp_max(s.absmax(p, t, G));
  if (lane == 0) red[t >> 5] = mx;
  __syncthreads();
  mx = warp_max(lane < (G >> 5) ? red[lane] : 0.f);  // every warp folds the warps' maxima
  if (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (t == 0) part = mx;
    cluster.sync();  // every block's part written and visible
    float m[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c)
      m[c] = c < C ? *cluster.map_shared_rank(&part, c) : 0.f;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) mx = nan_max(m[c], mx);
    cluster_arrive();
  }
  const float sc = nan_max(mx * a.g.inv_max, 1e-12f);
  s.quantize(p, t, G, sc, a.g);
  if (p.first && t == 0) a.scale[row] = sc;
  if (C > 1) cluster_wait();
}

template <typename T, int V, int NV>
int launch(const Args& a, int blocks, int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, act_quant_kernel<T, V, NV>, a);
  return err ? (int)err : (int)cudaGetLastError();
}

template <typename T, int V>
int launch_held(const Args& a, int per_thread, int blocks, int threads, cudaStream_t s) {
  switch (per_thread) {
    case 1: return launch<T, V, 1>(a, blocks, threads, s);
    case 2: return launch<T, V, 2>(a, blocks, threads, s);
    case 4: return launch<T, V, 4>(a, blocks, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_vec(const Args& a, int vec, int per_thread, int blocks, int threads, cudaStream_t s) {
  if (vec == 4) return launch_held<T, 4>(a, per_thread, blocks, threads, s);
  if (vec == 1) return launch_held<T, 1>(a, per_thread, blocks, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (rows, d) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1); q: (rows,
// d) f32; scale: (rows,) f32. The grid (man_bits, min_exp, max_exp,
// max_value and the f32 reciprocal inv_max) is the FP8 format's. The plan
// (kernels/act_quant.py::act_quant_plan): vec elements an access (4, with
// x aligned to 4 elements and q to 16 bytes, or 1), threads a block (all
// on a row, or on a cluster block's slice of it), cluster blocks a row,
// per_thread vectors a thread holds, blocks in the grid (rows x cluster).
// Returns cudaErrorInvalidValue for threads, a cluster or blocks the kernel
// cannot take, or vector accesses at a misaligned address, else
// cudaGetLastError() after the launch.
extern "C" int act_quant_launch(const void* x, void* q, void* scale, int rows, int d,
                                int is_bf16, int man_bits, int min_exp, int max_exp,
                                float max_value, float inv_max, int vec, int threads, int cluster,
                                int per_thread, int blocks, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaGetLastError();
  const bool aligned = (uintptr_t)x % (4 * (is_bf16 ? 2 : 4)) == 0 && (uintptr_t)q % 16 == 0;
  if (threads < 32 || threads > MAX_THREADS || threads % 32 || cluster < 1 ||
      cluster > MAX_CLUSTER || (long long)blocks != (long long)rows * cluster ||
      (vec > 1 && !aligned))
    return (int)cudaErrorInvalidValue;
  const Grid g{man_bits, min_exp, max_exp, max_value, inv_max};
  const Args a{x, (float*)q, (float*)scale, rows, d, cluster, g};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_vec<__nv_bfloat16>(a, vec, per_thread, blocks, threads, s)
                 : launch_vec<float>(a, vec, per_thread, blocks, threads, s);
}
