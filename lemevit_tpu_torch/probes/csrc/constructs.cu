// The construct probes: one small kernel for each CUDA construct that the
// port's kernels rely on or avoid, each the counterpart of one Mosaic probe
// of scripts/mosaic_probes.py (which compiled one Pallas construct in a
// subprocess to see whether the TPU compiler still crashed on it):
//   k_erf_probe<false>     device erff, K evaluations  probe_erf_prim :57
//   k_erf_probe<true>      JAX's degree-29 polynomial erf (pallas_block.py
//                          _erf, the TPU's workaround), K evaluations
//   k_scatter_add_probe    atomicAdd scatter of rows    probe_scatter :78
//   k_roll_rows_probe      rows shifted with 16-byte loads, wrapping
//                          (k_cpe_rows' row-shifted access)
//                                                       probe_pltpu_roll :93
//   k_fold_probe           (R, N, C) -> (R * N, C) bf16 through the folded
//                          index, 16-byte loads        probe_reshape_c320 :108
//   k_cluster_probe        thread-block clusters of 1-16 CTAs: cluster
//                          barrier, peer global and distributed shared
//                          memory reads (k_s_stage's construct)
// Bound on the H100: bytes for the roll and the fold (read and write once),
// each well below a microsecond at the probes' shapes, so their times are
// launch times; the erf passes are a few operations per element.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lp {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;

// lemevit_tpu/attn/pallas_block.py:73-95: erf(x) = x P(s), s = 2 x^2 / B^2
// - 1 on x clamped to [-B, B]; |err| < 5.1e-7
constexpr float kErfB = 3.925f;
__constant__ float kErfP[15] = {
    3.6027794364e-01f, -1.7988466805e-01f, 1.3393152019e-01f,
    -1.0907175299e-01f, 9.0606976620e-02f, -7.4288916019e-02f,
    5.8309038237e-02f, -4.2462337431e-02f, 3.0498341857e-02f,
    -2.3130013672e-02f, 1.3295609324e-02f, -3.5220870811e-03f,
    2.7808746265e-03f, -4.4408601711e-03f, 1.8774974659e-03f};

__device__ __forceinline__ float erf_poly(float x) {
  const float xc = fminf(fmaxf(x, -kErfB), kErfB);
  const float s = xc * xc * (2.f / (kErfB * kErfB)) - 1.f;
  float acc = kErfP[14];
#pragma unroll
  for (int i = 13; i >= 0; --i) acc = acc * s + kErfP[i];
  return xc * acc;
}

// out = sum over p < k of erf(x (1 + p / 1024)): k evaluations per element
// over the whole argument range (a chain erf(erf(x)) would stay below 1,
// where erff takes its short path), independent of each other, so the
// slope over k is the throughput of one evaluation.
template <bool POLY>
__global__ void k_erf_probe(const float* __restrict__ x,
                            float* __restrict__ out, int n, int k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float acc = 0.f;
  for (int p = 0; p < k; ++p) {
    const float t = xi * (1.f + p * (1.f / 1024.f));
    acc += POLY ? erf_poly(t) : erff(t);
  }
  out[i] = acc;
}

__global__ void k_scatter_add_probe(const float* __restrict__ x,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out, long rows,
                                    int cols) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * cols) return;
  const long r = i / cols;
  atomicAdd(out + (long)idx[r] * cols + (i - r * cols), x[i]);
}

// out row r = x row (r - shift) mod rows, as jnp.roll / torch.roll
__global__ void k_roll_rows_probe(const float4* __restrict__ x,
                                  float4* __restrict__ out, int rows,
                                  int vpr, int shift) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long)rows * vpr) return;
  const int r = (int)(i / vpr);
  int src = (r - shift) % rows;
  if (src < 0) src += rows;
  out[i] = x[(long)src * vpr + (i - (long)r * vpr)];
}

// out (R * N, C) row r * N + n = x[r, n, :]; vpr 16-byte vectors per row
__global__ void k_fold_probe(const uint4* __restrict__ x,
                             uint4* __restrict__ out, int R, int N,
                             int vpr) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long)R * N * vpr) return;
  const long row = i / vpr;
  const int r = (int)(row / N), n = (int)(row - (long)r * N);
  out[i] = x[((long)r * N + n) * vpr + (i - row * vpr)];
}

// Each CTA of a cluster of csize writes its rank to global memory and to
// its shared memory, waits at the cluster barrier, then reads every peer's
// rank from global memory and through map_shared_rank. out per CTA:
// [own rank, csize ranks read from global, csize read from shared].
__global__ void k_cluster_probe(int* __restrict__ out) {
  __shared__ int rank_smem;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int stride = 1 + 2 * csize;
  int* mine = out + (long)blockIdx.x * stride;
  int* first = out + (long)(blockIdx.x - rank) * stride;
  if (threadIdx.x == 0) {
    rank_smem = rank;
    mine[0] = rank;
  }
  __threadfence();
  cluster.sync();
  if (threadIdx.x < csize) {
    const int j = threadIdx.x;
    mine[1 + j] = *(volatile int*)(first + (long)j * stride);
    mine[1 + csize + j] = *cluster.map_shared_rank(&rank_smem, j);
  }
  cluster.sync();  // no CTA leaves while a peer reads its shared memory
}

cudaLaunchConfig_t cluster_config(int csize, int clusters,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * clusters);
  cfg.blockDim = dim3(32);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int allow_wide_clusters(int csize) {
  // above the portable 8 only after this opt-in
  return (int)cudaFuncSetAttribute(
      k_cluster_probe, cudaFuncAttributeNonPortableClusterSizeAllowed,
      csize > 8 ? 1 : 0);
}

}  // namespace
}  // namespace lp

// x, out: n fp32; poly 0 (erff) or 1 (JAX's polynomial); k >= 1
// evaluations per element (k = 1: out = erf(x)).
extern "C" int lm_erf_probe(int poly, int k, const void* x, void* out, int n,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + lp::kThreads - 1) / lp::kThreads;
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (poly)
    lp::k_erf_probe<true><<<blocks, lp::kThreads, 0, s>>>(xi, o, n, k);
  else
    lp::k_erf_probe<false><<<blocks, lp::kThreads, 0, s>>>(xi, o, n, k);
  return (int)cudaGetLastError();
}

// x: (rows, cols) fp32, idx: (rows,) int32 in [0, out rows), out: zeroed
// (out rows, cols) fp32; out[idx[r]] += x[r] by atomicAdd.
extern "C" int lm_scatter_add_probe(const void* x, const void* idx, void* out,
                                    int rows, int cols, void* stream) {
  const long n = (long)rows * cols;
  lp::k_scatter_add_probe<<<(unsigned)((n + lp::kThreads - 1) /
                                       lp::kThreads),
                            lp::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<float*>(out), rows, cols);
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) fp32, cols a multiple of 4, 16-byte aligned.
extern "C" int lm_roll_rows_probe(const void* x, void* out, int rows,
                                  int cols, int shift, void* stream) {
  const int vpr = cols / 4;
  const long n = (long)rows * vpr;
  lp::k_roll_rows_probe<<<(unsigned)((n + lp::kThreads - 1) / lp::kThreads),
                          lp::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), rows, vpr,
      shift);
  return (int)cudaGetLastError();
}

// x: (R, N, C) bf16, out: (R * N, C) bf16, C a multiple of 8, both 16-byte
// aligned.
extern "C" int lm_fold_probe(const void* x, void* out, int R, int N, int C,
                             void* stream) {
  const int vpr = C / 8;
  const long n = (long)R * N * vpr;
  lp::k_fold_probe<<<(unsigned)((n + lp::kThreads - 1) / lp::kThreads),
                     lp::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), R, N, vpr);
  return (int)cudaGetLastError();
}

// out: clusters * csize * (1 + 2 csize) int32; csize 1-16 (above 8 with
// the non-portable opt-in).
extern "C" int lm_cluster_probe(int csize, int clusters, void* out,
                                void* stream) {
  if (const int e = lp::allow_wide_clusters(csize)) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lp::cluster_config(
      csize, clusters, attr, static_cast<cudaStream_t>(stream));
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, lp::k_cluster_probe, static_cast<int*>(out));
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// *active: cudaOccupancyMaxActiveClusters for clusters of csize CTAs of
// k_cluster_probe.
extern "C" int lm_cluster_occupancy(int csize, int* active) {
  if (const int e = lp::allow_wide_clusters(csize)) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lp::cluster_config(csize, 1, attr, nullptr);
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(active, lp::k_cluster_probe, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    *active = 0;
  }
  return (int)e;
}

// Message for a code returned by any lm_* entry point of this library.
extern "C" const char* lm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
