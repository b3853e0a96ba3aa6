// The construct probes: one small kernel for each CUDA construct that the
// port's kernels rely on or avoid, each the counterpart of one Mosaic probe
// of scripts/mosaic_probes.py (which compiled one Pallas construct in a
// subprocess to see whether the TPU compiler still crashed on it):
//   k_erf_probe<false>     device erff, K evaluations  probe_erf_prim :57
//   k_erf_probe<true>      JAX's degree-29 polynomial erf (pallas_block.py
//                          _erf, the TPU's workaround), K evaluations
//   k_scatter_add_probe    atomicAdd scatter of rows, pre-summed on chip
//                                                       probe_scatter :78
//   k_roll_rows_probe      rows shifted with 16-byte loads, wrapping
//                          (k_cpe_rows' row-shifted access): a roll of a
//                          contiguous (rows, cols) array by whole rows is
//                          a flat roll of n = rows * cols / 4 vectors by
//                          s = (shift mod rows) * cols / 4, so it is a
//                          flat copy with a wrap
//                                                       probe_pltpu_roll :93
//   k_fold_probe           (R, N, C) -> (R * N, C) bf16: for a contiguous
//                          x the folded row index r * N + n is the flat
//                          one, so the fold is a flat copy of 16-byte
//                          vectors (a 640-byte row at C = 320 is 40
//                          aligned vectors, what the Mosaic probe asked)
//                                                   probe_reshape_c320 :108
//   k_cluster_probe        thread-block clusters of 1-16 CTAs: cluster
//                          barrier, peer global and distributed shared
//                          memory reads (the construct of k_s_stage's
//                          first design, one cluster an image)
// Bound on the H100: bytes for the roll and the fold (read and write once),
// each well below a microsecond at the probes' shapes, so there their times
// are launch times (constructs.py times the roll, the fold and the erf at a
// larger size too); the erf passes are a few operations per element. The
// scatter is bound by reading x and idx once (its atomics add to a few
// hundred bytes at the tap probe's shape).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace lp {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// the scatter's shared-memory partial, constructs.py::SCATTER_SMEM
constexpr long kScatterSmem = 96 * 1024;

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
// slope over k is the throughput of one evaluation. Thread i
// (constructs.py::erf_plan: CTAs of kErfThreads, about one wave of the 132
// SMs at the probe's shape) takes the float4 of elements 4i .. 4i + 3 and
// runs their four K-loops side by side, four independent chains behind one
// 16-byte load; thread nv = n / 4 takes the n % 4 tail elements (its other
// slots hold 0 and are not stored). Each element's sum keeps its order, p =
// 0 .. k - 1, from +0 (p = 0, where x (1 + 0) is x, runs outside the loop).
constexpr int kErfThreads = 128;

template <bool POLY>
__device__ __forceinline__ float erf_at(float t) {
  return POLY ? erf_poly(t) : erff(t);
}

template <bool POLY>
__global__ void __launch_bounds__(kErfThreads)
    k_erf_probe(const float* __restrict__ x, float* __restrict__ out,
                int nv, int tail, int k) {
  const int i = blockIdx.x * kErfThreads + threadIdx.x;
  float v[4];
  if (i < nv) {
    const float4 q = reinterpret_cast<const float4*>(x)[i];
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if (i == nv && tail > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < tail ? x[4L * nv + e] : 0.f;
  } else {
    return;
  }
  float acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.f + erf_at<POLY>(v[e]);
  for (int p = 1; p < k; ++p) {
    const float s = 1.f + p * (1.f / 1024.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += erf_at<POLY>(v[e] * s);
  }
  if (i < nv) {
    reinterpret_cast<float4*>(out)[i] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < tail) out[4L * nv + e] = acc[e];
  }
}

// out[idx[r]] += x[r], fp32, with the rows summed on chip before any
// global atomic. CTA b walks rows [b * lanes * per_lane, (b + 1) * lanes *
// per_lane) (constructs.py::scatter_plan): thread t takes the 4 columns of
// quad t % q (float4 loads, q = cols / 4) and lane t / q of lanes = 256 / q,
// which walks its per_lane rows in order, kScatterUnroll loads in flight.
// A run of equal idx is summed in registers (the run starts at its first
// row) and flushed when idx changes: with SHARED into the CTA's (out_rows,
// cols) partial in shared memory by shared atomics, then one global float4
// atomicAdd per (bin, quad) per CTA (a partial that is exactly zero adds
// nothing: out starts at +0 and a sum is -0 only when both terms are);
// without it (the partial would not fit) each run goes straight to global
// float4 atomics. The CTAs' partials meet by global atomics in an order the
// card chooses: the probe asks whether that order changes the sums.
constexpr int kScatterUnroll = 4;

template <bool SHARED>
__device__ __forceinline__ void flush_run(float4* part, float4* out, int q,
                                          int bin, int c, float4 acc) {
  if (bin < 0) return;  // no run yet
  if constexpr (SHARED) {
    float* p = reinterpret_cast<float*>(part + (long)bin * q + c);
    atomicAdd(p, acc.x);
    atomicAdd(p + 1, acc.y);
    atomicAdd(p + 2, acc.z);
    atomicAdd(p + 3, acc.w);
  } else {
    atomicAdd(out + (long)bin * q + c, acc);
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads)
    k_scatter_add_probe(const float4* __restrict__ x,
                        const int* __restrict__ idx, float4* __restrict__ out,
                        int rows, int q, int out_rows, int per_lane) {
  extern __shared__ float4 part[];  // (out_rows, q) with SHARED
  const int lanes = kThreads / q;
  const int c = threadIdx.x % q, lane = threadIdx.x / q;
  if constexpr (SHARED) {
    for (int i = threadIdx.x; i < out_rows * q; i += kThreads)
      part[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  if (lane < lanes) {
    const long r0 = ((long)blockIdx.x * lanes + lane) * per_lane;
    const long r1 = min(r0 + per_lane, (long)rows);
    int bin = -1;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long r = r0; r < r1; r += kScatterUnroll) {
      int id[kScatterUnroll];
      float4 v[kScatterUnroll];
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u)
        if (r + u < r1) {
          id[u] = idx[r + u];
          v[u] = x[(r + u) * q + c];
        }
#pragma unroll
      for (int u = 0; u < kScatterUnroll; ++u) {
        if (r + u >= r1) break;
        if (id[u] != bin) {
          flush_run<SHARED>(part, out, q, bin, c, acc);
          bin = id[u];
          acc = v[u];
        } else {
          acc.x += v[u].x;
          acc.y += v[u].y;
          acc.z += v[u].z;
          acc.w += v[u].w;
        }
      }
    }
    flush_run<SHARED>(part, out, q, bin, c, acc);
  }
  if constexpr (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < out_rows * q; i += kThreads) {
      const float4 s = part[i];
      if (s.x != 0.f || s.y != 0.f || s.z != 0.f || s.w != 0.f)
        atomicAdd(out + i, s);
    }
  }
}

// The roll as a flat copy of n 16-byte vectors with a wrap (see the
// header): out[i] = x[i - s] for i >= s and x[i - s + n] below s, where
// 0 <= s < n comes normalised from the host (constructs.py::roll_plan), so
// no index is divided or reduced. The layout is k_fold_probe's: a CTA of
// kRollThreads owns a tile of kRollThreads * kRollVpt vectors (98 CTAs at
// the probe's shape), thread t holds vectors t + j * kRollThreads (j <
// kRollVpt) and issues all its loads before its first store; full tiles
// run unmasked, the last, partial tile one vector at a time.
constexpr int kRollThreads = 128;
constexpr int kRollVpt = 4;

__global__ void __launch_bounds__(kRollThreads)
    k_roll_rows_probe(const float4* __restrict__ x, float4* __restrict__ out,
                      int n, int s) {
  constexpr int kTile = kRollThreads * kRollVpt;
  const long first = (long)blockIdx.x * kTile + threadIdx.x;
  const long back = (long)n - s;  // below s, vector i reads x[i + n - s]
  if ((long)(blockIdx.x + 1) * kTile <= n) {  // a full tile
    float4 v[kRollVpt];
#pragma unroll
    for (int j = 0; j < kRollVpt; ++j) {
      const long i = first + j * kRollThreads;
      v[j] = x[i < s ? i + back : i - s];
    }
#pragma unroll
    for (int j = 0; j < kRollVpt; ++j) out[first + j * kRollThreads] = v[j];
    return;
  }
#pragma unroll 1
  for (long i = first; i < n; i += kRollThreads)
    out[i] = x[i < s ? i + back : i - s];
}

// The fold as a flat copy of nvec 16-byte vectors (see the header). A CTA
// of kFoldThreads owns a tile of kFoldThreads * kFoldVpt vectors
// (constructs.py::fold_plan: about two CTAs an SM at the probe's shape);
// thread t holds vectors t + j * kFoldThreads (j < kFoldVpt, adjacent
// threads on adjacent vectors) and issues all its loads before its first
// store, as ew_probe.cu's k_ew_probe<Op, 0> does. Full tiles run unmasked;
// the last, partial tile runs one vector at a time. No index is divided.
constexpr int kFoldThreads = 128;
constexpr int kFoldVpt = 4;

__global__ void __launch_bounds__(kFoldThreads)
    k_fold_probe(const uint4* __restrict__ x, uint4* __restrict__ out,
                 int nvec) {
  constexpr int kTile = kFoldThreads * kFoldVpt;
  const long first = (long)blockIdx.x * kTile + threadIdx.x;
  if ((long)(blockIdx.x + 1) * kTile <= nvec) {  // a full tile
    uint4 v[kFoldVpt];
#pragma unroll
    for (int j = 0; j < kFoldVpt; ++j) v[j] = x[first + j * kFoldThreads];
#pragma unroll
    for (int j = 0; j < kFoldVpt; ++j) out[first + j * kFoldThreads] = v[j];
    return;
  }
#pragma unroll 1
  for (long i = first; i < nvec; i += kFoldThreads) out[i] = x[i];
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

// x, out: n fp32, 16-byte aligned; poly 0 (erff) or 1 (JAX's
// polynomial); k >= 1 evaluations per element (k = 1: out = erf(x)); grid:
// constructs.py::erf_plan (a float4 a thread, one more thread for the
// n % 4 tail, kErfThreads a CTA).
extern "C" int lm_erf_probe(int poly, int k, const void* x, void* out, int n,
                            int grid, void* stream) {
  const int nv = n / 4, tail = n % 4;
  const long threads = nv + (tail > 0);
  if (n < 1 || k < 1 || grid < 1 || (long)grid * lp::kErfThreads < threads ||
      (long)(grid - 1) * lp::kErfThreads >= threads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (poly)
    lp::k_erf_probe<true><<<grid, lp::kErfThreads, 0, s>>>(xi, o, nv, tail,
                                                           k);
  else
    lp::k_erf_probe<false><<<grid, lp::kErfThreads, 0, s>>>(xi, o, nv, tail,
                                                            k);
  return (int)cudaGetLastError();
}

// x: (rows, cols) fp32, cols a multiple of 4 up to 1024, idx: (rows,) int32
// in [0, out_rows), out: zeroed (out_rows, cols) fp32, all 16-byte aligned;
// out[idx[r]] += x[r]. per_lane, grid, shared: constructs.py::scatter_plan
// (rows per lane, CTAs, whether the (out_rows, cols) partial sits in
// shared memory; at most kScatterSmem bytes).
extern "C" int lm_scatter_add_probe(const void* x, const void* idx, void* out,
                                    int rows, int cols, int out_rows,
                                    int per_lane, int grid, int shared,
                                    void* stream) {
  const int q = cols / 4;
  const long smem = shared ? (long)out_rows * cols * 4 : 0;
  if (cols % 4 || q < 1 || q > lp::kThreads || rows < 1 || per_lane < 1 ||
      grid < 1 || smem > lp::kScatterSmem ||
      (long)grid * (lp::kThreads / q) * per_lane < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* xi = static_cast<const float4*>(x);
  const int* ii = static_cast<const int*>(idx);
  float4* o = static_cast<float4*>(out);
  if (shared) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lp::k_scatter_add_probe<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    lp::k_scatter_add_probe<true><<<grid, lp::kThreads, smem, s>>>(
        xi, ii, o, rows, q, out_rows, per_lane);
  } else {
    lp::k_scatter_add_probe<false><<<grid, lp::kThreads, 0, s>>>(
        xi, ii, o, rows, q, out_rows, per_lane);
  }
  return (int)cudaGetLastError();
}

// x, out: (rows, cols) fp32, contiguous and 16-byte aligned, rolled by
// whole rows as n = rows * cols / 4 vectors by s = (shift mod rows) * cols
// / 4 vectors, 0 <= s < n; grid: constructs.py::roll_plan (tiles of
// kRollThreads * kRollVpt vectors).
extern "C" int lm_roll_rows_probe(const void* x, void* out, int n, int s,
                                  int grid, void* stream) {
  constexpr long kTile = lp::kRollThreads * lp::kRollVpt;
  if (n < 1 || s < 0 || s >= n || grid < 1 || (long)grid * kTile < n ||
      (long)(grid - 1) * kTile >= n)
    return (int)cudaErrorInvalidValue;
  lp::k_roll_rows_probe<<<grid, lp::kRollThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), n, s);
  return (int)cudaGetLastError();
}

// x: (R, N, C) bf16, out: (R * N, C) bf16, both contiguous and 16-byte
// aligned, C a multiple of 8: nvec = R * N * C / 8 vectors; grid:
// constructs.py::fold_plan (tiles of kFoldThreads * kFoldVpt vectors).
extern "C" int lm_fold_probe(const void* x, void* out, int nvec, int grid,
                             void* stream) {
  constexpr long kTile = lp::kFoldThreads * lp::kFoldVpt;
  if (nvec < 1 || grid < 1 || (long)grid * kTile < nvec ||
      (long)(grid - 1) * kTile >= nvec)
    return (int)cudaErrorInvalidValue;
  lp::k_fold_probe<<<grid, lp::kFoldThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), nvec);
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
