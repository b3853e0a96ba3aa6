// The 3x3 CPE passes of the training kernels (s_train.cu, dca_train.cu,
// c_train.cu: their cpe mode), on top of block_common.cuh:
//   k_cpe_rows         y = x + b + sum_9 tap[ky, kx] x[i + (ky-1) W + (kx-1)]
//                      over flat (B N, C) rows (the 3x3 CPE); with the taps
//                      flipped and no bias, its transpose
//   k_cpe_tap_grads    dtap[ky*3+kx, c] = sum_i du[i, c] x[i + (ky-1) W +
//                      (kx-1), c] and dbias[c] = sum_i du[i, c], split over
//                      row ranges into fp32 partials; k_cpe_grads_reduce
//                      sums them in a fixed order
// All sums accumulate in fp32.
#pragma once

#include "block_common.cuh"

namespace lm {
namespace {

inline float* fp(const void* const* p, int i) {
  return static_cast<float*>(const_cast<void*>(p[i]));
}

// ---------------------------------------------------------------- CPE

// The 3x3 conditional position embedding of the training kernels (the TPU
// kernels' pallas_block.py::_cpe_flat with use_cpe, and its transpose;
// _cpe_tap_grads_flat for the tap gradients). Rows are flat (B N, C); a
// row's image position comes from i % N, as block_common.cuh's CpeRows
// finds it, so a shift never reaches into the next image and no tile size
// limits it. Each element sums its 9 taps in fp32 (bias first, taps in
// (ky, kx) order) and is rounded once to the output type, where the TPU's
// _cpe_flat accumulates separably in the activation type; this matches
// block_tc.cuh's cpe_chunk bit for bit. Bound on the H100: bytes (18 operations per element
// against 4-10 bytes). A thread takes 8 channels of one row with 16-byte
// loads (32 in fp32), so the row's image position (three integer
// divisions) and each tap's load serve 8 elements; the neighbours' re-reads
// come from L1 / L2. C is a multiple of 8 (head_dim 32).
constexpr int kCpeVec = 8;

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
    v[6] = b.z;
    v[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int k = 0; k < kCpeVec; ++k) v[k] = __bfloat162float(h[k]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int k = 0; k < kCpeVec; ++k) h[k] = __float2bfloat16(v[k]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// One thread per 8 channels of a row: y = x + bias + sum_j tap[j] x[i +
// s_j], s_j = (ky - 1) W + (kx - 1) under the image's edge masks. With
// ``flip`` tap 8 - j is used for tap j (the transpose: x is then the fp32
// gradient at the CPE's output and bias is null).
template <typename Tin, typename T>
__global__ void __launch_bounds__(kThreads)
    k_cpe_rows(const Tin* __restrict__ x, const T* __restrict__ taps,
               const T* __restrict__ bias, T* __restrict__ y, int rows, int C,
               int img_w, int img_n, int flip) {
  const int groups = C / kCpeVec;
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (size_t)rows * groups) return;
  const int r = (int)(t / groups);
  const int k = (int)(t - (size_t)r * groups) * kCpeVec;
  const int i = r % img_n;
  const int yy = i / img_w, xc = i - yy * img_w;
  const int img_h = img_n / img_w;
  const size_t off = (size_t)r * C + k;
  float acc[kCpeVec], w[kCpeVec], v[kCpeVec];
  if (bias) {
    load8(bias + k, acc);
  } else {
#pragma unroll
    for (int u = 0; u < kCpeVec; ++u) acc[u] = 0.f;
  }
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    if (yy + dy < 0 || yy + dy >= img_h) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (xc + dx < 0 || xc + dx >= img_w) continue;
      const int j = (dy + 1) * 3 + dx + 1;
      load8(taps + (size_t)(flip ? 8 - j : j) * C + k, w);
      load8(x + (ptrdiff_t)off + (ptrdiff_t)(dy * img_w + dx) * C, v);
#pragma unroll
      for (int u = 0; u < kCpeVec; ++u) acc[u] = fmaf(w[u], v[u], acc[u]);
    }
  }
  load8(x + off, v);
#pragma unroll
  for (int u = 0; u < kCpeVec; ++u) acc[u] = v[u] + acc[u];
  store8(y + off, acc);
}

template <typename Tin, typename T>
int launch_cpe_rows(const void* x, const void* taps, const void* bias,
                    void* y, int rows, int C, int img_w, int img_n, int flip,
                    cudaStream_t s) {
  const size_t n = (size_t)rows * (C / kCpeVec);
  k_cpe_rows<Tin, T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, s>>>(
      static_cast<const Tin*>(x), static_cast<const T*>(taps),
      static_cast<const T*>(bias), static_cast<T*>(y), rows, C, img_w, img_n,
      flip);
  return (int)cudaGetLastError();
}

constexpr int kCpeGrads = 10;  // 9 taps and the bias

// One block per row range, all channels: thread t takes the 8 channels of
// group t % (C / 8) in row-lane t / (C / 8) and walks the range's rows
// r0 + lane, r0 + lane + lanes, ...; the lanes' sums meet in shared memory
// one gradient row at a time and are summed over the lanes in order (no
// atomics: two runs give the same bits). part is (splits, 10, C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_cpe_tap_grads(const T* __restrict__ x, const float* __restrict__ du,
                    float* __restrict__ part, int rows, int C, int img_w,
                    int img_n, int rows_per_split) {
  __shared__ __align__(16) float red[kThreads * kCpeVec];
  const int groups = C / kCpeVec, lanes = kThreads / groups;
  const int lane = threadIdx.x / groups;
  const int k = (threadIdx.x - lane * groups) * kCpeVec;
  const int r0 = blockIdx.x * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  const int img_h = img_n / img_w;
  float acc[kCpeGrads][kCpeVec], g[kCpeVec], v[kCpeVec];
#pragma unroll
  for (int j = 0; j < kCpeGrads; ++j)
#pragma unroll
    for (int u = 0; u < kCpeVec; ++u) acc[j][u] = 0.f;
  if (lane < lanes) {
    for (int r = r0 + lane; r < r1; r += lanes) {
      const int i = r % img_n;
      const int yy = i / img_w, xc = i - yy * img_w;
      const size_t off = (size_t)r * C + k;
      load8(du + off, g);
#pragma unroll
      for (int u = 0; u < kCpeVec; ++u) acc[9][u] += g[u];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        if (yy + dy < 0 || yy + dy >= img_h) continue;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (xc + dx < 0 || xc + dx >= img_w) continue;
          const int j = (dy + 1) * 3 + dx + 1;
          load8(x + (ptrdiff_t)off + (ptrdiff_t)(dy * img_w + dx) * C, v);
#pragma unroll
          for (int u = 0; u < kCpeVec; ++u)
            acc[j][u] = fmaf(g[u], v[u], acc[j][u]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCpeGrads; ++j) {
    __syncthreads();  // the previous round's reads are done
    if (lane < lanes) {
#pragma unroll
      for (int u = 0; u < kCpeVec; ++u) red[lane * C + k + u] = acc[j][u];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * C + c];
      part[((size_t)blockIdx.x * kCpeGrads + j) * C + c] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_cpe_grads_reduce(const float* __restrict__ part, int splits, int C,
                       T* __restrict__ dtaps, T* __restrict__ dbias) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= kCpeGrads * C) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k)
    s += part[(size_t)k * kCpeGrads * C + idx];
  if (idx < 9 * C)
    dtaps[idx] = from_f<T>(s);
  else
    dbias[idx - 9 * C] = from_f<T>(s);
}

// The CPE of one block's image rows, as its training kernels take it.
// taps (9, C) and bias (C,) in T; null taps: the block has no CPE here.
struct TrainCpe {
  const void* taps;
  const void* bias;
  int img_w;
  int img_n;
  int rows_per_split;  // k_cpe_tap_grads' rows per block (backward only)
};

// The backward of the CPE y = CPE(x) from du (fp32, the gradient at y):
// dtaps / dbias (T) through fp32 partials in part, and dx = CPE^T du (the
// flipped taps, no bias; the identity term kept), in T.
template <typename T>
int launch_cpe_bwd(const TrainCpe& cpe, const void* x, const float* du,
                   float* part, void* dtaps, void* dbias, void* dx, int rows,
                   int C, cudaStream_t s) {
  const int splits = cdiv(rows, cpe.rows_per_split);
  k_cpe_tap_grads<T><<<splits, kThreads, 0, s>>>(
      static_cast<const T*>(x), du, part, rows, C, cpe.img_w, cpe.img_n,
      cpe.rows_per_split);
  int err = (int)cudaGetLastError();
  if (err) return err;
  k_cpe_grads_reduce<T><<<cdiv(kCpeGrads * C, kThreads), kThreads, 0, s>>>(
      part, splits, C, static_cast<T*>(dtaps), static_cast<T*>(dbias));
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_cpe_rows<float, T>(du, cpe.taps, nullptr, dx, rows, C,
                                   cpe.img_w, cpe.img_n, 1, s);
}

}  // namespace
}  // namespace lm
