// Device building blocks of the D and C block training kernels
// (dca_train.cu, c_train.cu: rows 12-15 of the TPU kernel table), on top
// of block_common.cuh; the S block's backward (rows 10-11, the MLP
// backward of every block kind too) runs train_tc.cuh's tensor-core
// kernels, which use only the CPE passes below.
//   k_ln_rows          a = LN(x) without affine, one warp per row
//   k_ln_bwd           dx = dres + LN'(x)^T da (LayerNorm without affine;
//                      dres may be null), in T or, for the CPE's backward,
//                      in fp32
//   k_cpe_rows         y = x + b + sum_9 tap[ky, kx] x[i + (ky-1) W + (kx-1)]
//                      over flat (B N, C) rows (the 3x3 CPE); with the taps
//                      flipped and no bias, its transpose
//   k_cpe_tap_grads    dtap[ky*3+kx, c] = sum_i du[i, c] x[i + (ky-1) W +
//                      (kx-1), c] and dbias[c] = sum_i du[i, c], split over
//                      row ranges into fp32 partials; k_cpe_grads_reduce
//                      sums them in a fixed order
//   k_attn_bwd_rowdot  D = rowsum(dO . o) per (row, head)
//   k_attn_bwd_dq      dq = scale dS K over key chunks
//   k_attn_bwd_dkv     dk = scale dS^T Q, dv = P^T dO over query chunks
//                      (self-attention, or cross-attention with nq != nk
//                      and separate q / k / v and dq / dk / dv buffers);
//                      both rebuild P = exp(s - lse) from the forward's
//                      log-sum-exp, dS = P . (dO v^T - D) (FlashAttention-2)
//   k_wgrad            dW = G^T A over token rows (and colsum G), split over
//                      row ranges into fp32 partials; k_wgrad_reduce sums
//                      the partials and writes dW (and db) in T
// All reductions and products accumulate in fp32; the LayerNorm
// derivative is exact. The attention kernels are plain fp32
// FMA, one lane per head channel, as k_attention is.
#pragma once

#include "block_common.cuh"

namespace lm {
namespace {

inline float* fp(const void* const* p, int i) {
  return static_cast<float*>(const_cast<void*>(p[i]));
}

// ---------------------------------------------------------------- LayerNorm

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_ln_rows(const T* __restrict__ x, T* __restrict__ out, int rows, int K,
              float eps) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* p = x + (size_t)r * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f(p[k]);
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f(p[k]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / K + eps);
  T* o = out + (size_t)r * K;
  for (int k = lane; k < K; k += 32)
    o[k] = from_f<T>((to_f(p[k]) - mean) * rstd);
}

// dx = dres + rstd (da - mean(da) - th mean(da th)), th = (x - mean) rstd;
// no residual where dres is null (x passes a block by another path). TO is
// T, or float where dx is the gradient at the CPE's output, which the CPE's
// backward takes unrounded (as the TPU kernels keep it in fp32).
template <typename T, typename TO = T>
__global__ void __launch_bounds__(kThreads)
    k_ln_bwd(const T* __restrict__ x, const float* __restrict__ da,
             const T* __restrict__ dres, TO* __restrict__ dx, int rows, int K,
             float eps) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const size_t off = (size_t)r * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f(x[off + k]);
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f(x[off + k]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / K + eps);
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float th = (to_f(x[off + k]) - mean) * rstd, g = da[off + k];
    s1 += g;
    s2 += g * th;
  }
  const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
  for (int k = lane; k < K; k += 32) {
    const float th = (to_f(x[off + k]) - mean) * rstd;
    const float r = dres ? to_f(dres[off + k]) : 0.f;
    dx[off + k] = from_f<TO>(r + rstd * (da[off + k] - m1 - th * m2));
  }
}

template <typename T>
int launch_ln_rows(const void* x, void* out, int rows, int K, float eps,
                   cudaStream_t s) {
  k_ln_rows<T><<<cdiv(rows, kWarps), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, K, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename TO = T>
int launch_ln_bwd(const void* x, const float* da, const void* dres, void* dx,
                  int rows, int K, float eps, cudaStream_t s) {
  k_ln_bwd<T, TO><<<cdiv(rows, kWarps), kThreads, 0, s>>>(
      static_cast<const T*>(x), da, static_cast<const T*>(dres),
      static_cast<TO*>(dx), rows, K, eps);
  return (int)cudaGetLastError();
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
// CpeRows bit for bit. Bound on the H100: bytes (18 operations per element
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

// ---------------------------------------------------------------- wgrad

// One BM x BN tile of G[r0:r1, o0:o0+BM]^T @ A[r0:r1, i0:i0+BN]. The sum
// runs over token rows, so both operands are read along their rows (16
// bytes per thread in bf16) and transposed into the staging tiles. Rows
// past r1 and columns past O / I read as zero; O and I are multiples of 8.
// epi(r, n, v) gets tile-local indices.
template <int BM, int BN, typename T, typename Epi>
__device__ __forceinline__ void tile_gemm_tn(const T* __restrict__ G, int ldg,
                                             const T* __restrict__ A, int lda,
                                             int r0, int r1, int o0, int O,
                                             int i0, int I, float* sA,
                                             float* sW, Epi epi) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using S = MmaShape<BM, BN>;
    __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(sA);
    __nv_bfloat16* w16 = reinterpret_cast<__nv_bfloat16*>(sW);
    float acc[S::NT][4];
#pragma unroll
    for (int t = 0; t < S::NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
    constexpr int V = 8;
    for (int k0 = r0; k0 < r1; k0 += kBK) {
      __syncthreads();
      for (int e = tid; e < kBK * BM / V; e += kThreads) {
        const int k = e / (BM / V), o = (e % (BM / V)) * V;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + k < r1 && o0 + o < O)
          v = *reinterpret_cast<const uint4*>(G + (size_t)(k0 + k) * ldg +
                                              o0 + o);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int u = 0; u < V; ++u) a16[(o + u) * kPitch + k] = h[u];
      }
      for (int e = tid; e < kBK * BN / V; e += kThreads) {
        const int k = e / (BN / V), i = (e % (BN / V)) * V;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + k < r1 && i0 + i < I)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(k0 + k) * lda +
                                              i0 + i);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int u = 0; u < V; ++u) w16[(i + u) * kPitch + k] = h[u];
      }
      __syncthreads();
      mma_kstep<BM, BN>(a16, w16, acc);
    }
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp % S::WARPS_M, wn = warp / S::WARPS_M;
    const int g = lane >> 2, tig = lane & 3;
    const int r = wm * 16 + g;
#pragma unroll
    for (int t = 0; t < S::NT; ++t) {
      const int n = wn * S::WN + t * 8 + tig * 2;
      epi(r, n, acc[t][0]);
      epi(r, n + 1, acc[t][1]);
      epi(r + 8, n, acc[t][2]);
      epi(r + 8, n + 1, acc[t][3]);
    }
  } else {
    constexpr int TM = BM / 16, TN = BN / 16;
    const int tx = tid & 15, ty = tid >> 4;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int k0 = r0; k0 < r1; k0 += kBK) {
      __syncthreads();
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int k = e / BM, o = e % BM;
        sA[k * (BM + 1) + o] =
            (k0 + k < r1 && o0 + o < O)
                ? to_f(G[(size_t)(k0 + k) * ldg + o0 + o])
                : 0.f;
      }
      for (int e = tid; e < BN * kBK; e += kThreads) {
        const int k = e / BN, i = e % BN;
        sW[k * (BN + 1) + i] =
            (k0 + k < r1 && i0 + i < I)
                ? to_f(A[(size_t)(k0 + k) * lda + i0 + i])
                : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = sA[k * (BM + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = sW[k * (BN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) epi(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
}

// One token stream of a weight gradient: dW += G^T A over its rows.
struct WgradSeg {
  const void* g;  // (rows, O)
  const void* a;  // (rows, I)
  int rows;
};

struct WgradArgs {
  WgradSeg seg[2];
  int splits0;         // row ranges of seg[0]; the rest belong to seg[1]
  int rows_per_split;  // a multiple of kBK
  int O, I;            // dW is (O, I), torch Linear layout
  float* part;         // (splits, O, I) fp32 partial sums
  float* part_bias;    // (splits, O) partial column sums of G, or null
};

constexpr int kWgBM = 64, kWgBN = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads) k_wgrad(const WgradArgs a) {
  __shared__ __align__(16) float sA[kBK * (kWgBM + 1)];
  __shared__ __align__(16) float sW[kBK * (kWgBN + 1)];
  const int split = blockIdx.z;
  int sp = split, si = 0;
  if (sp >= a.splits0) {
    sp -= a.splits0;
    si = 1;
  }
  const WgradSeg sg = a.seg[si];
  const int r0 = sp * a.rows_per_split;
  const int r1 = min(sg.rows, r0 + a.rows_per_split);
  const int o0 = blockIdx.y * kWgBM, i0 = blockIdx.x * kWgBN;
  const T* __restrict__ G = static_cast<const T*>(sg.g);
  const T* __restrict__ A = static_cast<const T*>(sg.a);
  float* part = a.part + (size_t)split * a.O * a.I;
  tile_gemm_tn<kWgBM, kWgBN>(G, a.O, A, a.I, r0, r1, o0, a.O, i0, a.I, sA, sW,
                             [&](int r, int n, float v) {
                               const int o = o0 + r, i = i0 + n;
                               if (o < a.O && i < a.I)
                                 part[(size_t)o * a.I + i] = v;
                             });
  if (a.part_bias && blockIdx.x == 0) {
    for (int o = threadIdx.x; o < kWgBM && o0 + o < a.O; o += kThreads) {
      float s = 0.f;
      for (int r = r0; r < r1; ++r) s += to_f(G[(size_t)r * a.O + o0 + o]);
      a.part_bias[(size_t)split * a.O + o0 + o] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_wgrad_reduce(const float* __restrict__ part,
                   const float* __restrict__ part_bias, int splits, int O,
                   int I, T* __restrict__ dw, T* __restrict__ db) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n = (size_t)O * I;
  if (idx < n) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + idx];
    dw[idx] = from_f<T>(s);
  } else if (db && idx < n + O) {
    const size_t j = idx - n;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part_bias[(size_t)k * O + j];
    db[j] = from_f<T>(s);
  }
}

// dw (O, I) = sum of G^T A over both segments; db (O,) = column sums of G
// when db is set (a.part_bias must then be set too).
template <typename T>
int launch_wgrad(const WgradArgs& a, void* dw, void* db, cudaStream_t s) {
  const int splits = a.splits0 + cdiv(a.seg[1].rows, a.rows_per_split);
  dim3 grid(cdiv(a.I, kWgBN), cdiv(a.O, kWgBM), splits);
  k_wgrad<T><<<grid, kThreads, 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int total = a.O * a.I + (db ? a.O : 0);
  k_wgrad_reduce<T><<<cdiv(total, kThreads), kThreads, 0, s>>>(
      a.part, a.part_bias, splits, a.O, a.I, static_cast<T*>(dw),
      static_cast<T*>(db));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- attention

// Attention backward of one direction: nq queries of each image attend to
// its nk keys (self-attention: the same rows, nq == nk). q rows
// (batch * nq, ldq), k / v rows (batch * nk, ldkv), o rows (batch * nq,
// ldo) and dO (batch * nq, C) fp32; dq goes to rows of ld lddq, dk / dv to
// rows of ld lddkv, each written exactly once. Head h uses columns
// [32 h, 32 h + 32) of every operand. lse and D are per (image, head,
// query), at [(b * heads + h) * nq + query].
struct AttnBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // attention output of the forward
  const float* dO;   // gradient of o
  const float* lse;  // log-sum-exp of the forward's scaled scores
  float* D;          // rowsum(dO . o)
  void* dq;
  void* dk;
  void* dv;
  int ldq, ldkv, ldo, lddq, lddkv;
  int batch, heads, nq, nk, C;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_attn_bwd_rowdot(const AttnBwdArgs a) {
  const int idx = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (idx >= a.batch * a.nq * a.heads) return;
  const int row = idx / a.heads, h = idx % a.heads;
  const int b = row / a.nq, i = row % a.nq;
  const int col = h * kHeadDim + lane;
  const T* o = static_cast<const T*>(a.o);
  const float s = warp_sum(a.dO[(size_t)row * a.C + col] *
                           to_f(o[(size_t)row * a.ldo + col]));
  if (lane == 0) a.D[((size_t)b * a.heads + h) * a.nq + i] = s;
}

// One block per (image, head, kQB queries); each warp owns kQPW queries and
// streams the keys through shared memory in kKC chunks, lane j taking keys
// j and j + 32 of a chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) k_attn_bwd_dq(const AttnBwdArgs a) {
  __shared__ float sQ[kQB][kHeadDim];
  __shared__ float sdO[kQB][kHeadDim];
  __shared__ float sK[kKC][kHeadDim + 1];
  __shared__ float sV[kKC][kHeadDim + 1];
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* __restrict__ Q = static_cast<const T*>(a.q);
  const T* __restrict__ Kp = static_cast<const T*>(a.k);
  const T* __restrict__ Vp = static_cast<const T*>(a.v);
  for (int e = threadIdx.x; e < kQB * kHeadDim; e += kThreads) {
    const int qi = e / kHeadDim, t = e % kHeadDim, gq = q0 + qi;
    const size_t row = (size_t)b * a.nq + gq;
    const bool ok = gq < a.nq;
    sQ[qi][t] =
        ok ? to_f(Q[row * a.ldq + h * kHeadDim + t]) * a.scale : 0.f;
    sdO[qi][t] = ok ? a.dO[row * a.C + h * kHeadDim + t] : 0.f;
  }
  float lse[kQPW], Dv[kQPW], acc[kQPW];
#pragma unroll
  for (int i = 0; i < kQPW; ++i) {
    const int gq = q0 + warp * kQPW + i;
    const size_t p = (size_t)bh * a.nq + gq;
    lse[i] = gq < a.nq ? a.lse[p] : 0.f;
    Dv[i] = gq < a.nq ? a.D[p] : 0.f;
    acc[i] = 0.f;
  }
  for (int kc = 0; kc < a.nk; kc += kKC) {
    const int cnt = min(kKC, a.nk - kc);
    __syncthreads();
    for (int e = threadIdx.x; e < kKC * kHeadDim; e += kThreads) {
      const int j = e / kHeadDim, t = e % kHeadDim;
      float kv = 0.f, vv = 0.f;
      if (j < cnt) {
        const size_t off =
            ((size_t)b * a.nk + kc + j) * a.ldkv + h * kHeadDim + t;
        kv = to_f(Kp[off]);
        vv = to_f(Vp[off]);
      }
      sK[j][t] = kv;
      sV[j][t] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kQPW; ++i) {
      const int qi = warp * kQPW + i;
      if (q0 + qi >= a.nq) continue;  // uniform over the warp
      float s0 = 0.f, s1 = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int t = 0; t < kHeadDim; ++t) {
        const float qv = sQ[qi][t], gv = sdO[qi][t];
        s0 = fmaf(qv, sK[lane][t], s0);
        s1 = fmaf(qv, sK[lane + 32][t], s1);
        d0 = fmaf(gv, sV[lane][t], d0);
        d1 = fmaf(gv, sV[lane + 32][t], d1);
      }
      const float p0 = lane < cnt ? expf(s0 - lse[i]) : 0.f;
      const float p1 = lane + 32 < cnt ? expf(s1 - lse[i]) : 0.f;
      const float ds0 = p0 * (d0 - Dv[i]), ds1 = p1 * (d1 - Dv[i]);
      float o = acc[i];
      for (int j = 0; j < cnt; ++j) {
        const float d = __shfl_sync(0xffffffffu, j < 32 ? ds0 : ds1, j & 31);
        o = fmaf(d, sK[j][lane], o);
      }
      acc[i] = o;
    }
  }
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kQPW; ++i) {
    const int gq = q0 + warp * kQPW + i;
    if (gq >= a.nq) continue;
    dq[((size_t)b * a.nq + gq) * a.lddq + h * kHeadDim + lane] =
        from_f<T>(acc[i] * a.scale);
  }
}

// One block per (image, head, kQB keys); each warp owns kQPW keys and
// streams the queries (scaled q, dO, lse, D) through shared memory in kKC
// chunks, lane i taking queries i and i + 32 of a chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_attn_bwd_dkv(const AttnBwdArgs a) {
  __shared__ float sKb[kQB][kHeadDim];
  __shared__ float sVb[kQB][kHeadDim];
  __shared__ float sQ[kKC][kHeadDim + 1];
  __shared__ float sdO[kKC][kHeadDim + 1];
  __shared__ float sL[kKC], sD[kKC];
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* __restrict__ Q = static_cast<const T*>(a.q);
  const T* __restrict__ Kp = static_cast<const T*>(a.k);
  const T* __restrict__ Vp = static_cast<const T*>(a.v);
  for (int e = threadIdx.x; e < kQB * kHeadDim; e += kThreads) {
    const int kj = e / kHeadDim, t = e % kHeadDim, gk = k0 + kj;
    const size_t off = ((size_t)b * a.nk + gk) * a.ldkv + h * kHeadDim + t;
    sKb[kj][t] = gk < a.nk ? to_f(Kp[off]) : 0.f;
    sVb[kj][t] = gk < a.nk ? to_f(Vp[off]) : 0.f;
  }
  float dk[kQPW], dv[kQPW];
#pragma unroll
  for (int i = 0; i < kQPW; ++i) dk[i] = dv[i] = 0.f;
  for (int qc = 0; qc < a.nq; qc += kKC) {
    const int cnt = min(kKC, a.nq - qc);
    __syncthreads();
    for (int e = threadIdx.x; e < kKC * kHeadDim; e += kThreads) {
      const int j = e / kHeadDim, t = e % kHeadDim;
      float qv = 0.f, gv = 0.f;
      if (j < cnt) {
        const size_t row = (size_t)b * a.nq + qc + j;
        qv = to_f(Q[row * a.ldq + h * kHeadDim + t]) * a.scale;
        gv = a.dO[row * a.C + h * kHeadDim + t];
      }
      sQ[j][t] = qv;
      sdO[j][t] = gv;
    }
    for (int j = threadIdx.x; j < kKC; j += kThreads) {
      const size_t p = (size_t)bh * a.nq + qc + j;
      sL[j] = j < cnt ? a.lse[p] : 0.f;
      sD[j] = j < cnt ? a.D[p] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kQPW; ++i) {
      const int kj = warp * kQPW + i;
      if (k0 + kj >= a.nk) continue;  // uniform over the warp
      float s0 = 0.f, s1 = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int t = 0; t < kHeadDim; ++t) {
        const float kv = sKb[kj][t], vv = sVb[kj][t];
        s0 = fmaf(sQ[lane][t], kv, s0);
        s1 = fmaf(sQ[lane + 32][t], kv, s1);
        d0 = fmaf(sdO[lane][t], vv, d0);
        d1 = fmaf(sdO[lane + 32][t], vv, d1);
      }
      const float p0 = lane < cnt ? expf(s0 - sL[lane]) : 0.f;
      const float p1 = lane + 32 < cnt ? expf(s1 - sL[lane + 32]) : 0.f;
      const float ds0 = p0 * (d0 - sD[lane]), ds1 = p1 * (d1 - sD[lane + 32]);
      float gk = dk[i], gv = dv[i];
      for (int j = 0; j < cnt; ++j) {
        const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
        const float dj = __shfl_sync(0xffffffffu, j < 32 ? ds0 : ds1, j & 31);
        gv = fmaf(pj, sdO[j][lane], gv);
        gk = fmaf(dj, sQ[j][lane], gk);
      }
      dk[i] = gk;
      dv[i] = gv;
    }
  }
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kQPW; ++i) {
    const int gk = k0 + warp * kQPW + i;
    if (gk >= a.nk) continue;
    const size_t off = ((size_t)b * a.nk + gk) * a.lddkv + h * kHeadDim + lane;
    dkp[off] = from_f<T>(dk[i]);
    dvp[off] = from_f<T>(dv[i]);
  }
}

template <typename T>
int launch_attn_bwd(const AttnBwdArgs& a, cudaStream_t s) {
  k_attn_bwd_rowdot<T><<<cdiv(a.batch * a.nq * a.heads, kWarps), kThreads, 0,
                         s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  k_attn_bwd_dq<T><<<dim3(a.batch * a.heads, cdiv(a.nq, kQB)), kThreads, 0,
                     s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  k_attn_bwd_dkv<T><<<dim3(a.batch * a.heads, cdiv(a.nk, kQB)), kThreads, 0,
                      s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lm
