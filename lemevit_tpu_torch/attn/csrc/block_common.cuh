// The S / D block tail past C = 512 (block_tc.cuh's launch_tail_tc and
// s_stage.cu's tail items at that width), and the types, layouts and
// helpers that block_tc.cuh, attn_tc.cuh and the training headers share.
//
//   tail_rows      t1 = t + s1 (o @ Wp^T + bp); out = t1 + s2 MLP(LN2(t1)),
//                  s1 / s2 per-image DropPath scales (1 in inference);
//                  k_block_tail runs it over 32-row blocks
// Its matrix products go through one routine, tile_gemm: a shared-memory
// tiled product with fp32 accumulation whose A operand is a matrix in
// global or shared memory (Rows), and whose result goes to an epilogue
// functor (bias, exact-erf GELU, residual). bf16 products run on the
// tensor cores (mma.sync m16n8k16, LN2 rounded to bf16 first, as the TPU
// kernels round before the MXU); fp32 products stay on FMA, so fp32 keeps
// full precision. No stage is pipelined: each 32-deep step loads, syncs and
// multiplies.
//
// Types: T is float or __nv_bfloat16 for every activation, weight, bias and
// norm parameter of one call; products, softmax and LayerNorm statistics are
// fp32. Weights are in torch Linear layout, (out_features, in_features).
// head_dim is fixed at 32 (one lane per head channel).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace lm {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 32;
constexpr int kBK = 32;  // depth of one shared-memory step of tile_gemm

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Two-pass LayerNorm statistics of `rows` rows of width K, one warp per row.
// get(r, k) returns element k of row r as float.
template <typename Get>
__device__ __forceinline__ void row_stats(Get get, int rows, int K, float eps,
                                          float* s_mean, float* s_rstd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += get(r, k);
    const float mean = warp_sum(s) / K;
    float v = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d = get(r, k) - mean;
      v += d * d;
    }
    const float var = warp_sum(v) / K;
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rsqrtf(var + eps);
    }
  }
}

// The A operand of tile_gemm: a row-major matrix (in global or shared
// memory), rows past `rows` read as zero. bf16 stages it 8 values per
// 16-byte load; the fp32 path reads it through a_elem.
template <typename T>
struct Rows {
  const T* p;
  int ld;
  int rows;
};

// ---------------------------------------------------------------- CPE

// A block's conditional position embedding, x + dwconv3x3(x) + bias with
// zero padding at each image's edges (the counterpart of the TPU kernels'
// lemevit_tpu/attn/pallas_block.py::_cpe_flat). Tokens are flat (B*N, C)
// rows, N = H * W per image; a row's image position comes from its flat
// index, so a shift never reaches into the next image of a batch.
struct Cpe {
  const void* taps;  // (9, C) in (ky, kx) order; null: no CPE
  const void* bias;  // (C,)
  int img_w;         // W
  int img_n;         // N = H * W
};

template <typename T>
__device__ __forceinline__ float a_elem(const Rows<T>& a, int r, int k) {
  return r < a.rows ? to_f(a.p[(size_t)r * a.ld + k]) : 0.f;
}

// D += A(16x16, bf16, row-major fragment) * B(16x8, bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row pitch of the bf16 staging tiles: 40 elements = 20 words, so the
// eight rows a fragment load touches fall in distinct banks.
constexpr int kPitch = kBK + 8;

// Warp tiling of a BM x BN bf16 tile: each warp owns a 16 x WN piece,
// NT m16n8 products wide.
template <int BM, int BN>
struct MmaShape {
  static constexpr int WARPS_M = BM / 16, WARPS_N = kWarps / WARPS_M;
  static constexpr int WN = BN / WARPS_N, NT = WN / 8;
  static_assert(WARPS_M * WARPS_N == kWarps && NT * 8 * WARPS_N == BN,
                "warp tiling");
};

// acc += one kBK-deep step of sA (BM x kBK) @ sW (BN x kBK)^T, both bf16
// in shared memory with row pitch kPitch.
template <int BM, int BN>
__device__ __forceinline__ void mma_kstep(
    const __nv_bfloat16* sA, const __nv_bfloat16* sW,
    float (&acc)[MmaShape<BM, BN>::NT][4]) {
  using S = MmaShape<BM, BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % S::WARPS_M, wn = warp / S::WARPS_M;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    const __nv_bfloat16* pa = sA + (wm * 16 + g) * kPitch + kk + tig * 2;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(pa);
    a[1] = *reinterpret_cast<const uint32_t*>(pa + 8 * kPitch);
    a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(pa + 8 * kPitch + 8);
#pragma unroll
    for (int t = 0; t < S::NT; ++t) {
      const __nv_bfloat16* pb =
          sW + (wn * S::WN + t * 8 + g) * kPitch + kk + tig * 2;
      mma_bf16(acc[t], a, *reinterpret_cast<const uint32_t*>(pb),
               *reinterpret_cast<const uint32_t*>(pb + 8));
    }
  }
}

// tile_gemm for bf16: each warp owns a 16 x (BN / warps along N) piece of
// the tile and issues m16n8k16 products from bf16 tiles in shared memory.
template <int BM, int BN, typename LoadA, typename Epi>
__device__ __forceinline__ void tile_gemm_mma(
    LoadA load_a, const __nv_bfloat16* __restrict__ wt, int ldw, int K,
    int n0, int ncols, __nv_bfloat16* sA, __nv_bfloat16* sW, Epi epi) {
  using S = MmaShape<BM, BN>;
  constexpr int WARPS_M = S::WARPS_M, WN = S::WN, NT = S::NT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, tig = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    constexpr int V = 8;  // bf16 per 16-byte copy
    for (int e = tid; e < BM * kBK / V; e += kThreads) {
      const int r = e / (kBK / V), k = (e % (kBK / V)) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < load_a.rows)
        v = *reinterpret_cast<const uint4*>(load_a.p +
                                            (size_t)r * load_a.ld + k0 + k);
      *reinterpret_cast<uint4*>(sA + r * kPitch + k) = v;
    }
    for (int e = tid; e < BN * kBK / V; e += kThreads) {
      const int n = e / (kBK / V), k = (e % (kBK / V)) * V, gn = n0 + n;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gn < ncols)
        v = *reinterpret_cast<const uint4*>(wt + (size_t)gn * ldw + k0 + k);
      *reinterpret_cast<uint4*>(sW + n * kPitch + k) = v;
    }
    __syncthreads();
    mma_kstep<BM, BN>(sA, sW, acc);
  }
  const int r = wm * 16 + g;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = n0 + wn * WN + t * 8 + tig * 2;
    if (n < ncols) {
      epi(r, n, acc[t][0]);
      epi(r + 8, n, acc[t][2]);
    }
    if (n + 1 < ncols) {
      epi(r, n + 1, acc[t][1]);
      epi(r + 8, n + 1, acc[t][3]);
    }
  }
}

// One BM x BN output tile of A[BM x K] @ Wt[n0:n0+BN, :]^T, K % kBK == 0.
// load_a is a Rows<T>; wt is (ncols, ldw) in torch Linear layout; columns
// >= ncols are masked. epi(r, n, v) receives every valid
// output exactly once, from the thread that owns it. sA and sW hold
// kBK * (BM + 1) and kBK * (BN + 1) floats, 16-byte aligned; in bf16 the
// operands' rows are 16-byte aligned too (the wrappers check the tensors).
// The caller synchronises before reading anything the epilogue wrote.
// fp32: each thread owns a (BM/16) x (BN/16) set of outputs at rows
// ty + 16 i, columns tx + 16 j, so shared-memory reads are broadcast (A) or
// consecutive (W). bf16: tile_gemm_mma.
template <int BM, int BN, typename T, typename LoadA, typename Epi>
__device__ __forceinline__ void tile_gemm(LoadA load_a,
                                          const T* __restrict__ wt, int ldw,
                                          int K, int n0, int ncols, float* sA,
                                          float* sW, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    tile_gemm_mma<BM, BN>(load_a, wt, ldw, K, n0, ncols,
                          reinterpret_cast<__nv_bfloat16*>(sA),
                          reinterpret_cast<__nv_bfloat16*>(sW), epi);
  } else {
    constexpr int TM = BM / 16, TN = BN / 16;
    static_assert(TM * 16 == BM && TN * 16 == BN, "tile must be 16-aligned");
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // the previous step's (or call's) reads are done
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int r = e / kBK, k = e % kBK;
        sA[k * (BM + 1) + r] = a_elem(load_a, r, k0 + k);
      }
      for (int e = tid; e < BN * kBK; e += kThreads) {
        const int n = e / kBK, k = e % kBK, gn = n0 + n;
        sW[k * (BN + 1) + n] =
            gn < ncols ? to_f(wt[(size_t)gn * ldw + k0 + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sA[k * (BM + 1) + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sW[k * (BN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < ncols) epi(ty + 16 * i, n, acc[i][j]);
      }
  }
}

// ---------------------------------------------------------------- attention

// q rows (batch * nq, ldq), k / v rows (batch * nk, ldkv), out rows
// (batch * nq, ldo); head h reads columns [32 h, 32 h + 32).
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int ldq, ldkv, ldo;
  int batch, heads, nq, nk;
  float scale;
  float* lse;  // where set: each query's log-sum-exp of its scaled scores,
               // at [(b * heads + h) * nq + query] (attn_tc.cuh's
               // k_mhsa_tc / k_mhsa_tc_small in their kLse instances)
};

// ---------------------------------------------------------------- tail

// One token stream's block tail: t1 = t + s1 (o @ wp^T + bp),
// out = t1 + s2 MLP(LN2(t1)). s1 / s2 are per-image branch scales (image
// of flat row r: r / seq), 1 where null; t1, where set, receives t1.
struct TailSeg {
  const void* t;
  const void* o;
  const void* wp;
  const void* bp;
  void* out;
  int rows;
  const float* s1;
  const float* s2;
  int seq;
  void* t1;
};

// Two streams share one launch and the block's norm2 + MLP weights.
struct TailArgs {
  TailSeg seg[2];
  int row_blocks0;
  const void* ln_w;
  const void* ln_b;
  const void* w1;  // (hidden, C)
  const void* b1;
  const void* w2;  // (C, hidden)
  const void* b2;
  int C, hidden;
  float eps;
};

constexpr int kTailBM = 32, kTailBN = 128, kTailBH = 128;

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Shared memory of one tail block: fp32 accumulator (BM x C), LN2(t1) and
// one hidden chunk in T, the staging tiles, the row statistics.
inline size_t tail_smem_bytes(int C, size_t elt) {
  return align16(4 * (size_t)kTailBM * C) + align16(elt * kTailBM * C) +
         align16(elt * kTailBM * kTailBH) + align16(4 * kBK * (kTailBM + 1)) +
         align16(4 * kBK * (kTailBN + 1)) + 16 * kTailBM;
}

// Rows [row0, row0 + kTailBM) of one stream's tail, in `smem`
// (tail_smem_bytes). Rows stay in shared memory from the projection to the
// output. sAcc holds t1 + b2 in fp32 and then gathers fc2; LN2(t1) is stored
// once in T as fc1's A operand; the hidden activation lives one BM x
// kTailBH chunk at a time, so the 4C-wide hidden row never exists whole.
// t, o and out may be written earlier in the same launch (k_s_stage), so
// they are not read as restrict.
template <typename T>
__device__ __forceinline__ void tail_rows(const TailArgs& a,
                                          const TailSeg& sg, int row0,
                                          unsigned char* smem) {
  const int C = a.C;
  unsigned char* q = smem;
  float* sAcc = reinterpret_cast<float*>(q);
  q += align16(4 * (size_t)kTailBM * C);
  T* sLN = reinterpret_cast<T*>(q);
  q += align16(sizeof(T) * kTailBM * C);
  T* sH = reinterpret_cast<T*>(q);
  q += align16(sizeof(T) * kTailBM * kTailBH);
  float* sA = reinterpret_cast<float*>(q);
  q += align16(4 * kBK * (kTailBM + 1));
  float* sW = reinterpret_cast<float*>(q);
  q += align16(4 * kBK * (kTailBN + 1));
  float* s_mean = reinterpret_cast<float*>(q);
  float* s_rstd = s_mean + kTailBM;
  float* s_s1 = s_rstd + kTailBM;
  float* s_s2 = s_s1 + kTailBM;

  const int rows = min(kTailBM, sg.rows - row0);
  for (int r = threadIdx.x; r < kTailBM; r += kThreads) {
    const int img = sg.seq ? (row0 + r) / sg.seq : 0;
    s_s1[r] = (sg.s1 && r < rows) ? sg.s1[img] : 1.f;
    s_s2[r] = (sg.s2 && r < rows) ? sg.s2[img] : 1.f;
  }
  const T* tin = static_cast<const T*>(sg.t) + (size_t)row0 * C;
  const T* o = static_cast<const T*>(sg.o) + (size_t)row0 * C;
  const T* __restrict__ bp = static_cast<const T*>(sg.bp);
  const T* __restrict__ g = static_cast<const T*>(a.ln_w);
  const T* __restrict__ beta = static_cast<const T*>(a.ln_b);
  const T* __restrict__ w1 = static_cast<const T*>(a.w1);
  const T* __restrict__ b1 = static_cast<const T*>(a.b1);
  const T* __restrict__ w2 = static_cast<const T*>(a.w2);
  const T* __restrict__ b2 = static_cast<const T*>(a.b2);
  T* out = static_cast<T*>(sg.out) + (size_t)row0 * C;

  // 1. t1 = t + s1 (o @ Wp^T + bp), in fp32 (tile_gemm's first barrier
  //    orders the scale loads above before the epilogue reads them)
  for (int n0 = 0; n0 < C; n0 += kTailBN)
    tile_gemm<kTailBM, kTailBN>(
        Rows<T>{o, C, rows}, static_cast<const T*>(sg.wp), C, C, n0, C, sA,
        sW, [&](int r, int n, float v) {
          sAcc[r * C + n] =
              r < rows ? s_s1[r] * (v + to_f(bp[n])) +
                             to_f(tin[(size_t)r * C + n])
                       : 0.f;
        });
  __syncthreads();
  if (sg.t1) {
    T* t1 = static_cast<T*>(sg.t1) + (size_t)row0 * C;
    for (int e = threadIdx.x; e < rows * C; e += kThreads)
      t1[e] = from_f<T>(sAcc[e]);
  }

  // 2. LN2(t1) into sLN; then sAcc = t1 + s2 b2 (the second residual)
  row_stats([&](int r, int k) { return sAcc[r * C + k]; }, kTailBM, C, a.eps,
            s_mean, s_rstd);
  __syncthreads();
  for (int e = threadIdx.x; e < kTailBM * C; e += kThreads) {
    const int r = e / C, k = e % C;
    sLN[e] = from_f<T>((sAcc[e] - s_mean[r]) * s_rstd[r] * to_f(g[k]) +
                       to_f(beta[k]));
    sAcc[e] += s_s2[r] * to_f(b2[k]);
  }
  __syncthreads();

  // 3. MLP over kTailBH-wide hidden chunks (the last one may be narrower,
  //    a multiple of kBK): h = GELU(LN2(t1) @ W1c^T + b1c),
  //    acc += h @ W2[:, chunk]^T
  for (int j0 = 0; j0 < a.hidden; j0 += kTailBH) {
    const int kc = min(kTailBH, a.hidden - j0);
    tile_gemm<kTailBM, kTailBH>(Rows<T>{sLN, C, kTailBM}, w1, C, C, j0,
                                a.hidden, sA, sW, [&](int r, int n, float v) {
                                  sH[r * kTailBH + (n - j0)] =
                                      from_f<T>(gelu_erf(v + to_f(b1[n])));
                                });
    for (int n0 = 0; n0 < C; n0 += kTailBN)
      tile_gemm<kTailBM, kTailBN>(Rows<T>{sH, kTailBH, kTailBM}, w2 + j0,
                                  a.hidden, kc, n0, C, sA, sW,
                                  [&](int r, int n, float v) {
                                    sAcc[r * C + n] += s_s2[r] * v;
                                  });
  }
  __syncthreads();

  // 4. out = t1 + s2 (b2 + fc2)
  for (int e = threadIdx.x; e < rows * C; e += kThreads)
    out[e] = from_f<T>(sAcc[e]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) k_block_tail(const TailArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int rb = blockIdx.x, si = 0;
  if (rb >= a.row_blocks0) {
    rb -= a.row_blocks0;
    si = 1;
  }
  tail_rows<T>(a, a.seg[si], rb * kTailBM, smem);
}

// Sets k's dynamic shared memory limit to `bytes` once per size increase
// (attr_bytes: the largest granted so far, one per kernel instance).
template <typename Kernel>
int grant_smem(Kernel k, size_t bytes, size_t& attr_bytes) {
  if (bytes <= attr_bytes) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  attr_bytes = bytes;
  return 0;
}

template <typename T>
int launch_tail(const TailArgs& a, cudaStream_t s) {
  static size_t attr_bytes = 0;
  const size_t bytes = tail_smem_bytes(a.C, sizeof(T));
  if (const int err = grant_smem(k_block_tail<T>, bytes, attr_bytes))
    return err;
  const int blocks = a.row_blocks0 + cdiv(a.seg[1].rows, kTailBM);
  k_block_tail<T><<<blocks, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// p[i] as a typed pointer (the host passes every tensor as void*).
template <typename T>
const T* cp(const void* const* p, int i) {
  return static_cast<const T*>(p[i]);
}
template <typename T>
T* mp(const void* const* p, int i) {
  return static_cast<T*>(const_cast<void*>(p[i]));
}

}  // namespace
}  // namespace lm
