// A whole stage of pre-norm S blocks in one launch: for each block j in
// order, x <- CPE_j(x) (when the blocks have one), then the S block on x and,
// with the same weights, on the meta tokens c (which attend only to
// themselves). The result is the chain of s_block.cu calls (cpe mode) up to
// summation order. Replaces the TPU kernel
// lemevit_tpu/attn/pallas_block.py::s_stage (_s_stage_call, _s_stage_kernel).
//
// Design. The TPU walked (batch folds x blocks) in order on one core and
// carried x in VMEM scratch. Here S attention stays within one image and one
// stream, so each image is owned by one thread-block cluster of `csize` CTAs
// (1, 2, 4 or 8: as many as keep B * csize CTAs within the card's SMs) that
// loops over the stage's blocks itself. Per block, four phases split their
// work items round-robin over the cluster's CTAs and end in a cluster
// barrier: the CPE of x into a workspace; qkv = LN1(t) Wqkv^T + b for both
// streams (32 x 128 tiles of tile_gemm); the attention (attention_tile, an
// online softmax per head and 32 queries); the tail (tail_rows: proj,
// residual, LN2, MLP over 32-row blocks, hidden in 128-wide chunks). Between
// blocks x and c stay in the input type in the output buffers, as the TPU
// scratch kept them. The weights are read in place through a device table
// of the blocks' pointers (any number of blocks; the wrapper copies it from
// pinned memory without waiting for the stream).
//
// What stays out of device memory: LN1(t) and LN2(t1), t1, the 4C-wide MLP
// hidden (one 32 x 128 chunk at a time) and the softmax scores. What does
// not fit a CTA's 227 KB (base stage 3: x 147 KB, qkv 441 KB, hidden 588 KB
// per image in bf16) lives in per-image workspaces: the CPE'd x, qkv and the
// attention output, written and read back within the launch (near the 50 MB
// L2 at batch 64). The stage's x and c cross device memory once in and once
// out, not once per block.
//
// Bound on the H100: operations, as for s_block: ~24 C^2 multiply-adds per
// row and block. chip_smoke.py::work summed over the blocks gives ~0.94 ms
// for base's stage 3 (18 blocks, N = 196, C = 384, batch 64) and ~0.11 ms
// for stage 4 (4 blocks, N = 49, C = 512). No phase is pipelined and one
// (or a few) CTAs work on an image: the kernel is far from that bound.
#include <cooperative_groups.h>

#include "block_common.cuh"

namespace lm {
namespace {

namespace cg = cooperative_groups;

constexpr int kStageBM = 32, kStageBN = 128;  // qkv product tiles
// per block in the table: ln1_w, ln1_b, wqkv, bqkv, wp, bp, ln2_w, ln2_b,
// w1, b1, w2, b2, cpe_taps, cpe_bias
constexpr int kStageParams = 14;

struct StageArgs {
  const void* x;
  const void* c;
  void* xo;     // (B*N, C): the carried x, the stage's output
  void* co;     // (B*M, C)
  void* xa;     // (B*N, C): CPE'd x (with the CPE)
  void* qkv_x;  // (B*N, 3C)
  void* qkv_c;  // (B*M, 3C)
  void* o_x;    // (B*N, C)
  void* o_c;    // (B*M, C)
  const void* const* table;  // device, nb * kStageParams pointers
  int nb, B, N, M, C, H, hidden, img_w, use_cpe, csize;
  float scale, eps;
};

// The end of a phase: every write of the cluster's CTAs is visible to all
// of them. The cluster barrier orders memory at cluster scope (arrive has
// release, wait acquire semantics); the fences make the order of the global
// writes explicit on both sides.
__device__ __forceinline__ void stage_sync(int csize) {
  if (csize == 1) {
    __syncthreads();
    return;
  }
  __threadfence();
  cg::this_cluster().sync();
  __threadfence();
}

inline size_t stage_smem_bytes(int C, size_t elt) {
  const size_t qkv = align16(4 * kBK * (kStageBM + 1)) +
                     align16(4 * kBK * (kStageBN + 1)) + 8 * kStageBM;
  const size_t attn = 4 * (size_t)kAttnSmemFloats;
  size_t b = tail_smem_bytes(C, elt);
  if (qkv > b) b = qkv;
  if (attn > b) b = attn;
  return b;
}

// qkv = LN1(t) Wqkv^T + bqkv for the image's x rows (t) and c rows.
template <typename T>
__device__ void stage_qkv(const StageArgs& a, const void* const* w,
                          const T* t, const T* c, T* qx, T* qc, int rank,
                          unsigned char* smem) {
  float* sA = reinterpret_cast<float*>(smem);
  float* sW = sA + align16(4 * kBK * (kStageBM + 1)) / 4;
  float* s_mean = sW + align16(4 * kBK * (kStageBN + 1)) / 4;
  float* s_rstd = s_mean + kStageBM;
  const int C = a.C, cols = 3 * C, cbs = cdiv(cols, kStageBN);
  const int nx = cdiv(a.N, kStageBM) * cbs, nc = cdiv(a.M, kStageBM) * cbs;
  const T* wqkv = static_cast<const T*>(w[2]);
  const T* bqkv = static_cast<const T*>(w[3]);
  const T* g = static_cast<const T*>(w[0]);
  const T* beta = static_cast<const T*>(w[1]);
  for (int it = rank; it < nx + nc; it += a.csize) {
    const bool isx = it < nx;
    const int i = isx ? it : it - nx, rb = i / cbs, cb = i % cbs;
    const int row0 = rb * kStageBM;
    const int rows = min(kStageBM, (isx ? a.N : a.M) - row0);
    const T* A = (isx ? t : c) + (size_t)row0 * C;
    T* out = (isx ? qx : qc) + (size_t)row0 * cols;
    __syncthreads();  // the previous item's reads of the statistics are done
    row_stats([&](int r, int k) {
      return r < rows ? to_f(A[(size_t)r * C + k]) : 0.f;
    }, kStageBM, C, a.eps, s_mean, s_rstd);
    __syncthreads();
    tile_gemm<kStageBM, kStageBN>(
        LnRows<T>{A, C, rows, s_mean, s_rstd, g, beta}, wqkv, C, C,
        cb * kStageBN, cols, sA, sW, [&](int r, int n, float v) {
          if (r < rows)
            out[(size_t)r * cols + n] = from_f<T>(v + to_f(bqkv[n]));
        });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) k_s_stage(const StageArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x / a.csize, rank = blockIdx.x % a.csize;
  const int C = a.C, N = a.N, M = a.M, H = a.H;
  const int step = a.csize * kThreads, tid = rank * kThreads + threadIdx.x;
  const size_t xr = (size_t)img * N, cr = (size_t)img * M;  // first rows
  T* xo = static_cast<T*>(a.xo) + xr * C;
  T* co = static_cast<T*>(a.co) + cr * C;
  T* xa = a.use_cpe ? static_cast<T*>(a.xa) + xr * C : nullptr;
  T* qx = static_cast<T*>(a.qkv_x) + xr * 3 * C;
  T* qc = static_cast<T*>(a.qkv_c) + cr * 3 * C;

  // the stage's input into the carried buffers
  const T* xin = static_cast<const T*>(a.x) + xr * C;
  const T* cin = static_cast<const T*>(a.c) + cr * C;
  for (int e = tid; e < N * C; e += step) xo[e] = xin[e];
  for (int e = tid; e < M * C; e += step) co[e] = cin[e];
  stage_sync(a.csize);

  for (int j = 0; j < a.nb; ++j) {
    const void* const* w = a.table + (size_t)j * kStageParams;

    // 1. the CPE of x, rounded to T, into xa; t is the block's x input
    const T* t = xo;
    if (a.use_cpe) {
      const CpeRows<T> cpe{xo, C, N, 0, Cpe{w[12], w[13], a.img_w, N}};
      for (int e = tid; e < N * C; e += step)
        xa[e] = from_f<T>(cpe(e / C, e % C));
      stage_sync(a.csize);
      t = xa;
    }

    // 2. qkv of both streams
    stage_qkv<T>(a, w, t, co, qx, qc, rank, smem);
    stage_sync(a.csize);

    // 3. attention: (head, 32 queries) items of x, then of c
    AttnArgs at{};
    at.ldq = at.ldkv = 3 * C;
    at.ldo = C;
    at.batch = a.B;
    at.heads = H;
    at.scale = a.scale;
    const int qbx = cdiv(N, kQB), qbc = cdiv(M, kQB);
    for (int it = rank; it < H * (qbx + qbc); it += a.csize) {
      const bool isx = it < H * qbx;
      const int i = isx ? it : it - H * qbx, qb = isx ? qbx : qbc;
      const T* qkv = static_cast<const T*>(isx ? a.qkv_x : a.qkv_c);
      at.q = qkv;
      at.k = qkv + C;
      at.v = qkv + 2 * C;
      at.out = isx ? a.o_x : a.o_c;
      at.nq = at.nk = isx ? N : M;
      attention_tile<T>(at, img * H + i / qb, (i % qb) * kQB,
                        reinterpret_cast<float*>(smem));
    }
    stage_sync(a.csize);

    // 4. proj, residual and MLP of each 32-row block, in place in xo / co
    TailArgs ta{};
    ta.ln_w = w[6];
    ta.ln_b = w[7];
    ta.w1 = w[8];
    ta.b1 = w[9];
    ta.w2 = w[10];
    ta.b2 = w[11];
    ta.C = C;
    ta.hidden = a.hidden;
    ta.eps = a.eps;
    const TailSeg sx{t, static_cast<const T*>(a.o_x) + xr * C, w[4], w[5],
                     xo, N};
    const TailSeg sc{co, static_cast<const T*>(a.o_c) + cr * C, w[4], w[5],
                     co, M};
    const int rbx = cdiv(N, kTailBM), rbc = cdiv(M, kTailBM);
    for (int it = rank; it < rbx + rbc; it += a.csize) {
      const bool isx = it < rbx;
      tail_rows<T>(ta, isx ? sx : sc, (isx ? it : it - rbx) * kTailBM,
                   smem);
    }
    stage_sync(a.csize);
  }
}

template <typename T>
int s_stage(const void* const* p, int nb, int B, int N, int M, int C, int H,
            int hidden, int img_w, int use_cpe, float scale, float eps,
            cudaStream_t s) {
  StageArgs a{p[0], p[1], mp<T>(p, 2), mp<T>(p, 3), mp<T>(p, 4),
              mp<T>(p, 5), mp<T>(p, 6), mp<T>(p, 7), mp<T>(p, 8)};
  a.table = static_cast<const void* const*>(p[9]);
  a.nb = nb;
  a.B = B;
  a.N = N;
  a.M = M;
  a.C = C;
  a.H = H;
  a.hidden = hidden;
  a.img_w = img_w;
  a.use_cpe = use_cpe;
  a.scale = scale;
  a.eps = eps;

  cudaError_t e;
  static size_t attr_bytes = 0;
  const size_t bytes = stage_smem_bytes(C, sizeof(T));
  if (const int err = grant_smem(k_s_stage<T>, bytes, attr_bytes)) return err;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  // the widest cluster (at most the portable 8) that keeps B * csize CTAs
  // within the SMs and that the card can place
  int csize = 8;
  while (csize > 1 && B * csize > sms) csize /= 2;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  for (;; csize /= 2) {
    cfg.gridDim = dim3(B * csize);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = csize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.numAttrs = csize > 1 ? 1 : 0;
    if (csize == 1) break;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, k_s_stage<T>, &cfg) ==
            cudaSuccess &&
        clusters > 0)
      break;
    cudaGetLastError();  // clear the refusal; try a narrower cluster
  }
  a.csize = csize;
  e = cudaLaunchKernelEx(&cfg, k_s_stage<T>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lm

// p: 0 x (B*N, C), 1 c (B*M, C), 2 x_out, 3 c_out | workspace 4 xa (B*N, C,
//    null without the CPE), 5 qkv_x (B*N, 3C), 6 qkv_c (B*M, 3C), 7 o_x
//    (B*N, C), 8 o_c (B*M, C), 9 table: a device array of the nb blocks'
//    14 pointers each, ln1_w, ln1_b, wqkv, bqkv, wp, bp, ln2_w, ln2_b, w1,
//    b1, w2, b2, cpe_taps (9, C), cpe_bias (C,) (the last two read only with
//    use_cpe; img_w: the image width, N = H * img_w).
extern "C" int lm_s_stage(int dtype, const void* const* p, int nb, int B,
                          int N, int M, int C, int H, int hidden, int img_w,
                          int use_cpe, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::s_stage<float>(p, nb, B, N, M, C, H, hidden, img_w, use_cpe,
                              scale, eps, s);
  return lm::s_stage<__nv_bfloat16>(p, nb, B, N, M, C, H, hidden, img_w,
                                    use_cpe, scale, eps, s);
}
