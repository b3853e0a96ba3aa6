// The S block's MLP backward and attention backward and the D and C
// blocks' attention backwards on Hopper's tensor cores (s_train.cu's
// lm_mlp_bwd and lm_s_attn_bwd, dca_train.cu's lm_dca_attn_bwd,
// c_train.cu's lm_c_attn_bwd). Replaces, with block_tc.cuh's k_qkv_wg,
// lemevit_tpu/attn/pallas_train.py's _mlp_bwd_kernel (_mlp_bwd_call),
// _s_attn_bwd_kernel (_s_train_bwd_call), _dca_attn_bwd_kernel
// (_dca_train_bwd_call) and _c_attn_bwd_kernel (_c_train_bwd_call): the
// TPU kernels
// recompute LN / fc1 / GELU and LN1 / qkv / P in VMEM and accumulate the
// weight gradients in resident fp32 blocks across their sequential grid;
// here the row kernels write the rounded operands of the weight gradients
// once, and a grouped
// weight-gradient product sums them over row ranges into fp32 partials
// that a fixed-order reduce adds (no atomics: two calls give the same
// bits).
//
// Bound on the H100: operations (the MLP backward ~40 C^2 multiply-adds a
// row against ~6 C bytes; the attention backward ~22 C^2 + 10 N C). What
// each kernel does about it:
//   k_mlp_bwd_wg   a CTA takes 64 rows of one stream, stages LN2(t1)
//                  (rounded to T, also written out for dW1) once in the
//                  128-byte-swizzled layout and walks the hidden width 64
//                  columns at a time: y = LN2(t1) W1c^T and dgg = dz W2c
//                  from W1 / W2^T / dz sub-tiles that arrive together by
//                  TMA, dy = dgg GELU'(y + b1) in fp32, rounded to T into a
//                  swizzled chunk (and out, with GELU(y), for the weight
//                  gradients), then d(LN2) += dy W1c from W1^T tiles into a
//                  (64 x C) fp32 accumulator that the two warpgroups split by
//                  columns and keep in registers across the hidden loop; the
//                  LN2 backward + dout runs in the epilogue from those
//                  registers, its row sums meeting in shared memory.
//   k_rowmm_wg     out = A W^T over 64 rows a CTA, A and W sub-tiles by TMA
//                  into a ring (each stream its own W and depth: the D
//                  block's proj_x / proj_c, qkv1 / qkv2; the C block's kv
//                  at 2C and q at C), the (64 x C) sum in registers: dO =
//                  dproj Wp rounded to T with D = rowsum(dO . o) per head
//                  in its epilogue, or da = dqkv Wqkv' with the LN1
//                  backward and the dt1 residual (none for the C block's
//                  image rows) in its epilogue (dx in T, or du in fp32 for
//                  the CPE's backward).
//   k_attn_bwd_kv_tc / k_attn_bwd_q_tc / k_attn_bwd_small_tc
//                  FlashAttention-2's backward on attn_tc.cuh's fragments
//                  (ldmatrix into mma.sync m16n8k16, quad-shuffle rows, ex2
//                  with scale log2(e) folded), head_dim 32: a CTA per
//                  (image, head, 128 keys) walks the queries 64 at a time
//                  for dK / dV, one per (image, head, 128 queries) walks the
//                  keys for dQ, all sums in registers; at N <= 16 (the
//                  meta stream) a warp takes a whole (image, head). P is
//                  rebuilt from the forward's log-sum-exp; dO, P and dS =
//                  P (dP - D) scale are rounded to T before their products
//                  (pallas_train.py::_attn_grp_bwd), D stays fp32.
//   k_dca_bwd_tc / k_dca_bwd_reduce
//                  the D block's cross-attention backward, both directions
//                  on the same fragments: a CTA per (image, head, range of
//                  image rows) walks its chunks of 128 rows (64 in fp32)
//                  with the image's meta rows staged once, writes dq1, dk1,
//                  dv1 of its rows and, for the sums over N (dq2, dk2, dv2:
//                  the 16 meta rows are one m tile, so no CTA walks all N),
//                  an fp32 partial per range, which the reduce adds in range
//                  order. The C block's is its c direction alone (kX
//                  false): k1 / v1 staged a chunk, q2 / dO2 up to 256 meta
//                  rows at a time, dk1 / dv1 written, dq2 through the
//                  partials.
//   k_wgrad_tc     dW = G^T A over token rows for up to two products in one
//                  launch: both operands arrive row-major with K = rows, so
//                  128 x 128 tiles of G and A are copied 64 rows deep by
//                  cp.async into a three-stage ring and read by
//                  ldmatrix.trans straight into mma.sync (no transposing
//                  copy); each CTA sums one row range into fp32 partials
//                  (and the column sums of G for a bias), and
//                  k_wgrad_tc_reduce adds the ranges in order.
// bf16 and fp32 run the same kernels, tiles, schedules and epilogues; only
// the products differ (wgmma / mma.sync, or FMA from the same shared
// tiles), so the fp32 checks against the plain phases at 1e-4 hold the
// indexing, TMA maps, masks and epilogues. fp32 never issues wgmma.
// block_tc.cuh's helpers (swz, sub_mma, the mbarrier ring, tma_map) and
// attn_tc.cuh's fragments are used as they are.
//
// On the card (PERF.md, section 6): the row kernels take two CTAs an SM in
// bf16 up to C = 192 (rings sized to half an SM); 128-row MLP CTAs of four
// warpgroups, sharing each weight tile between twice the rows, measured
// slower at every shape, and keeping the MLP's products in flight across
// the next barrier gained nothing; 128-row attention CTAs beat 64-row ones
// at N = 784 and lost a little at N = 1024 (B = 8), and two m tiles a warp
// (halving the ldmatrix per product, on 32-row streamed tiles) measured
// slower.
#pragma once

#include "block_tc.cuh"
#include "train_common.cuh"

namespace lm {
namespace {

// ---------------------------------------------------------------- attention

// One stream's self-attention backward: q / k / v are the thirds of the
// recomputed qkv rows and dq / dk / dv the thirds of dqkv's (both ld 3C),
// dO (rows, C) in T; lse and D per (image, head, token) at
// [(b heads + h) n + i], fp32. Head h uses columns [32 h, 32 h + 32).
struct AttnBwdTc {
  const void* qkv;
  const void* dO;
  const float* lse;
  const float* D;
  void* dqkv;
  int C, batch, heads, n;
  float scale;
};

// Keys (dK / dV) or queries (dQ) of a CTA, 16 a warp: 128 halve the
// streamed tiles' copies per row against 64 (each streamed row serves
// twice the rows of the CTA).
constexpr int kBwdRows = 128;
constexpr int kBwdThreads = 2 * kBwdRows;
constexpr int kBwdStep = 64;  // queries or keys of a streamed tile

// Shared bytes of the two row-tiled kernels: two resident row tiles, two
// stages of two streamed tiles, the kv kernel's lse / D of two stages.
template <typename T>
constexpr int attn_bwd_smem_bytes() {
  return (2 * kBwdRows + 4 * kBwdStep) * TcRows<T>::kPitch *
             (int)sizeof(T) +
         2 * 2 * kBwdStep * (int)sizeof(float);
}

// The operand pointers of (image b, head h) at token 0.
template <typename T>
struct BwdHead {
  const T* q;
  const T* k;
  const T* v;
  const T* dO;
  T* dq;
  __device__ __forceinline__ BwdHead(const AttnBwdTc& a, int b, int h) {
    const int ld = 3 * a.C;
    q = static_cast<const T*>(a.qkv) + (size_t)b * a.n * ld + h * kHeadDim;
    k = q + a.C;
    v = q + 2 * a.C;
    dO = static_cast<const T*>(a.dO) + (size_t)b * a.n * a.C + h * kHeadDim;
    dq = static_cast<T*>(a.dqkv) + (size_t)b * a.n * ld + h * kHeadDim;
  }
};

// dS = P (dP - D) scale in place of dp, and P in place of s, for a warp's
// scores s (rows g / g + 8, the 8 NT columns of qk_tile) against per-row
// (kRowStats: L / D of the two rows) or per-column (L / D indexed by the
// column) statistics; L = lse log2(e), +inf where the query is padding, so
// its P is exactly 0. With kMask, columns at or past `valid` get P = 0.
template <int NT, bool kRowStats, bool kMask>
__device__ __forceinline__ void bwd_scores(float (&s)[NT][4],
                                           float (&dp)[NT][4],
                                           const float* L, const float* D,
                                           float sl2, float scale,
                                           int valid) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * t + c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l = kRowStats ? L[h] : L[col];
        const float d = kRowStats ? D[h] : D[col];
        float p = exp2_sfu(fmaf(s[j][2 * h + c], sl2, -l));
        if (kMask && col >= valid) p = 0.f;
        s[j][2 * h + c] = p;
        dp[j][2 * h + c] = p * (dp[j][2 * h + c] - d) * scale;
      }
    }
}

// dK / dV of keys k0 .. k0 + 127 of (image, head) blockIdx.x: warp w owns
// keys 16 w .. 16 w + 15 (their K / V fragments loaded once) and walks the
// queries in 64-row tiles (Q, dO, lse, D) through a two-stage cp.async
// ring: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T, dV += P^T dO, dK += dS^T Q.
// Padded keys compute on zero rows and are not stored.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, sizeof(T) == 2 ? 2 : 1)
    k_attn_bwd_kv_tc(const AttnBwdTc a) {
  extern __shared__ __align__(16) unsigned char abk_smem[];
  constexpr int P = TcRows<T>::kPitch, R = kBwdRows, QS = kBwdStep;
  constexpr int kStage = 2 * QS * P;  // Q and dO rows of one stage
  T* sK = reinterpret_cast<T*>(abk_smem);
  T* sV = sK + R * P;
  T* st0 = sV + R * P;
  float* sLD = reinterpret_cast<float*>(st0 + 2 * kStage);  // [2][L | D]
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * R;
  const int warp = threadIdx.x >> 5, tid = threadIdx.x;
  const int ld = 3 * a.C;
  const BwdHead<T> hd(a, b, h);
  const float* lse = a.lse + (size_t)bh * a.n;
  const float* Dg = a.D + (size_t)bh * a.n;
  const float sl2 = a.scale * kLog2e;
  copy_rows(sK, hd.k + (size_t)k0 * ld, ld, R, a.n - k0, tid, kBwdThreads);
  copy_rows(sV, hd.v + (size_t)k0 * ld, ld, R, a.n - k0, tid, kBwdThreads);
  const int tiles = cdiv(a.n, QS);
  auto load_q = [&](int qt) {
    const int q0 = qt * QS;
    T* s = st0 + (qt & 1) * kStage;
    copy_rows(s, hd.q + (size_t)q0 * ld, ld, QS, a.n - q0, tid,
              kBwdThreads);
    copy_rows(s + QS * P, hd.dO + (size_t)q0 * a.C, a.C, QS, a.n - q0, tid,
              kBwdThreads);
    float* l = sLD + (qt & 1) * 2 * QS;
    for (int i = tid; i < QS; i += kBwdThreads) {
      const bool ok = q0 + i < a.n;
      l[i] = ok ? lse[q0 + i] * kLog2e : INFINITY;
      l[QS + i] = ok ? Dg[q0 + i] : 0.f;
    }
  };
  load_q(0);
  cp_async_commit();  // K, V and query tile 0
  if (tiles > 1) load_q(1);
  cp_async_commit();

  const bool busy = k0 + warp * 16 < a.n;
  ARows<T> AK, AV;
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  for (int qt = 0; qt < tiles; ++qt) {
    cp_async_wait<1>();  // tile qt (and K / V) landed for this thread ...
    __syncthreads();     // ... and for every thread
    if (busy) {
      if (qt == 0) {
        AK.load(sK + warp * 16 * P);
        AV.load(sV + warp * 16 * P);
      }
      const T* sQ = st0 + (qt & 1) * kStage;
      const T* sdO = sQ + QS * P;
      const float* sL = sLD + (qt & 1) * 2 * QS;
      float s[QS / 8][4], dp[QS / 8][4];
      qk_tile<QS / 8>(s, AK, sQ);    // S^T: the warp's 16 keys x QS queries
      qk_tile<QS / 8>(dp, AV, sdO);  // dP^T
      bwd_scores<QS / 8, false, false>(s, dp, sL, sL + QS, sl2, a.scale, QS);
      pv_tile<QS / 16>(dv, s, sdO);   // dV += P^T dO (P rounded to T)
      pv_tile<QS / 16>(dk, dp, sQ);   // dK += dS^T Q (dS rounded to T)
    }
    __syncthreads();  // every warp is done with this stage
    if (qt + 2 < tiles) load_q(qt + 2);
    cp_async_commit();
  }
  const int r = k0 + warp * 16;  // the warp's first key
  T* dK = hd.dq + (size_t)r * ld + a.C;
  store_tile(dK, ld, a.n - r, sK + warp * 16 * P, dk, 1.f, 1.f);
  store_tile(dK + a.C, ld, a.n - r, sV + warp * 16 * P, dv, 1.f, 1.f);
}

// dQ of queries q0 .. q0 + 127 of (image, head) blockIdx.x: warp w owns
// queries 16 w .. 16 w + 15 (their Q / dO fragments loaded once, their
// lse / D in registers) and walks the keys in 64-row tiles (K, V) through
// a two-stage cp.async ring: S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    k_attn_bwd_q_tc(const AttnBwdTc a) {
  extern __shared__ __align__(16) unsigned char abq_smem[];
  constexpr int P = TcRows<T>::kPitch, R = kBwdRows, KT = kBwdStep;
  constexpr int kStage = 2 * KT * P;  // K and V rows of one stage
  T* sQ = reinterpret_cast<T*>(abq_smem);
  T* sdO = sQ + R * P;
  T* st0 = sdO + R * P;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * R;
  const int warp = threadIdx.x >> 5, tid = threadIdx.x, lane = tid & 31;
  const int ld = 3 * a.C;
  const BwdHead<T> hd(a, b, h);
  const float sl2 = a.scale * kLog2e;
  copy_rows(sQ, hd.q + (size_t)q0 * ld, ld, R, a.n - q0, tid, kBwdThreads);
  copy_rows(sdO, hd.dO + (size_t)q0 * a.C, a.C, R, a.n - q0, tid,
            kBwdThreads);
  const int tiles = cdiv(a.n, KT);
  auto load_kv = [&](int kt) {
    const int j0 = kt * KT;
    T* s = st0 + (kt & 1) * kStage;
    copy_rows(s, hd.k + (size_t)j0 * ld, ld, KT, a.n - j0, tid,
              kBwdThreads);
    copy_rows(s + KT * P, hd.v + (size_t)j0 * ld, ld, KT, a.n - j0, tid,
              kBwdThreads);
  };
  load_kv(0);
  cp_async_commit();  // Q, dO and key tile 0
  if (tiles > 1) load_kv(1);
  cp_async_commit();

  const int r = q0 + warp * 16;  // the warp's first query
  const bool busy = r < a.n;
  float L[2], D[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r + (lane >> 2) + 8 * i;
    const size_t p = (size_t)bh * a.n + qi;
    L[i] = qi < a.n ? a.lse[p] * kLog2e : INFINITY;
    D[i] = qi < a.n ? a.D[p] : 0.f;
  }
  ARows<T> AQ, AdO;
  float dq[4][4];
  zero(dq);
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<1>();
    __syncthreads();
    if (busy) {
      if (kt == 0) {
        AQ.load(sQ + warp * 16 * P);
        AdO.load(sdO + warp * 16 * P);
      }
      const T* sK = st0 + (kt & 1) * kStage;
      const T* sV = sK + KT * P;
      float s[KT / 8][4], dp[KT / 8][4];
      qk_tile<KT / 8>(s, AQ, sK);   // S
      qk_tile<KT / 8>(dp, AdO, sV);  // dP = dO V^T
      bwd_scores<KT / 8, true, true>(s, dp, L, D, sl2, a.scale,
                                     a.n - kt * KT);
      pv_tile<KT / 16>(dq, dp, sK);  // dQ += dS K (dS rounded to T)
    }
    __syncthreads();
    if (kt + 2 < tiles) load_kv(kt + 2);
    cp_async_commit();
  }
  store_tile(hd.dq + (size_t)r * ld, ld, a.n - r, sQ + warp * 16 * P, dq,
             1.f, 1.f);
}

// At n <= 16 (the meta-token stream): warp w takes (image, head)
// blockIdx.x * 4 + w whole, both directions from one 16-row tile each of
// Q, K, V and dO.
template <typename T>
__global__ void __launch_bounds__(kTcThreads)
    k_attn_bwd_small_tc(const AttnBwdTc a) {
  constexpr int P = TcRows<T>::kPitch;
  constexpr int kWarpBytes = 4 * 16 * P * (int)sizeof(T) + 32 * 4;
  __shared__ __align__(16) unsigned char smem[kTcWarps * kWarpBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sQ = reinterpret_cast<T*>(smem + warp * kWarpBytes);
  T* sK = sQ + 16 * P;
  T* sV = sK + 16 * P;
  T* sdO = sV + 16 * P;
  float* sL = reinterpret_cast<float*>(sdO + 16 * P);  // [L 16 | D 16]
  const int bh = blockIdx.x * kTcWarps + warp;
  const bool live = bh < a.batch * a.heads;
  const int b = live ? bh / a.heads : 0, h = live ? bh % a.heads : 0;
  const int n = live ? a.n : 0, ld = 3 * a.C;
  const BwdHead<T> hd(a, b, h);
  copy_rows(sQ, hd.q, ld, 16, n, lane, 32);
  copy_rows(sK, hd.k, ld, 16, n, lane, 32);
  copy_rows(sV, hd.v, ld, 16, n, lane, 32);
  copy_rows(sdO, hd.dO, a.C, 16, n, lane, 32);
  cp_async_commit();
  if (lane < 16) {
    const size_t p = (size_t)bh * a.n + lane;
    sL[lane] = lane < n ? a.lse[p] * kLog2e : INFINITY;
    sL[16 + lane] = lane < n ? a.D[p] : 0.f;
  }
  cp_async_wait<0>();
  __syncwarp();
  const float sl2 = a.scale * kLog2e;
  const int g = lane >> 2;
  ARows<T> A0, A1;
  float s[2][4], dp[2][4];
  // dQ: rows are queries
  A0.load(sQ);
  A1.load(sdO);
  qk_tile<2>(s, A0, sK);
  qk_tile<2>(dp, A1, sV);
  const float L[2] = {sL[g], sL[g + 8]}, D[2] = {sL[16 + g], sL[24 + g]};
  bwd_scores<2, true, true>(s, dp, L, D, sl2, a.scale, n);
  float dq[4][4];
  zero(dq);
  pv_tile<1>(dq, dp, sK);
  // dK / dV: rows are keys
  A0.load(sK);
  A1.load(sV);
  qk_tile<2>(s, A0, sQ);
  qk_tile<2>(dp, A1, sdO);
  bwd_scores<2, false, false>(s, dp, sL, sL + 16, sl2, a.scale, 16);
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  pv_tile<1>(dv, s, sdO);
  pv_tile<1>(dk, dp, sQ);
  store_tile(hd.dq, ld, n, sQ, dq, 1.f, 1.f);
  store_tile(hd.dq + a.C, ld, n, sK, dk, 1.f, 1.f);
  store_tile(hd.dq + 2 * a.C, ld, n, sV, dv, 1.f, 1.f);
}

template <typename T>
int launch_attn_bwd_tc(const AttnBwdTc& a, cudaStream_t s) {
  if (a.n <= kTcSmall) {
    k_attn_bwd_small_tc<T><<<cdiv(a.batch * a.heads, kTcWarps), kTcThreads,
                             0, s>>>(a);
    return (int)cudaGetLastError();
  }
  static size_t attr_kv = 0, attr_q = 0;
  constexpr size_t bytes = attn_bwd_smem_bytes<T>();
  if (const int err = grant_smem(k_attn_bwd_kv_tc<T>, bytes, attr_kv))
    return err;
  if (const int err = grant_smem(k_attn_bwd_q_tc<T>, bytes, attr_q))
    return err;
  const dim3 grid(a.batch * a.heads, cdiv(a.n, kBwdRows));
  k_attn_bwd_kv_tc<T><<<grid, kBwdThreads, bytes, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  k_attn_bwd_q_tc<T><<<grid, kBwdThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- DCA bwd

// The cross-attention backward of the D block, both directions (kX,
// dca_train.cu's lm_dca_attn_bwd): the x direction's N image queries q1
// over the M meta keys k2 / v2, the c direction's M meta queries q2 over
// the N image keys k1 / v1. qkv1 / dqkv1 are (B N, 3C) image rows, qkv2 /
// dqkv2 (B M, 3C) meta rows. The C block's (kX false, c_train.cu's
// lm_c_attn_bwd) is the c direction alone: qkv1 / dqkv1 are then kv / dkv
// (B N, 2C: k1 | v1), qkv2 / dqkv2 are q / dq (B M, C), and nothing of dO1,
// lse1 or D1 is read. dO1 / dO2 (rows, C) in T; lse1 / D1 at [(b heads +
// h) N + i], lse2 / D2 at [(b heads + h) M + j], fp32. dq1, dk1 and dv1
// (one image row's) are written by k_dca_bwd_tc; dq2, dk2 and dv2 (sums
// over the N image rows; only dq2 without kX) leave each range of image
// rows as an fp32 partial (part: [((b heads + h) ranges + range) Mp +
// j][dq2 32 | dk2 32 | dv2 32], Mp = M rounded up to 16), which
// k_dca_bwd_reduce adds in range order.
struct DcaBwdTc {
  const void* qkv1;
  const void* qkv2;
  const void* dO1;
  const void* dO2;
  const float* lse1;
  const float* D1;
  const float* lse2;
  const float* D2;
  void* dqkv1;
  void* dqkv2;
  float* part;
  int C, batch, heads, n, m;
  int ranges, chunks;  // ranges of `chunks` row chunks per (image, head)
  float scale_x, scale_c;
  int mc;  // meta rows staged at a time (a multiple of 16; set by the
           // launch: all of them with kX, up to kDcaMetaChunk without)
};

// Image rows of one chunk, 16 a warp: 128 in bf16, 64 in fp32 (whose rows
// take twice the shared memory).
template <typename T, bool kX = true>
struct DcaBwdTile {
  static constexpr int kRows = sizeof(T) == 2 ? 128 : 64;
  static constexpr int kWarps = kRows / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSums = kX ? 3 : 1;  // dq2 [dk2 dv2]
  static constexpr int kPart = kSums * kHeadDim;  // floats of a partial row
  static constexpr int kChunk = kX ? 4 : 2;  // q1 k1 v1 dO1, or k1 v1
  static constexpr int kMeta = kX ? 4 : 2;   // q2 k2 v2 dO2, or q2 dO2
  // two stages of a chunk's kChunk arrays, mc meta rows of kMeta arrays,
  // with kX the chunk stages' L1 / D1, the meta L2 / D2, one meta tile's
  // partial (16 rows)
  static size_t smem_bytes(int mc) {
    return (size_t)(2 * kChunk * kRows + kMeta * mc) * TcRows<T>::kPitch *
               sizeof(T) +
           (size_t)((kX ? 2 * 2 * kRows : 0) + 2 * mc + 16 * kPart) *
               sizeof(float);
  }
};

// One warp's 16 image rows of a chunk against one meta tile of 16 (rows
// mt0 .. mt0 + 15 of the staged meta rows), every product on attn_tc.cuh's
// fragments, P rebuilt from the log-sum-exps (L = lse log2(e), +inf for a
// padded row, so its P is 0) and P, dS rounded to T before their
// products:
//   x (kX): S = Q1 K2^T, dP = dO1 V2^T (meta keys past m masked), dS;
//      dq1 += dS K2; then S^T = K2 Q1^T, dP^T = V2 dO1^T: pv2 += P^T dO1,
//      pk2 += dS^T Q1 (the warp's part of the sums over image rows);
//   c: S^T = K1 Q2^T, dP^T = V1 dO2^T: dv1 += P^T dO2, dk1 += dS^T Q2;
//      then S = Q2 K1^T, dP = dO2 V1^T (image keys past the chunk's valid
//      rows masked): pq2 += dS K1.
// The transposed products are recomputed rather than moved between
// fragments: head_dim 32 and 16 meta tokens make them a few mma.sync each.
template <typename T, bool kX>
__device__ __forceinline__ void dca_bwd_warp(
    const DcaBwdTc& a, const T* sQ1, const T* sK1, const T* sV1,
    const T* sdO1, const float* L1, const float* D1, const T* sQ2,
    const T* sK2, const T* sV2, const T* sdO2, const float* L2,
    const float* D2, int m_valid, int n_valid, float (&dq1)[4][4],
    float (&dk1)[4][4], float (&dv1)[4][4], float (&pq2)[4][4],
    float (&pk2)[4][4], float (&pv2)[4][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const float slc = a.scale_c * kLog2e;
  ARows<T> A0, A1;
  float s[2][4], dp[2][4];
  if constexpr (kX) {
    const float slx = a.scale_x * kLog2e;
    // x direction, rows = image queries
    A0.load(sQ1);
    A1.load(sdO1);
    qk_tile<2>(s, A0, sK2);
    qk_tile<2>(dp, A1, sV2);
    {
      const float L[2] = {L1[g], L1[g + 8]}, D[2] = {D1[g], D1[g + 8]};
      bwd_scores<2, true, true>(s, dp, L, D, slx, a.scale_x, m_valid);
    }
    pv_tile<1>(dq1, dp, sK2);
    // x direction, rows = meta keys (columns: the warp's image rows)
    A0.load(sK2);
    A1.load(sV2);
    qk_tile<2>(s, A0, sQ1);
    qk_tile<2>(dp, A1, sdO1);
    bwd_scores<2, false, false>(s, dp, L1, D1, slx, a.scale_x, 16);
    pv_tile<1>(pv2, s, sdO1);
    pv_tile<1>(pk2, dp, sQ1);
  }
  // c direction, rows = image keys (columns: the meta queries)
  A0.load(sK1);
  A1.load(sV1);
  qk_tile<2>(s, A0, sQ2);
  qk_tile<2>(dp, A1, sdO2);
  bwd_scores<2, false, false>(s, dp, L2, D2, slc, a.scale_c, 16);
  pv_tile<1>(dv1, s, sdO2);
  pv_tile<1>(dk1, dp, sQ2);
  // c direction, rows = meta queries
  A0.load(sQ2);
  A1.load(sdO2);
  qk_tile<2>(s, A0, sK1);
  qk_tile<2>(dp, A1, sV1);
  {
    const float L[2] = {L2[g], L2[g + 8]}, D[2] = {D2[g], D2[g + 8]};
    bwd_scores<2, true, true>(s, dp, L, D, slc, a.scale_c, n_valid);
  }
  pv_tile<1>(pq2, dp, sK1);
}

// CTA (image, head) blockIdx.x, range blockIdx.y: the range's chunks of
// DcaBwdTile<T>::kRows image rows in turn through a two-stage cp.async
// ring (chunk c + 2 in flight while chunk c computes), the image's meta
// rows staged once (without kX a.mc at a time: past a.mc meta rows the
// range holds one chunk, and each further group of meta rows is staged in
// turn against it). Warp w owns rows 16 w .. 16 w + 15 of each chunk:
// their dq1 / dk1 / dv1 sum over the meta tiles in registers and leave
// rounded to T; the meta sums pq2 (/ pk2 / pv2) stay in registers across
// the range's chunks (more than one meta tile: one chunk a range, the
// host's choice) and meet in shared memory in warp order, one meta tile
// at a time, before the range's partial goes out. No atomics: two calls
// give the same bits.
template <typename T, bool kX>
__global__ void __launch_bounds__(DcaBwdTile<T, kX>::kThreads, 1)
    k_dca_bwd_tc(const DcaBwdTc a) {
  using L = DcaBwdTile<T, kX>;
  constexpr int P = TcRows<T>::kPitch, R = L::kRows, NTH = L::kThreads;
  constexpr int kStage = L::kChunk * R * P;  // the arrays of one chunk
  extern __shared__ __align__(16) unsigned char dbw_smem[];
  // with kX every meta row is staged once (one group, known at compile
  // time, so the loop below adds nothing to the x direction's registers)
  const int mp = cdiv(a.m, kMetaTile) * kMetaTile, mc = kX ? mp : a.mc;
  const int groups = kX ? 1 : cdiv(a.m, mc);
  // a stage's rows: [q1] k1 v1 [dO1]; the meta rows: q2 [k2 v2] dO2
  constexpr int oK1 = kX ? R : 0, oV1 = oK1 + R, odO1 = oV1 + R;
  T* st0 = reinterpret_cast<T*>(dbw_smem);
  T* sQ2 = st0 + 2 * kStage;
  T* sK2 = sQ2 + mc * P;  // kX
  T* sV2 = sK2 + mc * P;  // kX
  T* sdO2 = kX ? sV2 + mc * P : sQ2 + mc * P;
  float* sLD1 = reinterpret_cast<float*>(sdO2 + mc * P);  // kX: [2][L1|D1]
  float* sL2 = sLD1 + (kX ? 2 * 2 * R : 0);
  float* sD2 = sL2 + mc;
  float* sRed = sD2 + mc;  // one meta tile's partial, [16][kPart]
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // row pitches: qkv1 / dqkv1 3C (kv / dkv 2C), qkv2 / dqkv2 3C (q / dq C)
  const int ld1 = (kX ? 3 : 2) * a.C, ld2 = (kX ? 3 : 1) * a.C;
  const T* X1 = static_cast<const T*>(a.qkv1) + (size_t)b * a.n * ld1 +
                h * kHeadDim;  // the head's first column of q1 (k1)
  const T* dO1 = kX ? static_cast<const T*>(a.dO1) +
                          (size_t)b * a.n * a.C + h * kHeadDim
                    : nullptr;
  const T* Q2 = static_cast<const T*>(a.qkv2) + (size_t)b * a.m * ld2 +
                h * kHeadDim;
  const T* dO2 = static_cast<const T*>(a.dO2) + (size_t)b * a.m * a.C +
                 h * kHeadDim;
  T* dX1 = static_cast<T*>(a.dqkv1) + (size_t)b * a.n * ld1 + h * kHeadDim;
  const float* lse1 = kX ? a.lse1 + (size_t)bh * a.n : nullptr;
  const float* D1g = kX ? a.D1 + (size_t)bh * a.n : nullptr;
  const int c0 = blockIdx.y * a.chunks;
  const int c1 = min(cdiv(a.n, R), c0 + a.chunks);

  auto stage_meta = [&](int j0) {  // meta rows j0 .. j0 + mc - 1
    const int cnt = min(mc, a.m - j0);
    copy_rows(sQ2, Q2 + (size_t)j0 * ld2, ld2, mc, cnt, tid, NTH);
    if constexpr (kX) {
      copy_rows(sK2, Q2 + a.C, ld2, mc, cnt, tid, NTH);
      copy_rows(sV2, Q2 + 2 * a.C, ld2, mc, cnt, tid, NTH);
    }
    copy_rows(sdO2, dO2 + (size_t)j0 * a.C, a.C, mc, cnt, tid, NTH);
    for (int j = tid; j < mc; j += NTH) {
      const bool ok = j < cnt;
      sL2[j] = ok ? a.lse2[(size_t)bh * a.m + j0 + j] * kLog2e : INFINITY;
      sD2[j] = ok ? a.D2[(size_t)bh * a.m + j0 + j] : 0.f;
    }
  };
  auto load = [&](int c) {  // chunk c's rows (and statistics) into its stage
    const int r0 = c * R, valid = a.n - r0;
    T* st = st0 + (c & 1) * kStage;
    const T* x1 = X1 + (size_t)r0 * ld1;
    if constexpr (kX) copy_rows(st, x1, ld1, R, valid, tid, NTH);
    copy_rows(st + oK1 * P, x1 + (kX ? a.C : 0), ld1, R, valid, tid, NTH);
    copy_rows(st + oV1 * P, x1 + (kX ? 2 : 1) * a.C, ld1, R, valid, tid,
              NTH);
    if constexpr (kX) {
      copy_rows(st + odO1 * P, dO1 + (size_t)r0 * a.C, a.C, R, valid, tid,
                NTH);
      float* l = sLD1 + (c & 1) * 2 * R;
      for (int i = tid; i < R; i += NTH) {
        const bool ok = i < valid;
        l[i] = ok ? lse1[r0 + i] * kLog2e : INFINITY;
        l[R + i] = ok ? D1g[r0 + i] : 0.f;
      }
    }
  };
  stage_meta(0);
  if (c0 < c1) load(c0);
  cp_async_commit();  // the meta rows and chunk c0
  if (c0 + 1 < c1) load(c0 + 1);
  cp_async_commit();

  float pq2[4][4], pk2[4][4], pv2[4][4];
  zero(pq2);
  zero(pk2);
  zero(pv2);
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<1>();  // chunk c (and the meta rows) landed for this
    __syncthreads();     // thread, and for every thread
    const int r0 = c * R + warp * 16;  // the warp's first image row
    T* st = st0 + (c & 1) * kStage + warp * 16 * P;
    const float* l1 = sLD1 + (c & 1) * 2 * R + warp * 16;
    const bool busy = r0 < a.n;
    float dq1[4][4], dk1[4][4], dv1[4][4];
    zero(dq1);
    zero(dk1);
    zero(dv1);
    for (int grp = 0; grp < groups; ++grp) {
      const int j0c = grp * mc;
      if (!kX && grp) {  // the next mc meta rows (one chunk in this range)
        __syncthreads();  // every warp is done with the staged ones
        stage_meta(j0c);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int mtiles = kX ? mp / kMetaTile
                            : cdiv(min(mc, a.m - j0c), kMetaTile);
      for (int mt = 0; mt < mtiles; ++mt) {
        const int j0 = mt * kMetaTile;
        if (busy)
          dca_bwd_warp<T, kX>(
              a, st, st + oK1 * P, st + oV1 * P, st + odO1 * P, l1, l1 + R,
              sQ2 + j0 * P, sK2 + j0 * P, sV2 + j0 * P, sdO2 + j0 * P,
              sL2 + j0, sD2 + j0, a.m - j0c - j0, a.n - r0, dq1, dk1, dv1,
              pq2, pk2, pv2);
        if (c == c1 - 1) {  // the range's sums of this meta tile: warps in
                            // order into sRed, then out
          float(*acc[3])[4] = {pq2, pk2, pv2};
          for (int w = 0; w < L::kWarps; ++w) {
            if (warp == w) {
#pragma unroll
              for (int k = 0; k < L::kSums; ++k)
#pragma unroll
                for (int d = 0; d < 4; ++d)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int row = g + 8 * (e >> 1);
                    float* r = sRed + row * L::kPart + k * kHeadDim + 8 * d +
                               2 * t + (e & 1);
                    *r = w ? *r + acc[k][d][e] : acc[k][d][e];
                  }
            }
            __syncthreads();
          }
          float* part = a.part + (((size_t)bh * a.ranges + blockIdx.y) * mp +
                                  j0c + j0) * L::kPart;
          for (int e = tid; e < 16 * L::kPart; e += NTH) part[e] = sRed[e];
          zero(pq2);
          zero(pk2);
          zero(pv2);
          __syncthreads();  // sRed is free for the next meta tile
        }
      }
    }
    // dq1 | dk1 | dv1 (dk1 | dv1 without kX) out, each staged through the
    // warp's own rows of the stage (no other warp reads them)
    T* out = dX1 + (size_t)r0 * ld1;
    const int rows = a.n - r0;
    if constexpr (kX) store_tile(out, ld1, rows, st, dq1, 1.f, 1.f);
    out += kX ? a.C : 0;
    store_tile(out, ld1, rows, st + oK1 * P, dk1, 1.f, 1.f);
    store_tile(out + a.C, ld1, rows, st + oV1 * P, dv1, 1.f, 1.f);
    __syncthreads();  // every warp is done with this stage
    if (c + 2 < c1) load(c + 2);
    cp_async_commit();
  }
}

// dq2 | dk2 | dv2 (dq2 alone without kX) of each (image, head, meta row):
// the ranges' partials added in range order, rounded to T into dqkv2's
// thirds (dq).
template <typename T, bool kX>
__global__ void __launch_bounds__(256) k_dca_bwd_reduce(const DcaBwdTc a) {
  constexpr int K = DcaBwdTile<T, kX>::kPart;
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (size_t)a.batch * a.heads * a.m * K) return;
  const int ch = idx % K, j = (idx / K) % a.m;
  const int bh = idx / ((size_t)K * a.m);
  const int mp = cdiv(a.m, kMetaTile) * kMetaTile;
  const float* p = a.part + ((size_t)bh * a.ranges * mp + j) * K + ch;
  float s = 0.f;
  for (int r = 0; r < a.ranges; ++r) s += p[(size_t)r * mp * K];
  const int b = bh / a.heads, h = bh % a.heads;
  static_cast<T*>(a.dqkv2)[((size_t)b * a.m + j) * (kX ? 3 : 1) * a.C +
                           (ch / kHeadDim) * a.C + h * kHeadDim +
                           ch % kHeadDim] = from_f<T>(s);
}

// Both launches; a.chunks > 1 only with one meta tile (m <= 16), whose
// sums then stay in registers across the chunks.
template <typename T, bool kX = true>
int launch_dca_bwd_tc(DcaBwdTc a, cudaStream_t s) {
  using L = DcaBwdTile<T, kX>;
  static size_t attr = 0;
  const int mp = cdiv(a.m, kMetaTile) * kMetaTile;
  if (a.m < 1 || a.n < 1 || a.chunks < 1 ||
      (a.chunks > 1 && a.m > kMetaTile) ||
      a.ranges != cdiv(cdiv(a.n, L::kRows), a.chunks))
    return (int)cudaErrorInvalidValue;
  a.mc = kX ? mp : min(mp, kDcaMetaChunk);
  // with kX, an M whose rows do not fit fails here (cudaErrorInvalidValue)
  const size_t bytes = L::smem_bytes(a.mc);
  if (const int err = grant_smem(k_dca_bwd_tc<T, kX>, bytes, attr))
    return err;
  k_dca_bwd_tc<T, kX><<<dim3(a.batch * a.heads, a.ranges), L::kThreads,
                        bytes, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)a.batch * a.heads * a.m * L::kPart;
  k_dca_bwd_reduce<T, kX><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- rows

// Rows r0 and r0 + 8 of a warpgroup's accumulator: their partial sums s0,
// s1 reduced over the quad into red[0 .. 2 RB) as [column half][row] (one
// writer per row).
__device__ __forceinline__ void row_sums_to(float* red, int RB, int half,
                                            int r0, float s0, float s1) {
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  if ((threadIdx.x & 3) == 0) {
    red[half * RB + r0] = s0;
    red[half * RB + r0 + 8] = s1;
  }
}

// LayerNorm statistics (mean, rstd; two passes over registers, fp32) of
// rows [0, RB) of X (row pitch C <= 512; rows past `rows` read as zero), a
// warp per row of NW warps, each lane holding up to two 16-byte chunks of
// it (four in fp32). A warp issues the loads of G rows before it reduces
// any, so their latencies overlap.
template <typename T, int RB, int NW>
__device__ __forceinline__ void ln_stats(const T* X, int rows, int C,
                                         float eps, float* s_mean,
                                         float* s_rstd) {
  constexpr int V = 16 / sizeof(T), K = 512 / V / 32;  // chunks a lane
  constexpr int G = sizeof(T) == 2 ? 8 : 4;            // rows in flight
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cv = C / V;
  for (int r0 = warp; r0 < RB; r0 += NW * G) {
    uint4 raw[G][K];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int r = r0 + NW * j, ch = lane + 32 * i;
        raw[j][i] = r < rows && ch < cv
                        ? *reinterpret_cast<const uint4*>(X + (size_t)r * C +
                                                          V * ch)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float v[K][V];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        unpack<T>(raw[j][i], v[i]);
#pragma unroll
        for (int u = 0; u < V; ++u) s += v[i][u];
      }
      const int r = r0 + NW * j;
      const float mean = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (r < rows && lane + 32 * i < cv) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const float d = v[i][u] - mean;
            q += d * d;
          }
        }
      const float rstd = rsqrtf(warp_sum(q) / C + eps);
      if (lane == 0 && r < RB) {
        s_mean[r] = mean;
        s_rstd[r] = rstd;
      }
    }
  }
}

// The LayerNorm backward of a warpgroup's accumulator rows r0, r0 + 8
// (columns c0 + 8 j + 2 t, + 1 of the m64 x 2 NT tile, those below C; the
// warpgroup holds column half `half` of the CTA's RB rows): out = res +
// rstd (g - mean(g) - th mean(g th)), th = (x - mean) rstd, g = acc; rows
// past `rows` are not stored. red holds 4 RB floats; the barrier between
// the two passes is the whole block's.
template <int NT, typename T, typename TO>
__device__ __forceinline__ void ln_bwd_epilogue(
    const float (&acc)[4 * NT], const T* X, const T* res, TO* out, int rows,
    int C, int c0, int r0, const float* s_mean, const float* s_rstd,
    float* red, int RB, int half) {
  const int t = threadIdx.x & 3;
  const float mean[2] = {s_mean[r0], s_mean[r0 + 8]};
  const float rstd[2] = {s_rstd[r0], s_rstd[r0 + 8]};
  const auto th = [&](int h, int n) {
    const int r = r0 + 8 * h;
    const float2 v = r < rows ? ld2(X + (size_t)r * C + n)
                              : make_float2(0.f, 0.f);
    return make_float2((v.x - mean[h]) * rstd[h], (v.y - mean[h]) * rstd[h]);
  };
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = c0 + 8 * j + 2 * t;
    if (n < C) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = th(h, n);
        const float g0 = acc[4 * j + 2 * h], g1 = acc[4 * j + 2 * h + 1];
        s1[h] += g0 + g1;
        s2[h] += g0 * v.x + g1 * v.y;
      }
    }
  }
  row_sums_to(red, RB, half, r0, s1[0], s1[1]);
  row_sums_to(red + 2 * RB, RB, half, r0, s2[0], s2[1]);
  __syncthreads();
  float m1[2], m2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    m1[h] = (red[r] + red[RB + r]) / C;
    m2[h] = (red[2 * RB + r] + red[3 * RB + r]) / C;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = c0 + 8 * j + 2 * t;
    if (n < C) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= rows) continue;
        const float2 v = th(h, n);
        const float2 rr =
            res ? ld2(res + (size_t)r * C + n) : make_float2(0.f, 0.f);
        store2(out + (size_t)r * C + n,
               rr.x + rstd[h] * (acc[4 * j + 2 * h] - m1[h] - v.x * m2[h]),
               rr.y +
                   rstd[h] * (acc[4 * j + 2 * h + 1] - m1[h] - v.y * m2[h]));
      }
    }
  }
}

// One stream of k_rowmm_wg: A (rows, K) by TMA (maps.a), out (rows, C).
// kRowDo: out = dO in T and D[(b heads + h) n + i] = rowsum over head h of
// dO . o. kRowLn / kRowLnF32: out = res + LN'(x)^T (A W^T), in T / fp32;
// no residual where res is null (the C block's x, which passes the block).
struct RowMmSeg {
  void* out;
  const void* x;    // the LayerNorm's input rows (kRowLn*)
  const void* res;  // the residual gradient (kRowLn*), in T, or null
  const void* o;    // the attention output (kRowDo)
  float* D;         // (kRowDo)
  int rows;
  int n;  // tokens per image (kRowDo)
  int K;  // A's columns, W's depth (the C block's streams differ: 2C, C)
};

struct RowMmArgs {
  RowMmSeg seg[2];
  int row_blocks0;
  int C, heads;
  float eps;
};

struct RowMmMaps {
  CUtensorMap a[2];  // each stream's A, boxes of one sub-tile x 64 rows
  CUtensorMap w[2];  // each stream's W (C, K), boxes of one sub-tile x
                     // kBoxP rows (the C and D blocks' streams have their
                     // own)
};

enum { kRowDo = 0, kRowLn = 1, kRowLnF32 = 2 };

// Shared bytes a CTA of the row kernels may take: half an SM where two
// CTAs an SM fit the registers too (bf16 up to C = 192: at most 128
// registers a thread), else the whole of it.
template <typename T, int CP>
struct TwoPerSm {
  static constexpr int kBlocks = sizeof(T) == 2 && CP <= 192 ? 2 : 1;
  static constexpr size_t kBudget = kBlocks == 2 ? 115712 : 232448;
};

// The most stages (up to four) of kStage bytes that fit beside kFixed.
constexpr int ring_stages(size_t fixed, size_t stage, size_t budget) {
  return fixed + 4 * stage <= budget   ? 4
         : fixed + 3 * stage <= budget ? 3
         : fixed + 2 * stage <= budget ? 2
                                       : 1;
}

template <typename T, int CP>
struct RowMmWg {
  static constexpr int kRows = 64;
  static constexpr int kKS = kSub<T>;
  static constexpr int kN = CP / 2;  // a warpgroup's columns
  static constexpr int kBoxP = CP > 256 ? CP / 2 : CP;
  static constexpr int kTileA = kRows * 128;
  static constexpr int kStage = kTileA + CP * 128;  // A and W sub-tiles
  static constexpr int kCPA = (CP + kKS - 1) / kKS * kKS;
  static constexpr int kOut = kRows * kCPA * (int)sizeof(T);  // dO staging
  static constexpr int kRed = 6 * kRows * 4;  // row sums, mean, rstd
  static constexpr size_t kFixed = 1024 + kRed + 64;
  static constexpr int kStages =
      ring_stages(kFixed, kStage, TwoPerSm<T, CP>::kBudget);
  static constexpr size_t kSmem = kFixed + (size_t)kStages * kStage;
  static_assert(kStages >= 2 && kStages * kStage >= kOut && kN % 8 == 0 &&
                    kStage % 1024 == 0,
                "row-product tiers");
};

template <typename T, int CP, int kMode>
__global__ void __launch_bounds__(256, (TwoPerSm<T, CP>::kBlocks))
    k_rowmm_wg(const RowMmArgs a, const __grid_constant__ RowMmMaps maps) {
  using L = RowMmWg<T, CP>;
  constexpr int S = L::kStages, RB = L::kRows, NT = L::kN / 8, KS = L::kKS;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ unsigned char rm_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(rm_smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(ring + S * L::kStage);
  float* s_mean = red + 4 * RB;
  float* s_rstd = s_mean + RB;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_rstd + RB);  // [S]
  int rb = blockIdx.x, si = 0;
  if (rb >= a.row_blocks0) {
    rb -= a.row_blocks0;
    si = 1;
  }
  // by value from a constant index: a.seg[si] made ptxas copy the
  // parameter block to a 120-byte stack frame
  const RowMmSeg sg = si ? a.seg[1] : a.seg[0];
  const int C = a.C, row0 = rb * RB, rows = min(RB, sg.rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const int c0 = wg * L::kN;                     // the warpgroup's columns
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nk = cdiv(sg.K, KS);
  auto load = [&](int i) {  // thread 0: sub-tile i of A and W
    unsigned char* dst = ring + (i % S) * L::kStage;
    uint64_t* bar = full + i % S;
    mbar_expect_tx(bar, L::kStage);
    tma_2d(dst, &maps.a[si], i * KS, row0, bar);
#pragma unroll
    for (int r = 0; r < CP; r += L::kBoxP)
      tma_2d(dst + L::kTileA + r * 128, &maps.w[si], i * KS, r, bar);
  };
  if (tid == 0)
    for (int i = 0; i < S - 1 && i < nk; ++i) load(i);
  const T* X = static_cast<const T*>(sg.x) + (size_t)row0 * C;
  if constexpr (kMode != kRowDo)
    ln_stats<T, 64, 8>(X, rows, C, a.eps, s_mean, s_rstd);

  float acc[L::kN / 2];
#pragma unroll
  for (int i = 0; i < L::kN / 2; ++i) acc[i] = 0.f;
  // bf16: sub-tile i's products stay in flight across the barrier that
  // frees sub-tile i - 1's stage for sub-tile i + S - 1 (k_qkv_wg's order)
  __syncthreads();  // the statistics
  for (int i = 0; i < nk; ++i) {
    mbar_wait(full + i % S, (i / S) & 1);
    const unsigned char* st = ring + (i % S) * L::kStage;
    mma_fence<T>();
    sub_mma<T, L::kN>(acc, st, st + L::kTileA + c0 * 128);
    mma_commit<T>();
    mma_wait<T, 1>();
    __syncthreads();  // every warpgroup is done with sub-tile i - 1
    if (tid == 0 && i + S - 1 < nk) load(i + S - 1);
  }
  mma_wait<T, 0>();
  pin(acc);
  __syncthreads();  // the ring is free

  if constexpr (kMode == kRowDo) {
    // dO rounded to T through the ring (swizzled), out 16 bytes a thread;
    // then D per (row, head) from the rounded dO
    unsigned char* so = ring;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = c0 + 8 * j + 2 * t;
      if (n < C) {
        store2(reinterpret_cast<T*>(so + swz<T>(RB, r0, n)), acc[4 * j],
               acc[4 * j + 1]);
        store2(reinterpret_cast<T*>(so + swz<T>(RB, r0 + 8, n)),
               acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncthreads();
    T* out = static_cast<T*>(sg.out) + (size_t)row0 * C;
    const int cv = C / V;
    for (int e = tid; e < rows * cv; e += 256) {
      const int r = e / cv, k = (e % cv) * V;
      *reinterpret_cast<uint4*>(out + (size_t)r * C + k) =
          *reinterpret_cast<const uint4*>(so + swz<T>(RB, r, k));
    }
    const T* O = static_cast<const T*>(sg.o) + (size_t)row0 * C;
    for (int e = tid; e < rows * a.heads; e += 256) {
      const int r = e / a.heads, hh = e % a.heads;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kHeadDim; k += V) {
        float d[V], o[V];
        unpack<T>(*reinterpret_cast<const uint4*>(
                      so + swz<T>(RB, r, hh * kHeadDim + k)),
                  d);
        unpack<T>(*reinterpret_cast<const uint4*>(
                      O + (size_t)r * C + hh * kHeadDim + k),
                  o);
#pragma unroll
        for (int v = 0; v < V; ++v) s = fmaf(d[v], o[v], s);
      }
      const int grow = row0 + r, b = grow / sg.n;
      sg.D[((size_t)b * a.heads + hh) * sg.n + (grow - b * sg.n)] = s;
    }
  } else {
    using TO = typename std::conditional<kMode == kRowLnF32, float, T>::type;
    const T* res = sg.res ? static_cast<const T*>(sg.res) +
                                (size_t)row0 * C
                          : nullptr;
    ln_bwd_epilogue<NT>(acc, X, res,
                        static_cast<TO*>(sg.out) + (size_t)row0 * C, rows, C,
                        c0, r0, s_mean, s_rstd, red, RB, wg);
  }
}

// The A map of one stream, or of the other where it has no rows (TMA
// takes no empty matrix; no CTA then reads it).
template <typename T>
int row_maps(CUtensorMap (&m)[2], const void* const (&p)[2],
             const int (&rows)[2], const int (&cols)[2]) {
  for (int i = 0; i < 2; ++i)
    if (rows[i])
      if (const int err = tma_map<T>(&m[i], p[i], rows[i], cols[i], 64))
        return err;
  if (!rows[0]) m[0] = m[1];
  if (!rows[1]) m[1] = m[0];
  return 0;
}

template <typename T, int CP, int kMode>
int launch_rowmm_inst(const RowMmArgs& a, const void* const (&A)[2],
                      const void* const (&w)[2], cudaStream_t s) {
  using L = RowMmWg<T, CP>;
  static size_t attr = 0;
  if (const int err = grant_smem(k_rowmm_wg<T, CP, kMode>, L::kSmem, attr))
    return err;
  RowMmMaps maps;
  const int rows[2] = {a.seg[0].rows, a.seg[1].rows};
  const int cols[2] = {a.seg[0].K, a.seg[1].K};
  int err = row_maps<T>(maps.a, A, rows, cols);
  for (int i = 0; i < 2 && !err; ++i)
    err = tma_map<T>(&maps.w[i], w[i], a.C, cols[i], L::kBoxP);
  if (err) return err;
  const int blocks = a.row_blocks0 + cdiv(a.seg[1].rows, L::kRows);
  k_rowmm_wg<T, CP, kMode><<<blocks, 256, L::kSmem, s>>>(a, maps);
  return (int)cudaGetLastError();
}

// out = A W^T (+ its epilogue) for both streams in one launch; A (rows, K)
// and W (C, K) per stream, each stream its K.
template <typename T, int kMode>
int launch_rowmm(RowMmArgs a, const void* const (&A)[2],
                 const void* const (&w)[2], cudaStream_t s) {
  for (const RowMmSeg& sg : a.seg)
    if (sg.K < 8 || sg.K % 8) return (int)cudaErrorInvalidValue;
  a.row_blocks0 = cdiv(a.seg[0].rows, 64);
  return by_tier(a.C, [&](auto cp) {
    return launch_rowmm_inst<T, decltype(cp)::value, kMode>(a, A, w, s);
  });
}

// ---------------------------------------------------------------- MLP bwd

// GELU(v) and GELU'(v), exact-erf form, from one erff (gelu_erf and
// gelu_erf_grad each take one).
__device__ __forceinline__ void gelu_and_grad(float v, float& g, float& dg) {
  const float e = erff(v * 0.70710678118654752f);
  g = 0.5f * v * (1.f + e);
  dg = 0.5f * (1.f + e) + v * expf(-0.5f * v * v) * 0.39894228040143268f;
}

// One stream of k_mlp_bwd_wg: t1, dout in; dz = s2 dout by TMA (maps.dz);
// dt1 out, and mm = LN2(t1) (rows, C), gg = GELU(y), dy (rows, hidden) out
// for the weight gradients.
struct MlpTcSeg {
  const void* t1;
  const void* dout;
  void* dt1;
  void* mm;
  void* gg;
  void* dy;
  int rows;
};

struct MlpTcArgs {
  MlpTcSeg seg[2];
  int row_blocks0;
  const void* b1;  // (hidden,)
  int C, hidden;
  float eps;
};

struct MlpTcMaps {
  CUtensorMap w1;     // W1' (hidden, C), boxes of one sub-tile x 64 rows
  CUtensorMap w2t;    // W2^T (hidden, C), the same boxes
  CUtensorMap w1t;    // W1'^T (C, hidden), one sub-tile x kBoxP rows
  CUtensorMap dz[2];  // each stream's dz (rows, C), one sub-tile x 64 rows
};

// y / dgg tile depth: KS d sub-tiles, d the largest divisor of KA / KS
// whose sub-tiles of W1, dz and W2^T (sub3 bytes) take no more than a W1^T
// tile (CP x 128 bytes) or one sub3.
constexpr int mlp_y_depth(int CP, int KA, int KS, int sub3) {
  int best = 1;
  for (int d = 1; d <= KA / KS; ++d)
    if ((KA / KS) % d == 0 &&
        sub3 * d <= (CP * 128 > sub3 ? CP * 128 : sub3))
      best = d;
  return KS * best;
}

template <typename T, int CP>
struct MlpBwdWg {
  static constexpr int kRows = 64;
  static constexpr int kKS = kSub<T>;
  static constexpr int kN = CP / 2;     // a warpgroup's d(LN2) columns
  static constexpr int kHid = 64;       // hidden chunk width
  static constexpr int kHN = kHid / 2;  // a warpgroup's hidden columns
  static constexpr int kKA = (CP + kKS - 1) / kKS * kKS;
  static constexpr int kSub3 = 3 * kRows * 128;  // W1, dz, W2^T sub-tiles
  static constexpr int kYD = mlp_y_depth(CP, kKA, kKS, kSub3);
  static constexpr int kBoxP = CP > 256 ? CP / 2 : CP;
  static constexpr int kTileY = kSub3 * (kYD / kKS);
  static constexpr int kTileP = CP * 128;  // a W1^T sub-tile
  static constexpr int kStage = kTileP > kTileY ? kTileP : kTileY;
  static constexpr int kSA = kRows * kKA * (int)sizeof(T);   // LN2(t1)
  static constexpr int kSH = kRows * kHid * (int)sizeof(T);  // dy chunk
  static constexpr int kRed = 6 * kRows * 4;  // row sums, mean, rstd
  static constexpr size_t kFixed = 1024 + kSA + kSH + kRed + 64;
  static constexpr int kStages =
      ring_stages(kFixed, kStage, TwoPerSm<T, CP>::kBudget);
  static constexpr size_t kSmem = kFixed + (size_t)kStages * kStage;
  static_assert(kN % 8 == 0 && kStage % 1024 == 0 && kSA % 1024 == 0 &&
                    kSmem <= 232448,
                "MLP-backward tiers");
};

template <typename T, int CP>
__global__ void __launch_bounds__(256, (TwoPerSm<T, CP>::kBlocks))
    k_mlp_bwd_wg(const MlpTcArgs a, const __grid_constant__ MlpTcMaps maps) {
  using L = MlpBwdWg<T, CP>;
  constexpr int S = L::kStages, RB = L::kRows, NT = L::kN / 8, KS = L::kKS;
  constexpr int HID = L::kHid, NTH = L::kHN / 8, YS = L::kYD / KS;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ unsigned char mb_smem_raw[];
  unsigned char* sA = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(mb_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sH = sA + L::kSA;
  unsigned char* ring = sH + L::kSH;
  float* red = reinterpret_cast<float*>(ring + S * L::kStage);
  float* s_mean = red + 4 * RB;
  float* s_rstd = s_mean + RB;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_rstd + RB);  // [S]
  int rb = blockIdx.x, si = 0;
  if (rb >= a.row_blocks0) {
    rb -= a.row_blocks0;
    si = 1;
  }
  const MlpTcSeg sg = a.seg[si];
  const int C = a.C, hidden = a.hidden;
  const int row0 = rb * RB, rows = min(RB, sg.rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const int c0 = wg * L::kN;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // per 64-wide hidden chunk: ny y / dgg tiles (YS sub-tiles each of W1,
  // dz and W2^T), then nh W1^T tiles (one sub-tile of the chunk's hidden
  // columns each)
  const int ny = cdiv(C, L::kYD);
  constexpr int nh = HID / KS;
  const int chunks = cdiv(hidden, HID);
  const int per = ny + nh;
  const int total = chunks * per;
  auto load = [&](int i) {
    const int chunk = i / per, r = i % per, j0 = chunk * HID;
    unsigned char* dst = ring + (i % S) * L::kStage;
    uint64_t* bar = full + i % S;
    if (r < ny) {
      mbar_expect_tx(bar, L::kTileY);
#pragma unroll
      for (int s = 0; s < YS; ++s) {
        const int k = r * L::kYD + s * KS;
        unsigned char* d = dst + s * L::kSub3;
        tma_2d(d, &maps.w1, k, j0, bar);
        tma_2d(d + RB * 128, &maps.dz[si], k, row0, bar);
        tma_2d(d + 2 * RB * 128, &maps.w2t, k, j0, bar);
      }
    } else {
      mbar_expect_tx(bar, L::kTileP);
#pragma unroll
      for (int rr = 0; rr < CP; rr += L::kBoxP)
        tma_2d(dst + rr * 128, &maps.w1t, j0 + (r - ny) * KS, rr, bar);
    }
  };
  if (tid == 0)
    for (int i = 0; i < S - 1 && i < total; ++i) load(i);

  // LN2(t1) into sA (zero past C and past the stream's rows), rounded to
  // T, and out to mm; the statistics kept for the epilogue
  {
    const T* T1 = static_cast<const T*>(sg.t1) + (size_t)row0 * C;
    constexpr int cv = L::kKA / V;
    for (int e = tid; e < RB * cv; e += 256) {
      const int r = e / cv, k = (e % cv) * V;
      const bool ok = r < rows && k < C;
      cp_async16(sA + swz<T>(RB, r, k), ok ? T1 + (size_t)r * C + k : T1,
                 ok);
    }
    cp_async_commit();
    ln_stats<T, RB, 8>(T1, rows, C, a.eps, s_mean, s_rstd);
    cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < RB * (C / 2); e += 256) {
      const int r = e / (C / 2), k = 2 * (e % (C / 2));
      T* p = reinterpret_cast<T*>(sA + swz<T>(RB, r, k));
      const float2 v = ld2(p);
      const float m = s_mean[r], rs = s_rstd[r];
      store2(p, r < rows ? (v.x - m) * rs : 0.f,
             r < rows ? (v.y - m) * rs : 0.f);
    }
    __syncthreads();
    T* mm = static_cast<T*>(sg.mm) + (size_t)row0 * C;
    const int cw = C / V;
    for (int e = tid; e < rows * cw; e += 256) {
      const int r = e / cw, k = (e % cw) * V;
      *reinterpret_cast<uint4*>(mm + (size_t)r * C + k) =
          *reinterpret_cast<const uint4*>(sA + swz<T>(RB, r, k));
    }
  }

  float acc[L::kN / 2];  // d(LN2) columns c0 .. c0 + kN
  float hacc[L::kHN / 2], gacc[L::kHN / 2];  // y, dgg of the chunk
#pragma unroll
  for (int i = 0; i < L::kN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < L::kHN / 2; ++i) hacc[i] = gacc[i] = 0.f;
  const T* __restrict__ b1 = static_cast<const T*>(a.b1);
  T* __restrict__ dy_out = static_cast<T*>(sg.dy) + (size_t)row0 * hidden;
  T* __restrict__ gg_out = static_cast<T*>(sg.gg) + (size_t)row0 * hidden;

  for (int i = 0; i < total; ++i) {
    fence_async_smem();  // LN2(t1) and the dy chunk, written by the threads,
                         // for the tensor cores' reads
    __syncthreads();     // ... and every warpgroup is done with tile i - 1
    if (tid == 0 && i + S - 1 < total) load(i + S - 1);
    mbar_wait(full + i % S, (i / S) & 1);
    const int chunk = i / per, r = i % per, j0 = chunk * HID;
    const unsigned char* st = ring + (i % S) * L::kStage;
    mma_fence<T>();
    if (r < ny) {
#pragma unroll
      for (int s = 0; s < YS; ++s) {
        const unsigned char* d = st + s * L::kSub3;
        const int ks = (r * L::kYD) / KS + s;  // LN2(t1)'s sub-tile
        sub_mma<T, L::kHN>(hacc, sA + ks * RB * 128,
                           d + wg * L::kHN * 128);
        sub_mma<T, L::kHN>(gacc, d + RB * 128,
                           d + 2 * RB * 128 + wg * L::kHN * 128);
      }
    } else {
      sub_mma<T, L::kN>(acc, sH + (r - ny) * RB * 128, st + c0 * 128);
    }
    mma_commit<T>();
    mma_wait<T, 0>();
    pin(acc);
    pin(hacc);
    pin(gacc);
    if (r == ny - 1) {
      // dy = dgg GELU'(y), y = LN2(t1) W1c^T + b1c, rounded to T into sH
      // (zero past the hidden width) and out with GELU(y)
#pragma unroll
      for (int j = 0; j < NTH; ++j) {
        const int n = wg * L::kHN + 8 * j + 2 * t, gn = j0 + n;
        const bool ok = gn < hidden;
        const float2 b = ok ? ld2(b1 + gn) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r0 + 8 * h;
          float g0, g1, dg0, dg1;
          gelu_and_grad(hacc[4 * j + 2 * h] + b.x, g0, dg0);
          gelu_and_grad(hacc[4 * j + 2 * h + 1] + b.y, g1, dg1);
          const float d0 = ok ? gacc[4 * j + 2 * h] * dg0 : 0.f;
          const float d1 = ok ? gacc[4 * j + 2 * h + 1] * dg1 : 0.f;
          store2(reinterpret_cast<T*>(sH + swz<T>(RB, rr, n)), d0, d1);
          if (ok && rr < rows) {
            store2(dy_out + (size_t)rr * hidden + gn, d0, d1);
            store2(gg_out + (size_t)rr * hidden + gn, g0, g1);
          }
        }
        hacc[4 * j] = hacc[4 * j + 1] = hacc[4 * j + 2] = hacc[4 * j + 3] =
            0.f;
        gacc[4 * j] = gacc[4 * j + 1] = gacc[4 * j + 2] = gacc[4 * j + 3] =
            0.f;
      }
    }
  }
  // dt1 = dout + LN2'(t1)^T d(LN2), from the registers
  __syncthreads();  // red is free; every warpgroup is past its last tile
  ln_bwd_epilogue<NT>(acc, static_cast<const T*>(sg.t1) + (size_t)row0 * C,
                      static_cast<const T*>(sg.dout) + (size_t)row0 * C,
                      static_cast<T*>(sg.dt1) + (size_t)row0 * C, rows, C, c0,
                      r0, s_mean, s_rstd, red, RB, wg);
}

template <typename T, int CP>
int launch_mlp_bwd_inst(MlpTcArgs a, const void* const (&dz)[2],
                        const void* w1, const void* w2t, const void* w1t,
                        cudaStream_t s) {
  using L = MlpBwdWg<T, CP>;
  static size_t attr = 0;
  if (const int err = grant_smem(k_mlp_bwd_wg<T, CP>, L::kSmem, attr))
    return err;
  MlpTcMaps maps;
  const int rows[2] = {a.seg[0].rows, a.seg[1].rows}, cols[2] = {a.C, a.C};
  int err = row_maps<T>(maps.dz, dz, rows, cols);
  if (!err) err = tma_map<T>(&maps.w1, w1, a.hidden, a.C, 64);
  if (!err) err = tma_map<T>(&maps.w2t, w2t, a.hidden, a.C, 64);
  if (!err) err = tma_map<T>(&maps.w1t, w1t, a.C, a.hidden, L::kBoxP);
  if (err) return err;
  a.row_blocks0 = cdiv(rows[0], L::kRows);
  const int blocks = a.row_blocks0 + cdiv(rows[1], L::kRows);
  k_mlp_bwd_wg<T, CP><<<blocks, 256, L::kSmem, s>>>(a, maps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mlp_bwd_tc(const MlpTcArgs& a, const void* const (&dz)[2],
                      const void* w1, const void* w2t, const void* w1t,
                      cudaStream_t s) {
  if (a.hidden % 32 || a.hidden < 32) return (int)cudaErrorInvalidValue;
  return by_tier(a.C, [&](auto cp) {
    return launch_mlp_bwd_inst<T, decltype(cp)::value>(a, dz, w1, w2t, w1t,
                                                       s);
  });
}

// ---------------------------------------------------------------- wgrad

// One weight gradient dW (O, I) = sum over both streams' rows of G^T A
// (torch Linear layout), and db (O,) = the column sums of G where db is
// set.
struct WgTcProd {
  const void* g[2];  // each stream's G (rows, O)
  const void* a[2];  // each stream's A (rows, I)
  int O, I;
  float* part;       // (splits, O, I) fp32 partial sums
  float* part_bias;  // (splits, O), where db is set
  void* dw;
  void* db;
};

struct WgTcArgs {
  WgTcProd prod[2];
  int nprod;
  int rows[2];
  int splits0, splits;  // row ranges of stream 0; of both streams
  int rows_per_split;   // a multiple of kWtK
  int ctas0;            // CTAs of product 0
};

constexpr int kWtM = 128, kWtN = 128;  // a CTA's tile of dW (o, i)
constexpr int kWtK = 64;               // rows of one ring stage
constexpr int kWtStages = 3;

template <typename T>
struct WgTc {
  // 16 bytes of padding a row: the eight rows an ldmatrix reads fall in
  // distinct banks
  static constexpr int kPitch = kWtM + 16 / (int)sizeof(T);
  static constexpr int kTile = kWtK * kPitch;  // elements of one operand
  static constexpr int kSmem = kWtStages * 2 * kTile * (int)sizeof(T);
};

// One kWtK-row stage: acc[mt][nt] (o rows wm 64 + 16 mt + g, + 8; i columns
// wn 32 + 8 nt + 2 t, + 1) += G^T A. bf16: both operands are K-major in
// shared memory ([row][o], [row][i]), so ldmatrix.trans gives mma.sync's
// row-major A and column-major B fragments directly.
__device__ __forceinline__ void wgrad_step(float (&acc)[4][4][4],
                                           const __nv_bfloat16* sg,
                                           const __nv_bfloat16* sa, int wm,
                                           int wn) {
  constexpr int P = WgTc<__nv_bfloat16>::kPitch;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kWtK / 16; ++ks) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldsm_x4_t(af[mt], sg + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            wm * 64 + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];  // i columns 16 np .. + 7, then + 8 .. + 15
      ldsm_x4_t(b, sa + (ks * 16 + (lane & 15)) * P + wn * 32 + np * 16 +
                       (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void wgrad_step(float (&acc)[4][4][4],
                                           const float* sg, const float* sa,
                                           int wm, int wn) {
  constexpr int P = WgTc<float>::kPitch;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < kWtK; ++k) {
    const float* gk = sg + k * P + wm * 64 + g;
    const float* ak = sa + k * P + wn * 32 + 2 * t;
    float2 av[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      av[nt] = *reinterpret_cast<const float2*>(ak + 8 * nt);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float g0 = gk[16 * mt], g1 = gk[16 * mt + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] = fmaf(g0, av[nt].x, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(g0, av[nt].y, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(g1, av[nt].x, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(g1, av[nt].y, acc[mt][nt][3]);
      }
    }
  }
}

// CTA (product p, tile, row range): tile-major within a row range, so the
// CTAs that read one range's rows run side by side. Warp w takes o rows
// (w & 1) 64 .. + 63 and i columns (w >> 1) 32 .. + 31 of the tile.
template <typename T>
__global__ void __launch_bounds__(256) k_wgrad_tc(const WgTcArgs a) {
  using L = WgTc<T>;
  constexpr int P = L::kPitch, V = 16 / sizeof(T), CPR = kWtM / V;
  extern __shared__ __align__(16) unsigned char wt_smem[];
  T* ring = reinterpret_cast<T*>(wt_smem);
  int cta = blockIdx.x, pi = 0;
  if (cta >= a.ctas0) {
    cta -= a.ctas0;
    pi = 1;
  }
  const WgTcProd pr = a.prod[pi];
  const int tiles_i = cdiv(pr.I, kWtN);
  const int tiles = cdiv(pr.O, kWtM) * tiles_i;
  const int tile = cta % tiles, split = cta / tiles;
  const int o0 = (tile / tiles_i) * kWtM, i0 = (tile % tiles_i) * kWtN;
  int sp = split, si = 0;
  if (sp >= a.splits0) {
    sp -= a.splits0;
    si = 1;
  }
  const int r0 = sp * a.rows_per_split;
  const int r1 = min(a.rows[si], r0 + a.rows_per_split);
  const T* __restrict__ G = static_cast<const T*>(pr.g[si]);
  const T* __restrict__ A = static_cast<const T*>(pr.a[si]);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int steps = cdiv(r1 - r0, kWtK);
  auto load = [&](int s) {  // rows past r1 and columns past O / I: zero
    T* sg = ring + (s % kWtStages) * 2 * L::kTile;
    T* sa = sg + L::kTile;
    const int k0 = r0 + s * kWtK;
    for (int e = tid; e < kWtK * CPR; e += 256) {
      const int k = e / CPR, c = (e % CPR) * V;
      const bool kr = k0 + k < r1;
      const bool og = kr && o0 + c < pr.O, ia = kr && i0 + c < pr.I;
      cp_async16(sg + k * P + c,
                 og ? G + (size_t)(k0 + k) * pr.O + o0 + c : G, og);
      cp_async16(sa + k * P + c,
                 ia ? A + (size_t)(k0 + k) * pr.I + i0 + c : A, ia);
    }
  };
#pragma unroll
  for (int s = 0; s < kWtStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  // the bias: column o0 + tid of G summed by the tile's first column block
  const bool bias = pr.part_bias && i0 == 0 && tid < kWtM;
  float bsum = 0.f;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWtStages - 2>();  // stage s landed for this thread ...
    __syncthreads();  // ... for every thread; stage s - 1 is free
    if (s + kWtStages - 1 < steps) load(s + kWtStages - 1);
    cp_async_commit();
    const T* sg = ring + (s % kWtStages) * 2 * L::kTile;
    wgrad_step(acc, sg, sg + L::kTile, wm, wn);
    if (bias) {
#pragma unroll 8
      for (int k = 0; k < kWtK; ++k) bsum += to_f(sg[k * P + tid]);
    }
  }
  float* part = pr.part + (size_t)split * pr.O * pr.I;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int o = o0 + wm * 64 + mt * 16 + g;
      const int i = i0 + wn * 32 + nt * 8 + 2 * t;
      if (i >= pr.I) continue;
      if (o < pr.O)
        *reinterpret_cast<float2*>(part + (size_t)o * pr.I + i) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (o + 8 < pr.O)
        *reinterpret_cast<float2*>(part + (size_t)(o + 8) * pr.I + i) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  if (bias && o0 + tid < pr.O)
    pr.part_bias[(size_t)split * pr.O + o0 + tid] = bsum;
}

// dW and db of each product: the row ranges' partials summed in order,
// four weight elements a thread, then one bias element a thread.
template <typename T>
__global__ void __launch_bounds__(256) k_wgrad_tc_reduce(const WgTcArgs a) {
  size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  for (int p = 0; p < a.nprod; ++p) {
    const WgTcProd& pr = a.prod[p];
    const size_t n = (size_t)pr.O * pr.I;
    if (idx < n / 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < a.splits; ++k) {
        const float4 v =
            reinterpret_cast<const float4*>(pr.part + (size_t)k * n)[idx];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      T* dw = static_cast<T*>(pr.dw) + 4 * idx;
      store2(dw, s.x, s.y);
      store2(dw + 2, s.z, s.w);
      return;
    }
    idx -= n / 4;
    const size_t nb = pr.db ? pr.O : 0;
    if (idx < nb) {
      float s = 0.f;
      for (int k = 0; k < a.splits; ++k)
        s += pr.part_bias[(size_t)k * pr.O + idx];
      static_cast<T*>(pr.db)[idx] = from_f<T>(s);
      return;
    }
    idx -= nb;
  }
}

// Both products in one launch and their reduce in a second; splits and
// ctas0 are set here from the rows and a.rows_per_split.
template <typename T>
int launch_wgrad_tc(WgTcArgs a, cudaStream_t s) {
  static size_t attr = 0;
  if (a.rows_per_split % kWtK) return (int)cudaErrorInvalidValue;
  if (const int err = grant_smem(k_wgrad_tc<T>, WgTc<T>::kSmem, attr))
    return err;
  a.splits0 = cdiv(a.rows[0], a.rows_per_split);
  a.splits = a.splits0 + cdiv(a.rows[1], a.rows_per_split);
  int ctas[2] = {0, 0};
  size_t total = 0;
  for (int p = 0; p < a.nprod; ++p) {
    const WgTcProd& pr = a.prod[p];
    if (pr.O % 8 || pr.I % 8) return (int)cudaErrorInvalidValue;
    ctas[p] = cdiv(pr.O, kWtM) * cdiv(pr.I, kWtN) * a.splits;
    total += (size_t)pr.O * pr.I / 4 + (pr.db ? pr.O : 0);
  }
  a.ctas0 = ctas[0];
  k_wgrad_tc<T><<<ctas[0] + ctas[1], 256, WgTc<T>::kSmem, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  k_wgrad_tc_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lm
