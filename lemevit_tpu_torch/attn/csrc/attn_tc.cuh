// Attention tiles on Hopper's tensor cores, fed by asynchronous copies
// (mhsa.cu, dca_attn.cu, the S and D block kernels; train_tc.cuh's
// attention backwards use its fragments).
//
// Every product here is made of a warp's 16-row m tiles: S = A B^T over
// 32 head channels (qk_tiles) and O += P V over 16-key steps (pv_tiles),
// with the fp32 sums in the m16n8 accumulator layout of mma.sync: lane =
// 4 g + t holds rows g and g + 8, columns 2 t and 2 t + 1 of each 8-column
// tile.
// The softmax runs on those registers: a row's maximum and sum take two
// shuffles within the lane's quad. Exponentials are the SFU's ex2
// (exp2_sfu) with scale * log2(e) folded into one FMA; P is rounded to the
// input type before P V, as the TPU kernels round it (pallas_mhsa.py:52,
// pallas_dca.py:68, :83).
//
// bf16: operands come from shared memory through ldmatrix (V through
// ldmatrix.trans) into mma.sync.m16n8k16 with fp32 accumulation. fp32: the
// same functions compute each lane's accumulator elements with FMAs from
// shared memory, so both types share one tiling, one softmax and one
// order of sums (TF32 would miss the fp32 checks' 1e-4).
//
// Rows reach shared memory by 16-byte cp.async copies (cp_async16,
// copy_rows), a head row of 32 channels in 4 (bf16) or 8 (fp32) copies,
// with a pitch of 32 + 16 / sizeof(T) elements, so the eight rows an
// ldmatrix reads fall in distinct banks. Rows past the valid count are
// zero-filled and their scores masked.
//
// Tiles over AttnArgs (block_common.cuh):
//   mhsa_rows_tile   128 (bf16) or 64 (fp32) queries of one (image, head)
//                    against all keys, a two-stage ring of 64-key K / V
//                    tiles, online softmax in 32-key steps
//                    (FlashAttention-2 order: one division at the end);
//   mhsa_small_tile  four (image, head) pairs of at most 16 tokens, one
//                    per warp.
// DCA (DcaArgs): dca_rows_tile takes 128 (bf16) or 64 (fp32) image rows of
// one image through every head, both directions, the meta tokens in tiles
// of 16, one head's slices in flight while the previous head computes;
// k_dca_merge merges the c direction's per-tile partials in a fixed
// order. Its instances: both directions (dca_attn.cu, dca_block.cu); both
// with each row's log-sum-exp (kLse, the D training forward, dca_train.cu);
// the c direction alone (kX false, the C block, c_block.cu, and its
// training forward, c_train.cu, where k_dca_merge's kLse instance writes
// the meta rows' log-sum-exp), whose CTAs also split the meta rows into
// chunks of DcaArgs::mc.
#pragma once

#include "block_common.cuh"

namespace lm {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- copies

// One 16-byte global -> shared copy in flight (cp.async, cached in L2
// only). With valid false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct TcRows {
  static constexpr int kVec = 16 / sizeof(T);     // elements per copy
  static constexpr int kVecs = kHeadDim / kVec;   // copies per head row
  static constexpr int kPitch = kHeadDim + kVec;  // shared row pitch
};

// Copy `rows` head rows (32 channels) of src, rows ld elements apart, into
// dst (pitch kPitch); rows at or past `valid` are zero-filled. Threads
// tid, tid + nthr, ... of the caller's group issue the copies.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int ld,
                                          int rows, int valid, int tid,
                                          int nthr) {
  using R = TcRows<T>;
  for (int e = tid; e < rows * R::kVecs; e += nthr) {
    const int r = e / R::kVecs, c = (e % R::kVecs) * R::kVec;
    const bool ok = r < valid;
    cp_async16(dst + r * R::kPitch + c, ok ? src + (size_t)r * ld + c : src,
               ok);
  }
}

// ---------------------------------------------------------------- fragments

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx.ftz: relative error ~2^-22, -inf -> +0).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A operand of qk_tiles, 16 rows of 32 channels in shared memory: in
// bf16 its two k16 fragments, loaded once into registers; in fp32 the rows
// themselves, read by each product.
template <typename T>
struct ARows;

template <>
struct ARows<__nv_bfloat16> {
  uint32_t a[2][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* s) {
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* p = s + (lane & 15) * TcRows<__nv_bfloat16>::kPitch +
                             (lane >> 4) * 8;
    ldsm_x4(a[0], p);
    ldsm_x4(a[1], p + 16);
  }
};

template <>
struct ARows<float> {
  const float* p;
  __device__ __forceinline__ void load(const float* s) { p = s; }
};

// s[i][j] = A[i] B^T for the MT m tiles of A and the 8 rows 8 j .. 8 j + 7
// of sB (NT * 8 rows of 32 channels in shared memory), fp32, in the
// accumulator layout. In bf16 each B fragment is loaded once (ldmatrix)
// for all MT m tiles, whose products then interleave.
template <int MT, int NT>
__device__ __forceinline__ void qk_tiles(float (&s)[MT][NT][4],
                                         const ARows<__nv_bfloat16> (&A)[MT],
                                         const __nv_bfloat16* sB) {
  constexpr int P = TcRows<__nv_bfloat16>::kPitch;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t b[4];  // channels 0-7, 8-15 (k step 0), 16-23, 24-31 (step 1)
    ldsm_x4(b, sB + (j * 8 + (lane & 7)) * P + (lane >> 3) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
      mma_bf16(s[i][j], A[i].a[0], b[0], b[1]);
      mma_bf16(s[i][j], A[i].a[1], b[2], b[3]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void qk_tiles(float (&s)[MT][NT][4],
                                         const ARows<float> (&A)[MT],
                                         const float* sB) {
  constexpr int P = TcRows<float>::kPitch;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float4* a0 = reinterpret_cast<const float4*>(A[i].p + g * P);
    const float4* a1 = reinterpret_cast<const float4*>(A[i].p + (g + 8) * P);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4* b =
            reinterpret_cast<const float4*>(sB + (j * 8 + 2 * t + c) * P);
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int k = 0; k < kHeadDim / 4; ++k) {
          const float4 bv = b[k], u = a0[k], w = a1[k];
          x0 = fmaf(u.x, bv.x, x0);
          x0 = fmaf(u.y, bv.y, x0);
          x0 = fmaf(u.z, bv.z, x0);
          x0 = fmaf(u.w, bv.w, x0);
          x1 = fmaf(w.x, bv.x, x1);
          x1 = fmaf(w.y, bv.y, x1);
          x1 = fmaf(w.z, bv.z, x1);
          x1 = fmaf(w.w, bv.w, x1);
        }
        s[i][j][c] = x0;
        s[i][j][2 + c] = x1;
      }
    }
  }
}

// One m tile: s = A B^T.
template <int NT, typename T>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const ARows<T>& A,
                                        const T* sB) {
  qk_tiles<1, NT>(reinterpret_cast<float(&)[1][NT][4]>(s),
                  reinterpret_cast<const ARows<T>(&)[1]>(A), sB);
}

// o[i][d] += P[i] V for the MT m tiles: P[i] (16 rows x 16 KS keys) in the
// accumulator layout of qk_tiles (p[i][2 k] and p[i][2 k + 1] hold keys
// 16 k .. 16 k + 15), rounded to bf16 as the A operand; V (16 KS rows of 32
// channels) in shared memory, through ldmatrix.trans, each fragment loaded
// once for all m tiles. o[i][d] holds channels 8 d .. 8 d + 7.
template <int MT, int KS>
__device__ __forceinline__ void pv_tiles(float (&o)[MT][4][4],
                                         const float (&p)[MT][2 * KS][4],
                                         const __nv_bfloat16* sV) {
  constexpr int P = TcRows<__nv_bfloat16>::kPitch;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      a[i][0] = pack_bf16(p[i][2 * k][0], p[i][2 * k][1]);
      a[i][1] = pack_bf16(p[i][2 * k][2], p[i][2 * k][3]);
      a[i][2] = pack_bf16(p[i][2 * k + 1][0], p[i][2 * k + 1][1]);
      a[i][3] = pack_bf16(p[i][2 * k + 1][2], p[i][2 * k + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];  // keys 0-7 / 8-15 of channels 16 dp .. +7, then +8
      ldsm_x4_t(b, sV + (k * 16 + (lane & 15)) * P + dp * 16 +
                       (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(o[i][2 * dp], a[i], b[0], b[1]);
        mma_bf16(o[i][2 * dp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

template <int MT, int KS>
__device__ __forceinline__ void pv_tiles(float (&o)[MT][4][4],
                                         const float (&p)[MT][2 * KS][4],
                                         const float* sV) {
  constexpr int P = TcRows<float>::kPitch;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // key 16 k + j of rows g and g + 8 sits with lane 4 g + (j & 7) / 2
        const int src = (lane & ~3) | ((j & 7) >> 1);
        const float pg =
            __shfl_sync(0xffffffffu, p[i][2 * k + (j >> 3)][j & 1], src);
        const float ph = __shfl_sync(
            0xffffffffu, p[i][2 * k + (j >> 3)][2 + (j & 1)], src);
        const float* v = sV + (k * 16 + j) * P + 2 * t;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float2 vv = *reinterpret_cast<const float2*>(v + 8 * d);
          o[i][d][0] = fmaf(pg, vv.x, o[i][d][0]);
          o[i][d][1] = fmaf(pg, vv.y, o[i][d][1]);
          o[i][d][2] = fmaf(ph, vv.x, o[i][d][2]);
          o[i][d][3] = fmaf(ph, vv.y, o[i][d][3]);
        }
      }
    }
  }
}

// One m tile: o += P V.
template <int KS, typename T>
__device__ __forceinline__ void pv_tile(float (&o)[4][4],
                                        const float (&p)[2 * KS][4],
                                        const T* sV) {
  pv_tiles<1, KS>(reinterpret_cast<float(&)[1][4][4]>(o),
                  reinterpret_cast<const float(&)[1][2 * KS][4]>(p), sV);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// A warp's 16 x 32 output o / (l0 for row g, l1 for row g + 8) in the
// input type, staged through its shared rows s (pitch kPitch), then out
// with 16-byte stores to rows [0, valid) of dst (rows ld apart).
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, int ld, int valid, T* s,
                                           const float (&o)[4][4], float l0,
                                           float l1) {
  using R = TcRows<T>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's reads of s are done
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    store2(s + g * R::kPitch + 8 * d + 2 * t, o[d][0] / l0, o[d][1] / l0);
    store2(s + (g + 8) * R::kPitch + 8 * d + 2 * t, o[d][2] / l1,
           o[d][3] / l1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * R::kVecs; e += 32) {
    const int r = e / R::kVecs, c = (e % R::kVecs) * R::kVec;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
          *reinterpret_cast<const uint4*>(s + r * R::kPitch + c);
  }
}

// ---------------------------------------------------------------- MHSA

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcK = 64;     // keys per shared K / V tile
constexpr int kTcStep = 32;  // keys per online-softmax step
constexpr int kTcSmall = 16;  // N at or below which a warp takes a whole
                              // (image, head)

// m tiles of 16 queries per warp: two in bf16 (their products interleave
// and share each K / V fragment), one in fp32 (whose rows take twice the
// shared memory).
template <typename T>
struct MhsaTile {
  static constexpr int kMT = sizeof(T) == 2 ? 2 : 1;
  static constexpr int kQ = kTcWarps * 16 * kMT;  // queries per CTA
  static constexpr int kSmemBytes =
      (kQ + 4 * kTcK) * TcRows<T>::kPitch * (int)sizeof(T);
};

// One warp's online softmax over its rows g and g + 8: running maxima of
// the raw scores and the lane's partial sums (reduced over the quad at the
// end); the unnormalised output is kept beside it.
struct Online {
  float m[2], l[2];
  __device__ __forceinline__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

__device__ __forceinline__ void zero(float (&o)[4][4]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
}

// Fold the scores s of keys 0 .. 8 NT - 1 of a tile (with kMask, keys at
// or past `valid` masked) into st: the new maxima, P = 2^(s sl2 - m sl2)
// in place of s (sl2 = scale * log2(e)), the sums; al[r] is the factor of
// row r's earlier sums (0 at the first tile).
template <int NT, bool kMask>
__device__ __forceinline__ void online_step(Online& st, float (&s)[NT][4],
                                            int valid, float sl2,
                                            float (&al)[2]) {
  const int t = threadIdx.x & 3;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (kMask) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (8 * j + 2 * t + c >= valid) s[j][c] = s[j][2 + c] = -INFINITY;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  // valid >= 1, so both maxima are finite
  const float m0 = fmaxf(st.m[0], quad_max(mx0));
  const float m1 = fmaxf(st.m[1], quad_max(mx1));
  al[0] = exp2_sfu((st.m[0] - m0) * sl2);
  al[1] = exp2_sfu((st.m[1] - m1) * sl2);
  const float b0 = -m0 * sl2, b1 = -m1 * sl2;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = exp2_sfu(fmaf(s[j][0], sl2, b0));
    s[j][1] = exp2_sfu(fmaf(s[j][1], sl2, b0));
    s[j][2] = exp2_sfu(fmaf(s[j][2], sl2, b1));
    s[j][3] = exp2_sfu(fmaf(s[j][3], sl2, b1));
    r0 += s[j][0] + s[j][1];
    r1 += s[j][2] + s[j][3];
  }
  st.l[0] = fmaf(st.l[0], al[0], r0);
  st.l[1] = fmaf(st.l[1], al[1], r1);
  st.m[0] = m0;
  st.m[1] = m1;
}

// online_step, then the output o rescaled. P V follows (pv_tiles).
template <int NT, bool kMask>
__device__ __forceinline__ void softmax_step(Online& st, float (&o)[4][4],
                                             float (&s)[NT][4], int valid,
                                             float sl2) {
  float al[2];
  online_step<NT, kMask>(st, s, valid, sl2, al);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    o[d][0] *= al[0];
    o[d][1] *= al[0];
    o[d][2] *= al[1];
    o[d][3] *= al[1];
  }
}

// A warp's MT m tiles of 16 queries against the 8 NT keys of a shared
// K / V tile (with kMask, keys at or past `valid` masked): S = Q K^T, the
// online softmax, P V.
template <int MT, int NT, bool kMask, typename T>
__device__ __forceinline__ void attend_tiles(Online (&st)[MT],
                                             float (&o)[MT][4][4],
                                             const ARows<T> (&A)[MT],
                                             const T* sK, const T* sV,
                                             int valid, float sl2) {
  float s[MT][NT][4];
  qk_tiles<MT, NT>(s, A, sK);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    softmax_step<NT, kMask>(st[i], o[i], s[i], valid, sl2);
  pv_tiles<MT, NT / 2>(o, s, sV);
}

// kLse (the training forward's instance): rows g and g + 8 of a warp's
// m tile, whose online softmax ended at raw maxima m0 / m1 and sums l0 /
// l1 (of 2^((s - m) scale log2(e)) = e^((s - m) scale)), get their
// log-sum-exp in natural-log units, m scale + ln(l), at a.lse[bh nq + q]
// (train_tc.cuh's attention backward multiplies it by log2(e)); queries
// at or past nq are not written.
template <bool kLse>
__device__ __forceinline__ void store_lse(const AttnArgs& a, int bh, int q,
                                          const Online& st, float l0,
                                          float l1) {
  if constexpr (kLse) {
    if ((threadIdx.x & 3) == 0) {
      q += (threadIdx.x & 31) >> 2;
      float* L = a.lse + (size_t)bh * a.nq;
      if (q < a.nq) L[q] = fmaf(st.m[0], a.scale, logf(l0));
      if (q + 8 < a.nq) L[q + 8] = fmaf(st.m[1], a.scale, logf(l1));
    }
  }
}

// The barrier of one tile's kTcThreads threads: the CTA's (__syncthreads),
// or with kWg, warpgroup threadIdx.x / 128's own (named barrier 1 + that
// index), so that each warpgroup of a larger CTA runs a tile of its own
// (s_stage.cu).
template <bool kWg>
__device__ __forceinline__ void tile_sync() {
  if constexpr (kWg)
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (threadIdx.x >> 7)),
                 "n"(kTcThreads)
                 : "memory");
  else
    __syncthreads();
}

// Queries q0 .. q0 + MhsaTile<T>::kQ - 1 of (image, head) bh against all
// a.nk keys; smem holds MhsaTile<T>::kSmemBytes. Warp w owns kMT m tiles
// of 16 queries. Q is copied once; 64-key K / V tiles stream through a
// two-stage ring, tile kt + 2 in flight while tile kt computes, in online
// softmax steps of 32 keys (half the score registers of a 64-key step). A
// warp past the last query only copies and waits; a ragged last step
// computes 16 keys where those hold the rest. kLse also writes each
// query's log-sum-exp (store_lse). kWg: run by one warpgroup of a larger
// CTA (tile_sync), its threads numbered within the warpgroup.
template <typename T, bool kLse = false, bool kWg = false>
__device__ __forceinline__ void mhsa_rows_tile(const AttnArgs& a, int bh,
                                               int q0, T* smem) {
  constexpr int P = TcRows<T>::kPitch, MT = MhsaTile<T>::kMT;
  constexpr int QR = MhsaTile<T>::kQ;
  T* sQ = smem;
  T* sK = sQ + QR * P;
  T* sV = sK + 2 * kTcK * P;
  const int tid = kWg ? threadIdx.x & (kTcThreads - 1) : threadIdx.x;
  const int warp = tid >> 5;
  const int b = bh / a.heads, h = bh % a.heads;
  const T* Q = static_cast<const T*>(a.q) +
               ((size_t)b * a.nq + q0) * a.ldq + h * kHeadDim;
  const T* K = static_cast<const T*>(a.k) + (size_t)b * a.nk * a.ldkv +
               h * kHeadDim;
  const T* V = static_cast<const T*>(a.v) + (size_t)b * a.nk * a.ldkv +
               h * kHeadDim;
  const float sl2 = a.scale * kLog2e;
  const int tiles = cdiv(a.nk, kTcK);
  auto load_kv = [&](int kt) {
    const int k0 = kt * kTcK, st = (kt & 1) * kTcK * P;
    copy_rows(sK + st, K + (size_t)k0 * a.ldkv, a.ldkv, kTcK, a.nk - k0, tid,
              kTcThreads);
    copy_rows(sV + st, V + (size_t)k0 * a.ldkv, a.ldkv, kTcK, a.nk - k0, tid,
              kTcThreads);
  };
  copy_rows(sQ, Q, a.ldq, QR, a.nq - q0, tid, kTcThreads);
  load_kv(0);
  cp_async_commit();
  if (tiles > 1) load_kv(1);
  cp_async_commit();

  const int row0 = warp * 16 * MT;  // the warp's first query in the tile
  const bool busy = q0 + row0 < a.nq;
  ARows<T> A[MT];
  Online st[MT];
  float o[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    st[i].init();
    zero(o[i]);
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<1>();  // tile kt (and Q) landed for this thread ...
    tile_sync<kWg>();    // ... and for every thread
    if (busy) {
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) A[i].load(sQ + (row0 + 16 * i) * P);
      }
      const T* k = sK + (kt & 1) * kTcK * P;
      const T* v = sV + (kt & 1) * kTcK * P;
      const int valid = a.nk - kt * kTcK;
#pragma unroll
      for (int k0 = 0; k0 < kTcK; k0 += kTcStep) {
        const int vs = valid - k0;
        if (vs <= 0) break;
        if (vs >= kTcStep)
          attend_tiles<MT, kTcStep / 8, false>(st, o, A, k + k0 * P,
                                               v + k0 * P, vs, sl2);
        else if (vs > 16)
          attend_tiles<MT, kTcStep / 8, true>(st, o, A, k + k0 * P,
                                              v + k0 * P, vs, sl2);
        else
          attend_tiles<MT, 2, true>(st, o, A, k + k0 * P, v + k0 * P, vs,
                                    sl2);
      }
    }
    tile_sync<kWg>();  // every warp is done with this stage
    if (kt + 2 < tiles) load_kv(kt + 2);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = row0 + 16 * i;  // m tile i's first row in the tile
    const float l0 = quad_sum(st[i].l[0]), l1 = quad_sum(st[i].l[1]);
    T* out = static_cast<T*>(a.out) +
             ((size_t)b * a.nq + q0 + r) * a.ldo + h * kHeadDim;
    store_tile(out, a.ldo, a.nq - q0 - r, sQ + r * P, o[i], l0, l1);
    store_lse<kLse>(a, bh, q0 + r, st[i], l0, l1);
  }
}

// Warp w takes (image, head) bh0 + w whole: its nq <= 16 queries against
// its nk <= 16 keys (N = 16 is the meta-token stream); smem holds 48 rows
// a warp of the CTA (4 in k_mhsa_tc_small, 8 in s_stage.cu). kLse as
// mhsa_rows_tile's.
template <typename T, bool kLse = false>
__device__ __forceinline__ void mhsa_small_tile(const AttnArgs& a, int bh0,
                                                T* smem) {
  constexpr int P = TcRows<T>::kPitch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sQ = smem + warp * 48 * P;
  T* sK = sQ + 16 * P;
  T* sV = sK + 16 * P;
  const int bh = bh0 + warp;
  const bool live = bh < a.batch * a.heads;
  const int b = live ? bh / a.heads : 0, h = live ? bh % a.heads : 0;
  const size_t kv = (size_t)b * a.nk * a.ldkv + h * kHeadDim;
  copy_rows(sQ, static_cast<const T*>(a.q) + (size_t)b * a.nq * a.ldq +
                    h * kHeadDim,
            a.ldq, 16, live ? a.nq : 0, lane, 32);
  copy_rows(sK, static_cast<const T*>(a.k) + kv, a.ldkv, 16,
            live ? a.nk : 0, lane, 32);
  copy_rows(sV, static_cast<const T*>(a.v) + kv, a.ldkv, 16,
            live ? a.nk : 0, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  ARows<T> A[1];
  A[0].load(sQ);
  Online st[1];
  st[0].init();
  float o[1][4][4];
  zero(o[0]);
  attend_tiles<1, 2, true>(st, o, A, sK, sV, a.nk, a.scale * kLog2e);
  const float l0 = quad_sum(st[0].l[0]), l1 = quad_sum(st[0].l[1]);
  T* out = static_cast<T*>(a.out) + (size_t)b * a.nq * a.ldo + h * kHeadDim;
  store_tile(out, a.ldo, live ? a.nq : 0, sQ, o[0], l0, l1);
  if (live) store_lse<kLse>(a, bh, 0, st[0], l0, l1);
}

// The explicit minimum of one CTA an SM lets ptxas keep more registers in
// flight for the two m tiles (159 against 140 without it in bf16), which
// measured faster on the H100 (PERF.md, section 6); occupancy is three
// CTAs an SM either way. kLse: the training forward's instance, which
// also writes the log-sum-exp (the inference instances compile without
// it).
template <typename T, bool kLse = false>
__global__ void __launch_bounds__(kTcThreads, 1) k_mhsa_tc(const AttnArgs a) {
  __shared__ __align__(16) unsigned char smem[MhsaTile<T>::kSmemBytes];
  mhsa_rows_tile<T, kLse>(a, blockIdx.x, blockIdx.y * MhsaTile<T>::kQ,
                          reinterpret_cast<T*>(smem));
}

template <typename T, bool kLse = false>
__global__ void __launch_bounds__(kTcThreads)
    k_mhsa_tc_small(const AttnArgs a) {
  __shared__ __align__(16) unsigned char
      smem[kTcWarps * 48 * TcRows<T>::kPitch * sizeof(T)];
  mhsa_small_tile<T, kLse>(a, blockIdx.x * kTcWarps,
                           reinterpret_cast<T*>(smem));
}

// ---------------------------------------------------------------- DCA

constexpr int kMetaTile = 16;  // meta rows of one m tile / key tile
constexpr int kAccPitch = 40;  // floats per row of a warp's partial sums

// Image rows per CTA of k_dca_tc: 128 in bf16 (faster than 64 at both
// UperNet shapes on the H100, PERF.md section 6), 64 in fp32 (whose rows
// take twice the shared memory).
template <typename T>
struct DcaTile {
  static constexpr int kRows = sizeof(T) == 2 ? 128 : 64;
};

// Both directions of dual cross-attention: image rows q1 / k1 / v1 (n per
// image), meta rows q2 / k2 / v2 (m per image, in m tiles of 16). The c
// direction's partials go to pm / pl / pacc at [((b heads + h) tiles +
// tile) m + r] (pacc with 32 channels more). The c direction alone (kX
// false) reads k1, v1 and q2 only.
struct DcaArgs {
  const void* q1;
  const void* k1;
  const void* v1;
  const void* q2;
  const void* k2;
  const void* v2;
  void* xo;
  void* co;
  float* pm;
  float* pl;
  float* pacc;
  int ld_q1, ld_kv1, ld_q2, ld_kv2, ldo;
  int batch, heads, n, m, tiles;
  float sl2x, sl2c;  // scale_x, scale_c times log2(e)
  int k1_is_q1;      // D2: k1 aliases q1, whose rows are read once
  float* lse_x;  // kLse: each image row's log-sum-exp (B, H, n) and each
  float* lse_c;  // meta row's (B, H, m), fp32, natural log: m scale + ln l
  int mc;        // kX false: meta rows of a CTA (a multiple of 16; grid z)
};

// The softmax numerators of one warp's scores s (rows g and g + 8, the
// 8 NT columns of qk_tiles; columns at or past `valid` masked), in place:
// P = 2^((s - m) sl2), with m[r] the row's maximum (-inf for a row with no
// valid column, whose P is all 0) and l[r] its sum over the quad.
template <int NT>
__device__ __forceinline__ void tile_softmax(float (&s)[NT][4], int valid,
                                             float sl2, float (&m)[2],
                                             float (&l)[2]) {
  const int t = threadIdx.x & 3;
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (8 * j + 2 * t + c >= valid) s[j][c] = s[j][2 + c] = -INFINITY;
    }
    m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
    m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  const float b0 = m[0] == -INFINITY ? 0.f : -m[0] * sl2;
  const float b1 = m[1] == -INFINITY ? 0.f : -m[1] * sl2;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = exp2_sfu(fmaf(s[j][0], sl2, b0));
    s[j][1] = exp2_sfu(fmaf(s[j][1], sl2, b0));
    s[j][2] = exp2_sfu(fmaf(s[j][2], sl2, b1));
    s[j][3] = exp2_sfu(fmaf(s[j][3], sl2, b1));
    l[0] += s[j][0] + s[j][1];
    l[1] += s[j][2] + s[j][3];
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// Rows g and g + 8 of a warp's P divided by their sums l0 and l1.
template <int NT>
__device__ __forceinline__ void divide_rows(float (&p)[NT][4], float l0,
                                            float l1) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    p[j][0] /= l0;
    p[j][1] /= l0;
    p[j][2] /= l1;
    p[j][3] /= l1;
  }
}

// Shared bytes of dca_rows_tile for mp meta rows (m rounded up to a
// multiple of 16): two stages of one head's slices (TR rows of q1, k1,
// v1; mp of q2, k2, v2; kX false: k1, v1 and q2 only), then each warp's
// partial (max, sum, 16 x 32 sums) of one m tile.
template <typename T, bool kX = true>
__host__ __device__ constexpr int dca_smem_bytes(int mp) {
  constexpr int TR = DcaTile<T>::kRows;
  return 2 * (kX ? 3 * TR + 3 * mp : 2 * TR + mp) * TcRows<T>::kPitch *
             (int)sizeof(T) +
         (TR / 16) * kMetaTile * (2 + kAccPitch) * (int)sizeof(float);
}

// Image rows row0 .. row0 + TR - 1 of image b, every head. Warp w owns
// rows 16 w .. 16 w + 15:
//   c: as keys of the c direction, against each m tile of 16 meta queries
//      in turn (a partial softmax, P' V1); the warps' partials of an m
//      tile merge in warp order into the tile's partial, in workspace;
//   x: as queries of the x direction against the meta keys, 16 at a time:
//      a first pass takes each row's maximum and sum (online, as
//      online_step), a second computes P normalised before rounding (as
//      pallas_dca.py:66-68) and P V2; the last key tile's P is kept from
//      the first pass, so at m <= 16 the scores are computed once. kLse:
//      each row's log-sum-exp too, from the first pass.
// kX false: the c direction alone, on the meta rows of chunk `chunk` (a.mc
// rows from chunk a.mc); nothing of q1, k2, v2 is staged.
template <typename T, bool kX, bool kLse>
__device__ __forceinline__ void dca_rows_tile(const DcaArgs& a, int b,
                                              int tile, int chunk,
                                              unsigned char* smem) {
  constexpr int TR = DcaTile<T>::kRows;
  constexpr int P = TcRows<T>::kPitch, W = TR / 16, NT = 2 * TR;
  const int mbeg = kX ? 0 : chunk * a.mc;
  const int mcnt = kX ? a.m : min(a.mc, a.m - mbeg);
  const int mtiles = cdiv(mcnt, kMetaTile), mp = mtiles * kMetaTile;
  // a stage's rows: [q1] k1 v1 q2 [k2 v2], the bracketed ones with kX
  constexpr int oK1 = kX ? TR : 0, oV1 = oK1 + TR, oQ2 = oV1 + TR;
  const int stage = (oQ2 + (kX ? 3 : 1) * mp) * P;
  T* stages = reinterpret_cast<T*>(smem);
  float* mw = reinterpret_cast<float*>(stages + 2 * stage);  // [W][16]
  float* lw = mw + W * kMetaTile;                            // [W][16]
  float* aw = lw + W * kMetaTile;             // [W][16][kAccPitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = tile * TR, valid = a.n - row0;
  const T* q1 = kX ? static_cast<const T*>(a.q1) +
                         ((size_t)b * a.n + row0) * a.ld_q1
                   : nullptr;
  const T* k1 = static_cast<const T*>(a.k1) +
                ((size_t)b * a.n + row0) * a.ld_kv1;
  const T* v1 = static_cast<const T*>(a.v1) +
                ((size_t)b * a.n + row0) * a.ld_kv1;
  const size_t meta_q = ((size_t)b * a.m + mbeg) * a.ld_q2,
               meta_kv = (size_t)b * a.m * a.ld_kv2;

  auto load_head = [&](int h) {
    T* s = stages + (h & 1) * stage;
    const int c0 = h * kHeadDim;
    if constexpr (kX) copy_rows(s, q1 + c0, a.ld_q1, TR, valid, tid, NT);
    if (!kX || !a.k1_is_q1)
      copy_rows(s + oK1 * P, k1 + c0, a.ld_kv1, TR, valid, tid, NT);
    copy_rows(s + oV1 * P, v1 + c0, a.ld_kv1, TR, valid, tid, NT);
    T* sm = s + oQ2 * P;
    copy_rows(sm, static_cast<const T*>(a.q2) + meta_q + c0, a.ld_q2, mp,
              mcnt, tid, NT);
    if constexpr (kX) {
      copy_rows(sm + mp * P, static_cast<const T*>(a.k2) + meta_kv + c0,
                a.ld_kv2, mp, a.m, tid, NT);
      copy_rows(sm + 2 * mp * P, static_cast<const T*>(a.v2) + meta_kv + c0,
                a.ld_kv2, mp, a.m, tid, NT);
    }
  };

  load_head(0);
  cp_async_commit();
  for (int h = 0; h < a.heads; ++h) {
    if (h + 1 < a.heads) load_head(h + 1);
    cp_async_commit();
    cp_async_wait<1>();  // head h's slices landed for this thread ...
    __syncthreads();     // ... and for every thread
    T* s = stages + (h & 1) * stage;
    T* sQ1 = s + warp * 16 * P;
    const T* sK1 = (kX && a.k1_is_q1 ? s : s + oK1 * P) + warp * 16 * P;
    const T* sV1 = s + (oV1 + warp * 16) * P;
    const T* sQ2 = s + oQ2 * P;
    const T* sK2 = sQ2 + mp * P;
    const T* sV2 = sK2 + mp * P;

    for (int mt = 0; mt < mtiles; ++mt) {
      if (mt) __syncthreads();  // m tile mt - 1's partials are merged

      // c direction: meta queries 16 mt .. 16 mt + 15 against this warp's
      // 16 image keys
      {
        ARows<T> A;
        A.load(sQ2 + mt * kMetaTile * P);
        float sc[2][4], mx[2], l[2];
        qk_tile<2>(sc, A, sK1);
        tile_softmax<2>(sc, valid - warp * 16, a.sl2c, mx, l);
        float o[4][4] = {};
        pv_tile<1>(o, sc, sV1);
        float* acc = aw + warp * kMetaTile * kAccPitch;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          *reinterpret_cast<float2*>(acc + g * kAccPitch + 8 * d + 2 * t) =
              make_float2(o[d][0], o[d][1]);
          *reinterpret_cast<float2*>(acc + (g + 8) * kAccPitch + 8 * d +
                                     2 * t) = make_float2(o[d][2], o[d][3]);
        }
        if (t == 0) {
          mw[warp * kMetaTile + g] = mx[0];
          mw[warp * kMetaTile + g + 8] = mx[1];
          lw[warp * kMetaTile + g] = l[0];
          lw[warp * kMetaTile + g + 8] = l[1];
        }
      }

      // x direction, once the c direction is done with this warp's rows
      // (its output leaves through its own q1 rows, which are D2's keys)
      if (kX && mt == mtiles - 1) {
        ARows<T> A;
        A.load(sQ1);
        float sx[2][4], al[2];
        Online st;
        st.init();
        for (int kt = 0; kt < mtiles; ++kt) {
          qk_tile<2>(sx, A, sK2 + kt * kMetaTile * P);
          online_step<2, true>(st, sx, a.m - kt * kMetaTile, a.sl2x, al);
        }
        const float l0 = quad_sum(st.l[0]), l1 = quad_sum(st.l[1]);
        if constexpr (kLse) {  // m scale + ln l, the exp2 scale unfolded
          const int r = row0 + warp * 16 + g;
          float* L = a.lse_x + ((size_t)b * a.heads + h) * a.n;
          const float sc = a.sl2x * kLn2;
          if (t == 0 && r < a.n) L[r] = fmaf(st.m[0], sc, logf(l0));
          if (t == 0 && r + 8 < a.n) L[r + 8] = fmaf(st.m[1], sc, logf(l1));
        }
        float o[4][4] = {};
        for (int kt = 0; kt + 1 < mtiles; ++kt) {  // full key tiles
          float p[2][4];
          qk_tile<2>(p, A, sK2 + kt * kMetaTile * P);
          const float b0 = -st.m[0] * a.sl2x, b1 = -st.m[1] * a.sl2x;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            p[j][0] = exp2_sfu(fmaf(p[j][0], a.sl2x, b0));
            p[j][1] = exp2_sfu(fmaf(p[j][1], a.sl2x, b0));
            p[j][2] = exp2_sfu(fmaf(p[j][2], a.sl2x, b1));
            p[j][3] = exp2_sfu(fmaf(p[j][3], a.sl2x, b1));
          }
          divide_rows(p, l0, l1);
          pv_tile<1>(o, p, sV2 + kt * kMetaTile * P);
        }
        divide_rows(sx, l0, l1);  // the last key tile, P from the first pass
        pv_tile<1>(o, sx, sV2 + (mtiles - 1) * kMetaTile * P);
        T* xo = static_cast<T*>(a.xo) +
                ((size_t)b * a.n + row0 + warp * 16) * a.ldo + h * kHeadDim;
        store_tile(xo, a.ldo, valid - warp * 16, sQ1, o, 1.f, 1.f);
      }
      // every warp's partial is in place (after the last m tile the stage
      // is free for head h + 2)
      __syncthreads();

      // m tile mt's c partial: the warps' partials merged in warp order
      for (int e = tid; e < kMetaTile * kHeadDim; e += NT) {
        const int i = e / kHeadDim, d = e % kHeadDim;
        const int r = mbeg + mt * kMetaTile + i;
        if (r >= a.m) continue;
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < W; ++w) mx = fmaxf(mx, mw[w * kMetaTile + i]);
        float L = 0.f, S = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float wt = exp2_sfu((mw[w * kMetaTile + i] - mx) * a.sl2c);
          L = fmaf(wt, lw[w * kMetaTile + i], L);
          S = fmaf(wt, aw[(w * kMetaTile + i) * kAccPitch + d], S);
        }
        const size_t p =
            (((size_t)b * a.heads + h) * a.tiles + tile) * a.m + r;
        a.pacc[p * kHeadDim + d] = S;
        if (d == 0) {
          a.pm[p] = mx;
          a.pl[p] = L;
        }
      }
    }
  }
}

// Grid: (tiles, batch, meta chunks: 1 with kX).
template <typename T, bool kX = true, bool kLse = false>
__global__ void __launch_bounds__(2 * DcaTile<T>::kRows)
    k_dca_tc(const DcaArgs a) {
  extern __shared__ __align__(16) unsigned char dca_smem[];
  dca_rows_tile<T, kX, kLse>(a, blockIdx.y, blockIdx.x, blockIdx.z,
                             dca_smem);
}

// One CTA per (image, head, meta query), lane = channel: the tiles'
// partials merged into c_out. The maximum is exact in any order; the sums
// run in a fixed order, warp w folding tiles w, w + kMergeWarps, ... in
// turn, then the warps' sums folded in warp order. kLse: the query's
// log-sum-exp too, from the merged maximum and sum.
constexpr int kMergeWarps = 8;

template <typename T, bool kLse = false>
__global__ void __launch_bounds__(kMergeWarps * 32)
    k_dca_merge(const DcaArgs a) {
  __shared__ float s_m[kMergeWarps], s_l[kMergeWarps];
  __shared__ float s_s[kMergeWarps][kHeadDim];
  const int row = blockIdx.x;  // (b * heads + h) * m + r
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = row / a.m, r = row % a.m;
  const int b = bh / a.heads, h = bh % a.heads;
  const size_t base = (size_t)bh * a.tiles * a.m + r;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < a.tiles; i += kMergeWarps * 32)
    mx = fmaxf(mx, a.pm[base + (size_t)i * a.m]);
  mx = warp_max(mx);
  if (lane == 0) s_m[warp] = mx;
  __syncthreads();
  mx = s_m[0];
#pragma unroll
  for (int w = 1; w < kMergeWarps; ++w) mx = fmaxf(mx, s_m[w]);
  float L = 0.f, S = 0.f;
#pragma unroll 4
  for (int i = warp; i < a.tiles; i += kMergeWarps) {
    const size_t p = base + (size_t)i * a.m;
    const float wt = exp2_sfu((a.pm[p] - mx) * a.sl2c);
    L = fmaf(wt, a.pl[p], L);
    S = fmaf(wt, a.pacc[p * kHeadDim + lane], S);
  }
  if (lane == 0) s_l[warp] = L;
  s_s[warp][lane] = S;
  __syncthreads();
  if (warp) return;
  L = 0.f;
  S = 0.f;
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) {
    L += s_l[w];
    S += s_s[w][lane];
  }
  static_cast<T*>(a.co)[((size_t)b * a.m + r) * a.ldo + h * kHeadDim +
                        lane] = from_f<T>(S / L);
  if constexpr (kLse)
    if (lane == 0) a.lse_c[row] = fmaf(mx, a.sl2c * kLn2, logf(L));
}

}  // namespace
}  // namespace lm
