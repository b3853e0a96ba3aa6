// Attention-only multi-head self-attention: softmax(q k^T scale) v per
// (image, head of 32 channels) over (B, N, C) projections, fp32 scores,
// softmax and sums, output (B, N, C) in the input type. Replaces
// lemevit_tpu/attn/pallas_mhsa.py::mhsa / sdpa (_mhsa_op, _mhsa_kernel),
// which the attention modules reach for S blocks that do not run as a
// whole-block kernel (the meta-token stream of blocks above N = 1024, the
// post-norm and layer-scale variants), for N <= 1024 within the JAX
// package's 12 MB budget. q, k and v are column views of the qkv
// projection (leading dimension 3C), read in place.
//
// Bound on the H100: bytes for the meta stream (N = 16), operations from
// N ~ 600 on in bf16 (4 N^2 C products); at head_dim 32 each score costs
// one exponential per 128 product operations, and the SFU's ~16 ex2 per
// clock per SM put that at about twice the operations bound at N = 1024.
//
// Design (attn_tc.cuh): FlashAttention-2-style tiles. A CTA of four warps
// takes 128 queries of one (image, head) in bf16, two m tiles of 16 rows
// per warp with Q's fragments in registers; 64-key K / V tiles stream
// through shared memory by 16-byte cp.async copies in a two-stage ring,
// the next tile's copy in flight during the current tile's products. S =
// Q K^T and P V run on mma.sync.m16n8k16 (bf16 in, fp32 sums) from
// ldmatrix (V through ldmatrix.trans), each K / V fragment serving both m
// tiles; the online softmax stays in the accumulator registers, in steps
// of 32 keys (ex2 on the SFU, scale * log2(e) folded into one FMA); P is
// rounded to bf16 as the A operand of P V, as the TPU kernel rounds it;
// one division at the end, stores of 16 bytes. On the H100 this measured
// faster at N = 1024 than one m tile per warp or 64-key steps (159
// registers, three CTAs an SM; PERF.md, section 6). At N <= 16 (the meta
// stream) each warp takes a whole (image, head), four per CTA. fp32
// inputs take the same tiles with FMA products and one m tile per warp
// (attn_tc.cuh), so both types share one kernel and one order of sums
// per query.
#include "attn_tc.cuh"

namespace lm {
namespace {

template <typename T>
int mhsa(const void* const* p, int B, int N, int C, int H, int ldq, int ldkv,
         float scale, cudaStream_t s) {
  AttnArgs a{};
  a.q = p[0];
  a.k = p[1];
  a.v = p[2];
  a.out = mp<T>(p, 3);
  a.ldq = ldq;
  a.ldkv = ldkv;
  a.ldo = C;
  a.batch = B;
  a.heads = H;
  a.nq = N;
  a.nk = N;
  a.scale = scale;
  if (N <= kTcSmall) {
    k_mhsa_tc_small<T><<<cdiv(B * H, kTcWarps), kTcThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  k_mhsa_tc<T><<<dim3(B * H, cdiv(N, MhsaTile<T>::kQ)), kTcThreads, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lm

// p: q, k, v | out (B*N, C). k / v share ldkv. Every row pointer must be
// 16-byte aligned (attn/mhsa.py copies a tensor that is not).
extern "C" int lm_mhsa(int dtype, const void* const* p, int B, int N, int C,
                       int H, int ldq, int ldkv, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::mhsa<float>(p, B, N, C, H, ldq, ldkv, scale, s);
  return lm::mhsa<__nv_bfloat16>(p, B, N, C, H, ldq, ldkv, scale, s);
}
