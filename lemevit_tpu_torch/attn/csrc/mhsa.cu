// Attention-only multi-head self-attention: softmax(q k^T scale) v per
// (image, head of 32 channels) over (B, N, C) projections, fp32 scores,
// softmax and accumulation, output (B, N, C) in the input type. Replaces
// lemevit_tpu/attn/pallas_mhsa.py::mhsa / sdpa (_mhsa_op, _mhsa_kernel),
// which the attention modules reach for S blocks that do not run as a
// whole-block kernel (the meta-token stream of blocks above N = 1024, the
// post-norm and layer-scale variants), for N <= 1024 within the JAX
// package's 12 MB budget.
//
// The TPU kernel holds a batch row's full N x N fp32 scores in VMEM; here
// k_attention (block_common.cuh) streams the keys through shared memory in
// 64-key chunks with an online softmax, which computes the same function
// for any N: one launch, one split, 32 queries per block. q, k and v are
// column views of the qkv projection (leading dimension 3C), read in place.
// Bound on the H100: bytes for the meta stream (N = 16: 4 N C elements moved
// for 4 N^2 C operations, 32 operations per element), operations from
// N ~ 600 on in bf16.
#include "block_common.cuh"

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
  a.keys_per_split = N;
  a.splits = 1;
  a.scale = scale;
  return launch_attention<T>(a, s);
}

}  // namespace
}  // namespace lm

// p: q, k, v | out (B*N, C). k / v share ldkv.
extern "C" int lm_mhsa(int dtype, const void* const* p, int B, int N, int C,
                       int H, int ldq, int ldkv, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::mhsa<float>(p, B, N, C, H, ldq, ldkv, scale, s);
  return lm::mhsa<__nv_bfloat16>(p, B, N, C, H, ldq, ldkv, scale, s);
}
