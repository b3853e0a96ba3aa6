// Attention-only dual cross-attention (DCA): both directions over the
// image-token projections q1, k1, v1 (B, N, C) and the meta-token
// projections q2, k2, v2 (B, M, C), per head of 32 channels:
//   x_out = softmax(q1 k2^T scale_x) v2   (each image token over M meta keys)
//   c_out = softmax(q2 k1^T scale_c) v1   (each meta token over N image keys)
// fp32 scores, softmax and accumulation; outputs (B, N, C) / (B, M, C) in
// the input type. Replaces lemevit_tpu/attn/pallas_dca.py::dca
// (_dca_forward, _dca_kernel), which the attention modules reach when the
// whole-block kernels decline (segmentation at 512^2: N = 16384 and 4096).
//
// The inputs are column views of the projection outputs, read in place:
// rows of leading dimension ld (3C for a D block's qkv, 2C for D2's qv / kv),
// images ld * N (or ld * M) elements apart, no copy.
//
// Launch chain (block_common.cuh): k_attention for the x direction (N
// queries, the M = 16 keys in one chunk, one split); k_attention split over
// blocks of keys_per_split image keys for the c direction, then
// k_attn_combine. The TPU kernel walks N in one pass and carries the c
// direction's online softmax in scratch from tile to tile; here blocks run
// in no order, so each split writes its (max, sum, acc) partial and the
// combine merges them. The two directions are separate launches, each
// reading its own inputs once.
// Bound on the H100: bytes. A call moves 4 (N + M) C elements (six inputs
// read, two outputs written) for 8 N M C operations: at M = 16 that is
// 32 operations per bf16 element, 16 per byte, far below the ~295 of the
// card's bf16 line.
#include "block_common.cuh"

namespace lm {
namespace {

template <typename T>
int dca_attn(const void* const* p, int B, int N, int M, int C, int H,
             int ld_q1, int ld_kv1, int ld_q2, int ld_kv2,
             int keys_per_split, float scale_x, float scale_c,
             cudaStream_t s) {
  // x direction: image queries against the meta keys
  AttnArgs ax{};
  ax.q = p[0];
  ax.k = p[4];
  ax.v = p[5];
  ax.out = mp<T>(p, 6);
  ax.ldq = ld_q1;
  ax.ldkv = ld_kv2;
  ax.ldo = C;
  ax.batch = B;
  ax.heads = H;
  ax.nq = N;
  ax.nk = M;
  ax.keys_per_split = M;
  ax.splits = 1;
  ax.scale = scale_x;
  int err = launch_attention<T>(ax, s);
  if (err) return err;

  // c direction: meta queries against the image keys, split over blocks
  AttnArgs ac{};
  ac.q = p[3];
  ac.k = p[1];
  ac.v = p[2];
  ac.out = mp<T>(p, 7);
  ac.pm = mp<float>(p, 8);
  ac.pl = mp<float>(p, 9);
  ac.pacc = mp<float>(p, 10);
  ac.ldq = ld_q2;
  ac.ldkv = ld_kv1;
  ac.ldo = C;
  ac.batch = B;
  ac.heads = H;
  ac.nq = M;
  ac.nk = N;
  ac.keys_per_split = keys_per_split;
  ac.splits = cdiv(N, keys_per_split);
  ac.scale = scale_c;
  return launch_attention<T>(ac, s);
}

}  // namespace
}  // namespace lm

// p: q1, k1, v1, q2, k2, v2 | x_out (B*N, C), c_out (B*M, C) | workspace
//    pm, pl (B*H*splits*M floats), pacc (B*H*splits*M*32 floats).
// k1 / v1 share ld_kv1, k2 / v2 share ld_kv2.
extern "C" int lm_dca_attn(int dtype, const void* const* p, int B, int N,
                           int M, int C, int H, int ld_q1, int ld_kv1,
                           int ld_q2, int ld_kv2, int keys_per_split,
                           float scale_x, float scale_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_attn<float>(p, B, N, M, C, H, ld_q1, ld_kv1, ld_q2,
                               ld_kv2, keys_per_split, scale_x, scale_c, s);
  return lm::dca_attn<__nv_bfloat16>(p, B, N, M, C, H, ld_q1, ld_kv1, ld_q2,
                                     ld_kv2, keys_per_split, scale_x,
                                     scale_c, s);
}
