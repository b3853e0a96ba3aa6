// Attention-only dual cross-attention (DCA): both directions over the
// image-token projections q1, k1, v1 (B, N, C) and the meta-token
// projections q2, k2, v2 (B, M, C), per head of 32 channels:
//   x_out = softmax(q1 k2^T scale_x) v2   (each image token over M meta keys)
//   c_out = softmax(q2 k1^T scale_c) v1   (each meta token over N image keys)
// fp32 scores, softmax and sums; outputs (B, N, C) / (B, M, C) in the input
// type. Replaces lemevit_tpu/attn/pallas_dca.py::dca (_dca_forward,
// _dca_kernel), which the attention modules reach when the whole-block
// kernels decline (segmentation at 512^2: N = 16384 and 4096). The inputs
// are column views of the projection outputs, read in place: rows of
// leading dimension ld (3C for a D block's qkv, 2C for D2's qv / kv).
//
// Bound on the H100: bytes. A call moves 4 (N + M) C elements (six inputs
// read, two outputs written) for 8 N M C operations: at M = 16 that is 16
// operations per byte in bf16, far below the ~295 of the card's bf16 line.
// So the design reads every image byte once, in one launch.
//
// Design (attn_tc.cuh, dca_rows_tile): a CTA takes TR image rows (128 in
// bf16, 64 in fp32: DcaTile) of one image through every head, one head's
// q1 / k1 / v1 slices (and its meta rows of q2 / k2 / v2) in flight by
// 16-byte cp.async copies while the previous head computes. Warp w owns
// rows 16 w .. 16 w + 15 in both directions:
//   c: each m tile of 16 meta queries against its 16 keys, S' = Q2 K1^T
//      on mma.sync, a partial softmax, P' V1 in one k step; the warps'
//      partials merge in warp order into the tile's (max, sum, 16 x 32
//      sums), written to fp32 workspace;
//   x: its 16 queries against the meta keys in tiles of 16, S = Q1 K2^T on
//      mma.sync, the rows' maxima and sums in a first pass, then P
//      normalised and rounded to the input type (as the TPU kernel), P V2,
//      out by 16-byte stores. At M = 16 (every released variant) that is
//      one key tile, whose scores are computed once.
// The TPU kernel carries the c direction's online softmax across its
// sequential grid; here tiles run in no order, so a second launch,
// k_dca_merge (a CTA per image, head and meta query), merges the tiles'
// partials in a fixed order: its warp w folds tiles w, w + 8, ... in turn,
// then the warps fold in warp order. No atomics: the same bits from run to
// run. D2 passes k1 = q1 (one tensor): those rows are copied once. fp32
// runs the same tiles with FMA products. The meta rows of a head sit in
// shared memory beside the image rows, so M is bounded by its 227 KB: at
// most 304 in bf16 and 192 in fp32 (attn/dca.py, MAX_META).
#include "attn_tc.cuh"

namespace lm {
namespace {

template <typename T>
int dca_attn(const void* const* p, int B, int N, int M, int C, int H,
             int ld_q1, int ld_kv1, int ld_q2, int ld_kv2, float scale_x,
             float scale_c, cudaStream_t s) {
  constexpr int TR = DcaTile<T>::kRows;
  if (M < 1) return (int)cudaErrorInvalidValue;
  DcaArgs a{};
  a.q1 = p[0];
  a.k1 = p[1];
  a.v1 = p[2];
  a.q2 = p[3];
  a.k2 = p[4];
  a.v2 = p[5];
  a.xo = mp<T>(p, 6);
  a.co = mp<T>(p, 7);
  a.pm = mp<float>(p, 8);
  a.pl = mp<float>(p, 9);
  a.pacc = mp<float>(p, 10);
  a.ld_q1 = ld_q1;
  a.ld_kv1 = ld_kv1;
  a.ld_q2 = ld_q2;
  a.ld_kv2 = ld_kv2;
  a.ldo = C;
  a.batch = B;
  a.heads = H;
  a.n = N;
  a.m = M;
  a.tiles = cdiv(N, TR);
  a.sl2x = scale_x * kLog2e;
  a.sl2c = scale_c * kLog2e;
  a.k1_is_q1 = p[1] == p[0] && ld_kv1 == ld_q1;
  // an M whose rows do not fit fails here (cudaErrorInvalidValue)
  const int bytes = dca_smem_bytes<T>(cdiv(M, kMetaTile) * kMetaTile);
  int err = (int)cudaFuncSetAttribute(
      k_dca_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  k_dca_tc<T><<<dim3(a.tiles, a.batch), 2 * TR, bytes, s>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  k_dca_merge<T><<<a.batch * a.heads * a.m, kMergeWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lm

// p: q1, k1, v1, q2, k2, v2 | x_out (B*N, C), c_out (B*M, C) | workspace
//    pm, pl (B*H*tiles*M floats), pacc (B*H*tiles*M*32 floats), tiles =
//    ceil(N / TR), TR = 128 in bf16, 64 in fp32. k1 / v1 share ld_kv1, k2 /
//    v2 share ld_kv2; row pointers 16-byte aligned (attn/dca.py copies a
//    tensor that is not).
extern "C" int lm_dca_attn(int dtype, const void* const* p, int B, int N,
                           int M, int C, int H, int ld_q1, int ld_kv1,
                           int ld_q2, int ld_kv2, float scale_x,
                           float scale_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_attn<float>(p, B, N, M, C, H, ld_q1, ld_kv1, ld_q2,
                               ld_kv2, scale_x, scale_c, s);
  return lm::dca_attn<__nv_bfloat16>(p, B, N, M, C, H, ld_q1, ld_kv1, ld_q2,
                                     ld_kv2, scale_x, scale_c, s);
}
