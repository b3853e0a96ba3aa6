// Fused pre-norm D block (stages 1-2 of LeMeViT, and D2 blocks through the
// [Wq|Wq|Wv1] / [Wk|Wk|Wv2] weight permutation done by the caller):
//   qkv1 = LN1(x) Wqkv1^T + b, qkv2 = LN1(c) Wqkv2^T + b
//   x <- softmax(q1 k2^T scale_x) v2 over the M meta keys
//   c <- softmax(q2 k1^T scale_c) v1 over the N image keys
//   proj_x / proj_c, residuals, the shared norm2 + MLP on both streams.
// Both directions read the block's input x and c; neither sees the other's
// update. Replaces lemevit_tpu/attn/pallas_block.py::dca_block
// (_dca_rows_call / _dca_rows_kernel, _dca_block_call / _dca_block_kernel).
//
// Bound on the H100: operations. A row costs ~24 C^2 operations (qkv,
// proj, MLP) against ~4 C bytes of bf16 input and output, 6 C operations
// per byte, above the card's bf16 line of ~295 already at C = 96; the
// attention (8 N M C for both directions at M = 16) is a few per cent.
//
// Launch chain (block_tc.cuh; bf16 products on wgmma, fp32 on FMA from
// the same TMA-fed tiles):
//   1. k_qkv_wg: both projections, 64 rows a CTA, LN1 staged once per row
//      block and rounded to T, the 3C columns walked from that copy with
//      the weight tiles in a TMA-fed ring;
//   2. k_dca_tc + k_dca_merge (attn_tc.cuh, dca_attn.cu's tiles): a CTA
//      reads 128 image rows (64 in fp32) of q1 / k1 / v1 once, in place in
//      the qkv1 workspace, through every head and both directions, the
//      meta tokens in tiles of 16 (so M up to attn/dca.py's MAX_META); the
//      c direction's per-tile partials merge in a fixed order, so two runs
//      give the same bits;
//   3. k_tail_wg: both streams' proj (each its own weights) + residual +
//      the shared LN2 + MLP, 64 rows a CTA, the fc2 sum in registers, every
//      weight tile through one TMA-fed ring (block_common.cuh's
//      k_block_tail past C = 512).
// Round trips through device memory: qkv1 (3x the size of x), the x
// direction's output and the c direction's fp32 partials.
// cpe mode (taps and bias given, x before its CPE): as s_block.cu's, the
// qkv launch stages each row block's CPE'd rows once and writes them to a
// workspace, the tail's residual.
#include "block_tc.cuh"

namespace lm {
namespace {

template <typename T>
int dca_block(const void* const* p, int B, int N, int M, int C, int H,
              int hidden, int img_w, float scale_x, float scale_c, float eps,
              cudaStream_t s) {
  const Cpe cpe{p[27], p[28], img_w, N};
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[4], p[5], mp<T>(p, 20), B * N};
  qa.seg[1] = {p[1], p[6], p[7], mp<T>(p, 21), B * M};
  qa.ln_w = p[2];
  qa.ln_b = p[3];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = cpe;
  qa.xc = mp<T>(p, 29);
  if (cpe.taps && !qa.xc) return (int)cudaErrorInvalidValue;
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  const T* qkv1 = cp<T>(p, 20);
  const T* qkv2 = cp<T>(p, 21);
  DcaArgs da{};
  da.q1 = qkv1;
  da.k1 = qkv1 + C;
  da.v1 = qkv1 + 2 * C;
  da.q2 = qkv2;
  da.k2 = qkv2 + C;
  da.v2 = qkv2 + 2 * C;
  da.xo = mp<T>(p, 22);
  da.co = mp<T>(p, 23);
  da.pm = mp<float>(p, 24);
  da.pl = mp<float>(p, 25);
  da.pacc = mp<float>(p, 26);
  da.ld_q1 = da.ld_kv1 = da.ld_q2 = da.ld_kv2 = 3 * C;
  da.ldo = C;
  da.batch = B;
  da.heads = H;
  da.n = N;
  da.m = M;
  da.tiles = cdiv(N, DcaTile<T>::kRows);
  da.sl2x = scale_x * kLog2e;
  da.sl2c = scale_c * kLog2e;
  da.k1_is_q1 = 0;
  err = launch_dca_tc<T>(da, s);
  if (err) return err;

  TailArgs ta{};
  ta.seg[0] = {cpe.taps ? p[29] : p[0], p[22], p[8], p[9], mp<T>(p, 18),
               B * N};
  ta.seg[1] = {p[1], p[23], p[10], p[11], mp<T>(p, 19), B * M};
  ta.ln_w = p[12];
  ta.ln_b = p[13];
  ta.w1 = p[14];
  ta.b1 = p[15];
  ta.w2 = p[16];
  ta.b2 = p[17];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail_tc<T>(ta, s);
}

}  // namespace
}  // namespace lm

// p: x, c, ln1_w, ln1_b, wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc,
//    ln2_w, ln2_b, w1, b1, w2, b2 | x_out, c_out | workspace qkv1 (B*N, 3C),
//    qkv2 (B*M, 3C), ax (B*N, C), ac (B*M, C), pm, pl (B*H*tiles*M
//    floats), pacc (B*H*tiles*M*32 floats), tiles = ceil(N / TR), TR = 128
//    in bf16, 64 in fp32 | cpe_taps (9, C), cpe_bias (C,), null without
//    the CPE (img_w: the image width, N = H * img_w) | workspace x_cpe
//    (B*N, C), the CPE'd x, null without the CPE.
extern "C" int lm_dca_block(int dtype, const void* const* p, int B, int N,
                            int M, int C, int H, int hidden, int img_w,
                            float scale_x, float scale_c, float eps,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_block<float>(p, B, N, M, C, H, hidden, img_w, scale_x,
                                scale_c, eps, s);
  return lm::dca_block<__nv_bfloat16>(p, B, N, M, C, H, hidden, img_w,
                                      scale_x, scale_c, eps, s);
}
