// Fused pre-norm D block (stages 1-2 of LeMeViT, and D2 blocks through the
// [Wq|Wq|Wv1] / [Wk|Wk|Wv2] weight permutation done by the caller):
//   qkv1 = LN1(x) Wqkv1^T + b, qkv2 = LN1(c) Wqkv2^T + b
//   x <- softmax(q1 k2^T scale_x) v2 over the M meta keys
//   c <- softmax(q2 k1^T scale_c) v1 over the N image keys
//   proj_x / proj_c, residuals, the shared norm2 + MLP on both streams.
// Both directions read the block's input x and c; neither sees the other's
// update. Replaces lemevit_tpu/attn/pallas_block.py::dca_block
// (_dca_rows_kernel, _dca_block_kernel).
//
// Launch chain (block_common.cuh): one k_linear_ln for both projections;
// k_attention for the x direction (16 keys, one split); k_attention split
// over the N keys + k_attn_combine for the c direction (the TPU's online
// softmax ran over sequential grid steps); one k_block_tail for both streams.
// Bound on the H100: operations. A row costs ~24 C^2 operations (qkv, proj,
// MLP) against ~4 C bytes of bf16 input and output, 6 C operations per
// byte, above the card's bf16 line of ~295 already at C = 96. bf16
// products run on mma.sync from shared-memory tiles staged by plain loads
// (no TMA, no wgmma, no pipelining yet). Round trips through device memory:
// qkv1 (3x the size of x) and the x-direction attention output.
// cpe mode (taps and bias given, x before its CPE): k_linear_ln's x rows
// are LayerNormed after their CPE (LnCpeRows, the 3x3 neighbourhood read
// where the prologue stages a row), and k_block_tail recomputes the CPE of
// its rows for the residual rather than reading a CPE'd copy of x: no
// workspace, one more pass over x's neighbourhoods in the tail.
#include "block_common.cuh"

namespace lm {
namespace {

template <typename T>
int dca_block(const void* const* p, int B, int N, int M, int C, int H,
              int hidden, int keys_per_split, int img_w, float scale_x,
              float scale_c, float eps, cudaStream_t s) {
  const Cpe cpe{p[27], p[28], img_w, N};
  LinArgs la{};
  la.seg[0] = {p[0], p[4], p[5], mp<T>(p, 20), B * N, 3 * C};
  la.seg[1] = {p[1], p[6], p[7], mp<T>(p, 21), B * M, 3 * C};
  la.row_blocks0 = cdiv(B * N, kLinBM);
  la.ln_w = p[2];
  la.ln_b = p[3];
  la.K = C;
  la.eps = eps;
  la.cpe = cpe;
  la.cpe_seg = 0;
  int err = launch_linear<T>(la, 3 * C, s);
  if (err) return err;

  // x direction: image queries against the meta keys
  AttnArgs ax{};
  ax.q = p[20];
  ax.k = cp<T>(p, 21) + C;
  ax.v = cp<T>(p, 21) + 2 * C;
  ax.out = mp<T>(p, 22);
  ax.ldq = 3 * C;
  ax.ldkv = 3 * C;
  ax.ldo = C;
  ax.batch = B;
  ax.heads = H;
  ax.nq = N;
  ax.nk = M;
  ax.keys_per_split = M;
  ax.splits = 1;
  ax.scale = scale_x;
  err = launch_attention<T>(ax, s);
  if (err) return err;

  // c direction: meta queries against the image keys, split over blocks
  AttnArgs ac{};
  ac.q = p[21];
  ac.k = cp<T>(p, 20) + C;
  ac.v = cp<T>(p, 20) + 2 * C;
  ac.out = mp<T>(p, 23);
  ac.pm = mp<float>(p, 24);
  ac.pl = mp<float>(p, 25);
  ac.pacc = mp<float>(p, 26);
  ac.ldq = 3 * C;
  ac.ldkv = 3 * C;
  ac.ldo = C;
  ac.batch = B;
  ac.heads = H;
  ac.nq = M;
  ac.nk = N;
  ac.keys_per_split = keys_per_split;
  ac.splits = cdiv(N, keys_per_split);
  ac.scale = scale_c;
  err = launch_attention<T>(ac, s);
  if (err) return err;

  TailArgs ta{};
  ta.seg[0] = {p[0], p[22], p[8], p[9], mp<T>(p, 18), B * N};
  ta.seg[0].cpe = cpe;
  ta.seg[1] = {p[1], p[23], p[10], p[11], mp<T>(p, 19), B * M};
  ta.row_blocks0 = cdiv(B * N, kTailBM);
  ta.ln_w = p[12];
  ta.ln_b = p[13];
  ta.w1 = p[14];
  ta.b1 = p[15];
  ta.w2 = p[16];
  ta.b2 = p[17];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail<T>(ta, s);
}

}  // namespace
}  // namespace lm

// p: x, c, ln1_w, ln1_b, wqkv1, bqkv1, wqkv2, bqkv2, wpx, bpx, wpc, bpc,
//    ln2_w, ln2_b, w1, b1, w2, b2 | x_out, c_out | workspace qkv1 (B*N, 3C),
//    qkv2 (B*M, 3C), ax (B*N, C), ac (B*M, C), pm, pl (B*H*splits*M floats),
//    pacc (B*H*splits*M*32 floats) | cpe_taps (9, C), cpe_bias (C,), null
//    without the CPE (img_w: the image width, N = H * img_w).
extern "C" int lm_dca_block(int dtype, const void* const* p, int B, int N,
                            int M, int C, int H, int hidden,
                            int keys_per_split, int img_w, float scale_x,
                            float scale_c, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_block<float>(p, B, N, M, C, H, hidden, keys_per_split,
                                img_w, scale_x, scale_c, eps, s);
  return lm::dca_block<__nv_bfloat16>(p, B, N, M, C, H, hidden,
                                      keys_per_split, img_w, scale_x, scale_c,
                                      eps, s);
}
