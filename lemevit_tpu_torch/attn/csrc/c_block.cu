// Fused pre-norm C block (stage 0 of LeMeViT): the M meta tokens attend to
// the N image tokens, then proj + residual + norm2 + MLP on the meta tokens.
// Only c is produced; x is read, never written. Replaces the TPU kernels
// lemevit_tpu/attn/pallas_block.py::c_block (_c_rows_kernel, _c_block_kernel).
//
// Launch chain (block_tc.cuh; bf16 products on wgmma, fp32 on FMA from the
// same TMA-fed tiles, as dca_block.cu's):
//   1. k_qkv_wg, one launch, two streams of different widths: the image rows
//      give kv = LN1(x) Wkv^T + bkv (2C columns), the meta rows q = LN1(c)
//      Wq^T + bq (C columns); LN1 staged once per 64 rows;
//   2. k_dca_tc + k_dca_merge in their c-direction instance (attn_tc.cuh):
//      a CTA reads 128 image rows (64 in fp32) of k / v once, in place in
//      the kv workspace, through every head, against the meta queries in
//      tiles of 16 (chunks of up to 256 meta rows a CTA, so any M fits);
//      the per-tile partials merge in a fixed order, so two runs give the
//      same bits;
//   3. k_tail_wg on the B M meta rows alone.
// cpe mode (taps and bias given, x before its CPE): k_qkv_wg's cpe mode
// stages each image row block's CPE'd rows once; only the kv product sees
// them, and nothing CPE'd is written (x passes the block unchanged).
// Bound on the H100: bytes. Each image row is read once and costs ~4 C^2
// operations (the kv projection), 2 C per byte of bf16 input: 192 at C =
// 96, below the card's bf16 line of ~295. kv (B N 2C, twice x) still
// round-trips through device memory.
#include "block_tc.cuh"

namespace lm {
namespace {

template <typename T>
int c_block(const void* const* p, int B, int N, int M, int C, int H,
            int hidden, int img_w, float scale, float eps, cudaStream_t s) {
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[6], p[7], mp<T>(p, 18), B * N, 2 * C};
  qa.seg[1] = {p[1], p[4], p[5], mp<T>(p, 17), B * M, C};
  qa.ln_w = p[2];
  qa.ln_b = p[3];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = Cpe{p[23], p[24], img_w, N};
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  const T* kv = cp<T>(p, 18);
  DcaArgs da{};  // the c direction alone: meta queries over the image keys
  da.k1 = kv;
  da.v1 = kv + C;
  da.q2 = p[17];
  da.co = mp<T>(p, 19);
  da.pm = mp<float>(p, 20);
  da.pl = mp<float>(p, 21);
  da.pacc = mp<float>(p, 22);
  da.ld_kv1 = 2 * C;
  da.ld_q2 = C;
  da.ldo = C;
  da.batch = B;
  da.heads = H;
  da.n = N;
  da.m = M;
  da.tiles = cdiv(N, DcaTile<T>::kRows);
  da.sl2c = scale * kLog2e;
  err = launch_dca_tc<T, false>(da, s);
  if (err) return err;

  TailArgs ta{};
  ta.seg[0] = {p[1], p[19], p[8], p[9], mp<T>(p, 16), B * M};
  ta.seg[1] = ta.seg[0];  // no second stream (its TMA map stays valid)
  ta.seg[1].rows = 0;
  ta.ln_w = p[10];
  ta.ln_b = p[11];
  ta.w1 = p[12];
  ta.b1 = p[13];
  ta.w2 = p[14];
  ta.b2 = p[15];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail_tc<T>(ta, s);
}

}  // namespace
}  // namespace lm

// p: 0 x, 1 c, 2 ln1_w, 3 ln1_b, 4 wq, 5 bq, 6 wkv, 7 bkv, 8 wp, 9 bp,
//    10 ln2_w, 11 ln2_b, 12 w1, 13 b1, 14 w2, 15 b2 | 16 c_out | workspace
//    17 q (B*M, C), 18 kv (B*N, 2C), 19 o (B*M, C), 20 pm, 21 pl
//    (B*H*tiles*M floats), 22 pacc (B*H*tiles*M*32 floats), tiles =
//    ceil(N / TR), TR = 128 in bf16, 64 in fp32 | 23 cpe_taps (9, C), 24
//    cpe_bias (C,), both null without the CPE (then x is after it; img_w is
//    the image width, N = H * img_w).
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int lm_c_block(int dtype, const void* const* p, int B, int N,
                          int M, int C, int H, int hidden, int img_w,
                          float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::c_block<float>(p, B, N, M, C, H, hidden, img_w, scale, eps,
                              s);
  return lm::c_block<__nv_bfloat16>(p, B, N, M, C, H, hidden, img_w, scale,
                                    eps, s);
}
