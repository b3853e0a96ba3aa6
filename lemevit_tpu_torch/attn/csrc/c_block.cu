// Fused pre-norm C block (stage 0 of LeMeViT): the M meta tokens attend to
// the N image tokens, then proj + residual + norm2 + MLP on the meta tokens.
// Only c is produced; x is read, never written. Replaces the TPU kernels
// lemevit_tpu/attn/pallas_block.py::c_block (_c_rows_kernel, _c_block_kernel).
//
// Launch chain (all from block_common.cuh):
//   1. k_linear_ln: q = LN1(c) Wq^T + bq and kv = LN1(x) Wkv^T + bkv, one
//      launch, two row ranges.
//   2. k_attention: the N keys are split over blocks (keys_per_split each);
//      each block writes its partial (max, sum, acc) per (image, head, query),
//      k_attn_combine merges them. The TPU carried these across sequential
//      grid steps; GPU blocks run in no order, hence the second pass.
//   3. k_block_tail on the B*M meta rows.
// cpe mode (taps and bias given, x before its CPE): only the kv product's A
// operand sees the CPE'd rows (LnCpeRows: each row's 3x3 neighbourhood is
// read where the prologue stages it); x passes through unchanged, so nothing
// CPE'd is ever written.
// Bound on the H100: bytes. Each image row is read once and costs ~4 C^2
// operations (the kv projection), 2 C per byte of bf16 input: 192 at C = 96,
// below the card's bf16 line of ~295. It still round-trips kv (B*N*2C,
// twice x) through device memory; keeping kv on chip is later work.
#include "block_common.cuh"

namespace lm {
namespace {

template <typename T>
int c_block(const void* const* p, int B, int N, int M, int C, int H,
            int hidden, int keys_per_split, int img_w, float scale, float eps,
            cudaStream_t s) {
  LinArgs la{};
  la.seg[0] = {p[1], p[4], p[5], mp<T>(p, 17), B * M, C};
  la.seg[1] = {p[0], p[6], p[7], mp<T>(p, 18), B * N, 2 * C};
  la.row_blocks0 = cdiv(B * M, kLinBM);
  la.ln_w = p[2];
  la.ln_b = p[3];
  la.K = C;
  la.eps = eps;
  la.cpe = {p[23], p[24], img_w, N};
  la.cpe_seg = 1;
  int err = launch_linear<T>(la, 2 * C, s);
  if (err) return err;

  AttnArgs aa{};
  aa.q = p[17];
  aa.k = p[18];
  aa.v = cp<T>(p, 18) + C;
  aa.out = mp<T>(p, 19);
  aa.pm = mp<float>(p, 20);
  aa.pl = mp<float>(p, 21);
  aa.pacc = mp<float>(p, 22);
  aa.ldq = C;
  aa.ldkv = 2 * C;
  aa.ldo = C;
  aa.batch = B;
  aa.heads = H;
  aa.nq = M;
  aa.nk = N;
  aa.keys_per_split = keys_per_split;
  aa.splits = cdiv(N, keys_per_split);
  aa.scale = scale;
  err = launch_attention<T>(aa, s);
  if (err) return err;

  TailArgs ta{};
  ta.seg[0] = {p[1], p[19], p[8], p[9], mp<T>(p, 16), B * M};
  ta.seg[1] = {nullptr, nullptr, nullptr, nullptr, nullptr, 0};
  ta.row_blocks0 = cdiv(B * M, kTailBM);
  ta.ln_w = p[10];
  ta.ln_b = p[11];
  ta.w1 = p[12];
  ta.b1 = p[13];
  ta.w2 = p[14];
  ta.b2 = p[15];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail<T>(ta, s);
}

}  // namespace
}  // namespace lm

// p: x, c, ln1_w, ln1_b, wq, bq, wkv, bkv, wp, bp, ln2_w, ln2_b, w1, b1, w2,
//    b2 | c_out | workspace q (B*M, C), kv (B*N, 2C), o (B*M, C),
//    pm, pl (B*H*splits*M floats), pacc (B*H*splits*M*32 floats) |
//    cpe_taps (9, C), cpe_bias (C,), both null without the CPE (then x is
//    after it; img_w is the image width, N = H * img_w).
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int lm_c_block(int dtype, const void* const* p, int B, int N,
                          int M, int C, int H, int hidden, int keys_per_split,
                          int img_w, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::c_block<float>(p, B, N, M, C, H, hidden, keys_per_split,
                              img_w, scale, eps, s);
  return lm::c_block<__nv_bfloat16>(p, B, N, M, C, H, hidden, keys_per_split,
                                    img_w, scale, eps, s);
}
