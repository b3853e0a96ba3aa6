// Training of the pre-norm C block (stage 0 of LeMeViT): the 16 meta
// tokens attend to the N image tokens; only c is produced, and x passes the
// block unchanged but gets gradients through the k / v projection.
// Forward with per-image DropPath branch scales, and attention backward.
// Replaces lemevit_tpu/attn/pallas_train.py::c_block_train
// (_c_train_fwd_call with _c_train_fwd_kernel, _c_train_bwd_call with
// _c_attn_bwd_kernel). The C block's MLP backward (B M meta rows only, plain
// XLA on the TPU) is s_train.cu's lm_mlp_bwd with an empty image stream.
//
// The weights come LN-folded (W' = W diag(gamma), b' = b + W beta for q,
// kv and fc1), so every LayerNorm runs without affine.
//
// lm_c_train_fwd (row 14 of the TPU kernel table): one k_linear_ln for
//   q = LN1(c) Wq'^T + bq' (B M rows) and kv = LN1(x) Wkv'^T + bkv' (B N
//   rows); the meta queries attend over the N keys, split over blocks and
//   merged by k_attn_combine, writing o and each query's log-sum-exp;
//   k_block_tail on the meta rows with s1c = dp[2], s2c = dp[3] writes
//   t1c and the new c.
// lm_c_attn_bwd (row 15): LN1, q and kv recomputed; dO = (s1c dt1c) Wp; the
//   attention backward gives dq (B M rows) and dkv (B N rows); dc = dt1c +
//   LN1'(c)^T (dq Wq') and dxt = LN1'(x)^T (dkv Wkv') with no residual (x
//   passes the block; autograd adds its identity gradient outside);
//   k_wgrad gives dWkv, dbkv over the B N rows, dWq, dbq from (LN1(c), dq)
//   and dWp from (o, s1c dt1c). dbp is a column sum left to the caller.
// With a CPE (taps non-null), x is the image tokens before the 3x3 CPE,
//   which feeds the k / v side only (the TPU's _c_train_fwd_kernel): the
//   forward runs k_cpe_rows once into a workspace and kv = LN1(CPE(x))
//   Wkv'^T + bkv'; the backward recomputes it, takes du = LN1'^T (dkv Wkv')
//   in fp32 (still no residual), then k_cpe_tap_grads and the flipped-tap
//   k_cpe_rows: dxt = CPE^T du, to which autograd adds x's identity
//   gradient outside.
// Bound on the H100: bytes. Each image row is read once and costs ~4 C^2
// operations (the kv projection), 2 C operations per byte of bf16 input:
// 128 at C = 64, below the card's bf16 line of ~295. kv (twice x) and dkv
// round-trip through device memory; keeping them on chip is later work.
#include "train_common.cuh"

namespace lm {
namespace {

// p: 0 x, 1 c, 2 ones, 3 zeros, 4 wq', 5 bq', 6 wkv', 7 bkv', 8 wp, 9 bp,
//    10 w1', 11 b1', 12 w2, 13 b2, 14 dp (4, B) fp32 | 15 c_out, 16 t1c,
//    17 o (B M, C), 18 lse (B H M) fp32 | workspace 19 q (B M, C),
//    20 kv (B N, 2C), 21 pm, 22 pl (B H splits M), 23 pacc (x 32) fp32 |
//    the CPE or nulls: 24 taps (9, C), 25 bias (C,), workspace 26 the CPE'd
//    x (B N, C). Images are img_w wide.
template <typename T>
int c_train_fwd(const void* const* p, int B, int N, int M, int C, int H,
                int hidden, int keys_per_split, int img_w, float scale,
                float eps, cudaStream_t s) {
  const void* x = p[0];
  int err;
  if (p[24]) {
    err = launch_cpe_rows<T, T>(p[0], p[24], p[25], mp<T>(p, 26), B * N, C,
                                img_w, N, 0, s);
    if (err) return err;
    x = p[26];
  }
  LinArgs la{};
  la.seg[0] = {p[1], p[4], p[5], mp<T>(p, 19), B * M, C};
  la.seg[1] = {x, p[6], p[7], mp<T>(p, 20), B * N, 2 * C};
  la.row_blocks0 = cdiv(B * M, kLinBM);
  la.ln_w = p[2];
  la.ln_b = p[3];
  la.K = C;
  la.eps = eps;
  err = launch_linear<T>(la, 2 * C, s);
  if (err) return err;

  AttnArgs aa{};
  aa.q = p[19];
  aa.k = p[20];
  aa.v = cp<T>(p, 20) + C;
  aa.out = mp<T>(p, 17);
  aa.lse = fp(p, 18);
  aa.pm = fp(p, 21);
  aa.pl = fp(p, 22);
  aa.pacc = fp(p, 23);
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

  const float* dp = static_cast<const float*>(p[14]);
  TailArgs ta{};  // the meta rows only; seg[1] stays empty
  ta.seg[0] = {p[1], p[17], p[8], p[9], mp<T>(p, 15), B * M,
               dp + 2 * B, dp + 3 * B, M, mp<T>(p, 16)};
  ta.row_blocks0 = cdiv(B * M, kTailBM);
  ta.ln_w = p[2];
  ta.ln_b = p[3];
  ta.w1 = p[10];
  ta.b1 = p[11];
  ta.w2 = p[12];
  ta.b2 = p[13];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail<T>(ta, s);
}

// p: 0 x, 1 c, 2 dt1c, 3 dprojc (= s1c dt1c), 4 wq', 5 bq', 6 wkv', 7 bkv',
//    8 wq'^T (C, C), 9 wkv'^T (C, 2C), 10 wp^T (C, C), 11 o, 12 lse |
//    13 dxt, 14 dc, 15 dwq (C, C), 16 dbq, 17 dwkv (2C, C), 18 dbkv,
//    19 dwp (C, C) | workspace 20 a_x (B N, C), 21 a_c (B M, C),
//    22 q (B M, C), 23 kv (B N, 2C), 24 dO (B M, C) fp32, 25 D (B H M) fp32,
//    26 dq (B M, C), 27 dkv (B N, 2C), 28 da_x (B N, C) fp32,
//    29 da_c (B M, C) fp32, 30 partials (splits, 2 C^2) fp32,
//    31 bias partials (splits, 2C) fp32 | the CPE or nulls: 32 taps (9, C),
//    33 bias (C,), workspace 34 the CPE'd x (B N, C), 35 du (B N, C) fp32,
//    36 partials (splits, 10, C) fp32, outputs 37 dtaps (9, C), 38 dbias
//    (C,). rps_x / rps_c: k_wgrad's rows per split over the B N image rows
//    and the B M meta rows; images are img_w wide; cpe_rps:
//    k_cpe_tap_grads' rows per block.
template <typename T>
int c_attn_bwd(const void* const* p, int B, int N, int M, int C, int H,
               int rps_x, int rps_c, int img_w, int cpe_rps, float scale,
               float eps, cudaStream_t s) {
  const int rx = B * N, rc = B * M;
  const TrainCpe cpe{p[32], p[33], img_w, N, cpe_rps};
  const void* x = p[0];  // the rows LN1 reads
  int err;
  if (cpe.taps) {
    err = launch_cpe_rows<T, T>(p[0], cpe.taps, cpe.bias, mp<T>(p, 34), rx,
                                C, img_w, N, 0, s);
    if (err) return err;
    x = p[34];
  }
  err = launch_ln_rows<T>(x, mp<T>(p, 20), rx, C, eps, s);
  if (err) return err;
  err = launch_ln_rows<T>(p[1], mp<T>(p, 21), rc, C, eps, s);
  if (err) return err;
  LinArgs la{};  // q = LN1(c) Wq'^T + bq', kv = LN1(x) Wkv'^T + bkv'
  la.seg[0] = {p[21], p[4], p[5], mp<T>(p, 22), rc, C};
  la.seg[1] = {p[20], p[6], p[7], mp<T>(p, 23), rx, 2 * C};
  la.row_blocks0 = cdiv(rc, kLinBM);
  la.K = C;
  la.eps = eps;
  la.plain_a = 1;
  err = launch_linear<T>(la, 2 * C, s);
  if (err) return err;

  LinArgs lo{};  // dO = dproj Wp, fp32
  lo.seg[0] = {p[3], p[10], nullptr, fp(p, 24), rc, C};
  lo.row_blocks0 = cdiv(rc, kLinBM);
  lo.K = C;
  lo.plain_a = 1;
  lo.out_f32 = 1;
  err = launch_linear<T>(lo, C, s);
  if (err) return err;

  AttnBwdArgs ab{};  // the meta queries against the image keys
  ab.q = p[22];
  ab.k = p[23];
  ab.v = cp<T>(p, 23) + C;
  ab.o = p[11];
  ab.dO = fp(p, 24);
  ab.lse = fp(p, 12);
  ab.D = fp(p, 25);
  ab.dq = mp<T>(p, 26);
  ab.dk = mp<T>(p, 27);
  ab.dv = mp<T>(p, 27) + C;
  ab.ldq = ab.lddq = ab.ldo = C;
  ab.ldkv = ab.lddkv = 2 * C;
  ab.batch = B;
  ab.heads = H;
  ab.nq = M;
  ab.nk = N;
  ab.C = C;
  ab.scale = scale;
  err = launch_attn_bwd<T>(ab, s);
  if (err) return err;

  // da_c = dq Wq' and da_x = dkv Wkv', fp32 (two launches: their depths
  // differ)
  LinArgs ld{};
  ld.seg[0] = {p[26], p[8], nullptr, fp(p, 29), rc, C};
  ld.row_blocks0 = cdiv(rc, kLinBM);
  ld.K = C;
  ld.plain_a = 1;
  ld.out_f32 = 1;
  err = launch_linear<T>(ld, C, s);
  if (err) return err;
  ld.seg[0] = {p[27], p[9], nullptr, fp(p, 28), rx, C};
  ld.row_blocks0 = cdiv(rx, kLinBM);
  ld.K = 2 * C;
  err = launch_linear<T>(ld, C, s);
  if (err) return err;
  err = launch_ln_bwd<T>(p[1], fp(p, 29), p[2], mp<T>(p, 14), rc, C, eps, s);
  if (err) return err;
  if (cpe.taps) {  // du in fp32, then the CPE's backward
    err = launch_ln_bwd<T, float>(x, fp(p, 28), nullptr, fp(p, 35), rx, C,
                                  eps, s);
    if (!err)
      err = launch_cpe_bwd<T>(cpe, p[0], fp(p, 35), fp(p, 36), mp<T>(p, 37),
                              mp<T>(p, 38), mp<T>(p, 13), rx, C, s);
  } else {
    err = launch_ln_bwd<T>(x, fp(p, 28), nullptr, mp<T>(p, 13), rx, C, eps,
                           s);
  }
  if (err) return err;

  WgradArgs wa{};
  wa.seg[0] = {p[27], p[20], rx};  // dWkv' = dkv^T LN1(x)
  wa.rows_per_split = rps_x;
  wa.splits0 = cdiv(rx, rps_x);
  wa.O = 2 * C;
  wa.I = C;
  wa.part = fp(p, 30);
  wa.part_bias = fp(p, 31);
  err = launch_wgrad<T>(wa, mp<T>(p, 17), mp<T>(p, 18), s);
  if (err) return err;
  wa.seg[0] = {p[26], p[21], rc};  // dWq' = dq^T LN1(c)
  wa.rows_per_split = rps_c;
  wa.splits0 = cdiv(rc, rps_c);
  wa.O = C;
  err = launch_wgrad<T>(wa, mp<T>(p, 15), mp<T>(p, 16), s);
  if (err) return err;
  wa.seg[0] = {p[3], p[11], rc};  // dWp = dproj^T o
  wa.part_bias = nullptr;
  return launch_wgrad<T>(wa, mp<T>(p, 19), nullptr, s);
}

}  // namespace
}  // namespace lm

extern "C" int lm_c_train_fwd(int dtype, const void* const* p, int B, int N,
                              int M, int C, int H, int hidden,
                              int keys_per_split, int img_w, float scale,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::c_train_fwd<float>(p, B, N, M, C, H, hidden, keys_per_split,
                                  img_w, scale, eps, s);
  return lm::c_train_fwd<__nv_bfloat16>(p, B, N, M, C, H, hidden,
                                        keys_per_split, img_w, scale, eps, s);
}

extern "C" int lm_c_attn_bwd(int dtype, const void* const* p, int B, int N,
                             int M, int C, int H, int rps_x, int rps_c,
                             int img_w, int cpe_rps, float scale, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::c_attn_bwd<float>(p, B, N, M, C, H, rps_x, rps_c, img_w,
                                 cpe_rps, scale, eps, s);
  return lm::c_attn_bwd<__nv_bfloat16>(p, B, N, M, C, H, rps_x, rps_c, img_w,
                                       cpe_rps, scale, eps, s);
}
