// Training of the pre-norm S block (LeMeViT's self-attention stages):
// forward with per-image DropPath branch scales, MLP backward and attention
// backward, on the image tokens and, with the same weights, on the meta
// tokens. Replaces lemevit_tpu/attn/pallas_train.py::s_block_train
// (_s_train_fwd_call, _mlp_bwd_call, _s_train_bwd_call).
//
// The weights come LN-folded, as on the TPU: W' = W diag(gamma),
// b' = b + W beta for qkv and fc1, so both LayerNorms run without affine
// (ones / zeros are passed where the inference launches take gamma / beta)
// and autograd outside the kernels chains the gamma / beta gradients.
//
// lm_s_train_fwd (row 9 of the TPU kernel table), on the inference S
//   block's tensor-core kernels: block_tc.cuh's k_qkv_wg (LN1 + qkv of both
//   streams, its inference instance) -> attn_tc.cuh's k_mhsa_tc (k_mhsa_tc_
//   small at n <= 16) per stream in the instance that also writes each
//   query's log-sum-exp, in natural-log units, beside o -> k_tail_wg's
//   training instance: per-image branch scales s1 / s2, t1 = t + s1 (o Wp^T
//   + bp) written rounded to T for lm_mlp_bwd, out = t1 + s2 (b2 + MLP)
//   with s2 applied to each GELU chunk before its rounding. 4 launches
//   (5 in the cpe mode).
// lm_mlp_bwd (row 11): train_tc.cuh's k_mlp_bwd_wg recomputes LN2 / fc1 /
//   GELU from t1 on wgmma and gives dt1, writing LN2(t1), GELU(y) and dy;
//   k_wgrad_tc gives dW1, db1 (from dy, LN2(t1)) and dW2 (from dz = s2
//   dout, GELU(y)) and db2 = colsum(dz) (the TPU wrapper leaves it to XLA)
//   in one launch, k_wgrad_tc_reduce sums their row ranges. 3 launches.
// lm_s_attn_bwd (row 10): block_tc.cuh's k_qkv_wg recomputes LN1 (of the
//   CPE'd x in the cpe mode) and qkv, also writing the LN1 rows;
//   k_rowmm_wg gives dO = dproj Wp (dproj = s1 dt1) and D = rowsum(dO . o);
//   train_tc.cuh's attention tiles rebuild P from the saved log-sum-exp and
//   give dq, dk, dv (two launches for the image stream, one for the meta
//   stream); k_rowmm_wg gives da = dqkv Wqkv' with dx = dt1 + LN1'^T da in
//   its epilogue; k_wgrad_tc gives dWqkv, dbqkv, dWp and dbp =
//   colsum(dproj) (left to XLA on the TPU). 8 launches.
// With a CPE (taps non-null: the TPU kernels' use_cpe, JAX's
//   PB_TRAIN_CPE=fused), x is the image tokens before the 3x3 CPE. The
//   forward runs k_cpe_rows once into a workspace and the chain on the CPE'd
//   rows (the residual is the CPE'd x, as on the TPU); the attention
//   backward recomputes them in k_qkv_wg's cpe mode (only the pre-CPE x is
//   saved), takes du = dt1x + LN1'^T da in fp32 from k_rowmm_wg (a launch
//   of its own for the image stream), then k_cpe_tap_grads (dtaps, dbias)
//   and the flipped-tap k_cpe_rows (dx = CPE^T du). One k_cpe_rows per
//   forward chain, rather than a CPE loader inside the products, which
//   recomputed each element's neighbourhood in every product and LayerNorm
//   pass that read it (2.3-2.8x slower in serving).
// Bound on the H100: operations for the products, bytes for the LayerNorm
// and row kernels. The forward's designs are block_tc.cuh's and
// attn_tc.cuh's (wgmma from TMA-fed weight tiles, mma.sync attention
// tiles; fp32 on FMA products of the same tiles), the backward's
// train_tc.cuh's. The weight gradients are split over row ranges into
// fp32 partials (no atomics: deterministic) and reduced. Every kernel here
// takes C <= 512 (block_tc.cuh::by_tier; the wrappers refuse more,
// attn/fused_train.py MAX_TRAIN_DIM).
#include "train_tc.cuh"

namespace lm {
namespace {

// p: 0 x, 1 c, 2 ones, 3 zeros, 4 wqkv', 5 bqkv', 6 wp, 7 bp, 8 w1', 9 b1',
//    10 w2, 11 b2, 12 dp (4, B) fp32 | 13 x_out, 14 c_out, 15 t1x, 16 t1c,
//    17 o_x, 18 o_c, 19 lse_x, 20 lse_c (fp32) | workspace 21 qkv_x,
//    22 qkv_c | the CPE or nulls: 23 taps (9, C), 24 bias (C,), workspace
//    25 the CPE'd x (B N, C). Images are img_w wide.
template <typename T>
int s_train_fwd(const void* const* p, int B, int N, int M, int C, int H,
                int hidden, int img_w, float scale, float eps,
                cudaStream_t s) {
  const void* x = p[0];
  int err;
  if (p[23]) {
    err = launch_cpe_rows<T, T>(p[0], p[23], p[24], mp<T>(p, 25), B * N, C,
                                img_w, N, 0, s);
    if (err) return err;
    x = p[25];
  }
  QkvArgs qa{};  // LN1 + qkv of both streams (the inference instance)
  qa.seg[0] = {x, p[4], p[5], mp<T>(p, 21), B * N};
  qa.seg[1] = {p[1], p[4], p[5], mp<T>(p, 22), B * M};
  qa.ln_w = p[2];
  qa.ln_b = p[3];
  qa.C = C;
  qa.eps = eps;
  err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  for (int si = 0; si < 2; ++si) {  // o and its log-sum-exp per stream
    const int n = si == 0 ? N : M;
    const T* qkv = cp<T>(p, 21 + si);
    AttnArgs aa{};
    aa.q = qkv;
    aa.k = qkv + C;
    aa.v = qkv + 2 * C;
    aa.out = mp<T>(p, 17 + si);
    aa.lse = fp(p, 19 + si);
    aa.ldq = 3 * C;
    aa.ldkv = 3 * C;
    aa.ldo = C;
    aa.batch = B;
    aa.heads = H;
    aa.nq = n;
    aa.nk = n;
    aa.scale = scale;
    err = launch_mhsa_tc<T>(aa, s);
    if (err) return err;
  }

  const float* dp = static_cast<const float*>(p[12]);
  TailArgs ta{};  // the training instance: s1 / s2, t1 out
  ta.seg[0] = {x, p[17], p[6], p[7], mp<T>(p, 13), B * N,
               dp, dp + B, N, mp<T>(p, 15)};
  ta.seg[1] = {p[1], p[18], p[6], p[7], mp<T>(p, 14), B * M,
               dp + 2 * B, dp + 3 * B, M, mp<T>(p, 16)};
  ta.ln_w = p[2];
  ta.ln_b = p[3];
  ta.w1 = p[8];
  ta.b1 = p[9];
  ta.w2 = p[10];
  ta.b2 = p[11];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail_tc<T>(ta, s);
}

// p: 0 t1x, 1 t1c, 2 dxo, 3 dco, 4 dzx, 5 dzc (= s2 dout), 6 w1', 7 b1',
//    8 w2^T (hidden, C), 9 w1'^T (C, hidden) | 10 dt1x, 11 dt1c,
//    12 dw1 (hidden, C), 13 db1, 14 dw2 (C, hidden) | workspace 15 mm_x,
//    16 mm_c (rows, C), 17 gg_x, 18 gg_c, 19 dy_x, 20 dy_c (rows, hidden),
//    21 partials (splits, 2 hidden C) fp32, 22 bias partials (splits,
//    hidden + C) | 23 db2 (C,). The image stream may have no rows (the C
//    block's MLP).
template <typename T>
int s_mlp_bwd(const void* const* p, int B, int N, int M, int C, int hidden,
              int rows_per_split, float eps, cudaStream_t s) {
  const int rows[2] = {B * N, B * M};
  MlpTcArgs ma{};
  for (int si = 0; si < 2; ++si)
    ma.seg[si] = {p[si], p[2 + si], mp<T>(p, 10 + si), mp<T>(p, 15 + si),
                  mp<T>(p, 17 + si), mp<T>(p, 19 + si), rows[si]};
  ma.b1 = p[7];
  ma.C = C;
  ma.hidden = hidden;
  ma.eps = eps;
  const void* const dz[2] = {p[4], p[5]};
  int err = launch_mlp_bwd_tc<T>(ma, dz, p[6], p[8], p[9], s);
  if (err) return err;

  WgTcArgs wa{};
  wa.nprod = 2;
  wa.rows[0] = rows[0];
  wa.rows[1] = rows[1];
  wa.rows_per_split = rows_per_split;
  const int splits =
      cdiv(rows[0], rows_per_split) + cdiv(rows[1], rows_per_split);
  float* part = fp(p, 21);
  float* part_b = fp(p, 22);
  // dW1 = dy^T LN2(t1), db1 = colsum(dy); dW2 = dz^T GELU(y), db2 =
  // colsum(dz)
  wa.prod[0] = {{p[19], p[20]}, {p[15], p[16]}, hidden, C, part, part_b,
                mp<T>(p, 12), mp<T>(p, 13)};
  wa.prod[1] = {{p[4], p[5]}, {p[17], p[18]}, C, hidden,
                part + (size_t)splits * hidden * C,
                part_b + (size_t)splits * hidden, mp<T>(p, 14),
                mp<T>(p, 23)};
  return launch_wgrad_tc<T>(wa, s);
}

// p: 0 x, 1 c, 2 dt1x, 3 dt1c, 4 dprojx, 5 dprojc (= s1 dt1), 6 wqkv',
//    7 bqkv', 8 wqkv'^T (C, 3C), 9 wp^T (C, C), 10 o_x, 11 o_c, 12 lse_x,
//    13 lse_c | 14 dx, 15 dc, 16 dwqkv (3C, C), 17 dbqkv, 18 dwp (C, C) |
//    workspace 19 a_x, 20 a_c (rows, C) the LN1 rows, 21 qkv_x, 22 qkv_c
//    (rows, 3C), 23 dO_x, 24 dO_c (rows, C), 25 D_x, 26 D_c (B H n) fp32,
//    27 dqkv_x, 28 dqkv_c (rows, 3C), 29 partials (splits, 4 C^2) fp32,
//    30 bias partials (splits, 4C) | the CPE or nulls: 31 taps (9, C),
//    32 bias (C,), workspace 33 the CPE'd x (B N, C), 34 du (B N, C) fp32,
//    35 partials (splits, 10, C) fp32, outputs 36 dtaps (9, C), 37 dbias
//    (C,) | 38 ones, 39 zeros (C,): LN1's affine (the weights come folded)
//    | 40 dbp (C,).
//    Images are img_w wide; cpe_rps: k_cpe_tap_grads' rows per block.
template <typename T>
int s_attn_bwd(const void* const* p, int B, int N, int M, int C, int H,
               int rows_per_split, int img_w, int cpe_rps, float scale,
               float eps, cudaStream_t s) {
  const int rows[2] = {B * N, B * M}, n[2] = {N, M};
  const TrainCpe cpe{p[31], p[32], img_w, N, cpe_rps};
  // LN1 (of the CPE'd x in the cpe mode) and qkv recomputed, the LN1 rows
  // written for dWqkv
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[6], p[7], mp<T>(p, 21), rows[0]};
  qa.seg[1] = {p[1], p[6], p[7], mp<T>(p, 22), rows[1]};
  qa.ln_w = p[38];
  qa.ln_b = p[39];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = Cpe{cpe.taps, cpe.bias, img_w, N};
  qa.xc = mp<T>(p, 33);
  qa.ln_out[0] = mp<T>(p, 19);
  qa.ln_out[1] = mp<T>(p, 20);
  if (cpe.taps && !qa.xc) return (int)cudaErrorInvalidValue;
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  // dO = dproj Wp in T, D = rowsum(dO . o) per head
  RowMmArgs ro{};
  for (int si = 0; si < 2; ++si)
    ro.seg[si] = {mp<T>(p, 23 + si), nullptr, nullptr, p[10 + si],
                  fp(p, 25 + si), rows[si], n[si], C};
  ro.C = C;
  ro.heads = H;
  ro.eps = eps;
  const void* const dproj[2] = {p[4], p[5]};
  const void* const wp_t[2] = {p[9], p[9]};
  err = launch_rowmm<T, kRowDo>(ro, dproj, wp_t, s);
  if (err) return err;

  for (int si = 0; si < 2; ++si) {  // dq / dk / dv: the thirds of dqkv
    const AttnBwdTc ab{p[21 + si], p[23 + si], fp(p, 12 + si),
                       fp(p, 25 + si), mp<T>(p, 27 + si), C, B, H, n[si],
                       scale};
    err = launch_attn_bwd_tc<T>(ab, s);
    if (err) return err;
  }

  // da = dqkv Wqkv' with the LN1 backward and dt1: dx, dc; in the cpe mode
  // du (fp32, at the CPE's output), then the CPE's backward
  RowMmArgs rl{};
  rl.seg[0] = {const_cast<void*>(cpe.taps ? p[34] : p[14]),
               cpe.taps ? p[33] : p[0], p[2], nullptr, nullptr, rows[0], N,
               3 * C};
  rl.seg[1] = {const_cast<void*>(p[15]), p[1], p[3], nullptr, nullptr,
               rows[1], M, 3 * C};
  rl.C = C;
  rl.heads = H;
  rl.eps = eps;
  const void* const dqkv[2] = {p[27], p[28]};
  const void* const wqkv_t[2] = {p[8], p[8]};
  if (cpe.taps) {
    RowMmArgs rx = rl, rc = rl;
    rx.seg[1].rows = 0;
    rc.seg[0].rows = 0;
    err = launch_rowmm<T, kRowLnF32>(rx, dqkv, wqkv_t, s);
    if (!err) err = launch_rowmm<T, kRowLn>(rc, dqkv, wqkv_t, s);
    if (!err)
      err = launch_cpe_bwd<T>(cpe, p[0], fp(p, 34), fp(p, 35), mp<T>(p, 36),
                              mp<T>(p, 37), mp<T>(p, 14), rows[0], C, s);
  } else {
    err = launch_rowmm<T, kRowLn>(rl, dqkv, wqkv_t, s);
  }
  if (err) return err;

  WgTcArgs wa{};
  wa.nprod = 2;
  wa.rows[0] = rows[0];
  wa.rows[1] = rows[1];
  wa.rows_per_split = rows_per_split;
  const int splits =
      cdiv(rows[0], rows_per_split) + cdiv(rows[1], rows_per_split);
  float* part = fp(p, 29);
  float* part_b = fp(p, 30);
  // dWqkv' = dqkv^T LN1(x), dbqkv = colsum(dqkv); dWp = dproj^T o, dbp =
  // colsum(dproj)
  wa.prod[0] = {{p[27], p[28]}, {p[19], p[20]}, 3 * C, C, part, part_b,
                mp<T>(p, 16), mp<T>(p, 17)};
  wa.prod[1] = {{p[4], p[5]}, {p[10], p[11]}, C, C,
                part + (size_t)splits * 3 * C * C,
                part_b + (size_t)splits * 3 * C, mp<T>(p, 18),
                mp<T>(p, 40)};
  return launch_wgrad_tc<T>(wa, s);
}

}  // namespace
}  // namespace lm

extern "C" int lm_s_train_fwd(int dtype, const void* const* p, int B, int N,
                              int M, int C, int H, int hidden, int img_w,
                              float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::s_train_fwd<float>(p, B, N, M, C, H, hidden, img_w, scale, eps,
                                  s);
  return lm::s_train_fwd<__nv_bfloat16>(p, B, N, M, C, H, hidden, img_w,
                                        scale, eps, s);
}

extern "C" int lm_mlp_bwd(int dtype, const void* const* p, int B, int N,
                            int M, int C, int hidden, int rows_per_split,
                            float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::s_mlp_bwd<float>(p, B, N, M, C, hidden, rows_per_split, eps, s);
  return lm::s_mlp_bwd<__nv_bfloat16>(p, B, N, M, C, hidden, rows_per_split,
                                      eps, s);
}

extern "C" int lm_s_attn_bwd(int dtype, const void* const* p, int B, int N,
                             int M, int C, int H, int rows_per_split,
                             int img_w, int cpe_rps, float scale, float eps,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::s_attn_bwd<float>(p, B, N, M, C, H, rows_per_split, img_w,
                                 cpe_rps, scale, eps, s);
  return lm::s_attn_bwd<__nv_bfloat16>(p, B, N, M, C, H, rows_per_split,
                                       img_w, cpe_rps, scale, eps, s);
}
