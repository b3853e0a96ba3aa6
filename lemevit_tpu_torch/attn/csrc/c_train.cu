// Training of the pre-norm C block (stage 0 of LeMeViT): the M meta tokens
// attend to the N image tokens; only c is produced, and x passes the block
// unchanged but gets gradients through the k / v projection. Forward with
// per-image DropPath branch scales, and attention backward. Replaces
// lemevit_tpu/attn/pallas_train.py::c_block_train (_c_train_fwd_call with
// _c_train_fwd_kernel, _c_train_bwd_call with _c_attn_bwd_kernel). The C
// block's MLP backward (B M meta rows only, plain XLA on the TPU) is
// s_train.cu's lm_mlp_bwd with an empty image stream.
//
// The weights come LN-folded (W' = W diag(gamma), b' = b + W beta for q,
// kv and fc1), so every LayerNorm runs without affine (ones / zeros where
// the launches take gamma / beta).
//
// lm_c_train_fwd (row 14 of the TPU kernel table), on the tensor cores
//   (the inference C block's chain, c_block.cu, in its training
//   instances): block_tc.cuh's k_qkv_wg, two streams of different widths,
//   kv = LN1(x) Wkv'^T + bkv' (2C columns, the image rows) and q = LN1(c)
//   Wq'^T + bq' (C columns, the meta rows); attn_tc.cuh's k_dca_tc + the
//   log-sum-exp instance of k_dca_merge for the c direction alone (meta
//   queries over the image keys, in chunks of up to 256 meta rows a CTA,
//   so any M fits): a CTA reads 128 image rows of k / v once, in place in
//   the kv workspace, the per-tile partials merge in a fixed order into o
//   and each meta row's log-sum-exp; k_tail_wg's training instance on the
//   meta rows alone (s1c = dp[2], s2c = dp[3]) writes t1c and the new c.
//   4 launches; no atomics, so two calls give the same bits.
// lm_c_attn_bwd (row 15), on the tensor cores: k_qkv_wg's LN1-rows
//   instance recomputes kv and q (two widths) and writes the LN1 rows a_x /
//   a_c; train_tc.cuh's k_rowmm_wg on the meta rows gives dO = (s1c dt1c)
//   Wp rounded to T with D = rowsum(dO . o) per head; the c-direction
//   instance of k_dca_bwd_tc (P rebuilt from the forward's log-sum-exp, dO,
//   P and dS rounded to T before their products) writes dk / dv of each
//   image row into dkv and an fp32 partial of dq per range of image rows,
//   which k_dca_bwd_reduce adds in range order into dq; k_rowmm_wg, each
//   stream its depth (2C, C), gives dxt = LN1'(x)^T (dkv Wkv') with no
//   residual (x passes the block; autograd adds its identity gradient
//   outside) and dc = dt1c + LN1'(c)^T (dq Wq'); k_wgrad_tc +
//   k_wgrad_tc_reduce, once per stream, give dWkv', dbkv over the B N
//   image rows, and dWq', dbq from (dq, LN1(c)) and dWp, dbp = colsum(s1c
//   dt1c) (left to XLA on the TPU) over the B M meta rows. 9 launches; no
//   atomics, so two calls give the same bits.
// With a CPE (taps non-null), x is the image tokens before the 3x3 CPE,
//   which feeds the k / v side only (the TPU's _c_train_fwd_kernel): the
//   forward's k_qkv_wg stages each image row block's CPE'd rows once and
//   writes nothing CPE'd; the backward's writes them to a workspace (the LN
//   backward reads them), takes du = LN1'^T (dkv Wkv') in fp32 (still no
//   residual), then k_cpe_tap_grads and the flipped-tap k_cpe_rows: dxt =
//   CPE^T du, to which autograd adds x's identity gradient outside. 4 and
//   13 launches.
// Bound on the H100: bytes. Each image row is read once and costs ~4 C^2
// operations (the kv projection), 2 C operations per byte of bf16 input:
// 128 at C = 64, below the card's bf16 line of ~295. kv (twice x) and dkv
// round-trip through device memory; bf16 and fp32 run the same kernels,
// fp32 on FMA products of the same tiles.
#include "train_tc.cuh"

namespace lm {
namespace {

// p: 0 x, 1 c, 2 ones, 3 zeros, 4 wq', 5 bq', 6 wkv', 7 bkv', 8 wp, 9 bp,
//    10 w1', 11 b1', 12 w2, 13 b2, 14 dp (4, B) fp32 | 15 c_out, 16 t1c,
//    17 o (B M, C), 18 lse (B H M) fp32 | workspace 19 q (B M, C),
//    20 kv (B N, 2C), 21 pm, 22 pl (B H tiles M), 23 pacc (x 32) fp32,
//    tiles = ceil(N / TR), TR = 128 in bf16, 64 in fp32 | the CPE or
//    nulls: 24 taps (9, C), 25 bias (C,). Images are img_w wide.
template <typename T>
int c_train_fwd(const void* const* p, int B, int N, int M, int C, int H,
                int hidden, int img_w, float scale, float eps,
                cudaStream_t s) {
  // kv (the CPE'd image rows' in the cpe mode) and q, each stream its
  // weights and width
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[6], p[7], mp<T>(p, 20), B * N, 2 * C};
  qa.seg[1] = {p[1], p[4], p[5], mp<T>(p, 19), B * M, C};
  qa.ln_w = p[2];
  qa.ln_b = p[3];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = Cpe{p[24], p[25], img_w, N};
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  // the c direction alone with each meta row's log-sum-exp
  const T* kv = cp<T>(p, 20);
  DcaArgs da{};
  da.k1 = kv;
  da.v1 = kv + C;
  da.q2 = p[19];
  da.co = mp<T>(p, 17);
  da.pm = fp(p, 21);
  da.pl = fp(p, 22);
  da.pacc = fp(p, 23);
  da.lse_c = fp(p, 18);
  da.ld_kv1 = 2 * C;
  da.ld_q2 = C;
  da.ldo = C;
  da.batch = B;
  da.heads = H;
  da.n = N;
  da.m = M;
  da.tiles = cdiv(N, DcaTile<T>::kRows);
  da.sl2c = scale * kLog2e;
  err = launch_dca_tc<T, false, true>(da, s);
  if (err) return err;

  // the meta rows alone: t1c = c + s1c (o Wp^T + bp) written, the new c =
  // t1c + s2c MLP(LN2(t1c))
  const float* dp = static_cast<const float*>(p[14]);
  TailArgs ta{};
  ta.seg[0] = {p[1], p[17], p[8], p[9], mp<T>(p, 15), B * M, dp + 2 * B,
               dp + 3 * B, M, mp<T>(p, 16)};
  ta.seg[1] = ta.seg[0];  // no second stream (its TMA map stays valid)
  ta.seg[1].rows = 0;
  ta.ln_w = p[2];
  ta.ln_b = p[3];
  ta.w1 = p[10];
  ta.b1 = p[11];
  ta.w2 = p[12];
  ta.b2 = p[13];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail_tc<T>(ta, s);
}

// p: 0 x, 1 c, 2 dt1c, 3 dprojc (= s1c dt1c), 4 wq', 5 bq', 6 wkv', 7 bkv',
//    8 wq'^T (C, C), 9 wkv'^T (C, 2C), 10 wp^T (C, C), 11 o, 12 lse |
//    13 dxt, 14 dc, 15 dwq (C, C), 16 dbq, 17 dwkv (2C, C), 18 dbkv,
//    19 dwp (C, C), 20 dbp | workspace 21 a_x (B N, C), 22 a_c (B M, C)
//    the LN1 rows, 23 kv (B N, 2C), 24 q (B M, C), 25 dO (B M, C),
//    26 D (B H M) fp32, 27 dkv (B N, 2C), 28 dq (B M, C), 29 the
//    attention's partials (B H ranges Mp, 32) fp32, 30 weight partials
//    (splits, 2 C^2) fp32, 31 bias partials (splits, 2C) | the CPE or
//    nulls: 32 taps (9, C), 33 bias (C,), workspace 34 the CPE'd x (B N,
//    C), 35 du (B N, C) fp32, 36 partials (splits, 10, C) fp32, outputs
//    37 dtaps (9, C), 38 dbias (C,) | 39 ones, 40 zeros (C,): LN1's affine
//    (the weights come folded). rps_x / rps_c: k_wgrad_tc's rows per split
//    over the B N image rows and the B M meta rows; chunks: k_dca_bwd_tc's
//    row chunks per range; images are img_w wide; cpe_rps:
//    k_cpe_tap_grads' rows per block.
template <typename T>
int c_attn_bwd(const void* const* p, int B, int N, int M, int C, int H,
               int rps_x, int rps_c, int chunks, int img_w, int cpe_rps,
               float scale, float eps, cudaStream_t s) {
  const int rows[2] = {B * N, B * M};
  const TrainCpe cpe{p[32], p[33], img_w, N, cpe_rps};
  // LN1 (of the CPE'd x in the cpe mode, written for the LN backward), kv
  // and q recomputed, the LN1 rows written for dWkv and dWq
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[6], p[7], mp<T>(p, 23), rows[0], 2 * C};
  qa.seg[1] = {p[1], p[4], p[5], mp<T>(p, 24), rows[1], C};
  qa.ln_w = p[39];
  qa.ln_b = p[40];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = Cpe{cpe.taps, cpe.bias, img_w, N};
  qa.xc = cpe.taps ? mp<T>(p, 34) : nullptr;
  qa.ln_out[0] = mp<T>(p, 21);
  qa.ln_out[1] = mp<T>(p, 22);
  if (cpe.taps && !qa.xc) return (int)cudaErrorInvalidValue;
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  // dO = dproj Wp in T, D = rowsum(dO . o) per head: the meta rows alone
  RowMmArgs ro{};
  ro.seg[0] = {mp<T>(p, 25), nullptr, nullptr, p[11], fp(p, 26), rows[1],
               M, C};
  ro.seg[1] = ro.seg[0];
  ro.seg[1].rows = 0;
  ro.C = C;
  ro.heads = H;
  ro.eps = eps;
  const void* const dproj[2] = {p[3], p[3]};
  const void* const wp_t[2] = {p[10], p[10]};
  err = launch_rowmm<T, kRowDo>(ro, dproj, wp_t, s);
  if (err) return err;

  // the c direction: dk / dv into dkv, dq through the ranges' partials
  DcaBwdTc ab{};
  ab.qkv1 = p[23];
  ab.qkv2 = p[24];
  ab.dO2 = p[25];
  ab.lse2 = fp(p, 12);
  ab.D2 = fp(p, 26);
  ab.dqkv1 = mp<T>(p, 27);
  ab.dqkv2 = mp<T>(p, 28);
  ab.part = fp(p, 29);
  ab.C = C;
  ab.batch = B;
  ab.heads = H;
  ab.n = N;
  ab.m = M;
  ab.chunks = chunks;
  ab.ranges = cdiv(cdiv(N, DcaBwdTile<T, false>::kRows), chunks);
  ab.scale_c = scale;
  err = launch_dca_bwd_tc<T, false>(ab, s);
  if (err) return err;

  // dxt = LN1'(x)^T (dkv Wkv'), no residual (in the cpe mode du, fp32, at
  // the CPE's output, then the CPE's backward); dc = dt1c + LN1'(c)^T (dq
  // Wq'). The streams' depths differ: 2C and C.
  RowMmArgs rl{};
  rl.seg[0] = {const_cast<void*>(cpe.taps ? p[35] : p[13]),
               cpe.taps ? p[34] : p[0], nullptr, nullptr, nullptr, rows[0],
               N, 2 * C};
  rl.seg[1] = {const_cast<void*>(p[14]), p[1], p[2], nullptr, nullptr,
               rows[1], M, C};
  rl.C = C;
  rl.heads = H;
  rl.eps = eps;
  const void* const dout[2] = {p[27], p[28]};
  const void* const w_t[2] = {p[9], p[8]};
  if (cpe.taps) {
    RowMmArgs rx = rl, rc = rl;
    rx.seg[1].rows = 0;
    rc.seg[0].rows = 0;
    err = launch_rowmm<T, kRowLnF32>(rx, dout, w_t, s);
    if (!err) err = launch_rowmm<T, kRowLn>(rc, dout, w_t, s);
    if (!err)
      err = launch_cpe_bwd<T>(cpe, p[0], fp(p, 35), fp(p, 36), mp<T>(p, 37),
                              mp<T>(p, 38), mp<T>(p, 13), rows[0], C, s);
  } else {
    err = launch_rowmm<T, kRowLn>(rl, dout, w_t, s);
  }
  if (err) return err;

  // One k_wgrad_tc launch per stream (their rows and products differ):
  // the image rows' dWkv' = dkv^T LN1(x), dbkv = colsum(dkv); the meta
  // rows' dWq' = dq^T LN1(c), dbq = colsum(dq), dWp = dproj^T o and dbp =
  // colsum(dproj). The two launches share the partials' workspace in turn.
  float* part = fp(p, 30);
  float* part_b = fp(p, 31);
  WgTcArgs wx{};
  wx.nprod = 1;
  wx.rows[0] = rows[0];
  wx.rows_per_split = rps_x;
  wx.prod[0] = {{p[27], nullptr}, {p[21], nullptr}, 2 * C, C, part, part_b,
                mp<T>(p, 17), mp<T>(p, 18)};
  err = launch_wgrad_tc<T>(wx, s);
  if (err) return err;
  const int splits_c = cdiv(rows[1], rps_c);
  WgTcArgs wc{};
  wc.nprod = 2;
  wc.rows[0] = rows[1];
  wc.rows_per_split = rps_c;
  wc.prod[0] = {{p[28], nullptr}, {p[22], nullptr}, C, C, part, part_b,
                mp<T>(p, 15), mp<T>(p, 16)};
  wc.prod[1] = {{p[3], nullptr}, {p[11], nullptr}, C, C,
                part + (size_t)splits_c * C * C, part_b + (size_t)splits_c * C,
                mp<T>(p, 19), mp<T>(p, 20)};
  return launch_wgrad_tc<T>(wc, s);
}

}  // namespace
}  // namespace lm

extern "C" int lm_c_train_fwd(int dtype, const void* const* p, int B, int N,
                              int M, int C, int H, int hidden, int img_w,
                              float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::c_train_fwd<float>(p, B, N, M, C, H, hidden, img_w, scale, eps,
                                  s);
  return lm::c_train_fwd<__nv_bfloat16>(p, B, N, M, C, H, hidden, img_w,
                                        scale, eps, s);
}

extern "C" int lm_c_attn_bwd(int dtype, const void* const* p, int B, int N,
                             int M, int C, int H, int rps_x, int rps_c,
                             int chunks, int img_w, int cpe_rps, float scale,
                             float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::c_attn_bwd<float>(p, B, N, M, C, H, rps_x, rps_c, chunks,
                                 img_w, cpe_rps, scale, eps, s);
  return lm::c_attn_bwd<__nv_bfloat16>(p, B, N, M, C, H, rps_x, rps_c, chunks,
                                       img_w, cpe_rps, scale, eps, s);
}
