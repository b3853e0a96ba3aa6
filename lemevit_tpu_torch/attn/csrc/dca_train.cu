// Training of the pre-norm D block (LeMeViT's dual cross-attention stages
// 1-2, and D2 blocks through the caller's [Wq|Wq|Wv1] / [Wk|Wk|Wv2]
// weights): forward with per-image DropPath branch scales, and attention
// backward. Replaces lemevit_tpu/attn/pallas_train.py::dca_block_train
// (_dca_train_fwd_call with _dca_train_fwd_kernel, _dca_train_bwd_call with
// _dca_attn_bwd_kernel). Its MLP backward is s_train.cu's lm_mlp_bwd, as
// the TPU's is the shared _mlp_bwd_call.
//
// The weights come LN-folded (W' = W diag(gamma), b' = b + W beta for qkv1,
// qkv2 and fc1), so every LayerNorm runs without affine (ones / zeros where
// the inference launches take gamma / beta).
//
// lm_dca_train_fwd (row 12 of the TPU kernel table), on the tensor cores
//   (the inference D block's chain, dca_block.cu, in its training
//   instances): block_tc.cuh's k_qkv_wg for qkv1 = LN1(x) Wqkv1'^T + b and
//   qkv2 = LN1(c) Wqkv2'^T + b (each stream with its own weights; in the
//   cpe mode it stages each row block's CPE'd x once and writes it, the
//   tail's residual); attn_tc.cuh's k_dca_tc + k_dca_merge in their kLse
//   instance: one pass over each 128-row image tile serves both directions,
//   the x direction (image queries over the M meta keys) writes o_x and
//   each row's log-sum-exp, the c direction's per-tile partials merge in a
//   fixed order into o_c and its log-sum-exp; k_tail_wg's training
//   instance applies proj_x / proj_c per stream, the branch scales s1 / s2
//   and the shared MLP, and writes t1x / t1c. 4 launches; no atomics, so
//   two calls give the same bits.
// lm_dca_attn_bwd (row 13), on the tensor cores: block_tc.cuh's k_qkv_wg
//   (its LN1-rows instance, each stream with its own weights) recomputes
//   LN1, qkv1 and qkv2 and writes the LN1 rows; train_tc.cuh's k_rowmm_wg
//   (per-stream W maps) gives dO_x = (s1x dt1x) Wpx and dO_c = (s1c dt1c)
//   Wpc rounded to T with D = rowsum(dO . o) per head; k_dca_bwd_tc takes
//   both directions on mma.sync fragments (P rebuilt from the forward's
//   log-sum-exp, dO, P and dS rounded to T before their products): a CTA
//   per (image, head, range of image rows) writes dq1 / dk1 / dv1 of its
//   rows into dqkv1 and fp32 partials of dq2 / dk2 / dv2 (sums over N),
//   which k_dca_bwd_reduce adds in range order into dqkv2; k_rowmm_wg gives
//   da = dqkv Wqkv' per stream with dx = dt1x + LN1'^T da_x and dc = dt1c +
//   LN1'^T da_c in its epilogue; k_wgrad_tc + k_wgrad_tc_reduce, once per
//   stream, give dWqkv', dbqkv, dWp and dbp = colsum(s1 dt1) (left to XLA
//   on the TPU). 9 launches; no atomics, so two calls give the same bits.
// With a CPE (taps non-null), x is the image tokens before the 3x3 CPE:
//   the forward's k_qkv_wg stages the CPE'd rows (its cpe mode) and writes
//   them to a workspace, the tail's residual; the backward recomputes the
//   CPE'd rows in k_qkv_wg's cpe mode, takes du = dt1x + LN1'^T da_x in
//   fp32 from k_rowmm_wg, then k_cpe_tap_grads and the flipped-tap
//   k_cpe_rows (dx = CPE^T du). D2's weight permutation is unchanged.
// Bound on the H100: operations in the products (~24 C^2 a row in the
//   qkv, proj and MLP products), bytes in the attention backward (~4 M C
//   operations a row each way against its q, k, v, dO rows in and dq, dk,
//   dv rows out). Both phases' kernels and their designs are block_tc.cuh's,
//   attn_tc.cuh's and train_tc.cuh's, fp32 on FMA products of the same
//   tiles.
#include "train_tc.cuh"

namespace lm {
namespace {

// p: 0 x, 1 c, 2 ones, 3 zeros, 4 wqkv1', 5 bqkv1', 6 wqkv2', 7 bqkv2',
//    8 wpx, 9 bpx, 10 wpc, 11 bpc, 12 w1', 13 b1', 14 w2, 15 b2,
//    16 dp (4, B) fp32 | 17 x_out, 18 c_out, 19 t1x, 20 t1c, 21 o_x, 22 o_c,
//    23 lse_x (B H N), 24 lse_c (B H M) fp32 | workspace 25 qkv1 (B N, 3C),
//    26 qkv2 (B M, 3C), 27 pm, 28 pl (B H tiles M), 29 pacc (x 32) fp32,
//    tiles = ceil(N / TR), TR = 128 in bf16, 64 in fp32 | the CPE or nulls:
//    30 taps (9, C), 31 bias (C,), workspace 32 the CPE'd x (B N, C).
//    Images are img_w wide.
template <typename T>
int dca_train_fwd(const void* const* p, int B, int N, int M, int C, int H,
                  int hidden, int img_w, float scale_x, float scale_c,
                  float eps, cudaStream_t s) {
  // LN1 (of the CPE'd x, staged once per row block and written to the
  // workspace, in the cpe mode) and qkv1 / qkv2, each stream its weights
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[4], p[5], mp<T>(p, 25), B * N};
  qa.seg[1] = {p[1], p[6], p[7], mp<T>(p, 26), B * M};
  qa.ln_w = p[2];
  qa.ln_b = p[3];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = Cpe{p[30], p[31], img_w, N};
  qa.xc = mp<T>(p, 32);
  if (qa.cpe.taps && !qa.xc) return (int)cudaErrorInvalidValue;
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  // both directions with each row's log-sum-exp: the x direction's from
  // k_dca_tc, the c direction's from k_dca_merge after its fixed-order merge
  const T* qkv1 = cp<T>(p, 25);
  const T* qkv2 = cp<T>(p, 26);
  DcaArgs da{};
  da.q1 = qkv1;
  da.k1 = qkv1 + C;
  da.v1 = qkv1 + 2 * C;
  da.q2 = qkv2;
  da.k2 = qkv2 + C;
  da.v2 = qkv2 + 2 * C;
  da.xo = mp<T>(p, 21);
  da.co = mp<T>(p, 22);
  da.pm = fp(p, 27);
  da.pl = fp(p, 28);
  da.pacc = fp(p, 29);
  da.lse_x = fp(p, 23);
  da.lse_c = fp(p, 24);
  da.ld_q1 = da.ld_kv1 = da.ld_q2 = da.ld_kv2 = 3 * C;
  da.ldo = C;
  da.batch = B;
  da.heads = H;
  da.n = N;
  da.m = M;
  da.tiles = cdiv(N, DcaTile<T>::kRows);
  da.sl2x = scale_x * kLog2e;
  da.sl2c = scale_c * kLog2e;
  err = launch_dca_tc<T, true, true>(da, s);
  if (err) return err;

  // proj per stream, t1 = t + s1 (o Wp^T + bp) written, the shared LN2 +
  // MLP under s2
  const float* dp = static_cast<const float*>(p[16]);
  TailArgs ta{};
  ta.seg[0] = {qa.cpe.taps ? p[32] : p[0], p[21], p[8], p[9], mp<T>(p, 17),
               B * N, dp, dp + B, N, mp<T>(p, 19)};
  ta.seg[1] = {p[1], p[22], p[10], p[11], mp<T>(p, 18), B * M, dp + 2 * B,
               dp + 3 * B, M, mp<T>(p, 20)};
  ta.ln_w = p[2];
  ta.ln_b = p[3];
  ta.w1 = p[12];
  ta.b1 = p[13];
  ta.w2 = p[14];
  ta.b2 = p[15];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail_tc<T>(ta, s);
}

// p: 0 x, 1 c, 2 dt1x, 3 dt1c, 4 dprojx, 5 dprojc (= s1 dt1), 6 wqkv1',
//    7 bqkv1', 8 wqkv2', 9 bqkv2', 10 wqkv1'^T (C, 3C), 11 wqkv2'^T,
//    12 wpx^T (C, C), 13 wpc^T, 14 o_x, 15 o_c, 16 lse_x, 17 lse_c |
//    18 dx, 19 dc, 20 dwqkv1 (3C, C), 21 dbqkv1, 22 dwqkv2, 23 dbqkv2,
//    24 dwpx (C, C), 25 dbpx, 26 dwpc, 27 dbpc | workspace 28 a_x, 29 a_c
//    (rows, C) the LN1 rows, 30 qkv1, 31 qkv2 (rows, 3C), 32 dO_x, 33 dO_c
//    (rows, C), 34 D_x (B H N), 35 D_c (B H M) fp32, 36 dqkv1, 37 dqkv2
//    (rows, 3C), 38 the attention's partials (B H ranges Mp, 96) fp32,
//    39 weight partials (splits, 4 C^2) fp32, 40 bias partials (splits,
//    4C) | the CPE or nulls: 41 taps (9, C), 42 bias (C,), workspace 43 the
//    CPE'd x (B N, C), 44 du (B N, C) fp32, 45 partials (splits, 10, C)
//    fp32, outputs 46 dtaps (9, C), 47 dbias (C,) | 48 ones, 49 zeros (C,):
//    LN1's affine (the weights come folded). rps_x / rps_c: k_wgrad_tc's
//    rows per split over the B N image rows and the B M meta rows; chunks:
//    k_dca_bwd_tc's row chunks per range; images are img_w wide; cpe_rps:
//    k_cpe_tap_grads' rows per block.
template <typename T>
int dca_attn_bwd(const void* const* p, int B, int N, int M, int C, int H,
                 int rps_x, int rps_c, int chunks, int img_w, int cpe_rps,
                 float scale_x, float scale_c, float eps, cudaStream_t s) {
  const int rows[2] = {B * N, B * M}, n[2] = {N, M};
  const TrainCpe cpe{p[41], p[42], img_w, N, cpe_rps};
  // LN1 (of the CPE'd x in the cpe mode) and qkv1 / qkv2 recomputed, each
  // stream with its own weights, the LN1 rows written for dWqkv
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[6], p[7], mp<T>(p, 30), rows[0]};
  qa.seg[1] = {p[1], p[8], p[9], mp<T>(p, 31), rows[1]};
  qa.ln_w = p[48];
  qa.ln_b = p[49];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = Cpe{cpe.taps, cpe.bias, img_w, N};
  qa.xc = mp<T>(p, 43);
  qa.ln_out[0] = mp<T>(p, 28);
  qa.ln_out[1] = mp<T>(p, 29);
  if (cpe.taps && !qa.xc) return (int)cudaErrorInvalidValue;
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  // dO = dproj Wp per stream in T, D = rowsum(dO . o) per head
  RowMmArgs ro{};
  for (int si = 0; si < 2; ++si)
    ro.seg[si] = {mp<T>(p, 32 + si), nullptr, nullptr, p[14 + si],
                  fp(p, 34 + si), rows[si], n[si], C};
  ro.C = C;
  ro.heads = H;
  ro.eps = eps;
  const void* const dproj[2] = {p[4], p[5]};
  const void* const wp_t[2] = {p[12], p[13]};
  err = launch_rowmm<T, kRowDo>(ro, dproj, wp_t, s);
  if (err) return err;

  // both directions: dq1 / dk1 / dv1 into dqkv1, dq2 / dk2 / dv2 into
  // dqkv2 through the ranges' partials
  DcaBwdTc ab{};
  ab.qkv1 = p[30];
  ab.qkv2 = p[31];
  ab.dO1 = p[32];
  ab.dO2 = p[33];
  ab.lse1 = fp(p, 16);
  ab.D1 = fp(p, 34);
  ab.lse2 = fp(p, 17);
  ab.D2 = fp(p, 35);
  ab.dqkv1 = mp<T>(p, 36);
  ab.dqkv2 = mp<T>(p, 37);
  ab.part = fp(p, 38);
  ab.C = C;
  ab.batch = B;
  ab.heads = H;
  ab.n = N;
  ab.m = M;
  ab.chunks = chunks;
  ab.ranges = cdiv(cdiv(N, DcaBwdTile<T>::kRows), chunks);
  ab.scale_x = scale_x;
  ab.scale_c = scale_c;
  err = launch_dca_bwd_tc<T>(ab, s);
  if (err) return err;

  // da = dqkv Wqkv' per stream with the LN1 backward and dt1: dx, dc; in
  // the cpe mode du (fp32, at the CPE's output), then the CPE's backward
  RowMmArgs rl{};
  rl.seg[0] = {const_cast<void*>(cpe.taps ? p[44] : p[18]),
               cpe.taps ? p[43] : p[0], p[2], nullptr, nullptr, rows[0], N,
               3 * C};
  rl.seg[1] = {const_cast<void*>(p[19]), p[1], p[3], nullptr, nullptr,
               rows[1], M, 3 * C};
  rl.C = C;
  rl.heads = H;
  rl.eps = eps;
  const void* const dqkv[2] = {p[36], p[37]};
  const void* const wqkv_t[2] = {p[10], p[11]};
  if (cpe.taps) {
    RowMmArgs rx = rl, rc = rl;
    rx.seg[1].rows = 0;
    rc.seg[0].rows = 0;
    err = launch_rowmm<T, kRowLnF32>(rx, dqkv, wqkv_t, s);
    if (!err) err = launch_rowmm<T, kRowLn>(rc, dqkv, wqkv_t, s);
    if (!err)
      err = launch_cpe_bwd<T>(cpe, p[0], fp(p, 44), fp(p, 45), mp<T>(p, 46),
                              mp<T>(p, 47), mp<T>(p, 18), rows[0], C, s);
  } else {
    err = launch_rowmm<T, kRowLn>(rl, dqkv, wqkv_t, s);
  }
  if (err) return err;

  // The streams have their own weights: one k_wgrad_tc launch per stream,
  // each with dWqkv' = dqkv^T LN1(t), dbqkv = colsum(dqkv), dWp = dproj^T
  // o and dbp = colsum(dproj) (left to XLA on the TPU).
  const int rps[2] = {rps_x, rps_c};
  for (int si = 0; si < 2; ++si) {
    WgTcArgs wa{};
    wa.nprod = 2;
    wa.rows[0] = rows[si];
    wa.rows_per_split = rps[si];
    const int splits = cdiv(rows[si], rps[si]);
    float* part = fp(p, 39);
    float* part_b = fp(p, 40);
    wa.prod[0] = {{p[36 + si], nullptr}, {p[28 + si], nullptr}, 3 * C, C,
                  part, part_b, mp<T>(p, 20 + 2 * si), mp<T>(p, 21 + 2 * si)};
    wa.prod[1] = {{p[4 + si], nullptr}, {p[14 + si], nullptr}, C, C,
                  part + (size_t)splits * 3 * C * C,
                  part_b + (size_t)splits * 3 * C, mp<T>(p, 24 + 2 * si),
                  mp<T>(p, 25 + 2 * si)};
    err = launch_wgrad_tc<T>(wa, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace
}  // namespace lm

extern "C" int lm_dca_train_fwd(int dtype, const void* const* p, int B,
                                int N, int M, int C, int H, int hidden,
                                int img_w, float scale_x, float scale_c,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_train_fwd<float>(p, B, N, M, C, H, hidden, img_w, scale_x,
                                    scale_c, eps, s);
  return lm::dca_train_fwd<__nv_bfloat16>(p, B, N, M, C, H, hidden, img_w,
                                          scale_x, scale_c, eps, s);
}

extern "C" int lm_dca_attn_bwd(int dtype, const void* const* p, int B, int N,
                               int M, int C, int H, int rps_x, int rps_c,
                               int chunks, int img_w, int cpe_rps,
                               float scale_x, float scale_c, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_attn_bwd<float>(p, B, N, M, C, H, rps_x, rps_c, chunks,
                                   img_w, cpe_rps, scale_x, scale_c, eps, s);
  return lm::dca_attn_bwd<__nv_bfloat16>(p, B, N, M, C, H, rps_x, rps_c,
                                         chunks, img_w, cpe_rps, scale_x,
                                         scale_c, eps, s);
}
