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
// lm_dca_train_fwd (row 12 of the TPU kernel table): one k_linear_ln for
//   qkv1 = LN1(x) Wqkv1'^T + b and qkv2 = LN1(c) Wqkv2'^T + b; the x
//   direction (image queries over the 16 meta keys, one split) writes o_x
//   and its log-sum-exp; the c direction (meta queries over the N image
//   keys, split over blocks and merged by k_attn_combine) writes o_c and
//   its log-sum-exp; k_block_tail applies proj_x / proj_c per stream, the
//   branch scales s1 / s2 and the shared MLP, and writes t1x / t1c.
// lm_dca_attn_bwd (row 13): LN1, qkv1 and qkv2 recomputed; dO_x =
//   (s1x dt1x) Wpx and dO_c = (s1c dt1c) Wpc; the x-direction backward
//   writes dq1 into dqkv1's q third and dk2 / dv2 into dqkv2's k / v
//   thirds, the c direction dq2 into dqkv2 and dk1 / dv1 into dqkv1, so
//   each third is written once; da = dqkv Wqkv' per stream; k_ln_bwd gives
//   dx = dt1x + LN1'^T da_x and dc = dt1c + LN1'^T da_c; k_wgrad gives
//   dWqkv1, dbqkv1 (B N rows), dWqkv2, dbqkv2 (B M rows), dWpx from
//   (o_x, s1x dt1x) and dWpc from (o_c, s1c dt1c). dbpx / dbpc are column
//   sums left to the caller, as the TPU wrapper leaves them to XLA.
// With a CPE (taps non-null), x is the image tokens before the 3x3 CPE and
//   both chains run it as s_train.cu's do: k_cpe_rows once into a workspace
//   (the forward's residual is the CPE'd x), and in the backward du =
//   dt1x + LN1'^T da_x in fp32, k_cpe_tap_grads and the flipped-tap
//   k_cpe_rows (dx = CPE^T du). D2's weight permutation is unchanged.
// Bound on the H100: operations. A row costs ~24 C^2 operations in the
// qkv, proj and MLP products and ~4 M C in attention (16 keys or queries
// each way). The products are block_common.cuh's tiled mma.sync (bf16) or
// FMA (fp32); the attention backward is fp32 FMA, one lane per head
// channel. The x direction's dk2 / dv2 (16 keys, each a sum over N
// queries) runs as B H blocks that each walk all N queries.
#include "train_common.cuh"

namespace lm {
namespace {

// p: 0 x, 1 c, 2 ones, 3 zeros, 4 wqkv1', 5 bqkv1', 6 wqkv2', 7 bqkv2',
//    8 wpx, 9 bpx, 10 wpc, 11 bpc, 12 w1', 13 b1', 14 w2, 15 b2,
//    16 dp (4, B) fp32 | 17 x_out, 18 c_out, 19 t1x, 20 t1c, 21 o_x, 22 o_c,
//    23 lse_x (B H N), 24 lse_c (B H M) fp32 | workspace 25 qkv1 (B N, 3C),
//    26 qkv2 (B M, 3C), 27 pm, 28 pl (B H splits M), 29 pacc (x 32) fp32 |
//    the CPE or nulls: 30 taps (9, C), 31 bias (C,), workspace 32 the CPE'd
//    x (B N, C). Images are img_w wide.
template <typename T>
int dca_train_fwd(const void* const* p, int B, int N, int M, int C, int H,
                  int hidden, int keys_per_split, int img_w, float scale_x,
                  float scale_c, float eps, cudaStream_t s) {
  const void* x = p[0];
  int err;
  if (p[30]) {
    err = launch_cpe_rows<T, T>(p[0], p[30], p[31], mp<T>(p, 32), B * N, C,
                                img_w, N, 0, s);
    if (err) return err;
    x = p[32];
  }
  LinArgs la{};
  la.seg[0] = {x, p[4], p[5], mp<T>(p, 25), B * N, 3 * C};
  la.seg[1] = {p[1], p[6], p[7], mp<T>(p, 26), B * M, 3 * C};
  la.row_blocks0 = cdiv(B * N, kLinBM);
  la.ln_w = p[2];
  la.ln_b = p[3];
  la.K = C;
  la.eps = eps;
  err = launch_linear<T>(la, 3 * C, s);
  if (err) return err;

  const T* qkv1 = cp<T>(p, 25);
  const T* qkv2 = cp<T>(p, 26);
  AttnArgs ax{};  // x direction: image queries against the meta keys
  ax.q = qkv1;
  ax.k = qkv2 + C;
  ax.v = qkv2 + 2 * C;
  ax.out = mp<T>(p, 21);
  ax.lse = fp(p, 23);
  ax.ldq = ax.ldkv = 3 * C;
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

  AttnArgs ac{};  // c direction: meta queries against the image keys
  ac.q = qkv2;
  ac.k = qkv1 + C;
  ac.v = qkv1 + 2 * C;
  ac.out = mp<T>(p, 22);
  ac.lse = fp(p, 24);
  ac.pm = fp(p, 27);
  ac.pl = fp(p, 28);
  ac.pacc = fp(p, 29);
  ac.ldq = ac.ldkv = 3 * C;
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

  const float* dp = static_cast<const float*>(p[16]);
  TailArgs ta{};
  ta.seg[0] = {x, p[21], p[8], p[9], mp<T>(p, 17), B * N,
               dp, dp + B, N, mp<T>(p, 19)};
  ta.seg[1] = {p[1], p[22], p[10], p[11], mp<T>(p, 18), B * M,
               dp + 2 * B, dp + 3 * B, M, mp<T>(p, 20)};
  ta.row_blocks0 = cdiv(B * N, kTailBM);
  ta.ln_w = p[2];
  ta.ln_b = p[3];
  ta.w1 = p[12];
  ta.b1 = p[13];
  ta.w2 = p[14];
  ta.b2 = p[15];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail<T>(ta, s);
}

// p: 0 x, 1 c, 2 dt1x, 3 dt1c, 4 dprojx, 5 dprojc (= s1 dt1), 6 wqkv1',
//    7 bqkv1', 8 wqkv2', 9 bqkv2', 10 wqkv1'^T (C, 3C), 11 wqkv2'^T,
//    12 wpx^T (C, C), 13 wpc^T, 14 o_x, 15 o_c, 16 lse_x, 17 lse_c |
//    18 dx, 19 dc, 20 dwqkv1 (3C, C), 21 dbqkv1, 22 dwqkv2, 23 dbqkv2,
//    24 dwpx (C, C), 25 dwpc | workspace 26 a_x, 27 a_c (rows, C),
//    28 qkv1, 29 qkv2 (rows, 3C), 30 dO_x, 31 dO_c (rows, C) fp32,
//    32 D_x (B H N), 33 D_c (B H M) fp32, 34 dqkv1, 35 dqkv2 (rows, 3C),
//    36 da_x, 37 da_c (rows, C) fp32, 38 partials (splits, 3 C^2) fp32,
//    39 bias partials (splits, 3C) fp32 | the CPE or nulls: 40 taps (9, C),
//    41 bias (C,), workspace 42 the CPE'd x (B N, C), 43 du (B N, C) fp32,
//    44 partials (splits, 10, C) fp32, outputs 45 dtaps (9, C), 46 dbias
//    (C,). rps_x / rps_c: k_wgrad's rows per split over the B N image rows
//    and the B M meta rows; images are img_w wide; cpe_rps:
//    k_cpe_tap_grads' rows per block.
template <typename T>
int dca_attn_bwd(const void* const* p, int B, int N, int M, int C, int H,
                 int rps_x, int rps_c, int img_w, int cpe_rps, float scale_x,
                 float scale_c, float eps, cudaStream_t s) {
  const int rows[2] = {B * N, B * M};
  const TrainCpe cpe{p[40], p[41], img_w, N, cpe_rps};
  const void* xs[2] = {p[0], p[1]};  // the rows LN1 reads
  int err;
  if (cpe.taps) {
    err = launch_cpe_rows<T, T>(p[0], cpe.taps, cpe.bias, mp<T>(p, 42),
                                rows[0], C, img_w, N, 0, s);
    if (err) return err;
    xs[0] = p[42];
  }
  for (int si = 0; si < 2; ++si) {
    err = launch_ln_rows<T>(xs[si], mp<T>(p, 26 + si), rows[si], C, eps, s);
    if (err) return err;
  }
  LinArgs la{};  // qkv1 = LN1(x) Wqkv1'^T + b, qkv2 = LN1(c) Wqkv2'^T + b
  la.seg[0] = {p[26], p[6], p[7], mp<T>(p, 28), rows[0], 3 * C};
  la.seg[1] = {p[27], p[8], p[9], mp<T>(p, 29), rows[1], 3 * C};
  la.row_blocks0 = cdiv(rows[0], kLinBM);
  la.K = C;
  la.eps = eps;
  la.plain_a = 1;
  err = launch_linear<T>(la, 3 * C, s);
  if (err) return err;

  LinArgs lo{};  // dO = dproj Wp per stream, fp32
  lo.seg[0] = {p[4], p[12], nullptr, fp(p, 30), rows[0], C};
  lo.seg[1] = {p[5], p[13], nullptr, fp(p, 31), rows[1], C};
  lo.row_blocks0 = cdiv(rows[0], kLinBM);
  lo.K = C;
  lo.plain_a = 1;
  lo.out_f32 = 1;
  err = launch_linear<T>(lo, C, s);
  if (err) return err;

  const T* qkv1 = cp<T>(p, 28);
  const T* qkv2 = cp<T>(p, 29);
  T* dqkv1 = mp<T>(p, 34);
  T* dqkv2 = mp<T>(p, 35);
  AttnBwdArgs ab{};  // x direction: q1 against k2 / v2
  ab.q = qkv1;
  ab.k = qkv2 + C;
  ab.v = qkv2 + 2 * C;
  ab.o = p[14];
  ab.dO = fp(p, 30);
  ab.lse = fp(p, 16);
  ab.D = fp(p, 32);
  ab.dq = dqkv1;
  ab.dk = dqkv2 + C;
  ab.dv = dqkv2 + 2 * C;
  ab.ldq = ab.ldkv = ab.lddq = ab.lddkv = 3 * C;
  ab.ldo = C;
  ab.batch = B;
  ab.heads = H;
  ab.nq = N;
  ab.nk = M;
  ab.C = C;
  ab.scale = scale_x;
  err = launch_attn_bwd<T>(ab, s);
  if (err) return err;
  ab.q = qkv2;  // c direction: q2 against k1 / v1
  ab.k = qkv1 + C;
  ab.v = qkv1 + 2 * C;
  ab.o = p[15];
  ab.dO = fp(p, 31);
  ab.lse = fp(p, 17);
  ab.D = fp(p, 33);
  ab.dq = dqkv2;
  ab.dk = dqkv1 + C;
  ab.dv = dqkv1 + 2 * C;
  ab.nq = M;
  ab.nk = N;
  ab.scale = scale_c;
  err = launch_attn_bwd<T>(ab, s);
  if (err) return err;

  LinArgs ld{};  // da = dqkv Wqkv' per stream, fp32
  ld.seg[0] = {p[34], p[10], nullptr, fp(p, 36), rows[0], C};
  ld.seg[1] = {p[35], p[11], nullptr, fp(p, 37), rows[1], C};
  ld.row_blocks0 = cdiv(rows[0], kLinBM);
  ld.K = 3 * C;
  ld.plain_a = 1;
  ld.out_f32 = 1;
  err = launch_linear<T>(ld, C, s);
  if (err) return err;
  for (int si = 0; si < 2; ++si) {
    if (si == 0 && cpe.taps) {  // du in fp32, then the CPE's backward
      err = launch_ln_bwd<T, float>(xs[0], fp(p, 36), p[2], fp(p, 43),
                                    rows[0], C, eps, s);
      if (!err)
        err = launch_cpe_bwd<T>(cpe, p[0], fp(p, 43), fp(p, 44),
                                mp<T>(p, 45), mp<T>(p, 46), mp<T>(p, 18),
                                rows[0], C, s);
    } else {
      err = launch_ln_bwd<T>(xs[si], fp(p, 36 + si), p[2 + si],
                             mp<T>(p, 18 + si), rows[si], C, eps, s);
    }
    if (err) return err;
  }

  // The two streams have their own projection weights, so each weight
  // gradient is one stream's product (a single segment).
  const int rps[2] = {rps_x, rps_c};
  for (int si = 0; si < 2; ++si) {
    WgradArgs wa{};
    wa.seg[0] = {p[34 + si], p[26 + si], rows[si]};  // dWqkv' = dqkv^T LN1
    wa.rows_per_split = rps[si];
    wa.splits0 = cdiv(rows[si], rps[si]);
    wa.O = 3 * C;
    wa.I = C;
    wa.part = fp(p, 38);
    wa.part_bias = fp(p, 39);
    err = launch_wgrad<T>(wa, mp<T>(p, 20 + 2 * si), mp<T>(p, 21 + 2 * si),
                          s);
    if (err) return err;
    wa.seg[0] = {p[4 + si], p[14 + si], rows[si]};  // dWp = dproj^T o
    wa.O = C;
    wa.part_bias = nullptr;
    err = launch_wgrad<T>(wa, mp<T>(p, 24 + si), nullptr, s);
    if (err) return err;
  }
  return 0;
}

}  // namespace
}  // namespace lm

extern "C" int lm_dca_train_fwd(int dtype, const void* const* p, int B,
                                int N, int M, int C, int H, int hidden,
                                int keys_per_split, int img_w, float scale_x,
                                float scale_c, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_train_fwd<float>(p, B, N, M, C, H, hidden, keys_per_split,
                                    img_w, scale_x, scale_c, eps, s);
  return lm::dca_train_fwd<__nv_bfloat16>(p, B, N, M, C, H, hidden,
                                          keys_per_split, img_w, scale_x,
                                          scale_c, eps, s);
}

extern "C" int lm_dca_attn_bwd(int dtype, const void* const* p, int B, int N,
                               int M, int C, int H, int rps_x, int rps_c,
                               int img_w, int cpe_rps, float scale_x,
                               float scale_c, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::dca_attn_bwd<float>(p, B, N, M, C, H, rps_x, rps_c, img_w,
                                   cpe_rps, scale_x, scale_c, eps, s);
  return lm::dca_attn_bwd<__nv_bfloat16>(p, B, N, M, C, H, rps_x, rps_c,
                                         img_w, cpe_rps, scale_x, scale_c,
                                         eps, s);
}
