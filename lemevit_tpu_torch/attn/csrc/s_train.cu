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
// lm_s_train_fwd (row 9 of the TPU kernel table): k_linear_ln (qkv, both
//   streams) -> k_attention per stream, also writing o and each query's
//   log-sum-exp -> k_block_tail with branch scales s1 / s2, also writing t1.
// lm_mlp_bwd (row 11): k_mlp_bwd recomputes LN2 / fc1 / GELU from t1 and
//   gives dt1; k_wgrad gives dW1, db1 (from dy, LN2(t1)) and dW2 (from
//   dz = s2 dout, GELU(y)). db2 = colsum(dz) is left to the caller, as the
//   TPU wrapper leaves it to XLA.
// lm_s_attn_bwd (row 10): LN1 and qkv recomputed (k_ln_rows, k_linear_ln);
//   dO = dproj Wp (dproj = s1 dt1); k_attn_bwd_* rebuild P from the saved
//   log-sum-exp and give dq, dk, dv; da = dqkv Wqkv'; k_ln_bwd gives
//   dx = dt1 + LN1'^T da; k_wgrad gives dWqkv, dbqkv and dWp. dbp =
//   colsum(dproj) is left to the caller.
// With a CPE (taps non-null: the TPU kernels' use_cpe, JAX's
//   PB_TRAIN_CPE=fused), x is the image tokens before the 3x3 CPE. The
//   forward runs k_cpe_rows once into a workspace and the chain on the CPE'd
//   rows (the residual is the CPE'd x, as on the TPU); the attention
//   backward recomputes them the same way (only the pre-CPE x is saved),
//   takes du = dt1x + LN1'^T da in fp32 from k_ln_bwd, then k_cpe_tap_grads
//   (dtaps, dbias) and the flipped-tap k_cpe_rows (dx = CPE^T du). One
//   k_cpe_rows per chain, rather than the inference kernels' CpeRows loader:
//   that loader recomputes each element's neighbourhood in every product
//   and LayerNorm pass that reads it (2.3-2.8x slower in serving).
// Bound on the H100: operations for the products, bytes for the LayerNorm
// and row kernels. Every product is a plain shared-memory tiled mma.sync
// (bf16) or FMA (fp32) product; the attention backward is fp32 FMA with one
// lane per head channel, which is what bounds it today (wgmma and tensor-
// core attention are later work). The weight gradients are split over row
// ranges into fp32 partials (no atomics: deterministic) and reduced.
#include "train_common.cuh"

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
  LinArgs la{};
  la.seg[0] = {x, p[4], p[5], mp<T>(p, 21), B * N, 3 * C};
  la.seg[1] = {p[1], p[4], p[5], mp<T>(p, 22), B * M, 3 * C};
  la.row_blocks0 = cdiv(B * N, kLinBM);
  la.ln_w = p[2];
  la.ln_b = p[3];
  la.K = C;
  la.eps = eps;
  err = launch_linear<T>(la, 3 * C, s);
  if (err) return err;

  for (int si = 0; si < 2; ++si) {
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
    aa.keys_per_split = n;
    aa.splits = 1;
    aa.scale = scale;
    err = launch_attention<T>(aa, s);
    if (err) return err;
  }

  const float* dp = static_cast<const float*>(p[12]);
  TailArgs ta{};
  ta.seg[0] = {x, p[17], p[6], p[7], mp<T>(p, 13), B * N,
               dp, dp + B, N, mp<T>(p, 15)};
  ta.seg[1] = {p[1], p[18], p[6], p[7], mp<T>(p, 14), B * M,
               dp + 2 * B, dp + 3 * B, M, mp<T>(p, 16)};
  ta.row_blocks0 = cdiv(B * N, kTailBM);
  ta.ln_w = p[2];
  ta.ln_b = p[3];
  ta.w1 = p[8];
  ta.b1 = p[9];
  ta.w2 = p[10];
  ta.b2 = p[11];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail<T>(ta, s);
}

// p: 0 t1x, 1 t1c, 2 dxo, 3 dco, 4 dzx, 5 dzc (= s2 dout), 6 w1', 7 b1',
//    8 w2^T (hidden, C), 9 w1'^T (C, hidden) | 10 dt1x, 11 dt1c,
//    12 dw1 (hidden, C), 13 db1, 14 dw2 (C, hidden) | workspace 15 mm_x,
//    16 mm_c (rows, C), 17 gg_x, 18 gg_c, 19 dy_x, 20 dy_c (rows, hidden),
//    21 partials (splits, max(O I)) fp32, 22 bias partials (splits, hidden).
template <typename T>
int s_mlp_bwd(const void* const* p, int B, int N, int M, int C, int hidden,
              int rows_per_split, float eps, cudaStream_t s) {
  MlpBwdArgs ma{};
  ma.seg[0] = {p[0], p[2], p[4], mp<T>(p, 10), mp<T>(p, 15), mp<T>(p, 17),
               mp<T>(p, 19), B * N};
  ma.seg[1] = {p[1], p[3], p[5], mp<T>(p, 11), mp<T>(p, 16), mp<T>(p, 18),
               mp<T>(p, 20), B * M};
  ma.row_blocks0 = cdiv(B * N, kMbBM);
  ma.w1 = p[6];
  ma.b1 = p[7];
  ma.w2t = p[8];
  ma.w1t = p[9];
  ma.C = C;
  ma.hidden = hidden;
  ma.eps = eps;
  int err = launch_mlp_bwd<T>(ma, s);
  if (err) return err;

  WgradArgs wa{};
  wa.seg[0] = {p[19], p[15], B * N};  // dW1 = dy^T LN2(t1)
  wa.seg[1] = {p[20], p[16], B * M};
  wa.rows_per_split = rows_per_split;
  wa.splits0 = cdiv(B * N, rows_per_split);
  wa.O = hidden;
  wa.I = C;
  wa.part = fp(p, 21);
  wa.part_bias = fp(p, 22);
  err = launch_wgrad<T>(wa, mp<T>(p, 12), mp<T>(p, 13), s);
  if (err) return err;
  wa.seg[0] = {p[4], p[17], B * N};  // dW2 = dz^T GELU(y)
  wa.seg[1] = {p[5], p[18], B * M};
  wa.O = C;
  wa.I = hidden;
  wa.part_bias = nullptr;
  return launch_wgrad<T>(wa, mp<T>(p, 14), nullptr, s);
}

// p: 0 x, 1 c, 2 dt1x, 3 dt1c, 4 dprojx, 5 dprojc (= s1 dt1), 6 wqkv',
//    7 bqkv', 8 wqkv'^T (C, 3C), 9 wp^T (C, C), 10 o_x, 11 o_c, 12 lse_x,
//    13 lse_c | 14 dx, 15 dc, 16 dwqkv (3C, C), 17 dbqkv, 18 dwp (C, C) |
//    workspace 19 a_x, 20 a_c (rows, C), 21 qkv_x, 22 qkv_c (rows, 3C),
//    23 dO_x, 24 dO_c (rows, C) fp32, 25 D_x, 26 D_c (B H n) fp32,
//    27 dqkv_x, 28 dqkv_c (rows, 3C), 29 da_x, 30 da_c (rows, C) fp32,
//    31 partials (splits, 3 C^2) fp32, 32 bias partials (splits, 3C) |
//    the CPE or nulls: 33 taps (9, C), 34 bias (C,), workspace 35 the
//    CPE'd x (B N, C), 36 du (B N, C) fp32, 37 partials (splits, 10, C)
//    fp32, outputs 38 dtaps (9, C), 39 dbias (C,). Images are img_w wide;
//    cpe_rps: k_cpe_tap_grads' rows per block.
template <typename T>
int s_attn_bwd(const void* const* p, int B, int N, int M, int C, int H,
               int rows_per_split, int img_w, int cpe_rps, float scale,
               float eps, cudaStream_t s) {
  const int rows[2] = {B * N, B * M};
  const TrainCpe cpe{p[33], p[34], img_w, N, cpe_rps};
  const void* xs[2] = {p[0], p[1]};  // the rows LN1 reads
  int err;
  if (cpe.taps) {
    err = launch_cpe_rows<T, T>(p[0], cpe.taps, cpe.bias, mp<T>(p, 35),
                                rows[0], C, img_w, N, 0, s);
    if (err) return err;
    xs[0] = p[35];
  }
  for (int si = 0; si < 2; ++si) {
    err = launch_ln_rows<T>(xs[si], mp<T>(p, 19 + si), rows[si], C, eps, s);
    if (err) return err;
  }
  LinArgs la{};  // qkv = LN1(x) Wqkv'^T + bqkv'
  la.seg[0] = {p[19], p[6], p[7], mp<T>(p, 21), rows[0], 3 * C};
  la.seg[1] = {p[20], p[6], p[7], mp<T>(p, 22), rows[1], 3 * C};
  la.row_blocks0 = cdiv(rows[0], kLinBM);
  la.K = C;
  la.eps = eps;
  la.plain_a = 1;
  err = launch_linear<T>(la, 3 * C, s);
  if (err) return err;

  LinArgs lo{};  // dO = dproj Wp, fp32
  lo.seg[0] = {p[4], p[9], nullptr, fp(p, 23), rows[0], C};
  lo.seg[1] = {p[5], p[9], nullptr, fp(p, 24), rows[1], C};
  lo.row_blocks0 = cdiv(rows[0], kLinBM);
  lo.K = C;
  lo.plain_a = 1;
  lo.out_f32 = 1;
  err = launch_linear<T>(lo, C, s);
  if (err) return err;

  for (int si = 0; si < 2; ++si) {  // q / k / v: the thirds of qkv
    const T* qkv = cp<T>(p, 21 + si);
    T* dqkv = mp<T>(p, 27 + si);
    AttnBwdArgs ab{};
    ab.q = qkv;
    ab.k = qkv + C;
    ab.v = qkv + 2 * C;
    ab.o = p[10 + si];
    ab.dO = fp(p, 23 + si);
    ab.lse = fp(p, 12 + si);
    ab.D = fp(p, 25 + si);
    ab.dq = dqkv;
    ab.dk = dqkv + C;
    ab.dv = dqkv + 2 * C;
    ab.ldq = ab.ldkv = ab.lddq = ab.lddkv = 3 * C;
    ab.ldo = C;
    ab.batch = B;
    ab.heads = H;
    ab.nq = ab.nk = si == 0 ? N : M;
    ab.C = C;
    ab.scale = scale;
    err = launch_attn_bwd<T>(ab, s);
    if (err) return err;
  }

  LinArgs ld{};  // da = dqkv Wqkv', fp32
  ld.seg[0] = {p[27], p[8], nullptr, fp(p, 29), rows[0], C};
  ld.seg[1] = {p[28], p[8], nullptr, fp(p, 30), rows[1], C};
  ld.row_blocks0 = cdiv(rows[0], kLinBM);
  ld.K = 3 * C;
  ld.plain_a = 1;
  ld.out_f32 = 1;
  err = launch_linear<T>(ld, C, s);
  if (err) return err;
  for (int si = 0; si < 2; ++si) {
    if (si == 0 && cpe.taps) {  // du in fp32, then the CPE's backward
      err = launch_ln_bwd<T, float>(xs[0], fp(p, 29), p[2], fp(p, 36),
                                    rows[0], C, eps, s);
      if (!err)
        err = launch_cpe_bwd<T>(cpe, p[0], fp(p, 36), fp(p, 37),
                                mp<T>(p, 38), mp<T>(p, 39), mp<T>(p, 14),
                                rows[0], C, s);
    } else {
      err = launch_ln_bwd<T>(xs[si], fp(p, 29 + si), p[2 + si],
                             mp<T>(p, 14 + si), rows[si], C, eps, s);
    }
    if (err) return err;
  }

  WgradArgs wa{};
  wa.seg[0] = {p[27], p[19], rows[0]};  // dWqkv' = dqkv^T LN1(x)
  wa.seg[1] = {p[28], p[20], rows[1]};
  wa.rows_per_split = rows_per_split;
  wa.splits0 = cdiv(rows[0], rows_per_split);
  wa.O = 3 * C;
  wa.I = C;
  wa.part = fp(p, 31);
  wa.part_bias = fp(p, 32);
  err = launch_wgrad<T>(wa, mp<T>(p, 16), mp<T>(p, 17), s);
  if (err) return err;
  wa.seg[0] = {p[4], p[10], rows[0]};  // dWp = dproj^T o
  wa.seg[1] = {p[5], p[11], rows[1]};
  wa.O = C;
  wa.part_bias = nullptr;
  return launch_wgrad<T>(wa, mp<T>(p, 18), nullptr, s);
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
