// Fused pre-norm S block (stages 3-4 of LeMeViT): multi-head self-attention
// + proj + residual + norm2 + MLP, applied to the image tokens and, with the
// same weights, separately to the meta tokens (the meta tokens attend only
// to themselves). Replaces lemevit_tpu/attn/pallas_block.py::s_block
// (_s_block_call, _s_block_kernel, _s_body).
//
// Bound on the H100: operations. At C = 384 a row costs ~24 C^2 = 3.5 M
// multiply-adds against ~4 C bytes of input and output, far above the
// card's bf16 line; the products are ~90 % of them, attention the rest.
//
// Launch chain (block_tc.cuh; bf16 products on wgmma, fp32 on FMA from
// the same TMA-fed tiles):
//   1. k_qkv_wg: both streams' LN1 + qkv, 64 rows a CTA, LN1 staged once
//      per row block and rounded to T, the 3C columns walked from that
//      copy with the weight tiles in a TMA-fed ring;
//   2. one attention launch per stream on attn_tc.cuh's tiles, q / k / v
//      read in place from the (rows, 3C) qkv workspace: k_mhsa_tc (128
//      queries of one (image, head) a CTA, 64-key tiles in a two-stage
//      ring, online softmax in 32-key steps) for the image tokens (N <=
//      1024, ragged N masked), k_mhsa_tc_small (a warp per (image, head))
//      for the meta tokens at M <= 16, k_mhsa_tc above;
//   3. k_tail_wg: both streams' proj + residual + LN2 + MLP, 64 rows a CTA,
//      the fc2 sum in registers, every weight tile through one TMA-fed ring
//      (block_common.cuh's k_block_tail past C = 512).
// Round trips through device memory: qkv (3x the size of x) and the
// attention output, each written once and read once.
// cpe mode (taps and bias given, x before its CPE; the TPU kernels'
// _cpe_flat): the qkv launch stages each row block's CPE'd rows once (the
// 3x3 neighbourhood read once per row, not per column tile), LayerNorms
// them, and writes them to a workspace, which the tail reads as its
// residual: one more write and read of x instead of a second pass over its
// neighbourhoods.
#include "block_tc.cuh"

namespace lm {
namespace {

template <typename T>
int s_block(const void* const* p, int B, int N, int M, int C, int H,
            int hidden, int img_w, float scale, float eps, cudaStream_t s) {
  const Cpe cpe{p[20], p[21], img_w, N};
  QkvArgs qa{};
  qa.seg[0] = {p[0], p[4], p[5], mp<T>(p, 16), B * N};
  qa.seg[1] = {p[1], p[4], p[5], mp<T>(p, 17), B * M};
  qa.ln_w = p[2];
  qa.ln_b = p[3];
  qa.C = C;
  qa.eps = eps;
  qa.cpe = cpe;
  qa.xc = mp<T>(p, 22);
  if (cpe.taps && !qa.xc) return (int)cudaErrorInvalidValue;
  int err = launch_qkv_tc<T>(qa, s);
  if (err) return err;

  for (int stream_i = 0; stream_i < 2; ++stream_i) {
    const int n = stream_i == 0 ? N : M;
    const T* qkv = cp<T>(p, 16 + stream_i);
    AttnArgs aa{};
    aa.q = qkv;
    aa.k = qkv + C;
    aa.v = qkv + 2 * C;
    aa.out = mp<T>(p, 18 + stream_i);
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

  TailArgs ta{};
  ta.seg[0] = {cpe.taps ? p[22] : p[0], p[18], p[6], p[7], mp<T>(p, 14),
               B * N};
  ta.seg[1] = {p[1], p[19], p[6], p[7], mp<T>(p, 15), B * M};
  ta.ln_w = p[8];
  ta.ln_b = p[9];
  ta.w1 = p[10];
  ta.b1 = p[11];
  ta.w2 = p[12];
  ta.b2 = p[13];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail_tc<T>(ta, s);
}

}  // namespace
}  // namespace lm

// p: x, c, ln1_w, ln1_b, wqkv, bqkv, wp, bp, ln2_w, ln2_b, w1, b1, w2, b2 |
//    x_out, c_out | workspace qkv_x (B*N, 3C), qkv_c (B*M, 3C),
//    o_x (B*N, C), o_c (B*M, C) | cpe_taps (9, C), cpe_bias (C,), null
//    without the CPE (img_w: the image width, N = H * img_w) | workspace
//    x_cpe (B*N, C), the CPE'd x, null without the CPE.
extern "C" int lm_s_block(int dtype, const void* const* p, int B, int N,
                          int M, int C, int H, int hidden, int img_w,
                          float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::s_block<float>(p, B, N, M, C, H, hidden, img_w, scale, eps, s);
  return lm::s_block<__nv_bfloat16>(p, B, N, M, C, H, hidden, img_w, scale,
                                    eps, s);
}

// Message for a code returned by any lm_* entry point.
extern "C" const char* lm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
