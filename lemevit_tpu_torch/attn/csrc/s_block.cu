// Fused pre-norm S block (stages 3-4 of LeMeViT): multi-head self-attention
// + proj + residual + norm2 + MLP, applied to the image tokens and, with the
// same weights, separately to the meta tokens (the meta tokens attend only
// to themselves). Replaces lemevit_tpu/attn/pallas_block.py::s_block
// (_s_block_kernel, _s_body).
//
// Launch chain (block_common.cuh): one k_linear_ln for both streams' qkv;
// one k_attention per stream (N <= a few hundred keys per image and head,
// streamed through shared memory in 64-key chunks with an online softmax,
// so any N is taken); one k_block_tail for both streams.
// Bound on the H100: operations. At C = 384 a row costs ~24 C^2 = 3.5 M
// multiply-adds against ~4 C bytes of input and output, above the line.
// bf16 products run on mma.sync from shared-memory tiles staged by plain
// loads; the tail re-stages every weight for each 32-row block, which
// wgmma with TMA multicast or larger row blocks would cut. Round trips
// through device memory: qkv (3x the size of x) and the attention output.
// cpe mode (taps and bias given, x before its CPE; the TPU kernels'
// _cpe_flat): as dca_block.cu's, the qkv prologue LayerNorms the CPE'd rows
// and the tail recomputes the CPE of its rows for the residual.
#include "block_common.cuh"

namespace lm {
namespace {

template <typename T>
int s_block(const void* const* p, int B, int N, int M, int C, int H,
            int hidden, int img_w, float scale, float eps, cudaStream_t s) {
  const Cpe cpe{p[20], p[21], img_w, N};
  LinArgs la{};
  la.seg[0] = {p[0], p[4], p[5], mp<T>(p, 16), B * N, 3 * C};
  la.seg[1] = {p[1], p[4], p[5], mp<T>(p, 17), B * M, 3 * C};
  la.row_blocks0 = cdiv(B * N, kLinBM);
  la.ln_w = p[2];
  la.ln_b = p[3];
  la.K = C;
  la.eps = eps;
  la.cpe = cpe;
  la.cpe_seg = 0;
  int err = launch_linear<T>(la, 3 * C, s);
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
    aa.keys_per_split = n;
    aa.splits = 1;
    aa.scale = scale;
    err = launch_attention<T>(aa, s);
    if (err) return err;
  }

  TailArgs ta{};
  ta.seg[0] = {p[0], p[18], p[6], p[7], mp<T>(p, 14), B * N};
  ta.seg[0].cpe = cpe;
  ta.seg[1] = {p[1], p[19], p[6], p[7], mp<T>(p, 15), B * M};
  ta.row_blocks0 = cdiv(B * N, kTailBM);
  ta.ln_w = p[8];
  ta.ln_b = p[9];
  ta.w1 = p[10];
  ta.b1 = p[11];
  ta.w2 = p[12];
  ta.b2 = p[13];
  ta.C = C;
  ta.hidden = hidden;
  ta.eps = eps;
  return launch_tail<T>(ta, s);
}

}  // namespace
}  // namespace lm

// p: x, c, ln1_w, ln1_b, wqkv, bqkv, wp, bp, ln2_w, ln2_b, w1, b1, w2, b2 |
//    x_out, c_out | workspace qkv_x (B*N, 3C), qkv_c (B*M, 3C),
//    o_x (B*N, C), o_c (B*M, C) | cpe_taps (9, C), cpe_bias (C,), null
//    without the CPE (img_w: the image width, N = H * img_w).
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
