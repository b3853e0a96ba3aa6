// The per-op cost probe: read a (rows, C) bf16 array, apply one op K times
// in fp32 registers, write it back as bf16. Replaces the TPU kernel
// scripts/vpu_probe.py::build (its pallas_call applies OPS[op] k times to a
// (R, C) bf16 tile of a (R * 64, C) array in fp32 and stores bf16). The
// slope of the time over K is the cost of one pass of the op, apart from
// the launch and the memory traffic, which K = 0 (load and store) measures.
//
// Design. One warp per row: each lane holds up to kVpl 16-byte vectors of 8
// bf16 (rows of C <= 32 * kVpl * 8 = 2048 columns), unpacked to fp32. The op
// and K are template parameters (k_ew_probe<Op, K>), so the inner loop has
// no run-time switch; the row ops (ln, rowmax, rowsum) reduce over the row
// with warp shuffles and keep the row in registers between passes.
// Bound on the H100: bytes, 2 * 2 * rows * C (one bf16 read and one write
// per element) over 3.35 TB/s at every K the probe times: even gelu_full at
// K = 8 (~30 fp32 operations per element and pass) stays below the byte
// time at the card's 67 TFLOP/s of fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lp {
namespace {

// the ops, in the order of scripts/vpu_probe.py::OPS
enum Op {
  kExp, kExp2, kRecip, kGeluFast, kGeluFull, kLn, kRowmax, kRowsum, kFma,
  kCastRt, kTanh, kGeluTanh, kNumOps
};

constexpr int kVpl = 8;       // 16-byte vectors per lane
constexpr int kWarps = 8;     // rows per block
constexpr float kLnEps = 1e-6f;

// JAX's tanh-erf form of GELU (lemevit_tpu/attn/pallas_block.py::_gelu,
// fast=True); scripts/vpu_probe.py::_gelu_tanh has the same coefficients
__device__ __forceinline__ float gelu_tanh_erf(float v) {
  const float t = fminf(fmaxf(v * 0.7071067811865476f, -6.f), 6.f);
  const float u = t * t;
  const float a = t * (1.12812423f + u * (0.10414107f + u * -0.00181363f));
  return 0.5f * v * (1.f + tanhf(a));
}

template <int OP>
__device__ __forceinline__ float elementwise(float t) {
  if constexpr (OP == kExp) return expf(t);
  if constexpr (OP == kExp2) return exp2f(t);
  if constexpr (OP == kRecip) return 1.f / (t + 1.001f);
  if constexpr (OP == kGeluFast || OP == kGeluTanh) return gelu_tanh_erf(t);
  // the exact form, as the port's kernels compute it (block_common.cuh)
  if constexpr (OP == kGeluFull)
    return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
  if constexpr (OP == kFma) return t * 1.0001f + 0.001f;
  if constexpr (OP == kCastRt) return __bfloat162float(__float2bfloat16(t));
  if constexpr (OP == kTanh) return tanhf(t);
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One pass of OP over the lane's share of the row: vector v of this lane is
// the row's vector v * 32 + lane, valid below nvec.
template <int OP>
__device__ __forceinline__ void pass(float (&t)[kVpl][8], int lane,
                                     int nvec) {
  if constexpr (OP == kLn || OP == kRowmax || OP == kRowsum) {
    float r = OP == kRowmax ? __int_as_float(0xff800000) : 0.f;  // -inf
#pragma unroll
    for (int v = 0; v < kVpl; ++v) {
      if (v * 32 + lane >= nvec) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        r = OP == kRowmax ? fmaxf(r, t[v][e]) : r + t[v][e];
    }
    r = OP == kRowmax ? warp_max(r) : warp_sum(r);
    if constexpr (OP == kLn) {
      // fp32 statistics, the centred variance (pallas_block.py::_ln)
      const float mu = r / (nvec * 8);
      float q = 0.f;
#pragma unroll
      for (int v = 0; v < kVpl; ++v) {
        if (v * 32 + lane >= nvec) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = t[v][e] - mu;
          q += d * d;
        }
      }
      const float inv = rsqrtf(warp_sum(q) / (nvec * 8) + kLnEps);
#pragma unroll
      for (int v = 0; v < kVpl; ++v)
#pragma unroll
        for (int e = 0; e < 8; ++e) t[v][e] = (t[v][e] - mu) * inv;
    } else {
#pragma unroll
      for (int v = 0; v < kVpl; ++v)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          t[v][e] = OP == kRowmax ? t[v][e] - r : t[v][e] / r;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kVpl; ++v)
#pragma unroll
      for (int e = 0; e < 8; ++e) t[v][e] = elementwise<OP>(t[v][e]);
  }
}

template <int OP, int K>
__global__ void __launch_bounds__(kWarps * 32)
    k_ew_probe(const uint4* __restrict__ x, uint4* __restrict__ out,
               int rows, int nvec) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = x + row * nvec;
  uint4* orow = out + row * nvec;
  float t[kVpl][8];
#pragma unroll
  for (int v = 0; v < kVpl; ++v) {
    const int j = v * 32 + lane;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (j < nvec) u = xr[j];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      t[v][2 * e] = f.x;
      t[v][2 * e + 1] = f.y;
    }
  }
#pragma unroll
  for (int p = 0; p < K; ++p) pass<OP>(t, lane, nvec);
#pragma unroll
  for (int v = 0; v < kVpl; ++v) {
    const int j = v * 32 + lane;
    if (j >= nvec) continue;
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(t[v][2 * e], t[v][2 * e + 1]);
    orow[j] = u;
  }
}

template <int OP, int K>
int launch(const void* x, void* out, int rows, int nvec, cudaStream_t s) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  k_ew_probe<OP, K><<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), rows, nvec);
  return (int)cudaGetLastError();
}

template <int OP>
int launch_k(int k, const void* x, void* out, int rows, int nvec,
             cudaStream_t s) {
  switch (k) {  // k = 0 is one instance for every op (lm_ew_probe)
    case 1: return launch<OP, 1>(x, out, rows, nvec, s);
    case 2: return launch<OP, 2>(x, out, rows, nvec, s);
    case 4: return launch<OP, 4>(x, out, rows, nvec, s);
    case 8: return launch<OP, 8>(x, out, rows, nvec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace lp

// x, out: (rows, cols) bf16, contiguous and 16-byte aligned, cols a
// multiple of 8 and at most 2048; op: an index into vpu_probe.OPS' order
// (exp, exp2, recip, gelu_fast, gelu_full, ln, rowmax, rowsum, fma, cast_rt,
// tanh, gelu_tanh); k: 0, 1, 2, 4 or 8 passes (k = 0 loads and stores).
extern "C" int lm_ew_probe(int op, int k, const void* x, void* out, int rows,
                           int cols, void* stream) {
  using namespace lp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nvec = cols / 8;
  if (cols % 8 || nvec > 32 * kVpl || rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return launch<kFma, 0>(x, out, rows, nvec, s);
  switch (op) {
    case kExp: return launch_k<kExp>(k, x, out, rows, nvec, s);
    case kExp2: return launch_k<kExp2>(k, x, out, rows, nvec, s);
    case kRecip: return launch_k<kRecip>(k, x, out, rows, nvec, s);
    case kGeluFast: return launch_k<kGeluFast>(k, x, out, rows, nvec, s);
    case kGeluFull: return launch_k<kGeluFull>(k, x, out, rows, nvec, s);
    case kLn: return launch_k<kLn>(k, x, out, rows, nvec, s);
    case kRowmax: return launch_k<kRowmax>(k, x, out, rows, nvec, s);
    case kRowsum: return launch_k<kRowsum>(k, x, out, rows, nvec, s);
    case kFma: return launch_k<kFma>(k, x, out, rows, nvec, s);
    case kCastRt: return launch_k<kCastRt>(k, x, out, rows, nvec, s);
    case kTanh: return launch_k<kTanh>(k, x, out, rows, nvec, s);
    case kGeluTanh: return launch_k<kGeluTanh>(k, x, out, rows, nvec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
