// The per-op cost probe: read a (rows, C) bf16 array, apply one op K times
// in fp32 registers, write it back as bf16. Replaces the TPU kernel
// scripts/vpu_probe.py::build (its pallas_call applies OPS[op] k times to a
// (R, C) bf16 tile of a (R * 64, C) array in fp32 and stores bf16). The
// slope of the time over K is the cost of one pass of the op, apart from
// the launch and the memory traffic, which K = 0 (load and store) measures.
//
// Design: no pass of the op reads or writes a register slot that holds no
// element, so the slope counts the op on the array's elements only, at any
// C (a multiple of 8, at most 2048). The op and K are template parameters,
// so the inner loops have no run-time switch.
//  - Elementwise ops (exp, exp2, recip, gelu_fast, gelu_full, fma, cast_rt,
//    tanh, gelu_tanh) and the K = 0 copy (one instance for every op) need
//    no row: k_ew_probe<Op, K> reads the array as rows * C / 8 flat 16-byte
//    vectors of 8 bf16. A CTA of kThreads owns a tile of kThreads * kVpt
//    vectors; thread t holds vectors t + j * kThreads (j < kVpt, adjacent
//    threads on adjacent vectors) and starts all kVpt loads before the
//    first pass. Every tile but the last is full and runs unmasked; the
//    last tile runs one vector at a time over the vectors that exist. So
//    the tail is masked once per thread, never per slot.
//  - Row ops (ln, rowmax, rowsum): k_ew_probe_rows<Op, K, G, V>, a group
//    of G lanes per row (G = 8, 16 or 32, aligned in the warp) with V
//    vectors a lane: vector j of the row sits in lane j % G, slot j / G.
//    ew.py::layout(C) picks (G, V) with the least padding G * V - C / 8 at
//    V = ceil(C / 8 / G) <= kMaxV (ew_layout below is the same rule, and
//    lm_ew_layout exposes it for the card check). So slots 0 .. V - 2 hold
//    an element in every lane, and only slot V - 1 may be empty (lanes g
//    with (V - 1) G + g >= C / 8): every loop of a pass (the sums, LN's
//    centred squares and normalise, rowmax's subtract, rowsum's divide)
//    runs slot V - 1 only where `last` holds (has_slot). C = 384: G = 16,
//    V = 3; C = 1536: 32, 6; C = 784 (98 vectors): 16, 7, 98 of 112 slots
//    (one warp a row, 8 slots a lane, would use 98 of 256). The row sums
//    take the order of one warp a row with lane l holding vectors l,
//    l + 32, ... (row_reduce): 32 partials, partial l over the vectors
//    j = l (mod 32) in order, then a butterfly over l from bit 4 to bit 0.
//    Lane g holds partials g + G m, sums them itself (the butterfly's bits
//    above log2 G), and the group's __shfl_xor_sync with its lane mask
//    takes the rest; so every layout gives the same bits (a row sum that
//    nearly cancels, as rowsum's passes after the first make, changes
//    with the order by more than the probe's tolerance allows).
// Arithmetic per element as before: bf16 in, K fp32 passes, one bf16
// rounding.
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

constexpr int kThreads = 256;  // threads per CTA, both kernels
constexpr int kVpt = 4;        // 16-byte vectors a thread of a full tile
constexpr int kMaxV = 8;       // 16-byte vectors a lane of a row op
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

__device__ __forceinline__ void unpack(const uint4& u, float (&t)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    t[2 * e] = f.x;
    t[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&t)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    h[e] = __floats2bfloat162_rn(t[2 * e], t[2 * e + 1]);
  return u;
}

template <int OP, int K>
__device__ __forceinline__ void passes(float (&t)[8]) {
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = elementwise<OP>(t[e]);
}

// Elementwise ops and the copy over nvec flat vectors (see the header).
template <int OP, int K>
__global__ void __launch_bounds__(kThreads)
    k_ew_probe(const uint4* __restrict__ x, uint4* __restrict__ out,
               long nvec) {
  const long first = (long)blockIdx.x * kThreads * kVpt + threadIdx.x;
  if ((long)(blockIdx.x + 1) * kThreads * kVpt <= nvec) {  // a full tile
    float t[kVpt][8];
#pragma unroll
    for (int j = 0; j < kVpt; ++j) unpack(x[first + j * kThreads], t[j]);
#pragma unroll
    for (int j = 0; j < kVpt; ++j) passes<OP, K>(t[j]);
#pragma unroll
    for (int j = 0; j < kVpt; ++j) out[first + j * kThreads] = pack(t[j]);
    return;
  }
#pragma unroll 1
  for (long i = first; i < nvec; i += kThreads) {  // the last tile
    float t[8];
    unpack(x[i], t);
    passes<OP, K>(t);
    out[i] = pack(t);
  }
}

// Slot v of a lane holds an element: always below V - 1, at V - 1 where
// the lane's last slot lies inside the row.
template <int V>
__device__ __forceinline__ bool has_slot(int v, bool last) {
  return v < V - 1 || last;
}

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

// The group's butterfly over its G lanes (offsets G / 2 .. 1).
template <bool MAX, int G>
__device__ __forceinline__ float group_reduce(float r, unsigned mask) {
#pragma unroll
  for (int o = G >> 1; o > 0; o >>= 1)
    r = combine<MAX>(r, __shfl_xor_sync(mask, r, o));
  return r;
}

// A row's sum (or max) of acc's terms in one warp a row's order (see the
// header): slot v of this lane adds to partial v % P, P = 32 / G, each
// partial from 0 (-inf) in slot order; the partials meet as the butterfly's
// upper levels pair them (a partial that stays empty is skipped: adding 0 to a
// sum that started at +0, or taking the max with -inf, changes no bit).
template <int G, int V, bool MAX, class Acc>
__device__ __forceinline__ float row_reduce(Acc acc, bool last,
                                            unsigned mask) {
  constexpr int P = 32 / G;
  constexpr int NP = P < V ? P : V;
  float p[NP];
#pragma unroll
  for (int m = 0; m < NP; ++m) p[m] = MAX ? __int_as_float(0xff800000) : 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (!has_slot<V>(v, last)) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) p[v % P] = acc(p[v % P], v, e);
  }
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2)
#pragma unroll
    for (int m = 0; m < h; ++m)
      if (m + h < NP) p[m] = combine<MAX>(p[m], p[m + h]);
  return group_reduce<MAX, G>(p[0], mask);
}

// One pass of a row op over the lane's slots of its row of `cols` columns.
template <int OP, int G, int V>
__device__ __forceinline__ void row_pass(float (&t)[V][8], bool last,
                                         int cols, unsigned mask) {
  constexpr bool kMax = OP == kRowmax;
  const float r = row_reduce<G, V, kMax>(
      [&](float a, int v, int e) { return combine<kMax>(a, t[v][e]); },
      last, mask);
  if constexpr (OP == kLn) {
    // fp32 statistics, the centred variance (pallas_block.py::_ln)
    const float mu = r / cols;
    const float q = row_reduce<G, V, false>(
        [&](float a, int v, int e) {
          const float d = t[v][e] - mu;
          return a + d * d;
        },
        last, mask);
    const float inv = rsqrtf(q / cols + kLnEps);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!has_slot<V>(v, last)) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) t[v][e] = (t[v][e] - mu) * inv;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (!has_slot<V>(v, last)) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        t[v][e] = kMax ? t[v][e] - r : t[v][e] / r;
    }
  }
}

// Row ops: a group of G lanes per row, V vectors a lane (see the header).
template <int OP, int K, int G, int V>
__global__ void __launch_bounds__(kThreads)
    k_ew_probe_rows(const uint4* __restrict__ x, uint4* __restrict__ out,
                    int rows, int nvec) {
  const int lane = threadIdx.x & 31;
  const int gl = threadIdx.x % G;  // this lane's place in its group
  const long row = (long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (row >= rows) return;  // whole groups leave: each row is one group
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  const bool last = (V - 1) * G + gl < nvec;
  const uint4* xr = x + row * nvec + gl;
  uint4* orow = out + row * nvec + gl;
  float t[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (has_slot<V>(v, last)) unpack(xr[v * G], t[v]);
#pragma unroll
  for (int p = 0; p < K; ++p) row_pass<OP, G, V>(t, last, nvec * 8, mask);
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (has_slot<V>(v, last)) orow[v * G] = pack(t[v]);
}

// ew.py::layout: (lanes per row g, vectors per lane v) with the least
// padding g * v - nvec over g = 32, 16, 8 (the larger g on a tie) at v =
// ceil(nvec / g) <= kMaxV; nvec in 1 .. 32 * kMaxV. Below g = 32 the least
// padding never falls on an even v (g * v / 2 lanes of 2 g would tie).
void ew_layout(int nvec, int* g_out, int* v_out) {
  int best_g = 0, best_v = 0;
  for (int g = 32; g >= 8; g >>= 1) {
    const int v = (nvec + g - 1) / g;
    if (v > kMaxV) continue;
    if (best_g == 0 || g * v < best_g * best_v) {
      best_g = g;
      best_v = v;
    }
  }
  *g_out = best_g;
  *v_out = best_v;
}

template <int OP, int K>
int launch(const void* x, void* out, long nvec, cudaStream_t s) {
  const long tile = (long)kThreads * kVpt;
  k_ew_probe<OP, K><<<(unsigned)((nvec + tile - 1) / tile), kThreads, 0,
                      s>>>(static_cast<const uint4*>(x),
                           static_cast<uint4*>(out), nvec);
  return (int)cudaGetLastError();
}

template <int OP, int K, int G, int V>
int launch_rows(const void* x, void* out, int rows, int nvec,
                cudaStream_t s) {
  constexpr int per_cta = kThreads / G;
  k_ew_probe_rows<OP, K, G, V><<<(rows + per_cta - 1) / per_cta, kThreads,
                                 0, s>>>(static_cast<const uint4*>(x),
                                         static_cast<uint4*>(out), rows,
                                         nvec);
  return (int)cudaGetLastError();
}

// The instance of ew_layout's (g, v): v odd below g = 32.
template <int OP, int K, int G>
int launch_group(int v, const void* x, void* out, int rows, int nvec,
                 cudaStream_t s) {
  switch (v) {
    case 1: return launch_rows<OP, K, G, 1>(x, out, rows, nvec, s);
    case 3: return launch_rows<OP, K, G, 3>(x, out, rows, nvec, s);
    case 5: return launch_rows<OP, K, G, 5>(x, out, rows, nvec, s);
    case 7: return launch_rows<OP, K, G, 7>(x, out, rows, nvec, s);
  }
  if constexpr (G == 32) {
    switch (v) {
      case 2: return launch_rows<OP, K, G, 2>(x, out, rows, nvec, s);
      case 4: return launch_rows<OP, K, G, 4>(x, out, rows, nvec, s);
      case 6: return launch_rows<OP, K, G, 6>(x, out, rows, nvec, s);
      case 8: return launch_rows<OP, K, G, 8>(x, out, rows, nvec, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int OP, int K>
int launch_layout(const void* x, void* out, int rows, int nvec,
                  cudaStream_t s) {
  int g, v;
  ew_layout(nvec, &g, &v);
  switch (g) {
    case 8: return launch_group<OP, K, 8>(v, x, out, rows, nvec, s);
    case 16: return launch_group<OP, K, 16>(v, x, out, rows, nvec, s);
    case 32: return launch_group<OP, K, 32>(v, x, out, rows, nvec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int OP, int K>
int launch_op(const void* x, void* out, int rows, int nvec, cudaStream_t s) {
  if constexpr (OP == kLn || OP == kRowmax || OP == kRowsum)
    return launch_layout<OP, K>(x, out, rows, nvec, s);
  else
    return launch<OP, K>(x, out, (long)rows * nvec, s);
}

template <int OP>
int launch_k(int k, const void* x, void* out, int rows, int nvec,
             cudaStream_t s) {
  switch (k) {  // k = 0 is one instance for every op (lm_ew_probe)
    case 1: return launch_op<OP, 1>(x, out, rows, nvec, s);
    case 2: return launch_op<OP, 2>(x, out, rows, nvec, s);
    case 4: return launch_op<OP, 4>(x, out, rows, nvec, s);
    case 8: return launch_op<OP, 8>(x, out, rows, nvec, s);
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
  if (cols % 8 || nvec < 1 || nvec > 32 * kMaxV || rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (k == 0) return launch<kFma, 0>(x, out, (long)rows * nvec, s);
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

// gv[0], gv[1]: the row ops' (lanes per row, vectors per lane) for rows of
// cols columns (ew.py::layout is the same rule; the card check holds the
// two equal at every C).
extern "C" int lm_ew_layout(int cols, int* gv) {
  if (cols % 8 || cols < 8 || cols > 8 * 32 * lp::kMaxV)
    return (int)cudaErrorInvalidValue;
  lp::ew_layout(cols / 8, gv, gv + 1);
  return 0;
}
