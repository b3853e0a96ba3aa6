// The qkv product and the tail of the inference S and D block kernels
// (s_block.cu, dca_block.cu), which run attn_tc.cuh's attention tiles in
// between; the S block's training forward (s_train.cu) runs the same
// kernels, the tail in its training instance (kTrain), and the training
// backwards (train_tc.cuh) k_qkv_wg's LN1-rows instance. Replaces, with
// those, lemevit_tpu/attn/pallas_block.py's _s_block_kernel and
// _dca_rows_kernel / _dca_block_kernel bodies: LN1 + qkv, proj + residual
// + LN2 + fc1 + exact-erf GELU + fc2 + residual.
//
// Bound on the H100: operations (a row costs ~24 C^2 multiply-adds against
// ~4 C bytes in and out). Every CTA owns a block of rows and streams the
// block's weights past them, so what it pays per weight tile (loads,
// barriers, operand traffic in shared memory) sets the pace; the measured
// designs and their times are in PERF.md, section 6.
//
//   k_qkv_wg   a CTA takes 64 rows of one stream, stages them once (their
//              3x3 CPE in the cpe mode, also written to a workspace for the
//              tail's residual), LayerNorms them once in place, rounded to
//              T as the TPU kernels round before the MXU, and walks its
//              share of the 3C output columns 128 at a time: the weight
//              tiles arrive one 128-byte sub-tile deep (64 bf16, 32 fp32
//              columns) by TMA into a three-stage ring, the two warpgroups
//              each take 64 columns, bf16 tile i's products stay in flight
//              across the barrier that frees tile i - 1's stage, and each
//              column tile leaves + bias by direct stores. Where the row
//              blocks are few, the columns are split over a few CTAs per
//              row block (each repeats the LN, not the product). bf16: 2
//              CTAs an SM up to C = 384. With ln_out set (train_tc.cuh's
//              attention backward, its own instances) the LN1 rows are
//              also written out, the operand of dWqkv.
//   k_tail_wg  (C <= 512) a CTA takes 64 rows of one stream through the
//              whole tail. o is staged for proj; t1 = t + proj lives in the
//              fp32 accumulators, which then take fc2, so the fc2 sum never
//              leaves registers; LN2(t1) is stored once as fc1's A operand;
//              the 4C-wide hidden row exists one 128-wide chunk at a time
//              (GELU in fp32, rounded to T as fc2's A operand). The two
//              warpgroups split the columns (m64 x C/2 for proj and fc2,
//              m64 x 64 for fc1). One schedule of weight tiles runs over
//              proj, then each chunk's fc1 and fc2 tiles, by TMA into a
//              ring of as many stages as fit (bf16 2-4, fp32 1-4), so the
//              ring never drains between products. The accumulator covers
//              CP >= C columns, a compile-time tier; columns past C compute
//              on the zeros TMA fills in and are dropped. Past C = 512 (no
//              released model) the tail is block_common.cuh's k_block_tail.
// bf16 and fp32 run the same kernels, layouts, schedules and epilogues;
// only the products differ (wgmma, or FMA: sub_mma), so the fp32 checks
// against the plain versions at 1e-4 hold the served kernels' indexing,
// TMA maps, LayerNorms, GELU and stores.
//
// On the card, against the parent's chain of block_common.cuh launches
// (its LN restaged per 32-deep step, 32 tail rows a CTA, no pipelining),
// the weight-tile loads by TMA and the wgmma products measured faster than
// cp.async copies and ldmatrix-fed mma.sync in the same loop; keeping a
// tail tile's products in flight across the next barrier measured slower.
// Types and layouts as block_common.cuh.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "attn_tc.cuh"

namespace lm {
namespace {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v,
                                       float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[16 / sizeof(T)]) {
  uint4 v;
  if constexpr (sizeof(T) == 2) {
    v.x = pack_bf16(f[0], f[1]);
    v.y = pack_bf16(f[2], f[3]);
    v.z = pack_bf16(f[4], f[5]);
    v.w = pack_bf16(f[6], f[7]);
  } else {
    v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  return v;
}

// 16-byte chunk [k, k + V) of flat row r0 + r's 3x3 CPE (block_common.cuh's
// Cpe: x + bias + sum_9 tap x[shifted], fp32 sums with the bias first and
// the taps in (ky, kx) order, rounded once to T). X points at flat row r0
// (row pitch C).
template <typename T>
__device__ __forceinline__ uint4 cpe_chunk(const T* X, int r, int k, int r0,
                                           int C, const Cpe& cpe) {
  constexpr int V = 16 / sizeof(T);
  const T* taps = static_cast<const T*>(cpe.taps);
  const int i = (r0 + r) % cpe.img_n;
  const int y = i / cpe.img_w, xc = i - y * cpe.img_w;
  const int img_h = cpe.img_n / cpe.img_w;
  const T* px = X + (size_t)r * C + k;
  float acc[V], f[V], w[V];
  unpack<T>(*reinterpret_cast<const uint4*>(static_cast<const T*>(cpe.bias) +
                                            k),
            acc);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    if (y + dy < 0 || y + dy >= img_h) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (xc + dx < 0 || xc + dx >= cpe.img_w) continue;
      unpack<T>(*reinterpret_cast<const uint4*>(
                    taps + ((dy + 1) * 3 + dx + 1) * C + k),
                w);
      unpack<T>(*reinterpret_cast<const uint4*>(
                    px + (ptrdiff_t)(dy * cpe.img_w + dx) * C),
                f);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(w[v], f[v], acc[v]);
    }
  }
  unpack<T>(*reinterpret_cast<const uint4*>(px), f);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = f[v] + acc[v];
  return pack<T>(acc);
}

// ---------------------------------------------------------------- wgmma, TMA

// Both types' products read their operands from shared memory in wgmma's
// K-major layout with the 128-byte swizzle: a tile of R rows and K columns
// is K / kSub sub-tiles of R rows of 128 bytes (kSub = 64 bf16 or 32 fp32
// columns), the 16-byte chunk c of row r at c ^ (r % 8). Weight tiles
// arrive in it by TMA (the Tensor Memory Accelerator writes the swizzle
// itself and zero-fills past the matrix), one thread's bulk copies
// completing on the stage's mbarrier; the rows the kernels stage themselves
// are written in it directly. bf16 multiplies on wgmma: a warpgroup (4
// warps) takes an m64 tile, and the tensor cores read both operands through
// descriptors. fp32 takes the same accumulator elements by FMA from the
// same tiles (correct, not fast; TF32 would miss the fp32 checks' 1e-4).

template <typename T>
constexpr int kSub = 128 / (int)sizeof(T);

// Byte offset of element (r, k) in a swizzled tile of R rows of T.
template <typename T>
__device__ __forceinline__ int swz(int R, int r, int k) {
  constexpr int SE = sizeof(T) == 2 ? 1 : 2;  // log2 sizeof(T)
  return (k >> (7 - SE)) * R * 128 + r * 128 +
         ((((k >> (4 - SE)) & 7) ^ (r & 7)) << 4) +
         ((k & ((16 >> SE) - 1)) << SE);
}

// Descriptor of a K-major bf16 operand whose 8-row groups of 128-byte rows
// (128-byte swizzle) start at p and lie 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma's fence, commit and wait (no-ops for the fp32 FMA products): wait
// until at most N committed groups are in flight.
template <typename T>
__device__ __forceinline__ void mma_fence() {
  if constexpr (sizeof(T) == 2)
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
template <typename T>
__device__ __forceinline__ void mma_commit() {
  if constexpr (sizeof(T) == 2)
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <typename T, int N>
__device__ __forceinline__ void mma_wait() {
  if constexpr (sizeof(T) == 2)
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of d across a wgmma wait.
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16: d += A B^T, bf16 A (64 x 16) and B (N x 16)
// read by the tensor cores from shared memory through descriptors (both
// K-major), fp32 d[N / 2] per thread in the m16n8 layout per warp (warp w
// of the warpgroup: rows 16 w + g and + 8; d[4 j .. 4 j + 3] for columns
// 8 j + 2 t, + 1). Written out per N, as the instruction lists its
// registers.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// d += A B^T over one sub-tile (128 bytes deep) for a warpgroup: A its 64
// rows at a, B its N rows at b, both swizzled with their 8-row groups
// 1024-byte aligned. bf16: four wgmma m64nNk16, issued between the
// caller's mma_fence and mma_commit; fp32: the same accumulator elements
// by FMA, k in order.
template <typename T, int N>
__device__ __forceinline__ void sub_mma(float (&d)[N / 2],
                                        const unsigned char* a,
                                        const unsigned char* b) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<N>::mma(d, wg_desc(a + kk * 32), wg_desc(b + kk * 32));
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g;
    const auto chunk = [](const unsigned char* p, int r, int c) {
      return *reinterpret_cast<const float4*>(p + r * 128 +
                                              ((c ^ (r & 7)) << 4));
    };
#pragma unroll 1
    for (int c = 0; c < 8; ++c) {
      const float4 u = chunk(a, r0, c), w = chunk(a, r0 + 8, c);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = chunk(b, 8 * j + 2 * t + h, c);
          float x0 = d[4 * j + h], x1 = d[4 * j + 2 + h];
          x0 = fmaf(u.x, v.x, x0);
          x0 = fmaf(u.y, v.y, x0);
          x0 = fmaf(u.z, v.z, x0);
          x0 = fmaf(u.w, v.w, x0);
          x1 = fmaf(w.x, v.x, x1);
          x1 = fmaf(w.y, v.y, x1);
          x1 = fmaf(w.z, v.z, x1);
          x1 = fmaf(w.w, v.w, x1);
          d[4 * j + h] = x0;
          d[4 * j + 2 + h] = x1;
        }
    }
  }
}

// mbarriers and TMA: a tile's bulk tensor copies complete a transaction
// count on its stage's mbarrier, which every thread waits on by phase.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(b)),
      "r"(phase)
      : "memory");
}
// Ends an mbarrier's life, so that its bytes may serve another purpose
// (s_stage.cu runs one work item after another in the same shared memory
// and invalidates an item's barriers, QkvWg / TailWg::barriers, once every
// thread has waited on them).
__device__ __forceinline__ void mbar_inval(uint64_t* b) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
// Box (c0, c1) (column, row) of the 2-D map into shared memory at dst.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (so the library needs no link to libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    cudaDriverEntryPointQueryResult q;
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A row-major (rows, cols) matrix of T as a TMA map of one sub-tile's
// columns (128 bytes) by box_rows rows, 128-byte swizzle, zero past its
// edges.
template <typename T>
inline int tma_map(CUtensorMap* m, const void* ptr, int rows, int cols,
                   int box_rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)kSub<T>, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      m,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- qkv

// One stream's rows and its projection out = LN1(x) W^T + b, (rows, cols):
// cols = 3C where left 0 (qkv); the C block's kv (2C) and q (C) set it.
struct QkvSeg {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  int rows;
  int cols;
};

struct QkvArgs {
  QkvSeg seg[2];   // the image rows, the meta rows (norm1 shared)
  int row_blocks0;  // row blocks of seg[0]; the rest belong to seg[1]
  const void* ln_w;
  const void* ln_b;
  int C;
  float eps;
  int tiles_per_cta;  // 128-column tiles per CTA (gridDim.y splits them)
  Cpe cpe;   // where cpe.taps is set: seg[0] is LayerNormed after its CPE,
  void* xc;  // which is also written here (rows, C) for the tail where set
  void* ln_out[2];  // where set (the training backward's recompute): each
                    // stream's LN1 rows, rounded to T, written here too
};

// Rows [row0, row0 + rows) of stream si (their 3x3 CPE in the cpe mode, also
// written to a.xc by column group 0, cg), staged once into the RB rows
// of a swizzled tile and LayerNormed there in place, a warp per row with
// two-pass fp32 statistics, rounded to T. Chunks at rows >= rows or columns
// in [C, KA) are zero.
template <typename T, bool kCpe, int RB>
__device__ __forceinline__ void stage_ln_rows(const QkvArgs& a,
                                              const QkvSeg& sg, int si,
                                              int row0, int rows, int KA,
                                              int cg, unsigned char* sA) {
  constexpr int V = 16 / sizeof(T);
  const auto at = [&](int r, int k) {
    return reinterpret_cast<T*>(sA + swz<T>(RB, r, k));
  };
  const int C = a.C, tid = threadIdx.x, nthr = blockDim.x;
  const T* X = static_cast<const T*>(sg.x) + (size_t)row0 * C;
  const bool cpe_rows = kCpe && si == 0;
  const int cv = KA / V;
  for (int e = tid; e < RB * cv; e += nthr) {
    const int r = e / cv, k = (e % cv) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && k < C) {
      if (cpe_rows) {
        v = cpe_chunk<T>(X, r, k, row0, C, a.cpe);
        if (cg == 0 && a.xc)
          *reinterpret_cast<uint4*>(static_cast<T*>(a.xc) +
                                    (size_t)(row0 + r) * C + k) = v;
      } else {
        v = *reinterpret_cast<const uint4*>(X + (size_t)r * C + k);
      }
    }
    *reinterpret_cast<uint4*>(at(r, k)) = v;
  }
  __syncthreads();
  const T* __restrict__ g = static_cast<const T*>(a.ln_w);
  const T* __restrict__ beta = static_cast<const T*>(a.ln_b);
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  for (int r = warp; r < RB; r += nwarps) {
    float s = 0.f;
    for (int k = lane; k < C; k += 32) s += to_f(*at(r, k));
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = to_f(*at(r, k)) - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / C + a.eps);
    for (int k = lane; k < C; k += 32)
      *at(r, k) = from_f<T>((to_f(*at(r, k)) - mean) * rstd * to_f(g[k]) +
                            to_f(beta[k]));
  }
}

// k_qkv_wg: 64 rows a CTA, LN1(x) staged once in the swizzled layout; each
// 128-column tile of W arrives one 128-byte sub-tile deep by TMA into a
// three-stage ring, the two warpgroups each multiply 64 of its columns
// (sub_mma), and a column tile leaves + bias by direct stores.
struct QkvMaps {
  CUtensorMap w[2];  // each stream's (3C, C) weights, 128-byte x 128 boxes
};

template <typename T>
struct QkvWg {
  static constexpr int kRows = 64, kBN = 128, kStages = 3;
  static constexpr int kTile = kBN * 128;  // bytes of a sub-tile deep tile
  static size_t smem_bytes(int C) {
    return 1024 + (size_t)kStages * kTile +
           (size_t)kRows * cdiv(C, kSub<T>) * 128 + 64;
  }
  // the kStages mbarriers of an item at base (after the ring and the rows)
  static __device__ uint64_t* barriers(unsigned char* base, int C) {
    return reinterpret_cast<uint64_t*>(base + kStages * kTile +
                                       kRows * cdiv(C, kSub<T>) * 128);
  }
};

// One work item of k_qkv_wg: row block rb of stream si (segment sg, its
// weights through maps.w[si]), its column group cg (tiles [cg
// tiles_per_cta, ...) of the 128-column tiles); base: the item's shared
// memory, 1024-aligned (QkvWg<T>::smem_bytes less the alignment slack). The
// item initialises its mbarriers (QkvWg<T>::barriers). x and its CPE
// neighbours are read by plain loads, never through the read-only path
// (s_stage.cu writes them earlier in the same launch).
template <typename T, bool kCpe, bool kLnOut = false>
__device__ __forceinline__ void qkv_wg_item(const QkvArgs& a,
                                            const QkvSeg& sg, int si, int rb,
                                            int cg, const QkvMaps& maps,
                                            unsigned char* base) {
  using L = QkvWg<T>;
  constexpr int S = L::kStages, BN = L::kBN, RB = L::kRows, KS = kSub<T>;
  const int C = a.C, ncols = sg.cols, nk = cdiv(C, KS), KA = nk * KS;
  const int ct0 = cg * a.tiles_per_cta;
  const int ct1 = min(cdiv(ncols, BN), ct0 + a.tiles_per_cta);
  if (ct0 >= ct1) return;  // uniform over the block, before any barrier
  const int row0 = rb * RB, rows = min(RB, sg.rows - row0);
  unsigned char* ring = base;
  unsigned char* sA = ring + S * L::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(sA + RB * nk * 128);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int r0 = 16 * (warp & 3) + g;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = (ct1 - ct0) * nk;
  auto load = [&](int i) {  // thread 0: tile i's box into its stage
    uint64_t* bar = full + i % S;
    mbar_expect_tx(bar, L::kTile);
    tma_2d(ring + (i % S) * L::kTile, &maps.w[si], (i % nk) * KS,
           (ct0 + i / nk) * BN, bar);
  };
  if (tid == 0)
    for (int i = 0; i < S - 1 && i < total; ++i) load(i);
  stage_ln_rows<T, kCpe, RB>(a, sg, si, row0, rows, KA, cg, sA);

  float acc[32];  // the warpgroup's 64 columns of the tile
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  T* out = static_cast<T*>(sg.out) + (size_t)row0 * ncols;
  fence_async_smem();  // LN1(x), written by the threads, for the tensor
  __syncthreads();     // cores
  if constexpr (kLnOut) {
    if (cg == 0) {  // LN1(x) rows out, 16 bytes a thread
      constexpr int V = 16 / sizeof(T);
      T* ln = static_cast<T*>(a.ln_out[si]) + (size_t)row0 * C;
      const int cv = C / V;
      for (int e = tid; e < rows * cv; e += 256) {
        const int r = e / cv, k = (e % cv) * V;
        *reinterpret_cast<uint4*>(ln + (size_t)r * C + k) =
            *reinterpret_cast<const uint4*>(sA + swz<T>(RB, r, k));
      }
    }
  }
  // bf16: tile i's products stay in flight across the barrier that frees
  // tile i - 1's stage for tile i + S - 1; only a column tile's last step
  // waits for its own.
  for (int i = 0; i < total; ++i) {
    mbar_wait(full + i % S, (i / S) & 1);
    mma_fence<T>();
    sub_mma<T, 64>(acc, sA + (i % nk) * RB * 128,
                   ring + (i % S) * L::kTile + wg * 64 * 128);
    mma_commit<T>();
    const bool epi = i % nk == nk - 1;
    if (epi) {
      mma_wait<T, 0>();
      pin(acc);
      // + bias, rounded, straight to the output: a quad's four stores fill
      // contiguous bytes of a row
      const int n0 = (ct0 + i / nk) * BN;
      const T* __restrict__ bias = static_cast<const T*>(sg.bias) + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = wg * 64 + 8 * j + 2 * t;
        if (n0 + n < ncols) {
          const float2 b = ld2(bias + n);
          if (r0 < rows)
            store2(out + (size_t)r0 * ncols + n0 + n, acc[4 * j] + b.x,
                   acc[4 * j + 1] + b.y);
          if (r0 + 8 < rows)
            store2(out + (size_t)(r0 + 8) * ncols + n0 + n,
                   acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        }
        acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.f;
      }
    } else {
      mma_wait<T, 1>();  // the accumulators stay untouched while in flight
    }
    __syncthreads();  // tile i - 1's products are done in every warpgroup
    if (tid == 0 && i + S - 1 < total) load(i + S - 1);
  }
  mma_wait<T, 0>();
}

template <typename T, bool kCpe, bool kLnOut = false>
__global__ void __launch_bounds__(256, 2)
    k_qkv_wg(const QkvArgs a, const __grid_constant__ QkvMaps maps) {
  extern __shared__ unsigned char qwg_smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(qwg_smem_raw) + 1023) & ~uintptr_t(1023));
  int rb = blockIdx.x, si = 0;
  if (rb >= a.row_blocks0) {
    rb -= a.row_blocks0;
    si = 1;
  }
  const QkvSeg sg = a.seg[si];
  qkv_wg_item<T, kCpe, kLnOut>(a, sg, si, rb, blockIdx.y, maps, base);
}

// Grid: (row blocks of both streams, column groups). Where the row blocks
// are fewer than kQkvFill, the 3C columns are split over up to that many
// CTAs per row block (each repeats the LN, not the product).
constexpr int kQkvFill = 2 * 132;

template <typename T, bool kCpe, bool kLnOut = false>
int launch_qkv_inst(const QkvArgs& a, dim3 grid, cudaStream_t s) {
  static size_t attr = 0;
  const size_t bytes = QkvWg<T>::smem_bytes(a.C);
  if (const int err = grant_smem(k_qkv_wg<T, kCpe, kLnOut>, bytes, attr))
    return err;
  QkvMaps maps;
  for (int i = 0; i < 2; ++i)
    if (const int err = tma_map<T>(&maps.w[i], a.seg[i].w, a.seg[i].cols,
                                   a.C, QkvWg<T>::kBN))
      return err;
  k_qkv_wg<T, kCpe, kLnOut><<<grid, 256, bytes, s>>>(a, maps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_qkv_tc(QkvArgs a, cudaStream_t s) {
  constexpr int RB = QkvWg<T>::kRows;
  if (a.C % 32 || a.C > 640) return (int)cudaErrorInvalidValue;
  for (QkvSeg& sg : a.seg)
    if (!sg.cols) sg.cols = 3 * a.C;
  a.row_blocks0 = cdiv(a.seg[0].rows, RB);
  const int rb = a.row_blocks0 + cdiv(a.seg[1].rows, RB);
  const int tiles =
      cdiv(max(a.seg[0].cols, a.seg[1].cols), QkvWg<T>::kBN);
  const int groups = min(tiles, max(1, cdiv(kQkvFill, rb)));
  a.tiles_per_cta = cdiv(tiles, groups);
  const dim3 grid(rb, cdiv(tiles, a.tiles_per_cta));
  if (a.ln_out[0]) {  // the training backward's recompute
    if (a.cpe.taps) return launch_qkv_inst<T, true, true>(a, grid, s);
    return launch_qkv_inst<T, false, true>(a, grid, s);
  }
  if (a.cpe.taps) return launch_qkv_inst<T, true>(a, grid, s);
  return launch_qkv_inst<T, false>(a, grid, s);
}

// ---------------------------------------------------------------- tail

// One launch takes two streams' tails (block_common.cuh's TailArgs; cpe
// stays unset): out = t1 + MLP(LN2(t1)), t1 = t + o Wp^T + bp, the streams
// sharing norm2 + MLP. The inference instances leave s1, s2, seq and t1
// unset. kTrain (the training forward, s_train.cu, where seg[0].s1 is set)
// takes each row's DropPath branch scales s1 / s2 of its image (row /
// seq: the image stream's seq is N, the meta stream's M), t1 = t + s1 (o
// Wp^T + bp), writes t1 rounded to T (mlp_bwd's input) from the
// accumulators, starts the fc2 sum at t1 + s2 b2 and scales each GELU
// chunk by s2 before its rounding to T, so out = t1 + s2 (b2 + MLP) with
// the fc2 sum still in the same registers.

// The tail at CP <= 512: two warpgroups split the columns (each an m64 x
// CP/2 product for proj and fc2, m64 x 64 for fc1); proj and fc2 tiles (CP
// weight rows x one sub-tile) and fc1 tiles (128 rows x kFD) arrive by TMA
// into the ring; o, LN2(t1) and the GELU chunk are written in the swizzled
// layout by the kernel.

// The tail's weights as TMA maps: boxes of one sub-tile (128 bytes, the
// swizzle's row) by kBoxP rows (proj, fc2) or 128 rows (fc1).
struct TailMaps {
  CUtensorMap wp[2];  // each stream's proj, (C, C)
  CUtensorMap w1;     // (hidden, C)
  CUtensorMap w2;     // (C, hidden)
};

// fc1 tile depth: KS d, d the largest divisor of KA / KS with 128 d <= CP
// (an fc1 tile moves no more bytes than a proj tile), at least one.
constexpr int wg_fc1_depth(int CP, int KA, int KS) {
  int best = 1;
  for (int d = 1; d <= KA / KS; ++d)
    if ((KA / KS) % d == 0 && 128 * d <= CP) best = d;
  return KS * best;
}

template <typename T, int CP>
struct TailWg {
  static constexpr int kRows = 64;
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr int kKS = kSub<T>;   // columns of a 128-byte sub-tile
  static constexpr int kN = CP / 2;     // a warpgroup's columns
  static constexpr int kHid = 128;      // hidden chunk width
  static constexpr int kHN = kHid / 2;  // a warpgroup's hidden columns
  static constexpr int kKA = (CP + kKS - 1) / kKS * kKS;  // A columns
  static constexpr int kFD = wg_fc1_depth(CP, kKA, kKS);
  static constexpr int kBoxP = CP > 256 ? CP / 2 : CP;  // TMA box rows
  static constexpr int kTileP = CP * 128;              // proj / fc2, bytes
  static constexpr int kTileF = kHid * kFD * (int)sizeof(T);  // fc1, bytes
  static constexpr int kStage = kTileP > kTileF ? kTileP : kTileF;
  static constexpr int kSA = kRows * kKA * (int)sizeof(T);  // o, LN2(t1),
                                                            // the output
  static constexpr int kSH = kRows * kHid * (int)sizeof(T);  // hidden chunk
  static constexpr int kRed = 2 * 2 * kRows * 4;  // [pass][warpgroup][row]
  static constexpr size_t kFixed = 1024 + kSA + kSH + kRed + 64;  // + align,
                                                                  // mbarriers
  // as many stages as fit in the 227 KB a CTA can have, up to four (fp32
  // at CP = 512: one, the next tile's load then waits for the products)
  static constexpr int kStages = kFixed + 4 * (size_t)kStage <= 232448   ? 4
                                 : kFixed + 3 * (size_t)kStage <= 232448 ? 3
                                 : kFixed + 2 * (size_t)kStage <= 232448 ? 2
                                                                         : 1;
  static constexpr size_t kSmem = kFixed + (size_t)kStages * kStage;
  static_assert(kN % 8 == 0 && kStage % 1024 == 0 && kSA % 1024 == 0,
                "wgmma tiers");
  // the kStages mbarriers of an item at base (after sA, sH, the ring and
  // the row sums)
  static __device__ uint64_t* barriers(unsigned char* base) {
    return reinterpret_cast<uint64_t*>(base + kSA + kSH + kStages * kStage +
                                       4 * kRows * 4);
  }
};

// One work item of k_tail_wg: row block `block` of both streams' blocks
// (a.row_blocks0 of the image stream first; segment a.seg[si], its proj
// weights through maps.wp[si], fc1 / fc2 through maps.w1 / w2); base as
// qkv_wg_item's (TailWg<T, CP>::kSmem less the slack). The item
// initialises its mbarriers (TailWg<T, CP>::barriers). t and o are read by
// plain loads and cp.async.cg (L2), never through the read-only path:
// s_stage.cu writes them earlier in the same launch.
template <typename T, int CP, bool kTrain = false>
__device__ __forceinline__ void tail_wg_item(const TailArgs& a, int block,
                                             const TailMaps& maps,
                                             unsigned char* base) {
  using L = TailWg<T, CP>;
  constexpr int S = L::kStages, RB = L::kRows, NT = L::kN / 8, KS = L::kKS;
  constexpr int NTH = L::kHN / 8, HID = L::kHid, NTHR = L::kThreads;
  constexpr int V = 16 / sizeof(T);
  unsigned char* sA = base;
  unsigned char* sH = sA + L::kSA;
  unsigned char* ring = sH + L::kSH;
  float* red = reinterpret_cast<float*>(ring + S * L::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * RB);  // [S]
  int rb = block, si = 0;
  if (rb >= a.row_blocks0) {
    rb -= a.row_blocks0;
    si = 1;
  }
  const TailSeg sg = a.seg[si];
  const int C = a.C, hidden = a.hidden;
  const int row0 = rb * RB, rows = min(RB, sg.rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, its warp
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int r0 = 16 * wq + g;               // rows r0, r0 + 8
  const CUtensorMap* wp_map = &maps.wp[si];
  float dp1[2] = {1.f, 1.f}, dp2[2] = {1.f, 1.f};  // rows r0, r0 + 8
  if constexpr (kTrain) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int img = min(row0 + r0 + 8 * h, sg.rows - 1) / sg.seq;
      dp1[h] = sg.s1[img];
      dp2[h] = sg.s2[img];
    }
  }

  const int nk = cdiv(C, KS), nf = cdiv(C, L::kFD);
  constexpr int nh = HID / KS;
  const int chunks = cdiv(hidden, HID);
  const int total = nk + chunks * nf + (chunks - 1) * nh +
                    cdiv(hidden - (chunks - 1) * HID, KS);
  struct Tile {
    int kind, k0, j0;  // kind 0 proj, 1 fc1, 2 fc2
    bool last;
  };
  auto decode = [&](int i) {
    if (i < nk) return Tile{0, i * KS, 0, i == nk - 1};
    i -= nk;
    const int chunk = i / (nf + nh), r = i % (nf + nh);
    if (r < nf) return Tile{1, r * L::kFD, chunk * HID, r == nf - 1};
    return Tile{2, (r - nf) * KS, chunk * HID, false};
  };
  // thread 0 issues tile i's boxes into its stage
  auto load = [&](int i) {
    const Tile tl = decode(i);
    unsigned char* dst = ring + (i % S) * L::kStage;
    uint64_t* bar = full + i % S;
    if (tl.kind == 1) {
      mbar_expect_tx(bar, L::kTileF);
#pragma unroll
      for (int s = 0; s < L::kFD / KS; ++s)
        tma_2d(dst + s * HID * 128, &maps.w1, tl.k0 + KS * s, tl.j0, bar);
    } else {
      mbar_expect_tx(bar, L::kTileP);
      const CUtensorMap* m = tl.kind == 0 ? wp_map : &maps.w2;
      const int c = tl.kind == 0 ? tl.k0 : tl.j0 + tl.k0;
#pragma unroll
      for (int r = 0; r < CP; r += L::kBoxP)
        tma_2d(dst + r * 128, m, c, r, bar);
    }
  };

  // o rows into sA (proj's A operand, zero past C), in the first group
  {
    const T* o = static_cast<const T*>(sg.o) + (size_t)row0 * C;
    constexpr int cv = L::kKA / V;
    for (int e = tid; e < RB * cv; e += NTHR) {
      const int r = e / cv, k = (e % cv) * V;
      const bool ok = r < rows && k < C;
      cp_async16(sA + swz<T>(RB, r, k), ok ? o + (size_t)r * C + k : o, ok);
    }
  }
  cp_async_commit();
  if (tid == 0)
    for (int i = 0; i < S - 1 && i < total; ++i) load(i);
  cp_async_wait<0>();

  float acc[L::kN / 2];  // t1, then t1 + b2 + fc2 (columns wg kN + ...)
  float hacc[L::kHN / 2];
#pragma unroll
  for (int i = 0; i < L::kN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < L::kHN / 2; ++i) hacc[i] = 0.f;
  const int c0 = wg * L::kN;  // the warpgroup's first column

  for (int i = 0; i < total; ++i) {
    fence_async_smem();  // the o rows' copies and this thread's epilogue
                         // writes, for the tensor cores' reads
    __syncthreads();     // ... and every warpgroup is done with tile i - 1
    if (tid == 0 && i + S - 1 < total) load(i + S - 1);
    mbar_wait(full + i % S, (i / S) & 1);  // tile i landed
    const Tile tl = decode(i);
    const unsigned char* st = ring + (i % S) * L::kStage;
    mma_fence<T>();
    if (tl.kind == 0) {
      sub_mma<T, L::kN>(acc, sA + (tl.k0 / KS) * RB * 128, st + c0 * 128);
    } else if (tl.kind == 1) {
#pragma unroll
      for (int s = 0; s < L::kFD / KS; ++s)
        sub_mma<T, L::kHN>(hacc, sA + (tl.k0 / KS + s) * RB * 128,
                           st + s * HID * 128 + wg * L::kHN * 128);
    } else {
      sub_mma<T, L::kN>(acc, sH + (tl.k0 / KS) * RB * 128, st + c0 * 128);
    }
    mma_commit<T>();
    mma_wait<T, 0>();
    pin(acc);
    pin(hacc);
    if (tl.kind == 0 && tl.last) {
      // t1 = t + o Wp^T + bp in the accumulator, then LN2(t1) into sA
      const T* __restrict__ bp = static_cast<const T*>(sg.bp);
      const T* tres = static_cast<const T*>(sg.t) + (size_t)row0 * C;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = c0 + 8 * j + 2 * t;
        if (n < C) {
          const float2 b = ld2(bp + n);
          const float2 x0 = r0 < rows ? ld2(tres + (size_t)r0 * C + n)
                                      : make_float2(0.f, 0.f);
          const float2 x1 = r0 + 8 < rows
                                ? ld2(tres + (size_t)(r0 + 8) * C + n)
                                : make_float2(0.f, 0.f);
          if constexpr (!kTrain) {
            acc[4 * j] += b.x + x0.x;
            acc[4 * j + 1] += b.y + x0.y;
            acc[4 * j + 2] += b.x + x1.x;
            acc[4 * j + 3] += b.y + x1.y;
          } else {  // t1 = t + s1 (o Wp^T + bp), out rounded to T
            acc[4 * j] = fmaf(dp1[0], acc[4 * j] + b.x, x0.x);
            acc[4 * j + 1] = fmaf(dp1[0], acc[4 * j + 1] + b.y, x0.y);
            acc[4 * j + 2] = fmaf(dp1[1], acc[4 * j + 2] + b.x, x1.x);
            acc[4 * j + 3] = fmaf(dp1[1], acc[4 * j + 3] + b.y, x1.y);
            T* t1 = static_cast<T*>(sg.t1) + (size_t)row0 * C + n;
            if (r0 < rows)
              store2(t1 + (size_t)r0 * C, acc[4 * j], acc[4 * j + 1]);
            if (r0 + 8 < rows)
              store2(t1 + (size_t)(r0 + 8) * C, acc[4 * j + 2],
                     acc[4 * j + 3]);
          }
          s0 += acc[4 * j] + acc[4 * j + 1];
          s1 += acc[4 * j + 2] + acc[4 * j + 3];
        }
      }
      s0 = quad_sum(s0);
      s1 = quad_sum(s1);
      if (t == 0) {
        red[wg * RB + r0] = s0;
        red[wg * RB + r0 + 8] = s1;
      }
      __syncthreads();  // also: every warpgroup's proj reads of sA are done
      const float m0 = (red[r0] + red[RB + r0]) / C;
      const float m1 = (red[r0 + 8] + red[RB + r0 + 8]) / C;
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (c0 + 8 * j + 2 * t < C) {
          float d;
          d = acc[4 * j] - m0; q0 += d * d;
          d = acc[4 * j + 1] - m0; q0 += d * d;
          d = acc[4 * j + 2] - m1; q1 += d * d;
          d = acc[4 * j + 3] - m1; q1 += d * d;
        }
      }
      q0 = quad_sum(q0);
      q1 = quad_sum(q1);
      float* red2 = red + 2 * RB;
      if (t == 0) {
        red2[wg * RB + r0] = q0;
        red2[wg * RB + r0 + 8] = q1;
      }
      __syncthreads();
      const float rs0 = rsqrtf((red2[r0] + red2[RB + r0]) / C + a.eps);
      const float rs1 =
          rsqrtf((red2[r0 + 8] + red2[RB + r0 + 8]) / C + a.eps);
      const T* __restrict__ lg = static_cast<const T*>(a.ln_w);
      const T* __restrict__ lb = static_cast<const T*>(a.ln_b);
      const T* __restrict__ b2 = static_cast<const T*>(a.b2);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = c0 + 8 * j + 2 * t;
        const bool ok = n < C;  // past C: zero, fc1 reads up to kKA
        const float2 gg = ok ? ld2(lg + n) : make_float2(0.f, 0.f);
        const float2 bb = ok ? ld2(lb + n) : make_float2(0.f, 0.f);
        const float2 c2 = ok ? ld2(b2 + n) : make_float2(0.f, 0.f);
        store2(reinterpret_cast<T*>(sA + swz<T>(RB, r0, n)),
               ok ? (acc[4 * j] - m0) * rs0 * gg.x + bb.x : 0.f,
               ok ? (acc[4 * j + 1] - m0) * rs0 * gg.y + bb.y : 0.f);
        store2(reinterpret_cast<T*>(sA + swz<T>(RB, r0 + 8, n)),
               ok ? (acc[4 * j + 2] - m1) * rs1 * gg.x + bb.x : 0.f,
               ok ? (acc[4 * j + 3] - m1) * rs1 * gg.y + bb.y : 0.f);
        acc[4 * j] = fmaf(dp2[0], c2.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(dp2[0], c2.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(dp2[1], c2.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(dp2[1], c2.y, acc[4 * j + 3]);
      }
    } else if (tl.kind == 1 && tl.last) {
      // h = GELU(LN2(t1) W1c^T + b1c), rounded to T, into sH (zero past
      // the hidden width, where fc2's weights are zero-filled too)
      const T* __restrict__ b1 = static_cast<const T*>(a.b1);
#pragma unroll
      for (int j = 0; j < NTH; ++j) {
        const int n = wg * L::kHN + 8 * j + 2 * t, gn = tl.j0 + n;
        const bool ok = gn < hidden;
        const float2 b = ok ? ld2(b1 + gn) : make_float2(0.f, 0.f);
        store2(reinterpret_cast<T*>(sH + swz<T>(RB, r0, n)),
               ok ? dp2[0] * gelu_erf(hacc[4 * j] + b.x) : 0.f,
               ok ? dp2[0] * gelu_erf(hacc[4 * j + 1] + b.y) : 0.f);
        store2(reinterpret_cast<T*>(sH + swz<T>(RB, r0 + 8, n)),
               ok ? dp2[1] * gelu_erf(hacc[4 * j + 2] + b.x) : 0.f,
               ok ? dp2[1] * gelu_erf(hacc[4 * j + 3] + b.y) : 0.f);
        hacc[4 * j] = hacc[4 * j + 1] = hacc[4 * j + 2] = hacc[4 * j + 3] =
            0.f;
      }
    }
  }
  // out = t1 + b2 + fc2, through sA, then 16-byte stores
  __syncthreads();  // every warpgroup is done with its last tile
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = c0 + 8 * j + 2 * t;
    if (n < C) {
      store2(reinterpret_cast<T*>(sA + swz<T>(RB, r0, n)), acc[4 * j],
             acc[4 * j + 1]);
      store2(reinterpret_cast<T*>(sA + swz<T>(RB, r0 + 8, n)),
             acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(sg.out) + (size_t)row0 * C;
  const int cv = C / V;
  for (int e = tid; e < rows * cv; e += NTHR) {
    const int r = e / cv, k = (e % cv) * V;
    *reinterpret_cast<uint4*>(out + (size_t)r * C + k) =
        *reinterpret_cast<const uint4*>(sA + swz<T>(RB, r, k));
  }
}

template <typename T, int CP, bool kTrain = false>
__global__ void __launch_bounds__(256, 1)
    k_tail_wg(const TailArgs a, const __grid_constant__ TailMaps maps) {
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  tail_wg_item<T, CP, kTrain>(a, blockIdx.x, maps, base);
}

template <typename T, int CP, bool kTrain>
int launch_tail_wg(const TailArgs& a, cudaStream_t s) {
  using L = TailWg<T, CP>;
  static size_t attr = 0;
  constexpr size_t bytes = L::kSmem;
  static_assert(bytes <= 232448, "tail shared memory");
  if (const int err = grant_smem(k_tail_wg<T, CP, kTrain>, bytes, attr))
    return err;
  TailMaps maps;
  int err = 0;
  for (int i = 0; i < 2 && !err; ++i)
    err = tma_map<T>(&maps.wp[i], a.seg[i].wp, a.C, a.C, L::kBoxP);
  if (!err) err = tma_map<T>(&maps.w1, a.w1, a.hidden, a.C, L::kHid);
  if (!err) err = tma_map<T>(&maps.w2, a.w2, a.C, a.hidden, L::kBoxP);
  if (err) return err;
  const int blocks = a.row_blocks0 + cdiv(a.seg[1].rows, L::kRows);
  k_tail_wg<T, CP, kTrain><<<blocks, L::kThreads, bytes, s>>>(a, maps);
  return (int)cudaGetLastError();
}

// The accumulator tiers: exact for every released width (64, 96, 128, 192,
// 320, 384, 512); other multiples of 32 round up, and columns past C
// compute on the zeros TMA fills in and are dropped. Past C = 512 the rows
// of o and LN2(t1) and a proj tile outgrow a CTA's shared memory in this
// layout (fp32's already at 640 x 64 rows), so those widths, which no
// released model has, run block_common.cuh's k_block_tail (32 rows a CTA,
// the same order of work and roundings). by_tier runs
// launch(std::integral_constant<int, CP>()) at C's tier CP (also for
// train_tc.cuh's row kernels, which have no path past C = 512: their
// wrappers refuse it, attn/fused_train.py MAX_TRAIN_DIM).
template <typename Launch>
int by_tier(int C, Launch launch) {
  if (C % 32 || C < 32 || C > 512) return (int)cudaErrorInvalidValue;
  if (C <= 64) return launch(std::integral_constant<int, 64>());
  if (C <= 96) return launch(std::integral_constant<int, 96>());
  if (C <= 128) return launch(std::integral_constant<int, 128>());
  if (C <= 192) return launch(std::integral_constant<int, 192>());
  if (C <= 256) return launch(std::integral_constant<int, 256>());
  if (C <= 320) return launch(std::integral_constant<int, 320>());
  if (C <= 384) return launch(std::integral_constant<int, 384>());
  return launch(std::integral_constant<int, 512>());
}

// seg[0].s1 set: the training instance (kTrain), which takes C <= 512
// (attn/fused_train.py MAX_TRAIN_DIM) and both streams' s1, s2, seq, t1.
template <typename T>
int launch_tail_tc(TailArgs a, cudaStream_t s) {
  const int C = a.C;
  const bool train = a.seg[0].s1 != nullptr;
  if (C % 32 || C > 640 || a.hidden % 32 || a.hidden < 32)
    return (int)cudaErrorInvalidValue;
  if (train) {
    for (int i = 0; i < 2; ++i) {
      const TailSeg& g = a.seg[i];
      if (!g.s1 || !g.s2 || !g.t1 || g.seq < 1)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (C > 512) {
    if (train) return (int)cudaErrorInvalidValue;
    a.row_blocks0 = cdiv(a.seg[0].rows, kTailBM);
    return launch_tail<T>(a, s);
  }
  a.row_blocks0 = cdiv(a.seg[0].rows, TailWg<T, 64>::kRows);
  return by_tier(C, [&](auto cp) {
    if (train) return launch_tail_wg<T, decltype(cp)::value, true>(a, s);
    return launch_tail_wg<T, decltype(cp)::value, false>(a, s);
  });
}

// ---------------------------------------------------------------- attention

// Self-attention of one stream on attn_tc.cuh's tiles (mhsa.cu's choice:
// a warp per (image, head) at N <= 16).
template <typename T, bool kLse>
int launch_mhsa_inst(const AttnArgs& a, cudaStream_t s) {
  if (a.nq <= kTcSmall) {
    k_mhsa_tc_small<T, kLse><<<cdiv(a.batch * a.heads, kTcWarps),
                               kTcThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  k_mhsa_tc<T, kLse><<<dim3(a.batch * a.heads, cdiv(a.nq, MhsaTile<T>::kQ)),
                       kTcThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// a.lse set (the training forward): the instances that also write each
// query's log-sum-exp.
template <typename T>
int launch_mhsa_tc(const AttnArgs& a, cudaStream_t s) {
  if (a.nq != a.nk) return (int)cudaErrorInvalidValue;
  if (a.lse) return launch_mhsa_inst<T, true>(a, s);
  return launch_mhsa_inst<T, false>(a, s);
}

// Meta rows of one CTA of the c direction alone (k_dca_tc with kX false):
// more split over the grid's z, so any M fits in shared memory.
constexpr int kDcaMetaChunk = 256;

// DCA on attn_tc.cuh's tiles plus the fixed-order merge (dca_attn.cu's
// launches); a.tiles = ceil(n / DcaTile<T>::kRows). kX: both directions
// (kLse: with each row's log-sum-exp at a.lse_x / a.lse_c); else the c
// direction alone, its meta rows in chunks of up to kDcaMetaChunk (kLse:
// the C block's training forward, the meta rows' log-sum-exp at a.lse_c,
// written by the merge alone, so k_dca_tc runs its inference instance).
template <typename T, bool kX = true, bool kLse = false>
int launch_dca_tc(DcaArgs a, cudaStream_t s) {
  constexpr bool kTileLse = kX && kLse;  // k_dca_tc writes lse_x
  static size_t attr = 0;
  if (a.m < 1 || (kLse && (!a.lse_c || (kX && !a.lse_x))))
    return (int)cudaErrorInvalidValue;
  int mp = cdiv(a.m, kMetaTile) * kMetaTile, chunks = 1;
  if constexpr (!kX) {
    a.mc = min(mp, kDcaMetaChunk);
    chunks = cdiv(a.m, a.mc);
    mp = a.mc;
  }
  // with kX, an M whose rows do not fit fails here (cudaErrorInvalidValue)
  const size_t bytes = dca_smem_bytes<T, kX>(mp);
  if (const int err = grant_smem(k_dca_tc<T, kX, kTileLse>, bytes, attr))
    return err;
  k_dca_tc<T, kX, kTileLse><<<dim3(a.tiles, a.batch, chunks),
                              2 * DcaTile<T>::kRows, bytes, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  k_dca_merge<T, kLse><<<a.batch * a.heads * a.m, kMergeWarps * 32, 0, s>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lm
