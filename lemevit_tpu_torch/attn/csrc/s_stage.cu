// A whole stage of pre-norm S blocks in one launch: for each block j in
// order, x <- CPE_j(x) (when the blocks have one), then the S block on x and,
// with the same weights, on the meta tokens c (which attend only to
// themselves). Replaces the TPU kernel
// lemevit_tpu/attn/pallas_block.py::s_stage (_s_stage_call, _s_stage_kernel).
//
// Design. The TPU walked (batch folds x blocks) in order on one core and
// carried x in VMEM scratch. Here one persistent launch (about one CTA an
// SM) runs the chain of s_block.cu's own tiles (block_tc.cuh, attn_tc.cuh)
// as work items of one ordered list, the schedule that
// attn/fused_block.py::stage_schedule builds on the host (cached per shape):
// for each block j, the qkv items of both streams (qkv_wg_item: 64 rows of
// one stream x a group of 128-column tiles, LN1 and in the cpe mode the CPE
// staged once, weight tiles by TMA into a ring, wgmma), then the attention
// items (mhsa_rows_tile: each warpgroup 128 queries of one (image, head);
// mhsa_small_tile at N <= 16: each warp one (image, head)), then the tail
// items (tail_wg_item: 64 rows of one stream through proj, LN2 and the MLP;
// past C = 512 block_common.cuh's tail_rows over 32 rows, as the chain),
// each phase ordered by image, so early images run ahead. A CTA claims the
// next item with an atomic ticket and, before it starts, waits for the
// item's dependencies, read from per-image completion counters: qkv(j) on
// tail(j - 1), attention(j) on qkv(j), tail(j) on attention(j) of every
// image the item touches (a 64-row block may straddle images; the CPE reads
// only rows of its own image). Every dependency lies earlier in the list and
// tickets are taken in order, so an awaited item is held by a running CTA:
// no deadlock, no cooperative launch. Block j + 1 of image 0 overlaps block
// j of image B - 1, the row blocks are flat over the batch (no ragged last
// tile per image), and the chain's launch gaps are gone.
//
// Memory. x and c are carried in the output buffers (block 0 reads the
// inputs); the CPE'd x (the tail's residual), qkv and the attention output
// live in workspaces, written and read within the launch. Such data is read
// by plain loads or cp.async.cg after a gpu-scope acquire, never through the
// read-only path; TMA reads only weights. An item is published by
// __syncthreads, then one thread's __threadfence and release add on each of
// its images' counters; the waiter spins with ld.acquire.gpu, then
// __syncthreads; a wait longer than 10 s (a fault of the schedule) traps.
// The ticket and the counters are zeroed by a memset before the launch.
// Each item's arguments sit in shared memory (StageItem); each item
// initialises its mbarriers and the stage invalidates them after it, so
// the next item may use those bytes. The weights: a device table of
// StageBlock (each block's TMA maps, built here on the host,
// lm_s_stage_table, and its pointers), copied on the stream before the
// launch, so any depth runs.
//
// Numerics: the same tiles, K orders and roundings as the chain of
// s_block(cpe=...) launches (x rounded to T between blocks in both), so the
// result is the chain's bit for bit, in bf16 and fp32.
//
// Bound on the H100: operations, as for s_block: ~24 C^2 multiply-adds per
// row and block (chip_smoke.py::work summed over the blocks: ~0.94 ms for
// base's stage 3, 18 blocks, N = 196, C = 384, batch 64). One CTA an SM
// (the tail needs 255 registers and up to 227 KB) gives up the chain's two
// qkv CTAs and three attention CTAs an SM, and each item pays a ticket and
// a wait; against that it saves the chain's launch gaps and wave tails. Its
// times beside the chain's: PERF.md, section 6, row 6.
#include <string.h>

#include <algorithm>

#include "block_tc.cuh"

namespace lm {
namespace {

// per block: ln1_w, ln1_b, wqkv, bqkv, wp, bp, ln2_w, ln2_b, w1, b1, w2, b2,
// cpe_taps, cpe_bias
constexpr int kStageParams = 14;

// One block's weights on the device: its TMA maps (wqkv for both streams;
// wp for both streams, w1, w2; none past C = 512) and its pointers.
struct StageBlock {
  QkvMaps qkv;
  TailMaps tail;
  const void* p[kStageParams];
};
static_assert(sizeof(StageBlock) == 896,
              "attn/fused_block.py STAGE_BLOCK_BYTES");

// The fields of one schedule row (attn/fused_block.py STAGE_FIELDS): the
// phase (0 qkv, 1 attention, 2 tail), the block, the stream (0 x, 1 c), the
// row block (qkv, tail) or first unit (attention), the column group (qkv),
// the first and last image touched, and the wait: every item of phase
// wait_phase touching each of those images done wait_mult times over
// (wait_mult blocks' worth of counts[wait_phase][image]; 0: none).
enum {
  kKind,
  kBlock,
  kStream,
  kIndex,
  kGroup,
  kFirst,
  kLast,
  kWaitPhase,
  kWaitMult,
  kFields
};

struct StageArgs {
  const void* x;
  const void* c;
  void* xo;     // (B*N, C): the carried x, the stage's output
  void* co;     // (B*M, C)
  void* xa;     // (B*N, C): CPE'd x (with the CPE)
  void* qkv_x;  // (B*N, 3C)
  void* qkv_c;  // (B*M, 3C)
  void* o_x;    // (B*N, C)
  void* o_c;    // (B*M, C)
  const StageBlock* blocks;
  const int* items;   // (n_items, kFields)
  const int* counts;  // (3, B): items of each phase a block touching an image
  int* sync;          // the ticket, then done (3, B)
  int n_items, B, N, M, C, H, hidden, img_w, use_cpe, qkv_tiles;
  float scale, eps;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait of more than 10 s means a fault of the schedule: trap, so that it
// shows as a launch error and not as a hung card.
constexpr uint64_t kWaitLimitNs = 10000000000ull;

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The item in progress, in shared memory: its schedule row and its tile's
// arguments, which the tile reads where it uses them instead of holding
// them in registers beside its accumulators (at C = 512 the tail's fill
// all 255).
struct StageItem {
  int f[kFields];
  QkvArgs q;
  QkvSeg qs;
  AttnArgs at;
  TailArgs t;  // its segment in t.seg[stream]
};

// Thread 0: the arguments of item it.f's tile (block j's weights blk).
template <typename T>
__device__ __forceinline__ void stage_args(const StageArgs& a,
                                           const StageBlock& blk,
                                           StageItem& it) {
  const int kind = it.f[kKind], j = it.f[kBlock];
  const bool isx = it.f[kStream] == 0;
  const void* in = isx ? (j ? a.xo : a.x) : (j ? a.co : a.c);
  const int rows = isx ? a.B * a.N : a.B * a.M;
  if (kind == 0) {
    it.q = QkvArgs{};
    it.q.ln_w = blk.p[0];
    it.q.ln_b = blk.p[1];
    it.q.C = a.C;
    it.q.eps = a.eps;
    it.q.tiles_per_cta = a.qkv_tiles;
    it.q.cpe = Cpe{blk.p[12], blk.p[13], a.img_w, a.N};
    it.q.xc = a.xa;
    it.qs = QkvSeg{in,   blk.p[2], blk.p[3], isx ? a.qkv_x : a.qkv_c,
                   rows, 3 * a.C};
  } else if (kind == 1) {
    const T* qkv = static_cast<const T*>(isx ? a.qkv_x : a.qkv_c);
    it.at = AttnArgs{};
    it.at.q = qkv;
    it.at.k = qkv + a.C;
    it.at.v = qkv + 2 * a.C;
    it.at.out = isx ? a.o_x : a.o_c;
    it.at.ldq = it.at.ldkv = 3 * a.C;
    it.at.ldo = a.C;
    it.at.batch = a.B;
    it.at.heads = a.H;
    it.at.nq = it.at.nk = isx ? a.N : a.M;
    it.at.scale = a.scale;
  } else {
    it.t = TailArgs{};
    it.t.ln_w = blk.p[6];
    it.t.ln_b = blk.p[7];
    it.t.w1 = blk.p[8];
    it.t.b1 = blk.p[9];
    it.t.w2 = blk.p[10];
    it.t.b2 = blk.p[11];
    it.t.C = a.C;
    it.t.hidden = a.hidden;
    it.t.eps = a.eps;
    it.t.row_blocks0 = cdiv(a.B * a.N, TailWg<T, 64>::kRows);
    // the residual: the CPE'd x (written by this block's qkv items) or the
    // block's input; the output in place in the carried buffer
    TailSeg& sg = it.t.seg[it.f[kStream]];
    sg = TailSeg{};
    sg.t = isx && a.use_cpe ? a.xa : in;
    sg.o = isx ? a.o_x : a.o_c;
    sg.wp = blk.p[4];
    sg.bp = blk.p[5];
    sg.out = isx ? a.xo : a.co;
    sg.rows = rows;
  }
}

// Attention units of one stream: at n <= kTcSmall, warp w takes (image,
// head) idx + w; else warpgroup g takes unit idx + g, (image, head) u / qb,
// queries from (u % qb) kQ, in its own half of shared memory.
template <typename T>
__device__ __forceinline__ void stage_attn(const AttnArgs& at, int idx,
                                           unsigned char* base) {
  if (at.nq <= kTcSmall) {
    mhsa_small_tile<T>(at, idx, reinterpret_cast<T*>(base));
    return;
  }
  constexpr int Q = MhsaTile<T>::kQ;
  const int qb = cdiv(at.nq, Q), wg = threadIdx.x >> 7, u = idx + wg;
  if (u < at.batch * at.heads * qb)  // uniform over the warpgroup
    mhsa_rows_tile<T, false, true>(
        at, u / qb, (u % qb) * Q,
        reinterpret_cast<T*>(base + wg * MhsaTile<T>::kSmemBytes));
}

template <typename T, int CP>
__global__ void __launch_bounds__(256, 1) k_s_stage(const StageArgs a) {
  extern __shared__ unsigned char stage_smem_raw[];
  __shared__ StageItem it;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(stage_smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  int* done = a.sync + 1;
  for (;;) {
    fence_async_smem();  // the last item's shared-memory writes, before the
    __syncthreads();     // next one's TMA and wgmma; every thread is done
    if (tid == 0) {
      // claim the next item, wait for its dependencies, set its arguments
      // (claiming the one after ahead of time measured slower: a CTA busy
      // with one item holds back the next from an idle one)
      const int cur = atomicAdd(a.sync, 1);
      if (cur < a.n_items) {
        for (int f = 0; f < kFields; ++f)
          it.f[f] = a.items[(size_t)cur * kFields + f];
        if (it.f[kWaitMult] > 0) {
          const int ph = it.f[kWaitPhase] * a.B, mult = it.f[kWaitMult];
          const uint64_t t0 = global_ns();
          for (int i = it.f[kFirst]; i <= it.f[kLast]; ++i) {
            const int need = mult * a.counts[ph + i];
            while (ld_acquire(done + ph + i) < need) {
              if (global_ns() - t0 > kWaitLimitNs) __trap();
              __nanosleep(64);
            }
          }
        }
        stage_args<T>(a, a.blocks[it.f[kBlock]], it);
      } else {
        it.f[kKind] = -1;
      }
    }
    __syncthreads();
    const int kind = it.f[kKind];
    if (kind < 0) break;
    const StageBlock& blk = a.blocks[it.f[kBlock]];
    if (kind == 0) {
      if (a.use_cpe)
        qkv_wg_item<T, true>(it.q, it.qs, it.f[kStream], it.f[kIndex],
                             it.f[kGroup], blk.qkv, base);
      else
        qkv_wg_item<T, false>(it.q, it.qs, it.f[kStream], it.f[kIndex],
                              it.f[kGroup], blk.qkv, base);
    } else if (kind == 1) {
      stage_attn<T>(it.at, it.f[kIndex], base);
    } else if constexpr (CP <= 512) {
      tail_wg_item<T, CP>(it.t, it.t.row_blocks0 * it.f[kStream] +
                                    it.f[kIndex],
                          blk.tail, base);
    } else {
      tail_rows<T>(it.t, it.t.seg[it.f[kStream]], it.f[kIndex] * kTailBM,
                   base);
    }
    __syncthreads();  // every thread's writes of the item are done, and
                      // every wait on its mbarriers
    if (tid == 0) {
      const int done_kind = it.f[kKind];
      if (done_kind == 0) {
        uint64_t* bar = QkvWg<T>::barriers(base, a.C);
        for (int i = 0; i < QkvWg<T>::kStages; ++i) mbar_inval(bar + i);
      } else if constexpr (CP <= 512) {
        if (done_kind == 2) {
          uint64_t* bar = TailWg<T, CP>::barriers(base);
          for (int i = 0; i < TailWg<T, CP>::kStages; ++i)
            mbar_inval(bar + i);
        }
      }
      __threadfence();
      for (int i = it.f[kFirst]; i <= it.f[kLast]; ++i)
        add_release(done + done_kind * a.B + i, 1);
    }
  }
}

// The tail's tier: block_tc.cuh's (C <= 512), or 640 for tail_rows.
template <typename Launch>
int stage_tier(int C, Launch launch) {
  if (C > 512 && C <= 640 && C % 32 == 0)
    return launch(std::integral_constant<int, 640>());
  return by_tier(C, launch);
}

// The largest shared memory of a phase (each with its 1024-byte alignment
// slack): the qkv ring and rows, the two warpgroups' attention tiles (or
// eight warps' small tiles), the tail.
template <typename T, int CP>
size_t stage_smem_bytes(int C) {
  size_t b = QkvWg<T>::smem_bytes(C);
  const size_t small = (size_t)kWarps * 48 * TcRows<T>::kPitch * sizeof(T);
  const size_t rows = 2 * (size_t)MhsaTile<T>::kSmemBytes;
  b = std::max(b, 1024 + std::max(small, rows));
  if constexpr (CP <= 512)
    b = std::max(b, TailWg<T, CP>::kSmem);
  else
    b = std::max(b, 1024 + tail_smem_bytes(C, sizeof(T)));
  return b;
}

template <typename T, int CP>
int launch_stage(const StageArgs& a, cudaStream_t s) {
  static size_t attr = 0;
  const size_t bytes = stage_smem_bytes<T, CP>(a.C);
  if (const int err = grant_smem(k_s_stage<T, CP>, bytes, attr)) return err;
  cudaError_t e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, k_s_stage<T, CP>, 256, bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const size_t sync_bytes = (1 + 3 * (size_t)a.B) * sizeof(int);
  if ((e = cudaMemsetAsync(a.sync, 0, sync_bytes, s)) != cudaSuccess)
    return (int)e;
  const int grid = std::max(1, std::min(a.n_items, per_sm * sms));
  k_s_stage<T, CP><<<grid, 256, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int s_stage(const void* const* p, int n_items, int B, int N, int M, int C,
            int H, int hidden, int img_w, int use_cpe, int qkv_tiles,
            float scale, float eps, cudaStream_t s) {
  if (C % 32 || C < 32 || C > 640 || hidden % 32 || hidden < 32 ||
      n_items < 1 || qkv_tiles < 1 || (use_cpe && !p[4]))
    return (int)cudaErrorInvalidValue;
  StageArgs a{p[0],        p[1],        mp<T>(p, 2), mp<T>(p, 3),
              mp<T>(p, 4), mp<T>(p, 5), mp<T>(p, 6), mp<T>(p, 7),
              mp<T>(p, 8)};
  a.blocks = static_cast<const StageBlock*>(p[9]);
  a.items = static_cast<const int*>(p[10]);
  a.counts = static_cast<const int*>(p[11]);
  a.sync = static_cast<int*>(const_cast<void*>(p[12]));
  a.n_items = n_items;
  a.B = B;
  a.N = N;
  a.M = M;
  a.C = C;
  a.H = H;
  a.hidden = hidden;
  a.img_w = img_w;
  a.use_cpe = use_cpe;
  a.qkv_tiles = qkv_tiles;
  a.scale = scale;
  a.eps = eps;
  return stage_tier(C, [&](auto cp) {
    return launch_stage<T, decltype(cp)::value>(a, s);
  });
}

// nb blocks' StageBlock into out (host memory, `bytes` long) from their
// pointers p (nb x kStageParams, host).
template <typename T>
int stage_table(const void* const* p, int nb, int C, int hidden, int bytes,
                void* out) {
  if (nb < 1 || (size_t)nb * sizeof(StageBlock) > (size_t)bytes)
    return (int)cudaErrorInvalidValue;
  StageBlock* blocks = static_cast<StageBlock*>(out);
  return stage_tier(C, [&](auto cp) {
    constexpr int CP = decltype(cp)::value;
    for (int j = 0; j < nb; ++j) {
      StageBlock& b = blocks[j];
      const void* const* w = p + (size_t)j * kStageParams;
      memset(&b, 0, sizeof(b));
      for (int i = 0; i < kStageParams; ++i) b.p[i] = w[i];
      int err = tma_map<T>(&b.qkv.w[0], w[2], 3 * C, C, QkvWg<T>::kBN);
      b.qkv.w[1] = b.qkv.w[0];
      if constexpr (CP <= 512) {
        using L = TailWg<T, CP>;
        if (!err) err = tma_map<T>(&b.tail.wp[0], w[4], C, C, L::kBoxP);
        b.tail.wp[1] = b.tail.wp[0];
        if (!err) err = tma_map<T>(&b.tail.w1, w[8], hidden, C, L::kHid);
        if (!err) err = tma_map<T>(&b.tail.w2, w[10], C, hidden, L::kBoxP);
      }
      if (err) return err;
    }
    return 0;
  });
}

}  // namespace
}  // namespace lm

// The weight table of a stage of nb blocks, on the host: p holds the
// blocks' 14 pointers each (ln1_w, ln1_b, wqkv, bqkv, wp, bp, ln2_w, ln2_b,
// w1, b1, w2, b2, cpe_taps (9, C), cpe_bias (C,); the last two null without
// the CPE), out `bytes` of host memory for nb StageBlocks (896 bytes each),
// which the caller copies to the device.
extern "C" int lm_s_stage_table(int dtype, const void* const* p, int nb,
                                int C, int hidden, int bytes, void* out) {
  if (dtype == 0) return lm::stage_table<float>(p, nb, C, hidden, bytes, out);
  return lm::stage_table<__nv_bfloat16>(p, nb, C, hidden, bytes, out);
}

// p: 0 x (B*N, C), 1 c (B*M, C), 2 x_out, 3 c_out | workspace 4 xa (B*N, C,
//    null without the CPE), 5 qkv_x (B*N, 3C), 6 qkv_c (B*M, 3C), 7 o_x
//    (B*N, C), 8 o_c (B*M, C) | 9 the blocks' StageBlocks (lm_s_stage_table,
//    on the device), 10 the schedule (n_items, 9) int32 and 11 its counts
//    (3, B) int32 (fused_block.stage_schedule, on the device), 12 the
//    ticket and counters, (1 + 3 B) int32, zeroed here. img_w: the image
//    width, N = H * img_w; qkv_tiles: 128-column tiles of a qkv item.
extern "C" int lm_s_stage(int dtype, const void* const* p, int n_items,
                          int B, int N, int M, int C, int H, int hidden,
                          int img_w, int use_cpe, int qkv_tiles, float scale,
                          float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return lm::s_stage<float>(p, n_items, B, N, M, C, H, hidden, img_w,
                              use_cpe, qkv_tiles, scale, eps, s);
  return lm::s_stage<__nv_bfloat16>(p, n_items, B, N, M, C, H, hidden, img_w,
                                    use_cpe, qkv_tiles, scale, eps, s);
}
