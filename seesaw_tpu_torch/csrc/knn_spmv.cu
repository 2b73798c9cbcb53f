// kNN SpMV and the Jacobi iteration of label propagation.
//
// Replaces the Pallas TPU kernels of seesaw_tpu/ops/pallas_spmv.py that
// together compute windowed_spmv:
//   _spmv_kernel (:606), the window-local slab contraction, and
//   _lane_gather_mul_kernel (:204) + _onehot_reduce_kernel (:210), the
//   routed out-of-window edges.
// All three serve one function over the graph's fixed-degree arrays,
//
//     wf[i] = sum_{k : nbr[i,k] >= 0} w[i,k] * f[nbr[i,k]],
//
// over EVERY edge. The TPU splits the edges into window-local lane shuffles
// and routed overflow because it has no fast scalar gather; on Hopper a
// gather is the natural primitive, so every edge is a slot of its row here.
//
// Two entry points:
//   knn_spmv:    out = W f.
//   jacobi_step: a segment of Jacobi iterations of seesaw_tpu/ops/
//                propagation.py (the lax.while_loop of _propagate_segment,
//                :36-77) in ONE launch, the update fused in,
//                  new_f = is_labeled ? label : (wf + lam*prior) / denom,
//                and after each step the convergence test max((new_f - f)^2)
//                < eps decided on the device; the remaining steps of a
//                converged run are skipped.
//
// What bounds them: bytes. Per row they read Kp neighbor ids and weights
// (8 bytes a slot) and gather Kp scores; 2 FLOP a slot. At the main path's
// 10M x 32 graph that is 2.56 GB of nbr + w per step, about 0.8 ms at the
// data-sheet 3.35 TB/s. The (N,) f32 score vector (40 MB at 10M rows) fits
// in the H100's 50 MB L2, so the gathers that leave the SM mostly hit L2;
// nbr and w are streamed with an evict-first policy so that they do not
// push f out.
//
// knn_spmv (simple first): a power-of-two sub-warp of L = min(32, Kp rounded
// up) lanes per row, lanes striding over the row's slots, a shuffle
// reduction, kRows rows in flight per sub-warp, a persistent grid.
//
// jacobi_step, designed for Hopper:
//   * One cooperative launch per segment. A persistent grid (every block
//     resident, which cudaLaunchCooperativeKernel guarantees or refuses)
//     loops over the steps with a grid barrier after each. The barrier is
//     written by hand and carries the reduction: each block puts its max
//     square into a state word, then arrives; the last block in turns the
//     max into the done flag and releases the others by counting the step
//     (the step count is the barrier's generation). So one barrier a step
//     suffices, every block reads the same decision, and the state words
//     end as the plain version leaves them. The max is an atomicMax on the
//     int bits of the non-negative squares (a NaN square becomes 0x7fffffff,
//     so it wins and leaves `done` false, as jnp.max(...) < eps does). No
//     sum uses atomics.
//   * Each block walks over a contiguous run of tiles of T consecutive rows
//     through a ring of kStages stages in shared memory. A tile's nbr and w
//     (T * Kp * 4 bytes each) and its rows' denom, lam_prior, labels and
//     is_labeled are contiguous, and one thread brings them in with 1-D bulk
//     asynchronous copies (TMA, cp.async.bulk completing on an mbarrier).
//     T (a multiple of 16, so that every copy has a 16-byte size) is as
//     large as kTileSlots slots allow, at most 256 rows. The ragged last
//     tile, and every tile of a graph too wide for a stage, is read straight
//     from device memory.
//   * f_in's rows around the tile (the tile plus kHalo rows on each side)
//     sit in a ring in shared memory, extended by cp.async for each tile; a
//     neighbour inside that window is read from there. On a graph with
//     locality (the JAX package's windowed layout assumes 97% of neighbours
//     within +-400 rows) nearly every gather is a window read.
//   * A block whose first tile shows such locality is warp-specialised: two
//     producer warps run up to kAhead tiles ahead of eight consumer warps
//     (full and empty mbarriers between them). They bulk-copy each stage,
//     extend the window and fetch the f of the tile's few far neighbours
//     (outside the window) by 4-byte cp.async into a small far buffer, so
//     the consumers find every byte of a tile in shared memory. A block
//     without locality feeds itself: its consumers issue the bulk copies
//     and read far neighbours from L2 as they sum. There nearly every slot
//     is far, the producers' 4-byte copies would cost more than the gathers,
//     and what counts is how many gathers are in flight, which the L1 left
//     beside the shared memory bounds.
//   * A block-wide epilogue: the sub-warps' row sums go to shared memory,
//     then one thread a row finishes it from the staged row terms and
//     stores f_out coalesced. The plain version's expression exactly:
//     (wf + lam*prior) / denom with no fused multiply-add, IEEE division.
//     A labeled row skips its gather.
// Within a row the lanes sum their slots in slot order and then shuffle in
// a fixed tree, whichever path a block takes, so two runs give the same bits.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // rows in flight per sub-warp (knn_spmv)

// state words of a Jacobi run (int32 on the device, zeroed by the caller)
constexpr int kDeltaBits = 0;  // atomicMax scratch: bits of max (new_f - f)^2; 0 between steps
constexpr int kDone = 1;       // 1 once max delta < eps
constexpr int kIters = 2;      // iterations executed
constexpr int kArrived = 3;    // grid barrier: blocks arrived at it; 0 between steps

template <int L>
__device__ __forceinline__ float subwarp_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, L);
  return v;
}

// acc[q] = sum over row (row0 + q * row_step)'s slots, reduced across the L
// lanes of the sub-warp (every lane holds the sum). Rows past N give 0.
template <int L>
__device__ __forceinline__ void gather_rows(const float* __restrict__ f,
                                            const int* __restrict__ nbr,
                                            const float* __restrict__ w,
                                            long long row0, int row_step,
                                            long long N, int Kp, int lane,
                                            float (&acc)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
  for (int k = lane; k < Kp; k += L) {
    int j[kRows];
    float wk[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const long long r = row0 + static_cast<long long>(q) * row_step;
      j[q] = -1;
      wk[q] = 0.f;
      if (r < N) {
        const long long e = r * Kp + k;
        j[q] = __ldcs(nbr + e);
        wk[q] = __ldcs(w + e);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (j[q] >= 0) acc[q] += wk[q] * __ldg(f + j[q]);  // -1 slots skipped
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = subwarp_sum<L>(acc[q]);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    spmv_kernel(const float* __restrict__ f, const int* __restrict__ nbr,
                const float* __restrict__ w, float* __restrict__ out,
                long long N, int Kp) {
  constexpr int kSubs = kThreads / L;
  const int lane = threadIdx.x % L;
  const int sub = threadIdx.x / L;
  const long long step = static_cast<long long>(gridDim.x) * kSubs * kRows;
  // `base` is block-uniform, so every lane reaches the shuffles
  for (long long base = static_cast<long long>(blockIdx.x) * kSubs * kRows; base < N;
       base += step) {
    float acc[kRows];
    gather_rows<L>(f, nbr, w, base + sub, kSubs, N, Kp, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const long long r = base + sub + static_cast<long long>(q) * kSubs;
        if (r < N) out[r] = acc[q];
      }
    }
  }
}

// -- the Jacobi segment -------------------------------------------------------

// The shape of a block, measured on the H100 with utils/compare_spmv_builds
// (variants of these constants in copies of this source, timed side by side):
// 64-row tiles at Kp = 32 in a ring of 3 stages, 2 blocks a multiprocessor.
// Shared memory is kept near 70 KB a block, because L1 holds what is left
// of the multiprocessor's 256 KB, and on a graph without locality L1 sets
// how many gathers from L2 can be in flight.
constexpr int kTileSlots = 2048;  // edge slots a stage holds (8 bytes each: nbr, w)
constexpr int kStages = 3;
constexpr int kAhead = (kStages - 1) / 2;  // tiles the bulk copies run ahead of the far fetches
constexpr int kMinBlocks = 2;              // resident blocks a multiprocessor
constexpr int kMaxTile = 256;  // rows of a tile: one epilogue thread each
constexpr int kMinTile = 16;   // is_labeled's bulk copy needs a 16-byte size
constexpr int kHalo = 512;     // f rows kept on each side of a tile
constexpr int kSlab = 2048;    // ring of f rows: the producer runs kAhead tiles ahead
constexpr int kProducerLanes = 64;  // two producer warps
constexpr int kJacobiThreads = kThreads + kProducerLanes;  // 8 consumer warps, the producers
constexpr int kU = 8;          // rows a sub-warp gathers at once
constexpr int kFarPerLane = 4;  // far slots a producer lane prefetches a tile
// a block that waits this many cycles for a barrier or a copy traps: a
// fault shows as a launch failure instead of a hung card
constexpr long long kSpinLimit = 20000000000LL;

// one stage: the tile's nbr and w, the gathered f of its far slots, then
// its rows' terms (16-byte aligned offsets)
constexpr int kStageW = kTileSlots * 4;
constexpr int kStageFar = kTileSlots * 8;
constexpr int kStageDen = kStageFar + kFarPerLane * kProducerLanes * 4;
constexpr int kStageLp = kStageDen + kMaxTile * 4;
constexpr int kStageLab = kStageLp + kMaxTile * 4;
constexpr int kStageIl = kStageLab + kMaxTile * 4;
constexpr int kStageBytes = kStageIl + kMaxTile;
constexpr int kSmemSlab = kStages * kStageBytes;
constexpr int kSmemRowsum = kSmemSlab + kSlab * 4;
constexpr int kSmemBars = kSmemRowsum + kMaxTile * 4;
constexpr int kSmemBytes = kSmemBars + 3 * kStages * 8;  // full (TMA), full (cp.async), empty
static_assert(kTileSlots % 16 == 0 && kStageBytes % 128 == 0, "stage alignment");
static_assert(kSlab >= (kStages - kAhead + 1) * kMaxTile + 2 * kHalo &&
                  (kSlab & (kSlab - 1)) == 0,
              "the ring holds the consumers' window and the rows the producer adds ahead");
static_assert(kHalo % 4 == 0 && kMaxTile <= kThreads, "tile shape");
static_assert(kAhead >= 1 && kAhead < kStages, "the producer's two cursors share the ring");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// the 256 consumer threads only (the producer warps never wait here)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned ok = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (clock64() - t0 > kSpinLimit) __trap();
  }
}

// L2 policy of the bulk copies: evict the streamed slots first, so that
// they do not push f out
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// staged tile at row r0: its slots and row terms into stage `sb`, completing on `bar`
__device__ __forceinline__ void issue_stage(unsigned char* sb, unsigned bar,
                                            const int* nbr, const float* w,
                                            const float* denom, const float* lam_prior,
                                            const float* labels,
                                            const unsigned char* is_labeled, long long r0,
                                            int T, int Kp) {
  const unsigned slots = static_cast<unsigned>(T * Kp) * 4u;
  const unsigned rows = static_cast<unsigned>(T) * 4u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(2u * slots + 3u * rows + static_cast<unsigned>(T))
               : "memory");
  const long long e0 = r0 * Kp;
  const unsigned long long pol = evict_first_policy();
  bulk_load(smem_addr(sb), nbr + e0, slots, bar, pol);
  bulk_load(smem_addr(sb + kStageW), w + e0, slots, bar, pol);
  bulk_load(smem_addr(sb + kStageDen), denom + r0, rows, bar, pol);
  bulk_load(smem_addr(sb + kStageLp), lam_prior + r0, rows, bar, pol);
  bulk_load(smem_addr(sb + kStageLab), labels + r0, rows, bar, pol);
  bulk_load(smem_addr(sb + kStageIl), is_labeled + r0, static_cast<unsigned>(T), bar, pol);
}

// rows [a, b) of f into the ring (a a multiple of 4), thread `lane` of
// `lanes`: 16-byte cp.async chunks through L2, the last zero-filled past b
__device__ __forceinline__ void load_slab(float* slab, const float* f, long long a,
                                          long long b, int lane, int lanes) {
  for (long long c = a + 4LL * lane; c < b; c += 4LL * lanes) {
    const unsigned bytes = static_cast<unsigned>(b - c < 4 ? b - c : 4) * 4u;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(slab + (c & (kSlab - 1)))),
                 "l"(f + c), "r"(bytes)
                 : "memory");
  }
}

// The f of a staged tile's far slots (neighbour outside the tile's window
// [lo, lo + span)), one producer lane's share: the lane's first
// kFarPerLane far slots go by 4-byte cp.async into its part of the stage's
// far buffer, and their ids in the stage become N + (buffer index), which no
// real id reaches; a far slot past that stays as it is and is read from L2
// when summed.
__device__ __forceinline__ void prefetch_far(unsigned char* sb, const float* f, long long N,
                                             int lo, unsigned span, int slots, int lane) {
  constexpr int kBatch = 2;  // 16-byte id groups read before their copies issue
  int4* nbr = reinterpret_cast<int4*>(sb);
  int* ids = reinterpret_cast<int*>(sb);
  const float* far = reinterpret_cast<const float*>(sb + kStageFar);
  const int groups = slots / 4;  // slots is a multiple of 4 (T of 16)
  int taken = 0;
  for (int g0 = lane; g0 < groups; g0 += kProducerLanes * kBatch) {
    int j[4 * kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int g = g0 + kProducerLanes * b;
      const int4 q = g < groups ? nbr[g] : make_int4(-1, -1, -1, -1);
      j[4 * b] = q.x;
      j[4 * b + 1] = q.y;
      j[4 * b + 2] = q.z;
      j[4 * b + 3] = q.w;
    }
#pragma unroll
    for (int u = 0; u < 4 * kBatch; ++u) {
      if (j[u] >= 0 && static_cast<unsigned>(j[u] - lo) >= span && taken < kFarPerLane) {
        const int e = 4 * (g0 + kProducerLanes * (u / 4)) + u % 4;
        const int slot = lane * kFarPerLane + taken++;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(far + slot)),
                     "l"(f + j[u])
                     : "memory");
        ids[e] = static_cast<int>(N) + slot;
      }
    }
  }
}

// rowsum[t] = W f over row t of the tile, t < rows (labeled rows skipped).
// Staged: nbr, w and is_labeled come from the stage and, with kFarStaged,
// the far slots the producer fetched from its far buffer; otherwise from
// the graph at the tile's first row. Other far slots come from L2. n: the
// graph's rows. Sub-warp `sub` takes rows
// sub + kSubs * q, kU at a time with all their loads in flight.
template <int L, bool kStaged, bool kFarStaged>
__device__ __forceinline__ void gather_tile(const int* __restrict__ nbr,
                                            const float* __restrict__ w,
                                            const float* __restrict__ far_f,
                                            const unsigned char* __restrict__ il,
                                            const float* f, const float* slab, int lo,
                                            unsigned span, float* rowsum, int rows, int T,
                                            int Kp, int n) {
  constexpr int kSubs = kThreads / L;
  const int lane = threadIdx.x % L;
  const int sub = threadIdx.x / L;
  const int R = T / kSubs;
  for (int q0 = 0; q0 < R; q0 += kU) {
    float acc[kU];
    bool act[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = sub + kSubs * (q0 + u);
      acc[u] = 0.f;
      act[u] = q0 + u < R && t < rows && !(kStaged ? il[t] : __ldg(il + t));
    }
    for (int k = lane; k < Kp; k += L) {
      int j[kU];
      float wk[kU], v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        j[u] = -1;
        wk[u] = 0.f;
        const int e = (sub + kSubs * (q0 + u)) * Kp + k;  // slot in the tile (< 2^31)
        if (act[u]) {
          j[u] = kStaged ? nbr[e] : __ldcs(nbr + e);
          wk[u] = kStaged ? w[e] : __ldcs(w + e);
        }
      }
      // f[j] from the ring when j lies in the tile's window [lo, lo + span),
      // from the far buffer when the producer fetched it (id N + index),
      // else from L2: every slot's load issues before any is used
      bool far[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool fetched = kFarStaged && j[u] >= n;
        far[u] = j[u] >= 0 && !fetched && static_cast<unsigned>(j[u] - lo) >= span;
        v[u] = fetched ? far_f[j[u] - n] : slab[j[u] & (kSlab - 1)];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (far[u]) v[u] = __ldcg(f + j[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (j[u] >= 0) acc[u] += wk[u] * v[u];  // -1 slots skipped
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u] = subwarp_sum<L>(acc[u]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (q0 + u < R) rowsum[sub + kSubs * (q0 + u)] = acc[u];
      }
    }
  }
}

// one thread a row: the update, a coalesced store, the thread's max square
// (bits). The plain version's order: (wf + lam*prior) / denom, no fused
// multiply-add, IEEE division
template <bool kStaged>
__device__ __forceinline__ int finish_tile(const float* den, const float* lp,
                                           const float* lab, const unsigned char* il,
                                           const float* rowsum, const float* slab,
                                           float* dst, long long r0, int rows, int local) {
  for (int t = threadIdx.x; t < rows; t += kThreads) {
    const long long r = r0 + t;
    float nf;
    if (kStaged ? il[t] : __ldg(il + t)) {
      nf = kStaged ? lab[t] : __ldg(lab + t);
    } else {
      nf = __fdiv_rn(__fadd_rn(rowsum[t], kStaged ? lp[t] : __ldg(lp + t)),
                     kStaged ? den[t] : __ldg(den + t));
    }
    const float d = __fsub_rn(nf, slab[r & (kSlab - 1)]);
    const float d2 = __fmul_rn(d, d);
    dst[r] = nf;
    local = max(local, d2 != d2 ? 0x7fffffff : __float_as_int(d2));
  }
  return local;
}

// End of a step for the whole grid: the block's max square into the state,
// the grid barrier, and the done flag as the last block in set it.
__device__ __forceinline__ bool step_barrier(int* state, int local, float eps,
                                             int* s_warp, int* s_flag) {
  const int m = __reduce_max_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0 && threadIdx.x < kThreads) s_warp[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) bm = max(bm, s_warp[i]);
    atomicMax(state + kDeltaBits, bm);
    __threadfence();
    // the step count only moves when the last block in releases this barrier
    volatile int* iters = state + kIters;
    const int gen = *iters;
    if (atomicAdd(state + kArrived, 1) == static_cast<int>(gridDim.x) - 1) {
      // last block in: every block's max is in; decide, reset the scratch and
      // the count, then release the others by counting the step
      __threadfence();
      const float dmax = __int_as_float(atomicExch(state + kDeltaBits, 0));
      atomicExch(state + kDone, dmax < eps ? 1 : 0);  // a NaN max compares false
      atomicExch(state + kArrived, 0);
      __threadfence();
      atomicAdd(state + kIters, 1);
    } else {
      const long long t0 = clock64();
      while (*iters == gen) {
        __nanosleep(32);
        if (clock64() - t0 > kSpinLimit) __trap();
      }
      __threadfence();
    }
    *s_flag = *reinterpret_cast<volatile int*>(state + kDone);
  }
  __syncthreads();
  return *s_flag != 0;
}

// `steps` Jacobi steps over the buffers (fa, fb), step k reading (k even ?
// fa : fb) and writing the other; none once state says done. Tiles of T
// rows; `staged` says whether a tile's slots fit a stage.
//
// A block whose first tile shows locality (at most 1/8 of its slots outside
// the tile's window) is warp-specialised: threads 0..255 consume tiles, the
// last warps produce them with two cursors. Producer lane 0 bulk-copies
// (TMA) the slots and row terms of the tile kAhead ahead once that stage is
// free; meanwhile the producers wait for the current tile's copies, fetch
// its far slots and the window's new rows by cp.async, and let each lane's
// copies arrive on the stage's second full barrier.
//
// A block without locality is fed by its consumers alone: consumer thread 0
// bulk-copies each stage kStages - 1 tiles ahead, the consumers extend the
// window, and far slots are read from L2 as they are summed. There the
// producer path's 4-byte copies of nearly every slot, and its consumers'
// wait on them, cost more than the gathers themselves.
template <int L>
__global__ void __launch_bounds__(kJacobiThreads, kMinBlocks)
    jacobi_kernel(float* fa, float* fb, const int* __restrict__ nbr,
                  const float* __restrict__ w,
                  const float* __restrict__ denom,      // (N,) degree + lam, 1 where <= 0
                  const float* __restrict__ lam_prior,  // (N,) lam * prior
                  const float* __restrict__ labels,     // (N,)
                  const unsigned char* __restrict__ is_labeled,  // (N,) bool
                  int* state, float eps, long long N, int Kp, int T, int staged,
                  int steps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* slab = reinterpret_cast<float*>(smem + kSmemSlab);
  float* rowsum = reinterpret_cast<float*>(smem + kSmemRowsum);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + kSmemBars);
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_flag;
  __shared__ int s_far;
  const auto tma_full = [&](int s) { return smem_addr(bars + s); };
  const auto copy_full = [&](int s) { return smem_addr(bars + kStages + s); };
  const auto empty = [&](int s) { return smem_addr(bars + 2 * kStages + s); };

  if (threadIdx.x == 0) {
    // converged in an earlier launch: every block sees it, none steps
    s_flag = *reinterpret_cast<volatile int*>(state + kDone);
    s_far = 0;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(tma_full(s), 1);
      // each producer lane arrives once its cp.async copies land (noinc),
      // and each producer warp once its rewritten ids are written
      mbar_init(copy_full(s), kProducerLanes + kProducerLanes / 32);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (s_flag) return;

  const long long n_tiles = (N + T - 1) / T;
  const long long t_begin = n_tiles * blockIdx.x / gridDim.x;
  const int mine = static_cast<int>(n_tiles * (blockIdx.x + 1) / gridDim.x - t_begin);
  const bool ragged_last = t_begin + mine == n_tiles && N % T != 0;
  const int n_staged = staged ? mine - (ragged_last ? 1 : 0) : 0;
  // the block's locality, from its first tile's slots
  const int first_slots = static_cast<int>((N - t_begin * T < T ? N - t_begin * T : T) * Kp);
  {
    const long long r = t_begin * T;
    const long long lo = r > kHalo ? r - kHalo : 0;
    const long long hi = r + T + kHalo < N ? r + T + kHalo : N;
    const int slots = mine > 0 ? first_slots : 0;
    int far = 0;
    for (int e = threadIdx.x; e < slots; e += kJacobiThreads) {
      const int j = __ldg(nbr + r * Kp + e);
      far += j >= 0 && (j < lo || j >= hi);
    }
    atomicAdd(&s_far, far);
    __syncthreads();
  }
  const bool local_graph = 8 * s_far <= first_slots;
  const bool producer = threadIdx.x >= kThreads;
  const int lane = threadIdx.x - kThreads;  // producer lane
  unsigned it = 0;  // tiles this block has handled, over all steps: stage it % kStages

  for (int k = 0; k < steps; ++k) {
    const float* src = (k & 1) ? fb : fa;
    float* dst = (k & 1) ? fa : fb;
    int local = 0;
    if (local_graph && producer) {
      // tile j's stage: wait until the consumers released its last use,
      // then (staged) its bulk copies
      const auto claim = [&](int j) {
        const unsigned u = it + j;
        const int s = u % kStages;
        if (u >= kStages) mbar_wait(empty(s), (u / kStages - 1) & 1);
        if (j < n_staged && lane == 0) {
          // the ids the producers rewrote in this stage before the copy overwrites them
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          issue_stage(smem + s * kStageBytes, tma_full(s), nbr, w, denom, lam_prior, labels,
                      is_labeled, (t_begin + j) * T, T, Kp);
        }
      };
      for (int j = 0; j < kAhead && j < mine; ++j) claim(j);
      for (int j = 0; j < mine; ++j) {
        if (j + kAhead < mine) claim(j + kAhead);
        const unsigned u = it + j;
        const int s = u % kStages;
        const long long r0 = (t_begin + j) * T;
        const int lo = static_cast<int>(r0 > kHalo ? r0 - kHalo : 0);
        const long long hi = r0 + T + kHalo < N ? r0 + T + kHalo : N;
        if (j < n_staged) {
          mbar_wait(tma_full(s), (u / kStages) & 1);
          prefetch_far(smem + s * kStageBytes, src, N, lo, static_cast<unsigned>(hi - lo),
                       T * Kp, lane);
        } else if (lane == 0) {
          mbar_arrive(tma_full(s));
        }
        // the window's rows this tile adds (all of it for the block's first)
        load_slab(slab, src, j == 0 ? lo : r0 + kHalo, hi, lane, kProducerLanes);
        asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(copy_full(s))
                     : "memory");
        __syncwarp();
        if ((lane & 31) == 0) mbar_arrive(copy_full(s));  // the warp's rewritten ids are written
      }
    } else if (!producer) {
      if (!local_graph) {  // the consumers feed themselves
        if (threadIdx.x == 0) {
          for (int j = 0; j < kStages - 1 && j < n_staged; ++j) {
            const int s = (it + j) % kStages;
            issue_stage(smem + s * kStageBytes, tma_full(s), nbr, w, denom, lam_prior, labels,
                        is_labeled, (t_begin + j) * T, T, Kp);
          }
        }
        const long long r = t_begin * T;
        load_slab(slab, src, r > kHalo ? r - kHalo : 0, r + T + kHalo < N ? r + T + kHalo : N,
                  threadIdx.x, kThreads);
      }
      for (int j = 0; j < mine; ++j) {
        const unsigned u = it + j;
        const int s = u % kStages;
        const unsigned parity = (u / kStages) & 1;
        unsigned char* sb = smem + s * kStageBytes;
        const long long r0 = (t_begin + j) * T;
        // the tile's window of f rows: [lo, hi)
        const int lo = static_cast<int>(r0 > kHalo ? r0 - kHalo : 0);
        const long long hi = r0 + T + kHalo < N ? r0 + T + kHalo : N;
        const unsigned span = static_cast<unsigned>(hi - lo);
        const int rows = static_cast<int>(N - r0 < T ? N - r0 : T);
        const bool st = j < n_staged;
        if (local_graph) {
          mbar_wait(tma_full(s), parity);
          mbar_wait(copy_full(s), parity);
        } else {
          // this tile's window rows (fetched a tile ago) and copies; every
          // consumer is done with the tile before, whose stage is refilled
          asm volatile("cp.async.wait_all;" ::: "memory");
          if (st) {
            mbar_wait(tma_full(s), parity);
          } else if (threadIdx.x == 0) {
            mbar_arrive(tma_full(s));  // an unstaged tile still takes its stage's phase
          }
          consumer_sync();
          if (threadIdx.x == 0 && j + kStages - 1 < n_staged) {
            const int s2 = (u + kStages - 1) % kStages;
            issue_stage(smem + s2 * kStageBytes, tma_full(s2), nbr, w, denom, lam_prior, labels,
                        is_labeled, r0 + static_cast<long long>(kStages - 1) * T, T, Kp);
          }
          if (j + 1 < mine) {  // the next tile's new window rows
            load_slab(slab, src, r0 + T + kHalo, hi + T < N ? hi + T : N, threadIdx.x,
                      kThreads);
          }
        }
        if (!st) {
          gather_tile<L, false, false>(nbr + r0 * Kp, w + r0 * Kp, nullptr, is_labeled + r0,
                                       src, slab, lo, span, rowsum, rows, T, Kp,
                                       static_cast<int>(N));
        } else if (local_graph) {
          gather_tile<L, true, true>(reinterpret_cast<const int*>(sb),
                                     reinterpret_cast<const float*>(sb + kStageW),
                                     reinterpret_cast<const float*>(sb + kStageFar),
                                     sb + kStageIl, src, slab, lo, span, rowsum, rows, T, Kp,
                                       static_cast<int>(N));
        } else {
          gather_tile<L, true, false>(reinterpret_cast<const int*>(sb),
                                      reinterpret_cast<const float*>(sb + kStageW), nullptr,
                                      sb + kStageIl, src, slab, lo, span, rowsum, rows, T, Kp,
                                       static_cast<int>(N));
        }
        consumer_sync();
        if (st) {
          local = finish_tile<true>(reinterpret_cast<const float*>(sb + kStageDen),
                                    reinterpret_cast<const float*>(sb + kStageLp),
                                    reinterpret_cast<const float*>(sb + kStageLab),
                                    sb + kStageIl, rowsum, slab, dst, r0, rows, local);
        } else {
          local = finish_tile<false>(denom + r0, lam_prior + r0, labels + r0, is_labeled + r0,
                                     rowsum, slab, dst, r0, rows, local);
        }
        // every consumer is done with the stage, the row sums and the window
        consumer_sync();
        if (local_graph && threadIdx.x == 0) mbar_arrive(empty(s));
      }
    }
    it += mine;
    if (step_barrier(state, local, eps, s_warp, &s_flag)) break;
  }
}

int sub_warp_index(int Kp) {
  int i = 0;
  while (i < 5 && (1 << i) < Kp) ++i;
  return i;  // L = 1 << i, 1..32
}

// blocks for a persistent launch: as many as fit on the card at once, but
// no more than there are row groups
int persistent_grid(const void* kernel, int* cache, long long groups) {
  if (*cache == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    *cache = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long g = groups < *cache ? groups : *cache;
  return static_cast<int>(g > 0 ? g : 1);
}

template <int L>
int launch_spmv(const float* f, const int* nbr, const float* w, float* out,
                long long N, int Kp, cudaStream_t s) {
  static int cache = 0;
  const long long groups = (N + (kThreads / L) * kRows - 1) / ((kThreads / L) * kRows);
  const int grid = persistent_grid(reinterpret_cast<const void*>(&spmv_kernel<L>), &cache, groups);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  spmv_kernel<L><<<grid, kThreads, 0, s>>>(f, nbr, w, out, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// resident blocks of jacobi_kernel<L> on device `dev` (0 on an error, with
// the error in *err); sets the kernel's shared-memory size on first use
template <int L>
int resident_blocks(int dev, cudaError_t* err) {
  static int cache[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    const void* fn = reinterpret_cast<const void*>(&jacobi_kernel<L>);
    int coop = 0, sms = 0, per_sm = 0;
    if ((*err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) ||
        (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (*err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     kSmemBytes)) ||
        (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kJacobiThreads,
                                                              kSmemBytes))) {
      return 0;
    }
    if (!coop || per_sm < 1) {
      *err = coop ? cudaErrorInvalidConfiguration : cudaErrorNotSupported;
      return 0;
    }
    const int blocks = sms * per_sm;
    cache[dev] = blocks;
  }
  return cache[dev];
}

template <int L>
int launch_jacobi(float* fa, float* fb, const int* nbr, const float* w, const float* denom,
                  const float* lam_prior, const float* labels,
                  const unsigned char* is_labeled, int* state, float eps, long long N,
                  int Kp, int steps, cudaStream_t s) {
  // prefetched far slots take the ids N .. N + kFarPerLane * kProducerLanes - 1
  if (N > INT_MAX - kFarPerLane * kProducerLanes) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = resident_blocks<L>(dev, &err);
  if (resident == 0) return static_cast<int>(err);
  // tile rows: a multiple of 16 and of the sub-warps a block holds, as many
  // as a stage's slots allow (at most kMaxTile); too wide a graph is not staged
  const int granule = kThreads / L > kMinTile ? kThreads / L : kMinTile;
  const int fit = Kp > 0 ? kTileSlots / Kp : 0;
  int staged = fit >= granule;
  int T = staged ? (fit < kMaxTile ? fit : kMaxTile) / granule * granule
                 : (granule > 64 ? granule : 64);
  const long long tiles = (N + T - 1) / T;
  int grid = static_cast<int>(tiles < resident ? tiles : resident);
  void* args[] = {&fa, &fb, &nbr, &w, &denom, &lam_prior, &labels, &is_labeled,
                  &state, &eps, &N, &Kp, &T, &staged, &steps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&jacobi_kernel<L>),
                                    dim3(grid), dim3(kJacobiThreads), args, kSmemBytes, s);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// out (N,) = W f over the (N, Kp) neighbor ids (-1 padding) and weights.
// The caller checks shapes, types, devices and contiguity. Returns
// cudaGetLastError() after the launch.
extern "C" int seesaw_knn_spmv(const void* f, const void* nbr, const void* w,
                               void* out, long long N, int Kp, void* stream) {
  if (N <= 0) return 0;
  const auto* ff = static_cast<const float*>(f);
  const auto* nb = static_cast<const int*>(nbr);
  const auto* ww = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sub_warp_index(Kp)) {
    case 0: return launch_spmv<1>(ff, nb, ww, o, N, Kp, s);
    case 1: return launch_spmv<2>(ff, nb, ww, o, N, Kp, s);
    case 2: return launch_spmv<4>(ff, nb, ww, o, N, Kp, s);
    case 3: return launch_spmv<8>(ff, nb, ww, o, N, Kp, s);
    case 4: return launch_spmv<16>(ff, nb, ww, o, N, Kp, s);
    default: return launch_spmv<32>(ff, nb, ww, o, N, Kp, s);
  }
}

// A segment of `steps` Jacobi steps in one launch: step k reads f_in when k
// is even and f_out when it is odd, and writes the other; no step runs once
// state[1] (done) is set. state: int32 x 4 on the device, zeroed before the
// first step of a run; state[2] counts the executed steps. f_in and f_out
// must not alias; every pointer 16-byte aligned. The caller checks shapes,
// types, devices and contiguity. Returns the launch's error code.
extern "C" int seesaw_jacobi_step(void* f_in, void* f_out, const void* nbr, const void* w,
                                  const void* denom, const void* lam_prior,
                                  const void* labels, const void* is_labeled, void* state,
                                  float eps, long long N, int Kp, int steps, void* stream) {
  if (N <= 0 || steps <= 0) return 0;
  auto* fa = static_cast<float*>(f_in);
  auto* fb = static_cast<float*>(f_out);
  const auto* nb = static_cast<const int*>(nbr);
  const auto* ww = static_cast<const float*>(w);
  const auto* dn = static_cast<const float*>(denom);
  const auto* lp = static_cast<const float*>(lam_prior);
  const auto* lb = static_cast<const float*>(labels);
  const auto* il = static_cast<const unsigned char*>(is_labeled);
  auto* st = static_cast<int*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sub_warp_index(Kp)) {
    case 0: return launch_jacobi<1>(fa, fb, nb, ww, dn, lp, lb, il, st, eps, N, Kp, steps, s);
    case 1: return launch_jacobi<2>(fa, fb, nb, ww, dn, lp, lb, il, st, eps, N, Kp, steps, s);
    case 2: return launch_jacobi<4>(fa, fb, nb, ww, dn, lp, lb, il, st, eps, N, Kp, steps, s);
    case 3: return launch_jacobi<8>(fa, fb, nb, ww, dn, lp, lb, il, st, eps, N, Kp, steps, s);
    case 4: return launch_jacobi<16>(fa, fb, nb, ww, dn, lp, lb, il, st, eps, N, Kp, steps, s);
    default: return launch_jacobi<32>(fa, fb, nb, ww, dn, lp, lb, il, st, eps, N, Kp, steps, s);
  }
}
