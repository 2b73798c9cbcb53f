// kNN SpMV and the fused Jacobi step of label propagation.
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
// gather from L2 is the natural primitive, so every edge is a slot of its
// row here and one kernel computes the whole function.
//
// Two entry points:
//   knn_spmv:    out = W f.
//   jacobi_step: one Jacobi iteration of seesaw_tpu/ops/propagation.py
//                (:47-56) with the update fused in,
//                  new_f = is_labeled ? label : (wf + lam*prior) / denom,
//                and the convergence test max((new_f - f)^2) < eps reduced
//                into a device scalar. A step launched after convergence
//                returns at once, so the host can launch a whole segment of
//                iterations without reading anything between them.
//
// What bounds it: bytes. Per row it reads Kp neighbor ids and weights
// (8 bytes a slot) and gathers Kp scores; 2 FLOP a slot. At the main path's
// 10M x 32 graph that is 2.56 GB of nbr + w per call, about 0.8 ms at the
// data-sheet 3.35 TB/s. The (N,) f32 score vector (40 MB at 10M rows) fits
// in the H100's 50 MB L2, so the gathers mostly hit L2; nbr and w are read
// with streaming (evict-first) loads so that they do not push f out.
//
// Design (simple first): a power-of-two sub-warp of L = min(32, Kp rounded
// up) lanes per row, lanes striding over the row's slots (coalesced nbr/w
// loads), a shuffle reduction, R rows in flight per sub-warp for memory
// parallelism, and a persistent grid (blocks stride over the rows) so that
// a no-op step after convergence costs one small launch. The convergence
// max is an atomicMax on the int bits of the non-negative f32 squares (a NaN
// square becomes 0x7fffffff, so it wins and leaves `done` false, as
// jnp.max(...) < eps does); the last block to finish turns it into the done
// flag, counts the iteration and resets the scratch for the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // rows in flight per sub-warp

// state words of a Jacobi run (int32 on the device, zeroed by the caller)
constexpr int kDeltaBits = 0;  // atomicMax scratch: bits of max (new_f - f)^2
constexpr int kDone = 1;       // 1 once max delta < eps
constexpr int kIters = 2;      // iterations executed
constexpr int kBlocksDone = 3;  // last-block counter

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

template <int L>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                  const int* __restrict__ nbr, const float* __restrict__ w,
                  const float* __restrict__ denom,      // (N,) degree + lam, 1 where <= 0
                  const float* __restrict__ lam_prior,  // (N,) lam * prior
                  const float* __restrict__ labels,     // (N,)
                  const unsigned char* __restrict__ is_labeled,  // (N,) bool
                  int* __restrict__ state, float eps, long long N, int Kp) {
  // converged in an earlier launch: nothing to do. The flag only changes in
  // the last block of a launch, after every block has passed this check.
  if (*reinterpret_cast<volatile int*>(state + kDone)) return;

  constexpr int kSubs = kThreads / L;
  const int lane = threadIdx.x % L;
  const int sub = threadIdx.x / L;
  const long long step = static_cast<long long>(gridDim.x) * kSubs * kRows;
  int local = 0;  // bits of this thread's max square (non-negative floats)
  for (long long base = static_cast<long long>(blockIdx.x) * kSubs * kRows; base < N;
       base += step) {
    float acc[kRows];
    gather_rows<L>(f_in, nbr, w, base + sub, kSubs, N, Kp, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const long long r = base + sub + static_cast<long long>(q) * kSubs;
        if (r >= N) continue;
        // the plain version's order: (wf + lam*prior) / denom, no fused
        // multiply-add, IEEE division
        const float nf = is_labeled[r]
                             ? labels[r]
                             : __fdiv_rn(__fadd_rn(acc[q], lam_prior[r]), denom[r]);
        const float d = __fsub_rn(nf, __ldg(f_in + r));
        const float d2 = __fmul_rn(d, d);
        f_out[r] = nf;
        local = max(local, d2 != d2 ? 0x7fffffff : __float_as_int(d2));
      }
    }
  }

  __shared__ int warp_max[kThreads / 32];
  const int m = __reduce_max_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) bm = max(bm, warp_max[i]);
    atomicMax(state + kDeltaBits, bm);
    __threadfence();
    if (atomicAdd(state + kBlocksDone, 1) == static_cast<int>(gridDim.x) - 1) {
      // last block: every block's max is in; decide and reset the scratch
      __threadfence();
      const float dmax = __int_as_float(atomicMax(state + kDeltaBits, 0));
      state[kDone] = dmax < eps ? 1 : 0;  // a NaN max compares false
      state[kIters] += 1;
      state[kDeltaBits] = 0;
      state[kBlocksDone] = 0;
    }
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

template <int L>
int launch_jacobi(const float* f_in, float* f_out, const int* nbr, const float* w,
                  const float* denom, const float* lam_prior, const float* labels,
                  const unsigned char* is_labeled, int* state, float eps,
                  long long N, int Kp, cudaStream_t s) {
  static int cache = 0;
  const long long groups = (N + (kThreads / L) * kRows - 1) / ((kThreads / L) * kRows);
  const int grid =
      persistent_grid(reinterpret_cast<const void*>(&jacobi_kernel<L>), &cache, groups);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  jacobi_kernel<L><<<grid, kThreads, 0, s>>>(f_in, f_out, nbr, w, denom, lam_prior,
                                             labels, is_labeled, state, eps, N, Kp);
  return static_cast<int>(cudaGetLastError());
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

// One Jacobi step f_out <- step(f_in), skipped when state[1] (done) is set.
// state: int32 x 4 on the device, zeroed before the first step of a run;
// state[2] counts the executed steps. f_in and f_out must not alias.
extern "C" int seesaw_jacobi_step(const void* f_in, void* f_out, const void* nbr,
                                  const void* w, const void* denom, const void* lam_prior,
                                  const void* labels, const void* is_labeled, void* state,
                                  float eps, long long N, int Kp, void* stream) {
  if (N <= 0) return 0;
  const auto* fi = static_cast<const float*>(f_in);
  auto* fo = static_cast<float*>(f_out);
  const auto* nb = static_cast<const int*>(nbr);
  const auto* ww = static_cast<const float*>(w);
  const auto* dn = static_cast<const float*>(denom);
  const auto* lp = static_cast<const float*>(lam_prior);
  const auto* lb = static_cast<const float*>(labels);
  const auto* il = static_cast<const unsigned char*>(is_labeled);
  auto* st = static_cast<int*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sub_warp_index(Kp)) {
    case 0: return launch_jacobi<1>(fi, fo, nb, ww, dn, lp, lb, il, st, eps, N, Kp, s);
    case 1: return launch_jacobi<2>(fi, fo, nb, ww, dn, lp, lb, il, st, eps, N, Kp, s);
    case 2: return launch_jacobi<4>(fi, fo, nb, ww, dn, lp, lb, il, st, eps, N, Kp, s);
    case 3: return launch_jacobi<8>(fi, fo, nb, ww, dn, lp, lb, il, st, eps, N, Kp, s);
    case 4: return launch_jacobi<16>(fi, fo, nb, ww, dn, lp, lb, il, st, eps, N, Kp, s);
    default: return launch_jacobi<32>(fi, fo, nb, ww, dn, lp, lb, il, st, eps, N, Kp, s);
  }
}
