// Fused score + frame-max scan over the frame-major padded embedding matrix.
//
// Replaces the Pallas TPU kernel seesaw_tpu/ops/pallas_scoring.py::_kernel
// (called through fused_frame_max). For every frame f it computes
//
//     out[f] = excluded[f] ? -inf : max_{t : valid[f, t]} (V[f*T + t] . q)
//
// in one pass over V, accumulating in f32 (int8: an exact int32 dot with the
// quantized query, times the row's dequantization scale, then times the
// query scale where the maximum is finite). The (F*T,) score vector is never
// written: one f32 per frame leaves the kernel.
//
// What bounds it: bytes read. Each row is read once and used for D
// multiply-adds, about 1 FLOP per byte at bf16, far below the ~295 FLOP/byte
// at which an H100's tensor cores would become the limit. On the main path
// (10M rows x 512 dims, bf16) that is 10.2 GB per query, so the floor at the
// data-sheet 3.35 TB/s is about 3 ms.
//
// Design (simple first): one warp per frame, 8 frames per 256-thread block.
// The query sits in shared memory (2 KB at D=512 in f32). Each lane reads
// 16 bytes at a time, neighbouring lanes on neighbouring addresses, with
// streaming (evict-first) loads since V is read once per query and is far
// larger than L2. Invalid tiles are skipped without reading their row. A
// warp shuffle reduces each row's dot; the running max over the frame's
// tiles stays in registers. TMA, persistent blocks and deeper pipelining are
// left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

enum Kind : int { kF32 = 0, kBF16 = 1, kInt8 = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max that keeps a NaN once seen, like jnp.max
__device__ __forceinline__ float nan_max(float m, float s) {
  return (s > m || s != s) ? s : m;
}

template <int KIND>
__device__ __forceinline__ float row_dot(const unsigned char* __restrict__ row,
                                         const unsigned char* qs, int chunks,
                                         int lane) {
  if constexpr (KIND == kInt8) {
    const int4* r = reinterpret_cast<const int4*>(row);
    const int* qw = reinterpret_cast<const int*>(qs);
    int acc = 0;
    for (int c = lane; c < chunks; c += 32) {
      int4 v = __ldcs(r + c);
      const int* q = qw + 4 * c;
      acc = __dp4a(v.x, q[0], acc);
      acc = __dp4a(v.y, q[1], acc);
      acc = __dp4a(v.z, q[2], acc);
      acc = __dp4a(v.w, q[3], acc);
    }
    return static_cast<float>(warp_sum(acc));
  } else if constexpr (KIND == kBF16) {
    const uint4* r = reinterpret_cast<const uint4*>(row);
    const float* qf = reinterpret_cast<const float*>(qs);
    float acc = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      uint4 v = __ldcs(r + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float* q = qf + 8 * c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float2 p = __bfloat1622float2(h[k]);
        acc += p.x * q[2 * k];
        acc += p.y * q[2 * k + 1];
      }
    }
    return warp_sum(acc);
  } else {
    const float4* r = reinterpret_cast<const float4*>(row);
    const float* qf = reinterpret_cast<const float*>(qs);
    float acc = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float4 v = __ldcs(r + c);
      const float* q = qf + 4 * c;
      acc += v.x * q[0];
      acc += v.y * q[1];
      acc += v.z * q[2];
      acc += v.w * q[3];
    }
    return warp_sum(acc);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    frame_max_kernel(const unsigned char* __restrict__ V,
                     const int* __restrict__ q,  // f32 values, or packed int8
                     const unsigned char* __restrict__ valid,     // (F, T)
                     const unsigned char* __restrict__ excluded,  // (F,)
                     const float* __restrict__ row_scale,  // (F*T,) or null
                     const float* __restrict__ q_scale,    // () or null
                     float* __restrict__ out, long long F, int T, int D) {
  extern __shared__ __align__(16) int q_smem[];
  const int elem = KIND == kInt8 ? 1 : (KIND == kBF16 ? 2 : 4);
  const int q_words = KIND == kInt8 ? D / 4 : D;
  for (int i = threadIdx.x; i < q_words; i += kThreads) q_smem[i] = q[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long f = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (f >= F) return;

  const long long row_bytes = static_cast<long long>(D) * elem;
  const int chunks = static_cast<int>(row_bytes / 16);
  const unsigned char* qs = reinterpret_cast<const unsigned char*>(q_smem);
  float m = -INFINITY;
  for (int t = 0; t < T; ++t) {
    const long long r = f * T + t;
    if (!valid[r]) continue;  // warp-uniform: every lane reads the same flag
    float s = row_dot<KIND>(V + r * row_bytes, qs, chunks, lane);
    if (KIND == kInt8 && row_scale != nullptr) s = s * row_scale[r];
    m = nan_max(m, s);
  }
  if (lane == 0) {
    if (excluded[f]) {
      m = -INFINITY;
    } else if (KIND == kInt8 && q_scale != nullptr && isfinite(m)) {
      m = m * q_scale[0];
    }
    out[f] = m;
  }
}

}  // namespace

// kind: 0 f32, 1 bf16, 2 int8. For f32/bf16, q holds D f32 values (for bf16
// already rounded to bf16); for int8, D int8 values. The caller checks
// shapes, alignment (16 bytes for V and q) and that D * itemsize is a
// multiple of 16. Returns cudaGetLastError() after the launch.
extern "C" int seesaw_fused_frame_max(int kind, const void* V, const void* q,
                                      const void* valid, const void* excluded,
                                      const void* row_scale, const void* q_scale,
                                      void* out, long long F, int T, int D,
                                      void* stream) {
  if (F <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((F + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const size_t smem = kind == kInt8 ? static_cast<size_t>(D) : static_cast<size_t>(D) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned char*>(V);
  const auto* qi = static_cast<const int*>(q);
  const auto* va = static_cast<const unsigned char*>(valid);
  const auto* ex = static_cast<const unsigned char*>(excluded);
  const auto* rs = static_cast<const float*>(row_scale);
  const auto* qsc = static_cast<const float*>(q_scale);
  auto* o = static_cast<float*>(out);
  switch (kind) {
    case kF32:
      frame_max_kernel<kF32><<<grid, kThreads, smem, s>>>(v, qi, va, ex, rs, qsc, o, F, T, D);
      break;
    case kBF16:
      frame_max_kernel<kBF16><<<grid, kThreads, smem, s>>>(v, qi, va, ex, rs, qsc, o, F, T, D);
      break;
    case kInt8:
      frame_max_kernel<kInt8><<<grid, kThreads, smem, s>>>(v, qi, va, ex, rs, qsc, o, F, T, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
