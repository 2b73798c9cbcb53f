// Pair attention forward: softmax(q k^T / 8) v per 64-wide head, the
// attention of every layer of both CLIP towers.
//
// Replaces the Pallas TPU kernel seesaw_tpu/ops/pallas_attention.py::
// _attn_kernel (called through fused_pair_attention). q, k, v and out are
// (B, L, W) in the projection layout, W = H * 64, head h in channels
// [64h, 64h + 64); no head split or merge is materialised. For every image
// b, head h and query row i:
//
//     s_j   = (q_i . k_j) / 8            f32 logits (f32 products of the inputs)
//     p_j   = exp(s_j - max s) / sum     exact two-pass softmax in f32
//     out_i = sum_j round(p_j) v_j       p rounded to the input type, f32 sum
//
// with keys j <= i only when causal (the text tower's mask, built here from
// the indices, never read as a tensor). The output is in the input type.
//
// What bounds it: at the towers' shapes (L = 50..257, 64-wide heads) the
// arithmetic intensity is L/4 FLOP per byte of q, k, v and out in f32 (L/2
// in bf16): bytes bound ViT-B/32 (L = 50), operations bound ViT-L/14 in f32
// (L = 257) at the 67 TFLOP/s f32 rate of the CUDA cores. TF32 and the
// tensor cores are left out: f32 must stay exact f32, and bf16 through
// mma/wgmma is later work.
//
// Design (simple first): one block per (image, head, tile of query rows),
// 8 warps of R rows each (R = 8 up to L = 64, else 4: fewer registers, and
// more blocks for the text tower's small batches).
// Shared memory holds the tile's queries transposed (d-major, so a warp's R
// rows at one d are one broadcast 16-byte load) and the head's keys as f32
// rows padded to 65 floats (32 lanes reading 32 different rows hit 32
// banks). Each lane keeps the logits of its warp's R rows for keys lane,
// lane + 32, ... in registers (RK chunks of 32 keys, a template parameter),
// so a row's max and sum are warp shuffles. p then goes to shared memory
// key-major (a broadcast 16-byte load gives 4 rows' p for one key), the key
// buffer is refilled with the head's values, and each lane accumulates two
// output channels of its warp's rows over the keys in order. Shared memory:
// max(64 * TQ, L * (TQ + 4)) + L * 65 floats, TQ = 8 R (104 KB at L = 257),
// so above 48 KB the launch first raises the kernel's dynamic shared-memory
// limit. The TPU kernel's head-pair packing, batch padding and VMEM block
// cap are not carried over: they fill a 128-lane MXU and fit VMEM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kHeadDim + 1;  // padded key / value row
constexpr int kMaxLen = 384;

enum Kind : int { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kPerVec = 4;  // values per 16-byte load
  __device__ static void load(const float* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  // round to the nearest bf16 (ties to even), as jnp's astype and torch's to()
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, n) of one head (64 values each, W elements apart) -> shared
// memory as f32, kStride apart.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long W, int n,
                                          float* dst) {
  constexpr int per = Io<T>::kPerVec;
  constexpr int vecs = kHeadDim / per;
  for (int idx = threadIdx.x; idx < n * vecs; idx += kThreads) {
    const int r = idx / vecs;
    const int c = (idx % vecs) * per;
    Io<T>::load(src + static_cast<long long>(r) * W + c, dst + r * kStride + c);
  }
}

// Shared memory of a block, in floats: region A (the transposed queries,
// then p) and the key / value rows.
// p rows of TQ + 4 floats: 16-byte aligned, and 32 lanes storing 32 keys'
// rows spread over the 8 groups of 4 banks
__host__ __device__ constexpr int pt_stride(int tq) { return tq + 4; }
__host__ __device__ constexpr int region_a(int tq, int L) {
  return 64 * tq > L * pt_stride(tq) ? 64 * tq : L * pt_stride(tq);
}

template <typename T, int RK, int R, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    pair_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out, int L, int H,
                          int tiles) {
  constexpr int TQ = kWarps * R;  // query rows per block
  constexpr int PS = pt_stride(TQ);
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                     // [64][TQ], then p as pt [L][PS]
  float* kv = smem + region_a(TQ, L);   // [L][kStride]: keys, then values

  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int h = bh % H;
  const long long b = bh / H;
  const long long W = static_cast<long long>(H) * kHeadDim;
  const long long base = b * L * W + static_cast<long long>(h) * kHeadDim;
  const int q0 = tile * TQ;
  const int rows = min(TQ, L - q0);
  // keys the tile needs: all, or up to its last row under the causal mask
  const int nkeys = CAUSAL ? q0 + rows : L;

  // queries, transposed; consecutive threads take consecutive rows so the
  // stores hit consecutive banks. Rows past L are zero.
  {
    constexpr int per = Io<T>::kPerVec;
    float x[per];
    for (int idx = threadIdx.x; idx < TQ * (kHeadDim / per); idx += kThreads) {
      const int r = idx % TQ;
      const int c = (idx / TQ) * per;
      if (r < rows) {
        Io<T>::load(q + base + static_cast<long long>(q0 + r) * W + c, x);
      } else {
#pragma unroll
        for (int t = 0; t < per; ++t) x[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < per; ++t) qt[(c + t) * TQ + r] = x[t];
    }
  }
  load_rows<T>(k + base, W, nkeys, kv);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * R;  // this warp's rows within the tile

  // logits of rows r0.. for keys lane + 32 c; keys past nkeys read row 0
  // and are masked below
  float s[R][RK];
  int koff[RK];
#pragma unroll
  for (int c = 0; c < RK; ++c) {
    const int j = lane + 32 * c;
    koff[c] = (j < nkeys ? j : 0) * kStride;
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][c] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < kHeadDim; ++d) {
    float qv[R];
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(qt + d * TQ + r0 + 4 * g);
      qv[4 * g] = x.x;
      qv[4 * g + 1] = x.y;
      qv[4 * g + 2] = x.z;
      qv[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      if (32 * c < nkeys) {  // warp-uniform
        const float kd = kv[koff[c] + d];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][c] = fmaf(qv[r], kd, s[r][c]);
      }
    }
  }

  // exact softmax per row: every row keeps key 0, so its max is finite
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + r0 + r;
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      const int j = lane + 32 * c;
      const bool keep = j < nkeys && (!CAUSAL || j <= i);
      s[r][c] = keep ? s[r][c] * 0.125f : -INFINITY;
      m = fmaxf(m, s[r][c]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      s[r][c] = expf(s[r][c] - m);  // masked: exp(-inf) = 0
      sum += s[r][c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < RK; ++c) s[r][c] = Io<T>::round(s[r][c] / sum);
  }

  __syncthreads();  // every warp is done with the queries and the keys
  float* pt = qt;
#pragma unroll
  for (int c = 0; c < RK; ++c) {
    const int j = lane + 32 * c;
    if (j < nkeys) {
#pragma unroll
      for (int g = 0; g < R / 4; ++g) {
        *reinterpret_cast<float4*>(pt + j * PS + r0 + 4 * g) = make_float4(
            s[4 * g][c], s[4 * g + 1][c], s[4 * g + 2][c], s[4 * g + 3][c]);
      }
    }
  }
  load_rows<T>(v + base, W, nkeys, kv);
  __syncthreads();

  // out rows r0.., channels lane and lane + 32: sum over keys in order
  float o[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) o[r][0] = o[r][1] = 0.f;
  for (int j = 0; j < nkeys; ++j) {
    const float* vr = kv + j * kStride;
    const float v0 = vr[lane];
    const float v1 = vr[lane + 32];
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 p = *reinterpret_cast<const float4*>(pt + j * PS + r0 + 4 * g);
      o[4 * g][0] = fmaf(p.x, v0, o[4 * g][0]);
      o[4 * g][1] = fmaf(p.x, v1, o[4 * g][1]);
      o[4 * g + 1][0] = fmaf(p.y, v0, o[4 * g + 1][0]);
      o[4 * g + 1][1] = fmaf(p.y, v1, o[4 * g + 1][1]);
      o[4 * g + 2][0] = fmaf(p.z, v0, o[4 * g + 2][0]);
      o[4 * g + 2][1] = fmaf(p.z, v1, o[4 * g + 2][1]);
      o[4 * g + 3][0] = fmaf(p.w, v0, o[4 * g + 3][0]);
      o[4 * g + 3][1] = fmaf(p.w, v1, o[4 * g + 3][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + r0 + r;
    if (i < L) {
      T* dst = out + base + static_cast<long long>(i) * W;
      Io<T>::store(dst + lane, o[r][0]);
      Io<T>::store(dst + lane + 32, o[r][1]);
    }
  }
}

template <typename T, int RK, int R, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
           cudaStream_t stream) {
  constexpr int TQ = kWarps * R;
  const int tiles = (L + TQ - 1) / TQ;
  const long long blocks = static_cast<long long>(B) * H * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(region_a(TQ, L) + L * kStride) * sizeof(float);
  auto kernel = pair_attention_kernel<T, RK, R, CAUSAL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, H, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool CAUSAL>
int dispatch_len(const void* q, const void* k, const void* v, void* out, int B, int L,
                 int H, cudaStream_t s) {
  if (L <= 64) return launch<T, 2, 8, CAUSAL>(q, k, v, out, B, L, H, s);
  if (L <= 128) return launch<T, 4, 4, CAUSAL>(q, k, v, out, B, L, H, s);
  if (L <= 256) return launch<T, 8, 4, CAUSAL>(q, k, v, out, B, L, H, s);
  return launch<T, 12, 4, CAUSAL>(q, k, v, out, B, L, H, s);
}

}  // namespace

// kind: 0 f32, 1 bf16. q, k, v, out: (B, L, H * 64) contiguous, 16-byte
// aligned (the caller checks). 1 <= L <= 384. Returns cudaGetLastError()
// after the launch (or the error of raising the shared-memory limit).
extern "C" int seesaw_pair_attention(int kind, const void* q, const void* k, const void* v,
                                     void* out, int B, int L, int H, int causal,
                                     void* stream) {
  if (L < 1 || L > kMaxLen || H < 1 || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      return causal ? dispatch_len<float, true>(q, k, v, out, B, L, H, s)
                    : dispatch_len<float, false>(q, k, v, out, B, L, H, s);
    case kBF16:
      return causal ? dispatch_len<__nv_bfloat16, true>(q, k, v, out, B, L, H, s)
                    : dispatch_len<__nv_bfloat16, false>(q, k, v, out, B, L, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
