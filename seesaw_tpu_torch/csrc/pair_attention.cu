// Pair attention in f32, forward (K5) and backward (K6): softmax(q k^T / 8) v
// per 64-wide head, the attention of every layer of both CLIP towers. bf16
// inputs take the tensor-core kernels of pair_attention_bf16.cu.
//
// Replaces the Pallas TPU kernels seesaw_tpu/ops/pallas_attention.py::
// _attn_kernel (forward, called through fused_pair_attention) and
// ::_attn_bwd_kernel (its custom VJP). q, k, v, g and every output are
// (B, L, W) in the projection layout, W = H * 64, head h in channels
// [64h, 64h + 64); no head split or merge is materialised. For every image
// b, head h and query row i:
//
//     s_j   = (q_i . k_j) / 8            f32 logits (f32 products of the inputs)
//     p_j   = exp(s_j - max s) / sum     exact two-pass softmax in f32
//     out_i = sum_j round(p_j) v_j       p rounded to the input type, f32 sum
//
// with keys j <= i only when causal (the text tower's mask, built here from
// the indices, never read as a tensor). The backward, for the output
// gradient g, in the order of operations of _attn_bwd_kernel:
//
//     dp_j  = g_i . v_j                  f32
//     r_i   = sum_j p_j dp_j             p unrounded
//     ds_j  = p_j (dp_j - r_i) / 8       f32, then rounded to the input type
//     dq_i  = sum_j round(ds_j) k_j;  dk_j = sum_i round(ds_ij) q_i;
//     dv_j  = sum_i round(p_ij) g_i      f32 sums, written in the input type
//
// p is recomputed in the backward by the same device functions the forward
// uses (tile_dots, scaled_logit, softmax_rows / prob), so it is bit-identical
// to the forward's, the role _pair_softmax plays for the TPU kernels.
//
// What bounds them: at the towers' shapes (L = 50..257, 64-wide heads) the
// arithmetic intensity is L/4 FLOP per byte of q, k, v and out in f32 (L/2
// in bf16): bytes bound ViT-B/32 (L = 50), operations bound ViT-L/14 in f32
// (L = 257) at the 67 TFLOP/s f32 rate of the CUDA cores. The backward does
// 5 products of the forward's size per kept pair where the forward does 2
// (the logits twice, dp twice, then dq, dk, dv: 7 in this two-pass design).
// TF32 and the tensor cores are left out: f32 must stay exact f32. The Io
// template keeps the input type apart from the f32 arithmetic; only f32 is
// instantiated.
//
// Design (simple first). Forward: one block per (image, head, tile of TQ
// query rows), 8 warps of R rows each (R = 8 up to L = 64, else 4: fewer
// registers, and more blocks for the text tower's small batches).
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
// limit.
//
// Backward: two passes over the same block shape and shared memory, no
// atomics, each output element summed by one thread in a fixed order (the
// result is bit-identical from run to run).
// - Pass 1, per tile of query rows: the logits and the softmax as the
//   forward computes them, then dp against the values (g^T in the queries'
//   region, values in the key buffer), r_i and ds in registers; round(ds)
//   goes to shared memory key-major, the keys come back into the key buffer
//   and each lane sums dq over the keys. Each row's max, sum and r_i go to
//   a (3, B * H * L) f32 scratch.
// - Pass 2, per tile of keys: the roles swap. The tile's keys transposed
//   and the head's queries as rows give the logits s_ij (the same fmaf
//   chains over d, so the same bits); p comes from pass 1's max and sum;
//   dp from v_j and the g rows, ds from r_i. round(p) goes to shared memory,
//   and with the g rows still in the row buffer each lane sums dv over the
//   query rows; then round(ds), the query rows again, and dk. Under the
//   causal mask a key tile needs only the rows i >= its first key.
// One pass would need the dk and dv sums of a key across query tiles
// (atomics or a reduction); holding q, k, v and g of a head as padded f32
// rows at once does not fit 227 KB at L = 257.
// The TPU kernels' head-pair packing, batch padding and VMEM block caps are
// not carried over: they fill a 128-lane MXU and fit VMEM.
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

// Rows [0, rows) of one head -> shared memory transposed, [64][TQ], rows
// past `rows` zero; consecutive threads take consecutive rows so the stores
// hit consecutive banks.
template <typename T, int TQ>
__device__ __forceinline__ void load_rows_t(const T* __restrict__ src, long long W, int rows,
                                            float* dst) {
  constexpr int per = Io<T>::kPerVec;
  float x[per];
  for (int idx = threadIdx.x; idx < TQ * (kHeadDim / per); idx += kThreads) {
    const int r = idx % TQ;
    const int c = (idx / TQ) * per;
    if (r < rows) {
      Io<T>::load(src + static_cast<long long>(r) * W + c, x);
    } else {
#pragma unroll
      for (int t = 0; t < per; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < per; ++t) dst[(c + t) * TQ + r] = x[t];
  }
}

// Shared memory of a block, in floats: region A (a transposed tile, then p
// or ds key-major) and the row buffer.
// p rows of TQ + 4 floats: 16-byte aligned, and 32 lanes storing 32 keys'
// rows spread over the 8 groups of 4 banks
__host__ __device__ constexpr int pt_stride(int tq) { return tq + 4; }
__host__ __device__ constexpr int region_a(int tq, int L) {
  return 64 * tq > L * pt_stride(tq) ? 64 * tq : L * pt_stride(tq);
}

// d[r][c] = sum over the 64 channels, in order, of tile row r0 + r (from
// the transposed tile `at`, [64][TQ]) times buffer row lane + 32 c (`rows`,
// kStride apart), by fmaf chains. Columns at or past n read buffer row 0
// (the caller masks them). Every logit and every dp of both kernels comes
// from here, so a product recomputed by the backward has the forward's bits.
template <int RK, int R, int TQ>
__device__ __forceinline__ void tile_dots(const float* at, const float* rows, int n, int r0,
                                          int lane, float (&d)[R][RK]) {
  int off[RK];
#pragma unroll
  for (int c = 0; c < RK; ++c) {
    const int j = lane + 32 * c;
    off[c] = (j < n ? j : 0) * kStride;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r][c] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < kHeadDim; ++k) {
    float a[R];
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(at + k * TQ + r0 + 4 * g);
      a[4 * g] = x.x;
      a[4 * g + 1] = x.y;
      a[4 * g + 2] = x.z;
      a[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      if (32 * c < n) {  // warp-uniform
        const float b = rows[off[c] + k];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r][c] = fmaf(a[r], b, d[r][c]);
      }
    }
  }
}

__device__ __forceinline__ float scaled_logit(float dot) { return dot * 0.125f; }

// p of one logit from its row's max and sum, as softmax_rows leaves it
__device__ __forceinline__ float prob(float logit, float m, float l) {
  return expf(logit - m) / l;
}

// Exact softmax of rows i0 + r over keys lane + 32 c < nkeys (j <= i when
// causal), in place, unrounded: s holds tile_dots' dots in and p out, m and
// l each row's max and sum (the same in every lane). Every row keeps key 0,
// so its max is finite.
template <int RK, int R, bool CAUSAL>
__device__ __forceinline__ void softmax_rows(float (&s)[R][RK], int i0, int nkeys, int lane,
                                             float (&m)[R], float (&l)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      const int j = lane + 32 * c;
      const bool keep = j < nkeys && (!CAUSAL || j <= i);
      s[r][c] = keep ? scaled_logit(s[r][c]) : -INFINITY;
      mx = fmaxf(mx, s[r][c]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      s[r][c] = expf(s[r][c] - mx);  // masked: exp(-inf) = 0
      sum += s[r][c];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int c = 0; c < RK; ++c) s[r][c] = s[r][c] / sum;
    m[r] = mx;
    l[r] = sum;
  }
}

// x[r][c] -> pt[(lane + 32 c) * PS + r0 + r] for columns below n: one
// column's values for the tile's rows are contiguous (key-major)
template <int RK, int R, int PS>
__device__ __forceinline__ void store_cols(const float (&x)[R][RK], int n, int r0, int lane,
                                           float* pt) {
#pragma unroll
  for (int c = 0; c < RK; ++c) {
    const int j = lane + 32 * c;
    if (j < n) {
#pragma unroll
      for (int g = 0; g < R / 4; ++g) {
        *reinterpret_cast<float4*>(pt + j * PS + r0 + 4 * g) =
            make_float4(x[4 * g][c], x[4 * g + 1][c], x[4 * g + 2][c], x[4 * g + 3][c]);
      }
    }
  }
}

// o[r] = sum over buffer rows j < n, in order, of pt[j][r0 + r] times the
// row's channels lane and lane + 32
template <int R, int PS>
__device__ __forceinline__ void sum_rows(const float* pt, const float* rows, int n, int r0,
                                         int lane, float (&o)[R][2]) {
#pragma unroll
  for (int r = 0; r < R; ++r) o[r][0] = o[r][1] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float* vr = rows + j * kStride;
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
}

// o[r] -> row i0 + r of dst (channels lane, lane + 32) for rows below L
template <typename T, int R>
__device__ __forceinline__ void store_out(T* __restrict__ dst, long long W, int i0, int L,
                                          int lane, const float (&o)[R][2]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r < L) {
      T* d = dst + static_cast<long long>(i0 + r) * W;
      Io<T>::store(d + lane, o[r][0]);
      Io<T>::store(d + lane + 32, o[r][1]);
    }
  }
}

// The block's (image, head, tile) and the head's base offset.
struct Block {
  int tile, h;
  long long bh, base, W;
  __device__ Block(int L, int H, int tiles) {
    tile = blockIdx.x % tiles;
    bh = blockIdx.x / tiles;
    h = static_cast<int>(bh % H);
    const long long b = bh / H;
    W = static_cast<long long>(H) * kHeadDim;
    base = b * L * W + static_cast<long long>(h) * kHeadDim;
  }
};

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

  const Block blk(L, H, tiles);
  const int q0 = blk.tile * TQ;
  const int rows = min(TQ, L - q0);
  // keys the tile needs: all, or up to its last row under the causal mask
  const int nkeys = CAUSAL ? q0 + rows : L;

  load_rows_t<T, TQ>(q + blk.base + static_cast<long long>(q0) * blk.W, blk.W, rows, qt);
  load_rows<T>(k + blk.base, blk.W, nkeys, kv);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * R;  // this warp's rows within the tile

  float s[R][RK], m[R], l[R];
  tile_dots<RK, R, TQ>(qt, kv, nkeys, r0, lane, s);
  softmax_rows<RK, R, CAUSAL>(s, q0 + r0, nkeys, lane, m, l);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < RK; ++c) s[r][c] = Io<T>::round(s[r][c]);
  }

  __syncthreads();  // every warp is done with the queries and the keys
  store_cols<RK, R, PS>(s, nkeys, r0, lane, qt);
  load_rows<T>(v + blk.base, blk.W, nkeys, kv);
  __syncthreads();

  float o[R][2];
  sum_rows<R, PS>(qt, kv, nkeys, r0, lane, o);
  store_out<T, R>(out + blk.base, blk.W, q0 + r0, L, lane, o);
}

// Backward pass 1: one block per (image, head, tile of query rows): dq and
// each row's softmax max, sum and r (stats: 3 arrays of B * H * L floats).
template <typename T, int RK, int R, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    pair_attention_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            T* __restrict__ dq, float* __restrict__ stats, int L, int H,
                            int tiles, long long n_rows) {
  constexpr int TQ = kWarps * R;
  constexpr int PS = pt_stride(TQ);
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // q^T, g^T, then round(ds) as [L][PS]
  float* kv = smem + region_a(TQ, L);  // keys, values, keys

  const Block blk(L, H, tiles);
  const int q0 = blk.tile * TQ;
  const int rows = min(TQ, L - q0);
  const int nkeys = CAUSAL ? q0 + rows : L;
  const long long row0 = static_cast<long long>(q0) * blk.W;

  load_rows_t<T, TQ>(q + blk.base + row0, blk.W, rows, qt);
  load_rows<T>(k + blk.base, blk.W, nkeys, kv);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * R;

  float p[R][RK], m[R], l[R];
  tile_dots<RK, R, TQ>(qt, kv, nkeys, r0, lane, p);
  softmax_rows<RK, R, CAUSAL>(p, q0 + r0, nkeys, lane, m, l);
  __syncthreads();  // done with q^T and the keys
  load_rows_t<T, TQ>(g + blk.base + row0, blk.W, rows, qt);
  load_rows<T>(v + blk.base, blk.W, nkeys, kv);
  __syncthreads();

  float ds[R][RK], rs[R];
  tile_dots<RK, R, TQ>(qt, kv, nkeys, r0, lane, ds);  // dp
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;  // masked and padded keys have p = 0 and a finite dp
#pragma unroll
    for (int c = 0; c < RK; ++c) acc += p[r][c] * ds[r][c];
    rs[r] = warp_sum(acc);
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      ds[r][c] = Io<T>::round((p[r][c] * (ds[r][c] - rs[r])) * 0.125f);
    }
  }
  __syncthreads();  // done with g^T and the values
  store_cols<RK, R, PS>(ds, nkeys, r0, lane, qt);
  load_rows<T>(k + blk.base, blk.W, nkeys, kv);
  __syncthreads();

  float o[R][2];
  sum_rows<R, PS>(qt, kv, nkeys, r0, lane, o);
  store_out<T, R>(dq + blk.base, blk.W, q0 + r0, L, lane, o);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = q0 + r0 + r;
      if (i < L) {
        const long long at = blk.bh * L + i;
        stats[at] = m[r];
        stats[n_rows + at] = l[r];
        stats[2 * n_rows + at] = rs[r];
      }
    }
  }
}

// Backward pass 2: one block per (image, head, tile of keys): dk and dv.
// Tile "rows" are keys j, "columns" the query rows i from c0 (the tile's
// first key under the causal mask, else 0).
template <typename T, int RK, int R, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    pair_attention_bwd_cols(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const float* __restrict__ stats, int L, int H, int tiles,
                            long long n_rows) {
  constexpr int TK = kWarps * R;
  constexpr int PS = pt_stride(TK);
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                    // k^T, v^T, then round(p), round(ds) as [L][PS]
  float* rb = smem + region_a(TK, L);  // query rows, g rows, query rows

  const Block blk(L, H, tiles);
  const int k0 = blk.tile * TK;
  const int keys = min(TK, L - k0);
  const int c0 = CAUSAL ? k0 : 0;  // rows i < k0 see no key of this tile
  const int n = L - c0;
  const long long key0 = static_cast<long long>(k0) * blk.W;
  const long long row0 = static_cast<long long>(c0) * blk.W;

  load_rows_t<T, TK>(k + blk.base + key0, blk.W, keys, kt);
  load_rows<T>(q + blk.base + row0, blk.W, n, rb);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * R;

  float p[R][RK], rr[RK];
  tile_dots<RK, R, TK>(kt, rb, n, r0, lane, p);  // s_ji = k_j . q_i
  const float* st = stats + blk.bh * L + c0;
#pragma unroll
  for (int c = 0; c < RK; ++c) {
    const int t = lane + 32 * c;  // column: query row c0 + t
    const bool valid = t < n;
    const float mi = valid ? st[t] : 0.f;
    const float li = valid ? st[n_rows + t] : 1.f;
    rr[c] = valid ? st[2 * n_rows + t] : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = k0 + r0 + r;
      const bool keep = valid && j < L && (!CAUSAL || j <= c0 + t);
      p[r][c] = keep ? prob(scaled_logit(p[r][c]), mi, li) : 0.f;
    }
  }
  __syncthreads();  // done with k^T and the query rows
  load_rows_t<T, TK>(v + blk.base + key0, blk.W, keys, kt);
  load_rows<T>(g + blk.base + row0, blk.W, n, rb);
  __syncthreads();

  float ds[R][RK];
  tile_dots<RK, R, TK>(kt, rb, n, r0, lane, ds);  // dp_ij = g_i . v_j
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      ds[r][c] = Io<T>::round((p[r][c] * (ds[r][c] - rr[c])) * 0.125f);
      p[r][c] = Io<T>::round(p[r][c]);
    }
  }
  __syncthreads();  // done with v^T
  store_cols<RK, R, PS>(p, n, r0, lane, kt);
  __syncthreads();

  float o[R][2];
  sum_rows<R, PS>(kt, rb, n, r0, lane, o);  // dv_j = sum_i round(p_ij) g_i
  store_out<T, R>(dv + blk.base, blk.W, k0 + r0, L, lane, o);
  __syncthreads();  // done with round(p) and the g rows
  store_cols<RK, R, PS>(ds, n, r0, lane, kt);
  load_rows<T>(q + blk.base + row0, blk.W, n, rb);
  __syncthreads();

  sum_rows<R, PS>(kt, rb, n, r0, lane, o);  // dk_j = sum_i round(ds_ij) q_i
  store_out<T, R>(dk + blk.base, blk.W, k0 + r0, L, lane, o);
}

// Grid of B * H * tiles blocks, dynamic shared memory raised above 48 KB.
template <int R, typename Kernel>
int prepare(Kernel kernel, int B, int L, int H, int* tiles, unsigned* blocks, size_t* smem) {
  constexpr int TQ = kWarps * R;
  *tiles = (L + TQ - 1) / TQ;
  const long long n = static_cast<long long>(B) * H * *tiles;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(n);
  *smem = static_cast<size_t>(region_a(TQ, L) + L * kStride) * sizeof(float);
  if (*smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem)));
  }
  return 0;
}

template <typename T, int RK, int R, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
           cudaStream_t stream) {
  auto kernel = pair_attention_kernel<T, RK, R, CAUSAL>;
  int tiles;
  unsigned blocks;
  size_t smem;
  if (const int e = prepare<R>(kernel, B, L, H, &tiles, &blocks, &smem)) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, H, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RK, int R, bool CAUSAL>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq,
               void* dk, void* dv, float* stats, int B, int L, int H, cudaStream_t stream) {
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* G = static_cast<const T*>(g);
  const long long n_rows = static_cast<long long>(B) * H * L;
  auto rows = pair_attention_bwd_rows<T, RK, R, CAUSAL>;
  auto cols = pair_attention_bwd_cols<T, RK, R, CAUSAL>;
  int tiles;
  unsigned blocks;
  size_t smem;
  if (const int e = prepare<R>(rows, B, L, H, &tiles, &blocks, &smem)) return e;
  if (const int e = prepare<R>(cols, B, L, H, &tiles, &blocks, &smem)) return e;
  rows<<<blocks, kThreads, smem, stream>>>(Q, K, V, G, static_cast<T*>(dq), stats, L, H,
                                           tiles, n_rows);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  cols<<<blocks, kThreads, smem, stream>>>(Q, K, V, G, static_cast<T*>(dk),
                                           static_cast<T*>(dv), stats, L, H, tiles, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// The (RK, R) of a length: R rows a warp, RK chunks of 32 keys a lane.
template <typename T, bool C>
int fwd_len(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
            cudaStream_t s) {
  if (L <= 64) return launch<T, 2, 8, C>(q, k, v, out, B, L, H, s);
  if (L <= 128) return launch<T, 4, 4, C>(q, k, v, out, B, L, H, s);
  if (L <= 256) return launch<T, 8, 4, C>(q, k, v, out, B, L, H, s);
  return launch<T, 12, 4, C>(q, k, v, out, B, L, H, s);
}

template <typename T, bool C>
int bwd_len(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
            void* dv, float* st, int B, int L, int H, cudaStream_t s) {
  if (L <= 64) return launch_bwd<T, 2, 8, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  if (L <= 128) return launch_bwd<T, 4, 4, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  if (L <= 256) return launch_bwd<T, 8, 4, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  return launch_bwd<T, 12, 4, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
}

bool bad_shape(int B, int L, int H) { return L < 1 || L > kMaxLen || H < 1 || B < 0; }

}  // namespace

// q, k, v, out: (B, L, H * 64) f32, contiguous, 16-byte aligned (the caller
// checks). 1 <= L <= 384. Returns cudaGetLastError() after the launch (or
// the error of raising the shared-memory limit).
extern "C" int seesaw_pair_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int L, int H, int causal, void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? fwd_len<float, true>(q, k, v, out, B, L, H, s)
                : fwd_len<float, false>(q, k, v, out, B, L, H, s);
}

// The backward: dq, dk, dv (each like q) for the output gradient g (like q),
// stats a scratch of 3 * B * H * L floats. Two launches on `stream`; returns
// the first CUDA error.
extern "C" int seesaw_pair_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv,
                                         void* stats, int B, int L, int H, int causal,
                                         void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  return causal ? bwd_len<float, true>(q, k, v, g, dq, dk, dv, st, B, L, H, s)
                : bwd_len<float, false>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
}
