// Pair attention in bf16 on Hopper's tensor cores: forward (K5) and
// backward (K6) of softmax(q k^T / 8) v per 64-wide head.
//
// Replaces the Pallas TPU kernels seesaw_tpu/ops/pallas_attention.py:91
// (_attn_kernel) and :115 (_attn_bwd_kernel) for bf16 inputs; f32 keeps
// the CUDA-core kernels of pair_attention.cu. The function is theirs, as
// pair_attention.cu writes it out: for every image b, head h, query row i
//
//     s_j   = (q_i . k_j) / 8            f32 sums of exact bf16 products
//     p_j   = exp(s_j - max s) / sum     exact two-pass softmax over the row, f32
//     out_i = sum_j round(p_j) v_j       p normalised, then rounded to bf16
//
// (keys j <= i only when causal, the mask built from the indices), and
//
//     dp_j  = g_i . v_j;   r_i = sum_j p_j dp_j     (p unrounded)
//     ds_j  = round(p_j (dp_j - r_i) / 8)
//     dq_i  = sum_j ds_j k_j;  dk_j = sum_i ds_ij q_i;  dv_j = sum_i round(p_ij) g_i
//
// with f32 sums and bf16 outputs. r is not flash attention's rowsum(dO o O):
// O was built from the rounded p.
//
// What bounds them: at the towers' shapes (L = 50..257, d = 64) a head's
// work is 2 L^2 64 operations a product against 4 L 64 bf16 elements moved
// (7 in the backward), so on the tensor cores (989 TFLOP/s) the bytes would
// bound both kernels. The CUDA-core kernels ran every product as f32 fmaf
// chains, so bf16 went at the f32 rate. Here the products whose inputs are
// bf16 roundings (P.V, and dq = ds K, dk = ds^T q, dv = round(p)^T g) are
// warp-level mma.sync.m16n8k16 (bf16 in, f32 sums), operands from shared
// memory through ldmatrix (.trans for every transposed operand), tiles
// arriving by cp.async with zero fill past the ragged edge. The logits and dp
// stay on the CUDA cores (below), so those fmaf chains (64 a logit, at the
// 67 TFLOP/s f32 rate) are what bounds both kernels now: one product of the
// forward's two, two of the backward's five (the two-pass backward beyond
// L = 128 computes the logits twice and dp three times).
//
// Why the logits and dp stay on the CUDA cores: they are fmaf chains in
// channel order (dot_tile, row_dots), the order of the plain version's f32
// GEMM, and the softmax sums its exps in torch.softmax's order, so p and ds
// are the plain version's bit for bit. The tensor cores sum in another
// order, which moves a logit or a dp by an f32 bit now and then and flips
// that p's (or ds's) bf16 rounding; a flipped p of 0.3 moves its row's
// outputs by 2^-9 |v|, beyond 1e-3 where an output is a cancelled sum near 0
// (measured: 9 of 10M outputs of the text tower's causal rows at B = 256,
// whose few keys carry large p). So the bf16 bar against the plain version
// (rtol 2^-7, atol 1e-3) holds only with p and ds exact. P.V and the
// gradients' products need no such care: their inputs are already rounded,
// and another sum order moves an output by at most its own rounding.
//
// One loop gives every logit and every dp: an fmaf chain from 0 over the 64
// channels in order, laid out as the m16n8 C fragment (rows g, g + 8 of a
// warp's 16, columns 2 (lane % 4) + {0, 1} of 8), A rows (queries or g) in
// bf16 and B rows (keys or values) in f32 in shared memory. Each element
// depends only on its row and column, so the backward's logits have the
// forward's bits wherever its tile sits, and p (softmax_rows in the forward,
// the one-pass backward and pass 1, prob from pass 1's max and sum in pass
// 2) is bit-identical in the forward and the backward. K Q^T is never
// computed: P^T and dS^T come from shared memory by ldmatrix.trans.
//
// Forward: one block per (image, head, tile of 16 WARPS query rows), 4 warps
// (8 for L in (128, 272], where the f32 keys fill shared memory) of 16 rows.
// Each warp keeps its rows' logits over all keys in registers (NT n-tiles of
// 8 keys, a template parameter up to 48 for L = 384), takes the exact
// softmax, and feeds p to P.V straight from the registers (the m16n8 C
// layout of two n-tiles is the m16k16 A layout). Shared memory: the query
// tile (bf16), the head's keys (f32) and values (bf16), rows padded so
// ldmatrix and the dots' loads are free of bank conflicts (at L = 257 and 8
// warps: 131 KB).
//
// Backward: no atomics, each output element one thread's sum in a fixed
// order, so two runs give the same bits. Up to L = 128 one block per (image,
// head; 4 or 8 warps) holds all rows and keys and does it in one pass
// (attn_bwd_head): p, dp, r and ds once, dq = ds K, round(p) and round(ds)
// into shared memory, then dk and dv per 16 keys. Beyond, two passes:
// - Pass 1 (rows), per tile of query rows, all keys in shared memory: logits
//   and softmax as the forward; r from dp tile by tile; then per 16 keys dp
//   again, ds rounded into an A fragment, and dq += ds K. Each row's max,
//   sum and r go to a (3, B H L) scratch.
// - Pass 2 (cols), per tile of 64 keys: over the query rows in chunks of 64
//   (from the tile's first key when causal), each warp computes its 16 rows'
//   logits and dp against the tile's keys (same chains), p from pass 1's max
//   and sum, ds; round(p) and ds go to shared memory as [query][key]; then
//   each warp owns 16 keys and sums dv += round(p)^T g and dk += ds^T q over
//   the chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;    // rows (keys in pass 2) of a 4-warp block
constexpr int kLd = kHeadDim + 8;     // shared row in bf16: 144 bytes
constexpr int kLdF = kHeadDim + 4;    // shared row in f32: 272 bytes
constexpr int kMaxLen = 384;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [0, n) of one head (64 bf16 each, W elements apart) -> dst, kLd
// apart, by cp.async; rows [n, rows) zero. The caller waits (load_wait).
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, long long W, int n,
                                          int rows, bf16* dst) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += blockDim.x) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    const bool valid = r < n;
    const bf16* g = src + (valid ? static_cast<long long>(r) * W + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * kLd + c)),
                 "l"(g), "r"(valid ? 16 : 0)
                 : "memory");
  }
}

// The same into f32 rows, kLdF apart (the CUDA-core dots' B operands):
// plain loads, kBatch in flight a thread, converted in registers
__device__ __forceinline__ void load_rows_f32(const bf16* __restrict__ src, long long W, int n,
                                              int rows, float* dst) {
  constexpr int kBatch = 4;
  for (int base = threadIdx.x; base < rows * 8; base += kBatch * blockDim.x) {
    uint4 w[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + b * blockDim.x;
      const int r = idx >> 3;
      w[b] = make_uint4(0, 0, 0, 0);
      if (r < n) w[b] = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * W +
                                                        (idx & 7) * 8);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + b * blockDim.x;
      if (idx < rows * 8) {
        const uint32_t u[4] = {w[b].x, w[b].y, w[b].z, w[b].w};
        float* d = dst + (idx >> 3) * kLdF + (idx & 7) * 8;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          *reinterpret_cast<float4*>(d + 4 * i) = make_float4(
              __uint_as_float(u[2 * i] << 16), __uint_as_float(u[2 * i] & 0xffff0000u),
              __uint_as_float(u[2 * i + 1] << 16), __uint_as_float(u[2 * i + 1] & 0xffff0000u));
        }
      }
    }
  }
}

__device__ __forceinline__ void load_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> bf16x2, each rounded to the nearest (ties to even), lo first
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 bf16 of shared memory (16 bytes) -> f32, exactly
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// A fragment of X^T for X = 16 shared rows [k0, k0 + 16) x columns
// [m0, m0 + 16), rows ld apart: A[m][k] = X[k0 + k][m0 + m]
__device__ __forceinline__ void load_at(const bf16* x, int k0, int m0, int lane,
                                        uint32_t (&a)[4], int ld) {
  const int mat = lane >> 3;
  ldsm4_t(a, x + (k0 + (lane & 7) + (mat >> 1) * 8) * ld + m0 + (mat & 1) * 8);
}

// B fragments of rows [k0, k0 + 16) of X as a k x n matrix, for the two
// n-tiles of columns [n0, n0 + 8) (b[0], b[1]) and [n0 + 8, n0 + 16) (b[2], b[3])
__device__ __forceinline__ void load_bt(const bf16* x, int k0, int n0, int lane,
                                        uint32_t (&b)[4]) {
  const int mat = lane >> 3;
  ldsm4_t(b, x + (k0 + (lane & 7) + (mat & 1) * 8) * kLd + n0 + (mat >> 1) * 8);
}

// The same fragments from f32 rows (exact bf16 values), by scalar loads
__device__ __forceinline__ void load_bt(const float* x, int k0, int n0, int lane,
                                        uint32_t (&b)[4]) {
  const float* p = x + (k0 + (lane & 3) * 2) * kLdF + n0 + (lane >> 2);
  b[0] = pack(p[0], p[kLdF]);
  b[1] = pack(p[8 * kLdF], p[9 * kLdF]);
  b[2] = pack(p[8], p[kLdF + 8]);
  b[3] = pack(p[8 * kLdF + 8], p[9 * kLdF + 8]);
}

__device__ __forceinline__ void load4x2(const float* p, float (&x)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// c[e] += the channels [dc, dc + 8) of A row g + 8 (e / 2) (a0, a1, as
// f32) times f32 B row b + e % 2 (b: B's row 2 (lane % 4), channel dc),
// one fmaf each, in channel order
__device__ __forceinline__ void fma8(const float (&a0)[8], const float (&a1)[8],
                                     const float* b, float (&c)[4]) {
  float b0[8], b1[8];
  load4x2(b, b0);
  load4x2(b + kLdF, b1);
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    c[0] = fmaf(a0[d], b0[d], c[0]);
    c[1] = fmaf(a0[d], b1[d], c[1]);
    c[2] = fmaf(a1[d], b0[d], c[2]);
    c[3] = fmaf(a1[d], b1[d], c[3]);
  }
}

// c[e] = sum over the 64 channels of shared bf16 A row g + 8 (e / 2) (of
// the 16 at arows; g = lane / 4) times shared f32 row 2 (lane % 4) + e % 2
// of the 8 at brows: the m16n8 C layout, each element an fmaf chain from 0 in channel
// order, the order of the plain version's f32 GEMM. Every logit and every
// dp of both kernels is such a chain (here, or in row_dots, which runs the
// same chains in another loop order), so the backward's logits have the
// forward's bits wherever its tile sits.
__device__ __forceinline__ void dot_tile(const bf16* arows, const float* brows, int lane,
                                         float (&c)[4]) {
  const bf16* a = arows + (lane >> 2) * kLd;
  const float* b = brows + (lane & 3) * 2 * kLdF;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int dc = 0; dc < kHeadDim; dc += 8) {
    float a0[8], a1[8];
    load8(a + dc, a0);
    load8(a + 8 * kLd + dc, a1);
    fma8(a0, a1, b + dc, c);
  }
}

// s[t] = dot_tile(arows, keys + 8 t rows) for the n-tiles below nk, the
// others 0 (the softmax masks them); channels outside, n-tiles inside, so
// the A rows are read once per 8 channels
template <int NT>
__device__ __forceinline__ void row_dots(const bf16* arows, const float* keys, int nk, int lane,
                                         float (&s)[NT][4]) {
  const bf16* a = arows + (lane >> 2) * kLd;
  const float* b = keys + (lane & 3) * 2 * kLdF;
#pragma unroll
  for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll 1
  for (int dc = 0; dc < kHeadDim; dc += 8) {
    float a0[8], a1[8];
    load8(a + dc, a0);
    load8(a + 8 * kLd + dc, a1);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (8 * t < nk) fma8(a0, a1, b + 8 * t * kLdF + dc, s[t]);  // warp-uniform
    }
  }
}

__device__ __forceinline__ float scaled_logit(float dot) { return dot * 0.125f; }

// p of one logit from its row's max and sum, as softmax_rows leaves it
__device__ __forceinline__ float prob(float logit, float m, float l) {
  return expf(logit - m) / l;
}

__device__ __forceinline__ float ds_of(float p, float dp, float r) {
  return (p * (dp - r)) * 0.125f;
}

// A row's sum as a warp of 32 lanes takes it when lane λ holds the terms
// of keys λ + 32 it, sums them in order of it and the lanes then add in a
// butterfly, xor 16 down to 1: torch.softmax's warp kernel on the card (rows
// of up to 1024), and the CUDA-core kernels' order for r. In the m16n8 C
// layout key j = 8t + 2 (lane % 4) + e % 2 is λ = 8 (t mod 4) + 2 (lane % 4)
// + e % 2, so the caller sums the terms of each (t mod 4, e % 2) in order of
// t into part; the xor-16 and xor-8 steps are then in the thread, xor 4 and
// 2 across the quad, xor 1 in the thread. Every lane of the quad gets the sum.
__device__ __forceinline__ float lane_order_sum(const float (&part)[4][2]) {
  float x[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    x[b] = (part[0][b] + part[2][b]) + (part[1][b] + part[3][b]);  // xor 16, xor 8
    x[b] += __shfl_xor_sync(0xffffffffu, x[b], 2);                  // xor 4
    x[b] += __shfl_xor_sync(0xffffffffu, x[b], 1);                  // xor 2
  }
  return x[0] + x[1];  // xor 1
}

__device__ __forceinline__ void zero(float (&part)[2][4][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int u = 0; u < 4; ++u) part[h][u][0] = part[h][u][1] = 0.f;
  }
}

// Keys a warp whose first row is i0 needs: all, or up to its last row.
template <bool CAUSAL>
__device__ __forceinline__ int warp_keys(int i0, int L) {
  return CAUSAL ? min(L, i0 + 16) : L;
}

// Exact softmax in place over the dots of rows i0 + g and i0 + g + 8
// (g = lane / 4; s[t][e] is row g + 8 (e / 2), key 8t + 2 (lane % 4) + e % 2):
// keys j < L (and j <= i when causal) kept, the rest p = 0. m and l get each
// row's max and sum (the same in the quad). Every row keeps key 0. The sum
// runs in torch.softmax's order (lane_order_sum): with the logits' fmaf
// chains this makes p the plain version's bit for bit.
template <int NT, bool CAUSAL>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int i0, int L, int lane,
                                             float (&m)[2], float (&l)[2]) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8;
      const int j = 8 * t + c2 + (e & 1);
      const bool keep = j < L && (!CAUSAL || j <= i);
      s[t][e] = keep ? scaled_logit(s[t][e]) : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  float part[2][4][2];  // [row][t mod 4][e % 2]
  zero(part);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = expf(s[t][e] - mx[e >> 1]);  // masked: exp(-inf) = 0
      part[e >> 1][t & 3][e & 1] += s[t][e];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = mx[h];
    l[h] = lane_order_sum(part[h]);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = s[t][e] / l[e >> 1];
  }
}

// acc[n] (rows g, g + 8 of the warp; channels 8n + 2 (lane % 4) + {0, 1})
// -> rows i0 + g, i0 + g + 8 of dst, those below L, in bf16
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long W, int i0, int L,
                                           int lane, const float (&acc)[8][4]) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    if (i < L) {
      bf16* d = dst + static_cast<long long>(i) * W + c2;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<uint32_t*>(d + 8 * n) = pack(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
}

// acc[n] += a X for the 16 x 16 A fragment `a` and X = shared rows
// [k0, k0 + 16) over the 64 channels (bf16 or f32 rows)
template <typename T>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const uint32_t (&a)[4],
                                         const T* x, int k0, int lane) {
#pragma unroll
  for (int n = 0; n < 8; n += 2) {
    uint32_t b[4];
    load_bt(x, k0, 8 * n, lane, b);
    mma(acc[n], a, b[0], b[1]);
    mma(acc[n + 1], a, b[2], b[3]);
  }
}

// The 16 x 16 A fragment of key step t from two n-tiles of accumulators
// (the m16n8 C layout of n-tiles 2t and 2t + 1 is the m16k16 A layout)
__device__ __forceinline__ void a_of(const float (&lo)[4], const float (&hi)[4],
                                     uint32_t (&a)[4]) {
  a[0] = pack(lo[0], lo[1]);
  a[1] = pack(lo[2], lo[3]);
  a[2] = pack(hi[0], hi[1]);
  a[3] = pack(hi[2], hi[3]);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// The block's (image, head, tile) and the head's base offset.
struct Block {
  int tile;
  long long bh, base, W;
  __device__ Block(int L, int H, int tiles) {
    tile = blockIdx.x % tiles;
    bh = blockIdx.x / tiles;
    const int h = static_cast<int>(bh % H);
    const long long b = bh / H;
    W = static_cast<long long>(H) * kHeadDim;
    base = b * L * W + static_cast<long long>(h) * kHeadDim;
  }
};

template <int NT, bool CAUSAL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int L, int H, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TQ = 16 * WARPS;  // query rows of the block
  const Block blk(L, H, tiles);
  const int q0 = blk.tile * TQ;
  const int rows = min(TQ, L - q0);
  const int nkeys = CAUSAL ? q0 + rows : L;  // keys the block needs
  bf16* qs = reinterpret_cast<bf16*>(smem);
  float* ks = reinterpret_cast<float*>(qs + TQ * kLd);
  bf16* vs = reinterpret_cast<bf16*>(ks + round16(nkeys) * kLdF);
  load_rows(q + blk.base + static_cast<long long>(q0) * blk.W, blk.W, rows, TQ, qs);
  load_rows(v + blk.base, blk.W, nkeys, round16(nkeys), vs);
  load_rows_f32(k + blk.base, blk.W, nkeys, round16(nkeys), ks);
  load_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = q0 + 16 * warp;
  if (i0 >= L) return;
  const int nk = warp_keys<CAUSAL>(i0, L);

  float s[NT][4], m[2], l[2];
  row_dots<NT>(qs + 16 * warp * kLd, ks, nk, lane, s);
  softmax_rows<NT, CAUSAL>(s, i0, L, lane, m, l);

  float o[8][4];
  zero(o);
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    if (16 * t < nk) {
      uint32_t a[4];
      a_of(s[2 * t], s[2 * t + 1], a);  // round(p)
      mma_rows(o, a, vs, 16 * t, lane);
    }
  }
  store_rows(out + blk.base, blk.W, i0, L, lane, o);
}

// Backward pass 1: one block per (image, head, tile of 16 WARPS query rows): dq
// and each row's softmax max, sum and r (stats: 3 arrays of B H L floats).
template <int NT, bool CAUSAL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_rows(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  bf16* __restrict__ dq, float* __restrict__ stats, int L, int H, int tiles,
                  long long n_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TQ = 16 * WARPS;
  const Block blk(L, H, tiles);
  const int q0 = blk.tile * TQ;
  const int rows = min(TQ, L - q0);
  const int nkeys = CAUSAL ? q0 + rows : L;
  const long long row0 = static_cast<long long>(q0) * blk.W;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + TQ * kLd;
  float* ks = reinterpret_cast<float*>(gs + TQ * kLd);
  float* vs = ks + round16(nkeys) * kLdF;
  load_rows(q + blk.base + row0, blk.W, rows, TQ, qs);
  load_rows(g + blk.base + row0, blk.W, rows, TQ, gs);
  load_rows_f32(k + blk.base, blk.W, nkeys, round16(nkeys), ks);
  load_rows_f32(v + blk.base, blk.W, nkeys, round16(nkeys), vs);
  load_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = q0 + 16 * warp;
  if (i0 >= L) return;
  const int nk = warp_keys<CAUSAL>(i0, L);

  float p[NT][4], m[2], l[2];
  row_dots<NT>(qs + 16 * warp * kLd, ks, nk, lane, p);
  softmax_rows<NT, CAUSAL>(p, i0, L, lane, m, l);

  // dp tile by tile (the registers hold p for up to 272 keys), once for r
  // and again for ds
  const bf16* ga = gs + 16 * warp * kLd;  // this warp's g rows
  float part[2][4][2];  // r's terms p dp; masked and padded keys: p = 0, dp finite
  zero(part);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (8 * t < nk) {
      float dp[4];
      dot_tile(ga, vs + 8 * t * kLdF, lane, dp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[e >> 1][t & 3][e & 1] = fmaf(p[t][e], dp[e], part[e >> 1][t & 3][e & 1]);
      }
    }
  }
  const float r[2] = {lane_order_sum(part[0]), lane_order_sum(part[1])};

  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    if (16 * t < nk) {
      float ds[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dot_tile(ga, vs + (16 * t + 8 * h) * kLdF, lane, ds[h]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[h][e] = ds_of(p[2 * t + h][e], ds[h][e], r[e >> 1]);
      }
      uint32_t a[4];
      a_of(ds[0], ds[1], a);  // round(ds)
      mma_rows(acc, a, ks, 16 * t, lane);
    }
  }
  store_rows(dq + blk.base, blk.W, i0, L, lane, acc);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + (lane >> 2) + 8 * h;
      if (i < L) {
        const long long at = blk.bh * L + i;
        stats[at] = m[h];
        stats[n_rows + at] = l[h];
        stats[2 * n_rows + at] = r[h];
      }
    }
  }
}

// Backward pass 2: one block per (image, head, tile of 64 keys): dk and dv,
// summed over the query rows in chunks of 64 from c0 (the tile's first key
// under the causal mask, else 0).
template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_cols(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                  const float* __restrict__ stats, int L, int H, int tiles, long long n_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block blk(L, H, tiles);
  const int k0 = blk.tile * kTile;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kTile * kLd;
  bf16* ps = gs + kTile * kLd;   // round(p) as [query][key]
  bf16* dss = ps + kTile * kLd;  // round(ds) as [query][key]
  float* ks = reinterpret_cast<float*>(dss + kTile * kLd);
  float* vs = ks + kTile * kLdF;
  const long long key0 = static_cast<long long>(k0) * blk.W;
  load_rows_f32(k + blk.base + key0, blk.W, min(kTile, L - k0), kTile, ks);
  load_rows_f32(v + blk.base + key0, blk.W, min(kTile, L - k0), kTile, vs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, c2 = (lane & 3) * 2;
  const int nk = min(kTile, L - k0);  // the tile's keys
  const float* st = stats + blk.bh * L;
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  for (int c = CAUSAL ? k0 : 0; c < L; c += kTile) {
    const int rows = min(kTile, L - c);
    const long long row0 = static_cast<long long>(c) * blk.W;
    load_rows(q + blk.base + row0, blk.W, rows, kTile, qs);
    load_rows(g + blk.base + row0, blk.W, rows, kTile, gs);
    load_wait();  // the key tile too, on the first chunk

    const int i0 = c + 16 * warp;  // this warp's query rows
    // causal, first chunk: the warp's rows see the tile's keys up to its last row
    const bool diag = CAUSAL && c == k0;
    if (i0 < L) {
      const int nkw = diag ? min(nk, 16 * warp + 16) : nk;
      float p[8][4];
      row_dots<8>(qs + 16 * warp * kLd, ks, nkw, lane, p);
      float dp[8][4];
      row_dots<8>(gs + 16 * warp * kLd, vs, nkw, lane, dp);
      float m[2], l[2], r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + gr + 8 * h;
        m[h] = i < L ? st[i] : 0.f;
        l[h] = i < L ? st[n_rows + i] : 1.f;
        r[h] = i < L ? st[2 * n_rows + i] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + (e >> 1) * 8;
          const int j = k0 + 8 * t + c2 + (e & 1);
          const bool keep = i < L && j < L && (!CAUSAL || j <= i);
          p[t][e] = keep ? prob(scaled_logit(p[t][e]), m[e >> 1], l[e >> 1]) : 0.f;
          dp[t][e] = ds_of(p[t][e], dp[t][e], r[e >> 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = (16 * warp + gr + 8 * h) * kLd + 8 * t + c2;
          *reinterpret_cast<uint32_t*>(ps + at) = pack(p[t][2 * h], p[t][2 * h + 1]);
          *reinterpret_cast<uint32_t*>(dss + at) = pack(dp[t][2 * h], dp[t][2 * h + 1]);
        }
      }
    }
    __syncthreads();

    // this warp's keys k0 + 16 warp .. + 15 over the chunk's valid rows (on
    // the diagonal only rows at or past them)
    for (int s = diag ? warp : 0; 16 * s < rows; ++s) {
      uint32_t a[4];
      load_at(ps, 16 * s, 16 * warp, lane, a, kLd);
      mma_rows(dva, a, gs, 16 * s, lane);  // dv += round(p)^T g
      load_at(dss, 16 * s, 16 * warp, lane, a, kLd);
      mma_rows(dka, a, qs, 16 * s, lane);  // dk += ds^T q
    }
    __syncthreads();  // before the next chunk overwrites q, g, p and ds
  }
  store_rows(dk + blk.base, blk.W, k0 + 16 * warp, L, lane, dka);
  store_rows(dv + blk.base, blk.W, k0 + 16 * warp, L, lane, dva);
}

// The backward for L <= 16 WARPS (64 or 128): one block per (image, head)
// holds every query and key, so p, dp and ds are computed once (no stats, no
// second pass): each warp's 16 rows give dq = ds K as in pass 1 and put
// round(p) and round(ds) into shared memory; then each warp sums dk and dv
// of its 16 keys as in pass 2.
template <bool CAUSAL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_head(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                  int H) {
  constexpr int TQ = 16 * WARPS;  // rows and keys of the block
  constexpr int NT = TQ / 8;
  constexpr int KP = TQ + 8;  // a p / ds row in bf16
  extern __shared__ __align__(16) unsigned char smem[];
  const Block blk(L, H, 1);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + TQ * kLd;
  bf16* ps = gs + TQ * kLd;   // round(p) as [query][key]
  bf16* dss = ps + TQ * KP;   // round(ds) as [query][key]
  float* ks = reinterpret_cast<float*>(dss + TQ * KP);
  float* vs = ks + TQ * kLdF;
  load_rows(q + blk.base, blk.W, L, TQ, qs);
  load_rows(g + blk.base, blk.W, L, TQ, gs);
  load_rows_f32(k + blk.base, blk.W, L, TQ, ks);
  load_rows_f32(v + blk.base, blk.W, L, TQ, vs);
  load_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, c2 = (lane & 3) * 2;
  const int i0 = 16 * warp;
  if (i0 < L) {
    const int nk = warp_keys<CAUSAL>(i0, L);
    float p[NT][4], m[2], l[2];
    row_dots<NT>(qs + 16 * warp * kLd, ks, nk, lane, p);
    softmax_rows<NT, CAUSAL>(p, i0, L, lane, m, l);
    float ds[NT][4];  // dp, then ds
    row_dots<NT>(gs + 16 * warp * kLd, vs, nk, lane, ds);
    float part[2][4][2];
    zero(part);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (8 * t < nk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[e >> 1][t & 3][e & 1] = fmaf(p[t][e], ds[t][e], part[e >> 1][t & 3][e & 1]);
        }
      }
    }
    const float r[2] = {lane_order_sum(part[0]), lane_order_sum(part[1])};
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row = i0 + gr + (e >> 1) * 8 < L;  // padded rows give nothing
        ds[t][e] = row ? ds_of(p[t][e], ds[t][e], r[e >> 1]) : 0.f;
        p[t][e] = row ? p[t][e] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (16 * warp + gr + 8 * h) * KP + 8 * t + c2;
        *reinterpret_cast<uint32_t*>(ps + at) = pack(p[t][2 * h], p[t][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dss + at) = pack(ds[t][2 * h], ds[t][2 * h + 1]);
      }
    }
#pragma unroll
    for (int t = 0; t < NT / 2; ++t) {
      if (16 * t < nk) {
        uint32_t a[4];
        a_of(ds[2 * t], ds[2 * t + 1], a);  // round(ds)
        mma_rows(acc, a, ks, 16 * t, lane);
      }
    }
    store_rows(dq + blk.base, blk.W, i0, L, lane, acc);
  }
  __syncthreads();

  if (16 * warp < L) {  // this warp's keys 16 warp .. + 15 over the valid rows
    float dka[8][4], dva[8][4];
    zero(dka);
    zero(dva);
    for (int s = CAUSAL ? warp : 0; 16 * s < L; ++s) {  // causal: rows i >= the keys
      uint32_t a[4];
      load_at(ps, 16 * s, 16 * warp, lane, a, KP);
      mma_rows(dva, a, gs, 16 * s, lane);  // dv += round(p)^T g
      load_at(dss, 16 * s, 16 * warp, lane, a, KP);
      mma_rows(dka, a, qs, 16 * s, lane);  // dk += ds^T q
    }
    store_rows(dk + blk.base, blk.W, 16 * warp, L, lane, dka);
    store_rows(dv + blk.base, blk.W, 16 * warp, L, lane, dva);
  }
}

// Grid of B * H * tiles blocks; dynamic shared memory raised above 48 KB.
template <typename Kernel>
int prepare(Kernel kernel, int B, int L, int H, size_t smem, int tile, int* tiles,
            unsigned* blocks) {
  *tiles = (L + tile - 1) / tile;
  const long long n = static_cast<long long>(B) * H * *tiles;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(n);
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  return 0;
}

constexpr size_t rows_bytes(int rows) { return static_cast<size_t>(rows) * kLd * sizeof(bf16); }
constexpr size_t f32_rows_bytes(int rows) {
  return static_cast<size_t>(rows) * kLdF * sizeof(float);
}

// Warps a block of the forward and of pass 1: 8 for L in (128, 272], where
// the f32 keys (and values) fill shared memory, so that one block a
// multiprocessor still has 8 warps and loads the keys for 128 rows; 4 above
// (pass 1's f32 keys and values alone take 209 KB at L = 384)
template <int NT>
constexpr int warps_for() { return NT > 16 && NT <= 34 ? 8 : 4; }

template <int NT, bool C>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int L, int H,
               cudaStream_t s) {
  constexpr int kW = warps_for<NT>();
  auto kernel = attn_fwd<NT, C, kW>;
  const size_t smem = rows_bytes(16 * kW + round16(L)) + f32_rows_bytes(round16(L));
  int tiles;
  unsigned blocks;
  if (const int e = prepare(kernel, B, L, H, smem, 16 * kW, &tiles, &blocks)) return e;
  kernel<<<blocks, kW * 32, smem, s>>>(q, k, v, out, L, H, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool C, int W>
int launch_bwd_head(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq,
                    bf16* dk, bf16* dv, int B, int L, int H, cudaStream_t s) {
  auto kernel = attn_bwd_head<C, W>;
  constexpr int TQ = 16 * W;
  const size_t smem = rows_bytes(2 * TQ) + static_cast<size_t>(2 * TQ) * (TQ + 8) * sizeof(bf16) +
                      f32_rows_bytes(2 * TQ);
  int tiles;
  unsigned blocks;
  if (const int e = prepare(kernel, B, L, H, smem, TQ, &tiles, &blocks)) return e;
  kernel<<<blocks, W * 32, smem, s>>>(q, k, v, g, dq, dk, dv, L, H);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool C>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq, bf16* dk,
               bf16* dv, float* stats, int B, int L, int H, cudaStream_t s) {
  const long long n_rows = static_cast<long long>(B) * H * L;
  constexpr int kW = warps_for<NT>();
  auto rows = attn_bwd_rows<NT, C, kW>;
  auto cols = attn_bwd_cols<C>;
  const size_t smem_rows = rows_bytes(2 * 16 * kW) + f32_rows_bytes(2 * round16(L));
  const size_t smem_cols = rows_bytes(4 * kTile) + f32_rows_bytes(2 * kTile);
  int row_tiles, col_tiles;
  unsigned row_blocks, col_blocks;
  if (const int e = prepare(rows, B, L, H, smem_rows, 16 * kW, &row_tiles, &row_blocks)) return e;
  if (const int e = prepare(cols, B, L, H, smem_cols, kTile, &col_tiles, &col_blocks)) return e;
  rows<<<row_blocks, kW * 32, smem_rows, s>>>(q, k, v, g, dq, stats, L, H, row_tiles, n_rows);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  cols<<<col_blocks, kThreads, smem_cols, s>>>(q, k, v, g, dk, dv, stats, L, H, col_tiles,
                                                n_rows);
  return static_cast<int>(cudaGetLastError());
}

// NT, the n-tiles of 8 keys a warp keeps in registers (even: P.V and dq
// take them in pairs), by length: 64, 128, 208 (ViT-B/16's 197), 272
// (ViT-L/14's 257), 384
template <bool C>
int fwd_len(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int L, int H,
            cudaStream_t s) {
  if (L <= 64) return launch_fwd<8, C>(q, k, v, out, B, L, H, s);
  if (L <= 128) return launch_fwd<16, C>(q, k, v, out, B, L, H, s);
  if (L <= 208) return launch_fwd<26, C>(q, k, v, out, B, L, H, s);
  if (L <= 272) return launch_fwd<34, C>(q, k, v, out, B, L, H, s);
  return launch_fwd<48, C>(q, k, v, out, B, L, H, s);
}

template <bool C>
int bwd_len(const bf16* q, const bf16* k, const bf16* v, const bf16* g, bf16* dq, bf16* dk,
            bf16* dv, float* st, int B, int L, int H, cudaStream_t s) {
  if (L <= 64) return launch_bwd_head<C, 4>(q, k, v, g, dq, dk, dv, B, L, H, s);
  if (L <= 128) return launch_bwd_head<C, 8>(q, k, v, g, dq, dk, dv, B, L, H, s);
  if (L <= 208) return launch_bwd<26, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  if (L <= 272) return launch_bwd<34, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  return launch_bwd<48, C>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
}

bool bad_shape(int B, int L, int H) { return L < 1 || L > kMaxLen || H < 1 || B < 0; }

}  // namespace

// q, k, v, out: (B, L, H * 64) bf16, contiguous, 16-byte aligned (the
// caller checks). 1 <= L <= 384. Returns cudaGetLastError() after the
// launch (or the error of raising the shared-memory limit).
extern "C" int seesaw_pair_attention_bf16(const void* q, const void* k, const void* v,
                                          void* out, int B, int L, int H, int causal,
                                          void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? fwd_len<true>(Q, K, V, O, B, L, H, s) : fwd_len<false>(Q, K, V, O, B, L, H, s);
}

// The backward: dq, dk, dv (each like q) for the output gradient g (like
// q), stats a scratch of 3 * B * H * L floats (unused up to L = 128). One
// launch up to L = 128, else two, on `stream`;
// returns the first CUDA error.
extern "C" int seesaw_pair_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                              const void* g, void* dq, void* dk, void* dv,
                                              void* stats, int B, int L, int H, int causal,
                                              void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* G = static_cast<const bf16*>(g);
  bf16* DQ = static_cast<bf16*>(dq);
  bf16* DK = static_cast<bf16*>(dk);
  bf16* DV = static_cast<bf16*>(dv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? bwd_len<true>(Q, K, V, G, DQ, DK, DV, st, B, L, H, s)
                : bwd_len<false>(Q, K, V, G, DQ, DK, DV, st, B, L, H, s);
}
