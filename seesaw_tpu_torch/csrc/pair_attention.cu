// Pair attention in f32 on Hopper's tensor cores, forward (K5) and backward
// (K6): softmax(q k^T / 8) v per 64-wide head, the attention of every layer
// of both CLIP towers. bf16 inputs take pair_attention_bf16.cu.
//
// Replaces the Pallas TPU kernels seesaw_tpu/ops/pallas_attention.py::
// _attn_kernel (forward, called through fused_pair_attention) and
// ::_attn_bwd_kernel (its custom VJP). q, k, v, g and every output are
// (B, L, W) in the projection layout, W = H * 64, head h in channels
// [64h, 64h + 64); no head split or merge is materialised. For every image
// b, head h and query row i:
//
//     s_j   = (q_i . k_j) / 8            f32 logits
//     p_j   = exp(s_j - max s) / sum     exact two-pass softmax in f32
//     out_i = sum_j p_j v_j              f32 sums
//
// with keys j <= i only when causal (the text tower's mask, built here from
// the indices, never read as a tensor). The backward, for the output
// gradient g, in the order of operations of _attn_bwd_kernel:
//
//     dp_j  = g_i . v_j;   r_i = sum_j p_j dp_j;   ds_j = p_j (dp_j - r_i) / 8
//     dq_i  = sum_j ds_j k_j;  dk_j = sum_i ds_ij q_i;  dv_j = sum_i p_ij g_i
//
// What bounds them: a head's work is 2 L^2 64 operations a product (2
// products forward, 5 backward) against 4 L 64 f32 elements moved (7 in the
// backward); at the towers' shapes (L = 50..257) the operations bound both
// at any f32 rate the card has. So every product runs on the tensor cores by
// the 3xTF32 split (the route of CUTLASS's OpMultiplyAddFastF32, which SDPA's
// f32 kernel takes): each f32 operand x is written as big + small, big =
// rna_tf32(x), small = rna_tf32(x - big), and a product is summed as
// big.small + small.big + big.big (in that order, small terms first) on
// mma.sync.m16n8k8 TF32 with f32 accumulation. That keeps ~22 of f32's 24
// bits at three TF32 operations each (495 / 3 TFLOP/s against the CUDA
// cores' 67). A raw f32 is never handed to the TF32 MMA: the hardware would
// drop its low 13 bits, and that alone breaks the f32 bar.
//
// One orientation: every logit and every dp is row_dots' sequence (query
// or g rows on the MMA's M side, keys or values on N, eight k-steps of 8
// channels in order, three MMAs each), and an MMA's output element depends
// only on its own row, column and accumulator. So a logit has the same bits
// wherever its tile sits, and p (softmax_rows in the forward, the one-pass
// backward and pass 1; prob from pass 1's max and sum in pass 2) is the
// same in the forward and the backward, the role _pair_softmax plays for
// the TPU kernels. K Q^T is never computed: P^T and dS^T for dk and dv are
// read back transposed from shared memory.
//
// Fragments (m16n8k8 TF32; g = lane / 4, t = lane % 4): A holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k = t, n = g) and (t + 4,
// g); C holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A product
// that sums over keys or query rows (P.V, dq, dk, dv) takes its k index in
// pairs: k slot t is element 2t, slot t + 4 element 2t + 1, on both the A
// and the B side. Then a C fragment of p or ds is an A fragment as it stands
// (no shuffle), and every shared-memory read is one 32-bit load a lane,
// free of bank conflicts: rows of 64 + 4 floats (row-major (g, t) reads hit
// bank 4g + t, paired (2t, g) reads bank 8t + g), and p / ds rows of a
// multiple of 8 plus 4 floats for the transposed reads.
//
// What the split costs, and where it is done: cvt.rna.tf32.f32 compiles to
// four instructions (an infinity test, an add, a select, a mask), so a
// split is nine, against one 32-bit load an element. Split by every warp
// at every read, the splits' instructions outnumber the MMAs several times
// and set the pace. So an operand that several warps read on an MMA's B
// side is split once, as the block loads it (load_split), into two planes
// of TF32 values, big and small; operands a warp alone reads (its query or
// g rows on the A side, p and ds) are split in registers and reused across
// the n-tiles. Each group of MMAs is issued in three sweeps over
// independent accumulators (mma3).
//
// The softmax runs on the C fragment in f32 with expf: a row's max and sum
// over the thread's n-tiles in order, then across the quad (xor 1, xor 2),
// and p = exp(s - max) times the sum's reciprocal: one f32 division a row,
// not one a key (an IEEE division is a dozen instructions and a slow path).
// The order is fixed and there are no atomics, so two runs give the same
// bits.
//
// Forward: one block per (image, head, tile of 16 WARPS query rows), each
// warp 16 rows with their logits over all keys in registers (NT n-tiles of
// 8 keys, up to 48 for L = 384), exact softmax, p fed to P.V from the
// registers. Shared memory: the query tile (f32, by cp.async), then the
// head's keys, split, then its values, split, in the same region. A grid
// with fewer 4-warp blocks than multiprocessors (the text query) takes
// attn_fwd_small instead, which spreads a row group over four warps.
//
// Backward: up to L = 96 one block per (image, head) holds q, g, k and v
// (split; f32 up to L = 64, where more blocks a multiprocessor measured
// faster) and computes p, dp and ds once, dq = ds K; p and ds then go to
// shared memory in place of the keys and values, and each warp sums dk =
// ds^T q and dv = p^T g over all rows for its 16 keys: 5 products per kept
// pair. Beyond, two passes, each output summed by one warp in a fixed order:
// - Pass 1 (rows), per tile of query rows: p as the forward (split keys);
//   then the split values, r from dp 64 keys at a time, dp again and ds in
//   place of p; then the split keys again and dq += ds K. Each row's max,
//   sum and r go to a (3, B H L) scratch.
// - Pass 2 (cols), per tile of 64 keys: over the query rows in chunks of 64
//   (from the tile's first key when causal), each warp computes its 16 rows'
//   logits and dp against the tile's keys, p from pass 1's max and sum, ds;
//   p and ds go to shared memory as [query][key]; then each warp owns 16
//   keys and sums dv += p^T g and dk += ds^T q over the chunk.
// The TPU kernels' head-pair packing, batch padding and VMEM block caps are
// not carried over: they fill a 128-deep MXU contraction and fit VMEM.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kLd = kHeadDim + 4;  // shared row of 64 channels, in floats
constexpr int kTile = 64;          // keys of a pass-2 block, rows of its chunks
constexpr int kMaxLen = 384;
constexpr int kHeadMaxLen = 96;    // the one-pass backward's longest L

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows [0, n) of one head (64 floats each, W elements apart) -> dst, kLd
// apart, by cp.async; rows [n, rows) zero. The caller waits (load_wait).
__device__ __forceinline__ void load_rows(const float* __restrict__ src, long long W, int n,
                                          int rows, float* dst) {
  for (int idx = threadIdx.x; idx < rows * 16; idx += blockDim.x) {
    const int r = idx >> 4;
    const int c = (idx & 15) * 4;
    const bool valid = r < n;
    const float* g = src + (valid ? static_cast<long long>(r) * W + c : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * kLd + c)),
                 "l"(g), "r"(valid ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void load_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value (x - big is exact in f32)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  FragA a;
  split(a0, a.big[0], a.small[0]);
  split(a1, a.big[1], a.small[1]);
  split(a2, a.big[2], a.small[2]);
  split(a3, a.big[3], a.small[3]);
  return a;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB b;
  split(b0, b.big[0], b.small[0]);
  split(b1, b.big[1], b.small[1]);
  return b;
}

// Rows [0, n) of one head -> dst split: the big parts, and `plane` words
// further the small parts, rows kLd apart; rows [n, rows) zero. Every
// operand that more than one warp reads as an MMA's B side is split once
// here, not once a warp. BATCH 16-byte loads in flight a thread (4 where
// the registers are short). The caller synchronises.
template <int BATCH = 8>
__device__ __forceinline__ void load_split(const float* __restrict__ src, long long W, int n,
                                           int rows, uint32_t* dst, int plane) {
  constexpr int kBatch = BATCH;
  for (int base = threadIdx.x; base < rows * 16; base += kBatch * blockDim.x) {
    float4 x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + b * blockDim.x;
      const int r = idx >> 4;
      x[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < rows * 16 && r < n) {
        x[b] = *reinterpret_cast<const float4*>(src + static_cast<long long>(r) * W +
                                                (idx & 15) * 4);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = base + b * blockDim.x;
      if (idx < rows * 16) {
        uint4 big, small;
        split(x[b].x, big.x, small.x);
        split(x[b].y, big.y, small.y);
        split(x[b].z, big.z, small.z);
        split(x[b].w, big.w, small.w);
        uint32_t* d = dst + (idx >> 4) * kLd + (idx & 15) * 4;
        *reinterpret_cast<uint4*>(d) = big;
        *reinterpret_cast<uint4*>(d + plane) = small;
      }
    }
  }
}

// c += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[u] += a b[u] in f32 by the 3xTF32 split, for the u < N with use[u]:
// big.small, small.big, then big.big into each accumulator, issued in three
// sweeps over u so that neighbouring MMAs do not wait on each other
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const FragA& a, const FragB (&b)[N],
                                     const bool (&use)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (use[u]) mma(c[u], a.big, b[u].small);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (use[u]) mma(c[u], a.small, b[u].big);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (use[u]) mma(c[u], a.big, b[u].big);
  }
}

// Shared rows of 64 channels, kLd apart, as an MMA reads them: f32 rows,
// split by each warp as it reads them (an operand only its own warp reads,
// or where shared memory is short), or rows split once into two planes,
// big and small, `plane` words apart (load_split).
struct F32Rows {
  const float* x;
  __device__ F32Rows at(int row) const { return F32Rows{x + row * kLd}; }
  // A fragment of the 16 rows at channels [dc, dc + 8)
  __device__ FragA a(int dc, int lane) const {
    const float* p = x + (lane >> 2) * kLd + (lane & 3) + dc;
    return frag_a(p[0], p[8 * kLd], p[4], p[8 * kLd + 4]);
  }
  // B fragment with n = the 8 rows, k = channels [dc, dc + 8)
  __device__ FragB b_rows(int dc, int lane) const {
    const float* p = x + (lane >> 2) * kLd + (lane & 3) + dc;
    return frag_b(p[0], p[4]);
  }
  // B fragment with k = the 8 rows (in pairs), n = channels [c0, c0 + 8)
  __device__ FragB b_pairs(int c0, int lane) const {
    const float* p = x + (lane & 3) * 2 * kLd + (lane >> 2) + c0;
    return frag_b(p[0], p[kLd]);
  }
};

struct SplitRows {
  const uint32_t* x;
  int plane;
  __device__ SplitRows at(int row) const { return SplitRows{x + row * kLd, plane}; }
  __device__ FragA a(int dc, int lane) const {
    const uint32_t* p = x + (lane >> 2) * kLd + (lane & 3) + dc;
    return FragA{{p[0], p[8 * kLd], p[4], p[8 * kLd + 4]},
                 {p[plane], p[plane + 8 * kLd], p[plane + 4], p[plane + 8 * kLd + 4]}};
  }
  __device__ FragB b_rows(int dc, int lane) const {
    const uint32_t* p = x + (lane >> 2) * kLd + (lane & 3) + dc;
    return FragB{{p[0], p[4]}, {p[plane], p[plane + 4]}};
  }
  __device__ FragB b_pairs(int c0, int lane) const {
    const uint32_t* p = x + (lane & 3) * 2 * kLd + (lane >> 2) + c0;
    return FragB{{p[0], p[kLd]}, {p[plane], p[plane + kLd]}};
  }
};

// The view of buffer x as SPLIT rows or f32 rows
template <bool SPLIT>
__device__ __forceinline__ auto rows_at(uint32_t* x, int plane) {
  if constexpr (SPLIT) {
    return SplitRows{x, plane};
  } else {
    return F32Rows{reinterpret_cast<const float*>(x)};
  }
}

// Rows [0, n) of one head -> a SPLIT or f32 buffer, rows [n, rows) zero;
// the caller waits (load_wait)
template <bool SPLIT>
__device__ __forceinline__ void load_any(const float* __restrict__ src, long long W, int n,
                                         int rows, uint32_t* dst, int plane) {
  if constexpr (SPLIT) {
    load_split(src, W, n, rows, dst, plane);
  } else {
    load_rows(src, W, n, rows, reinterpret_cast<float*>(dst));
  }
}

// A fragment of X^T for X = 8 shared f32 rows at x (ld apart, k in pairs)
// by columns [0, 16) (m)
__device__ __forceinline__ FragA load_at(const float* x, int ld, int lane) {
  const float* p = x + (lane & 3) * 2 * ld + (lane >> 2);
  return frag_a(p[0], p[8], p[ld], p[ld + 8]);
}

// The A fragment (k in pairs) of an n-tile's C fragment, as it stands
__device__ __forceinline__ FragA a_of(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// s[t] = the 16 A rows (queries or g) times the 8 split B rows at brows +
// 8 t (keys or values) over the 64 channels, for the n-tiles below nk, the
// others 0 (the caller masks them). Every logit and every dp of both
// kernels comes from here: eight k-steps in channel order, mma3 each, on
// operands split by the one function split, so an element's bits depend
// only on its row and column.
template <int NT, typename ARows, typename BRows>
__device__ __forceinline__ void row_dots(const ARows& arows, const BRows& brows, int nk, int lane,
                                         float (&s)[NT][4]) {
  constexpr int G = 4;  // n-tiles a sweep
  zero(s);
#pragma unroll 1
  for (int dc = 0; dc < kHeadDim; dc += 8) {
    const FragA a = arows.a(dc, lane);
#pragma unroll
    for (int t0 = 0; t0 < NT; t0 += G) {
      if (8 * t0 < nk) {  // warp-uniform, as every use[u]
        FragB b[G];
        bool use[G];
        float c[G][4];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          use[u] = t0 + u < NT && 8 * (t0 + u) < nk;
          if (use[u]) b[u] = brows.at(8 * (t0 + u)).b_rows(dc, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) c[u][e] = t0 + u < NT ? s[t0 + u][e] : 0.f;
        }
        mma3<G>(c, a, b, use);
#pragma unroll
        for (int u = 0; u < G; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (t0 + u < NT) s[t0 + u][e] = c[u][e];
          }
        }
      }
    }
  }
}

// acc[n] += a X for the 16 x 8 A fragment a (k in pairs) and X = the 8
// shared rows x over the 64 channels
template <typename Rows>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const FragA& a, const Rows& x,
                                         int lane) {
  FragB b[8];
  bool use[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    b[n] = x.b_pairs(8 * n, lane);
    use[n] = true;
  }
  mma3<8>(acc, a, b, use);
}

__device__ __forceinline__ float scaled_logit(float dot) { return dot * 0.125f; }

// p of one logit from its row's max and the reciprocal of its sum, as
// softmax_rows leaves it (one division a row, not one a key)
__device__ __forceinline__ float prob(float logit, float m, float inv_l) {
  return expf(logit - m) * inv_l;
}

__device__ __forceinline__ float ds_of(float p, float dp, float r) {
  return (p * (dp - r)) * 0.125f;
}

// The sum over the quad of x (every lane of the quad gets the same bits)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys a warp whose first row is i0 needs: all, or up to its last row.
template <bool CAUSAL>
__device__ __forceinline__ int warp_keys(int i0, int L) {
  return CAUSAL ? min(L, i0 + 16) : L;
}

// Exact softmax in place over the dots of rows i0 + g and i0 + g + 8
// (s[t][e] is row g + 8 (e / 2), key 8t + 2 (lane % 4) + e % 2): keys j < L
// (and j <= i when causal) kept, the rest p = 0; n-tiles at or past nk (the
// warp's keys) hold no kept key and are skipped. m and l get each row's max
// and sum (the same in the quad). Every row keeps key 0.
template <int NT, bool CAUSAL>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int i0, int L, int nk, int lane,
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
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (8 * t < nk) {  // warp-uniform
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = expf(s[t][e] - mx[e >> 1]);  // masked: exp(-inf) = 0
        sum[e >> 1] += s[t][e];
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = mx[h];
    l[h] = quad_sum(sum[h]);
    inv[h] = 1.f / l[h];
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 8 * t < nk ? s[t][e] * inv[e >> 1] : 0.f;
  }
}

// acc[n] (rows g, g + 8 of the warp; channels 8n + 2 (lane % 4) + {0, 1})
// -> rows i0 + g, i0 + g + 8 of dst, those below L
__device__ __forceinline__ void store_rows(float* __restrict__ dst, long long W, int i0, int L,
                                           int lane, const float (&acc)[8][4]) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    if (i < L) {
      float* d = dst + static_cast<long long>(i) * W + c2;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<float2*>(d + 8 * n) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
  }
}

// x[t] (C fragments of the warp's 16 rows) -> shared rows r0 + g, r0 + g + 8
// at columns 8t + 2 (lane % 4) + {0, 1}, ld apart, for the n-tiles below nt
template <int NT>
__device__ __forceinline__ void store_tiles(const float (&x)[NT][4], int nt, float* dst, int ld,
                                            int lane) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(dst + (g + 8 * h) * ld + 8 * t + c2) =
            make_float2(x[t][2 * h], x[t][2 * h + 1]);
      }
    }
  }
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
    attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int L, int H, int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TQ = 16 * WARPS;  // query rows of the block
  const Block blk(L, H, tiles);
  const int q0 = blk.tile * TQ;
  const int rows = min(TQ, L - q0);
  const int nkeys = CAUSAL ? q0 + rows : L;  // keys the block needs
  const int plane = round8(nkeys) * kLd;
  float* qs = smem;
  uint32_t* kv = reinterpret_cast<uint32_t*>(qs + TQ * kLd);  // the keys, then the values, split
  load_rows(q + blk.base + static_cast<long long>(q0) * blk.W, blk.W, rows, TQ, qs);
  constexpr int kBatch = NT < 34 ? 8 : 4;
  load_split<kBatch>(k + blk.base, blk.W, nkeys, round8(nkeys), kv, plane);
  load_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = q0 + 16 * warp;
  const bool active = i0 < L;
  const int nk = warp_keys<CAUSAL>(i0, L);

  float s[NT][4], m[2], l[2];
  if (active) {
    row_dots<NT>(F32Rows{qs + 16 * warp * kLd}, SplitRows{kv, plane}, nk, lane, s);
    softmax_rows<NT, CAUSAL>(s, i0, L, nk, lane, m, l);
  }
  __syncthreads();  // every warp is done with the keys
  load_split<kBatch>(v + blk.base, blk.W, nkeys, round8(nkeys), kv, plane);
  __syncthreads();
  if (!active) return;

  float o[8][4];
  zero(o);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (8 * t < nk) mma_rows(o, a_of(s[t]), SplitRows{kv + 8 * t * kLd, plane}, lane);
  }
  store_rows(out + blk.base, blk.W, i0, L, lane, o);
}

// The forward for a grid too small to fill the card (the text query: B = 1),
// up to L = 128: one block of kSmallWarps warps per (image, head, 16 query
// rows). There latency sets the time: one warp's chain of MMAs, and each
// round of loads a thread waits on. So the rows, keys and values arrive by
// cp.async in one round, as f32 (each element has one reader), and the
// warps share a row group's work: each computes a quarter of its logit
// tiles (row_dots, so the same bits), all read every logit back from shared
// memory and take the softmax (softmax_rows: the same bits again, so p is
// attn_fwd's and the backward's), and each sums P.V for 16 of the 64
// output channels.
constexpr int kSmallWarps = 4;
constexpr int kSmallMaxLen = 128;

template <int NT, bool CAUSAL>
__global__ void __launch_bounds__(kSmallWarps * 32)
    attn_fwd_small(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out, int L, int H,
                   int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TW = (NT + kSmallWarps - 1) / kSmallWarps;  // logit tiles a warp
  constexpr int LS = 8 * NT + 4;                            // a logit row
  const Block blk(L, H, tiles);
  const int i0 = blk.tile * 16;
  const int nk = warp_keys<CAUSAL>(i0, L);  // keys of the row group
  float* qs = smem;
  float* ks = qs + 16 * kLd;
  float* vs = ks + round8(nk) * kLd;
  float* ls = vs + round8(nk) * kLd;  // logits, [16][LS]
  load_rows(q + blk.base + static_cast<long long>(i0) * blk.W, blk.W, min(16, L - i0), 16, qs);
  load_rows(k + blk.base, blk.W, nk, round8(nk), ks);
  load_rows(v + blk.base, blk.W, nk, round8(nk), vs);
  load_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int t0 = TW * warp;  // this warp's first logit tile
  if (t0 < NT) {
    float d[TW][4];
    row_dots<TW>(F32Rows{qs}, F32Rows{ks}.at(8 * t0), nk - 8 * t0, lane, d);
    store_tiles<TW>(d, NT - t0, ls + 8 * t0, LS, lane);
  }
  __syncthreads();

  float s[NT][4], m[2], l[2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = ls[(g + 8 * (e >> 1)) * LS + 8 * t + c2 + (e & 1)];
  }
  softmax_rows<NT, CAUSAL>(s, i0, L, nk, lane, m, l);

  float o[2][4];  // channels 16 warp + 8 u + c2 + {0, 1}
  zero(o);
  const bool use[2] = {true, true};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (8 * t < nk) {
      const F32Rows vt = F32Rows{vs}.at(8 * t);
      const FragB b[2] = {vt.b_pairs(16 * warp, lane), vt.b_pairs(16 * warp + 8, lane)};
      mma3<2>(o, a_of(s[t]), b, use);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    if (i < L) {
      float* d = out + blk.base + static_cast<long long>(i) * blk.W + 16 * warp + c2;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        *reinterpret_cast<float2*>(d + 8 * u) = make_float2(o[u][2 * h], o[u][2 * h + 1]);
      }
    }
  }
}

// The backward for L <= kHeadMaxLen: one block per (image, head) of
// round16(L) / 16 warps holds every query and key, so p, dp and ds are
// computed once (no stats, no second pass): each warp's 16 rows give dq =
// ds K; then p and ds go to shared memory in place of the keys and values,
// and each warp sums dk and dv of its 16 keys over all rows.
template <int NT, bool CAUSAL, bool SPLIT>
__global__ void __launch_bounds__(kHeadMaxLen / 16 * 32)
    attn_bwd_head(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int L,
                  int H) {
  extern __shared__ __align__(16) float smem[];
  const Block blk(L, H, 1);
  const int Lp = round16(L);
  const int plane = Lp * kLd;
  const int kp = Lp + 4;  // a p / ds row
  const int buf = SPLIT ? 2 * plane : plane;  // words a buffer
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);
  uint32_t* gs = qs + buf;
  uint32_t* ks = gs + buf;
  uint32_t* vs = ks + buf;
  float* ps = reinterpret_cast<float*>(ks);  // then p as [query][key], once dq is done
  float* dss = ps + Lp * kp;                 // and ds
  load_any<SPLIT>(q + blk.base, blk.W, L, Lp, qs, plane);
  load_any<SPLIT>(g + blk.base, blk.W, L, Lp, gs, plane);
  load_any<SPLIT>(k + blk.base, blk.W, L, Lp, ks, plane);
  load_any<SPLIT>(v + blk.base, blk.W, L, Lp, vs, plane);
  load_wait();
  const auto Q = rows_at<SPLIT>(qs, plane), G = rows_at<SPLIT>(gs, plane);
  const auto K = rows_at<SPLIT>(ks, plane), V = rows_at<SPLIT>(vs, plane);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int i0 = 16 * warp;  // below L: the block has round16(L) / 16 warps
  const int nk = warp_keys<CAUSAL>(i0, L);
  {
    float p[NT][4], m[2], l[2];
    row_dots<NT>(Q.at(i0), K, nk, lane, p);
    softmax_rows<NT, CAUSAL>(p, i0, L, nk, lane, m, l);
    float ds[NT][4];  // dp, then ds
    row_dots<NT>(G.at(i0), V, nk, lane, ds);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (8 * t < nk) {  // masked and padded keys: p = 0, dp finite
#pragma unroll
        for (int e = 0; e < 4; ++e) part[e >> 1] = fmaf(p[t][e], ds[t][e], part[e >> 1]);
      }
    }
    const float r[2] = {quad_sum(part[0]), quad_sum(part[1])};
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row = i0 + gr + (e >> 1) * 8 < L;  // padded rows give nothing
        ds[t][e] = row ? ds_of(p[t][e], ds[t][e], r[e >> 1]) : 0.f;
        p[t][e] = row ? p[t][e] : 0.f;
      }
    }
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (8 * t < nk) mma_rows(acc, a_of(ds[t]), K.at(8 * t), lane);
    }
    store_rows(dq + blk.base, blk.W, i0, L, lane, acc);
    __syncthreads();  // every warp is done with the keys and values
    store_tiles<NT>(p, Lp / 8, ps + i0 * kp, kp, lane);
    store_tiles<NT>(ds, Lp / 8, dss + i0 * kp, kp, lane);
  }
  __syncthreads();

  // this warp's keys 16 warp .. + 15 over the rows (causal: rows i >= the keys)
  float dka[8][4], dva[8][4];
  zero(dka);
  zero(dva);
  for (int s = CAUSAL ? i0 : 0; s < Lp; s += 8) {
    mma_rows(dva, load_at(ps + s * kp + i0, kp, lane), G.at(s), lane);   // dv += p^T g
    mma_rows(dka, load_at(dss + s * kp + i0, kp, lane), Q.at(s), lane);  // dk += ds^T q
  }
  store_rows(dk + blk.base, blk.W, i0, L, lane, dka);
  store_rows(dv + blk.base, blk.W, i0, L, lane, dva);
}

// Backward pass 1: one block per (image, head, tile of 16 WARPS query rows):
// dq and each row's softmax max, sum and r (stats: 3 arrays of B H L floats).
// The keys, then the values, then the keys again take one split region.
template <int NT, bool CAUSAL, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    attn_bwd_rows(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  float* __restrict__ dq, float* __restrict__ stats, int L, int H, int tiles,
                  long long n_rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TQ = 16 * WARPS;
  const Block blk(L, H, tiles);
  const int q0 = blk.tile * TQ;
  const int rows = min(TQ, L - q0);
  const int nkeys = CAUSAL ? q0 + rows : L;
  const int plane = round8(nkeys) * kLd;
  const long long row0 = static_cast<long long>(q0) * blk.W;
  float* qs = smem;
  float* gs = qs + TQ * kLd;
  uint32_t* kv = reinterpret_cast<uint32_t*>(gs + TQ * kLd);
  load_rows(q + blk.base + row0, blk.W, rows, TQ, qs);
  load_rows(g + blk.base + row0, blk.W, rows, TQ, gs);
  load_split<4>(k + blk.base, blk.W, nkeys, round8(nkeys), kv, plane);
  load_wait();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = q0 + 16 * warp;
  const bool active = i0 < L;
  const int nk = warp_keys<CAUSAL>(i0, L);

  float p[NT][4], m[2], l[2];  // p, then ds
  if (active) {
    row_dots<NT>(F32Rows{qs + 16 * warp * kLd}, SplitRows{kv, plane}, nk, lane, p);
    softmax_rows<NT, CAUSAL>(p, i0, L, nk, lane, m, l);
  }
  __syncthreads();
  load_split<4>(v + blk.base, blk.W, nkeys, round8(nkeys), kv, plane);
  __syncthreads();

  // dp 64 keys at a time, once for r and again for ds
  const F32Rows ga{gs + 16 * warp * kLd};  // this warp's g rows
  constexpr int kChunks = (NT + 7) / 8;
  float r[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (64 * c < nk) {
        float dp[8][4];
        row_dots<8>(ga, SplitRows{kv + 64 * c * kLd, plane}, nk - 64 * c, lane, dp);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (8 * c + u < NT && 8 * (8 * c + u) < nk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) r[e >> 1] = fmaf(p[8 * c + u][e], dp[u][e], r[e >> 1]);
          }
        }
      }
    }
    r[0] = quad_sum(r[0]);
    r[1] = quad_sum(r[1]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (64 * c < nk) {
        float dp[8][4];
        row_dots<8>(ga, SplitRows{kv + 64 * c * kLd, plane}, nk - 64 * c, lane, dp);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = 8 * c + u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (t < NT) p[t][e] = ds_of(p[t][e], dp[u][e], r[e >> 1]);
          }
        }
      }
    }
  }
  __syncthreads();
  load_split<4>(k + blk.base, blk.W, nkeys, round8(nkeys), kv, plane);
  __syncthreads();
  if (!active) return;

  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (8 * t < nk) mma_rows(acc, a_of(p[t]), SplitRows{kv + 8 * t * kLd, plane}, lane);
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

// Backward pass 2: one block per (image, head, tile of kTile keys): dk and
// dv, summed over the query rows in chunks of kTile from c0 (the tile's
// first key under the causal mask, else 0).
template <bool CAUSAL>
__global__ void __launch_bounds__(kTile / 16 * 32)
    attn_bwd_cols(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ g,
                  float* __restrict__ dk, float* __restrict__ dv,
                  const float* __restrict__ stats, int L, int H, int tiles, long long n_rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int plane = kTile * kLd;
  const Block blk(L, H, tiles);
  const int k0 = blk.tile * kTile;
  // f32 rows, split by each warp as it reads them: split copies would take
  // 174 KB and halve the blocks a multiprocessor holds, which measured slower
  float* qs = smem;
  float* gs = qs + plane;
  float* ks = gs + plane;
  float* vs = ks + plane;
  float* ps = vs + plane;   // p as [query][key]
  float* dss = ps + plane;  // ds as [query][key]
  const F32Rows Q{qs}, G{gs}, K{ks}, V{vs};
  const int nk = min(kTile, L - k0);  // the tile's keys
  const long long key0 = static_cast<long long>(k0) * blk.W;
  load_rows(k + blk.base + key0, blk.W, nk, kTile, ks);
  load_rows(v + blk.base + key0, blk.W, nk, kTile, vs);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, c2 = (lane & 3) * 2;
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
      float p[8][4], ds[8][4];
      row_dots<8>(Q.at(16 * warp), K, nkw, lane, p);
      row_dots<8>(G.at(16 * warp), V, nkw, lane, ds);  // dp
      float m[2], inv_l[2], r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + gr + 8 * h;
        m[h] = i < L ? st[i] : 0.f;
        inv_l[h] = 1.f / (i < L ? st[n_rows + i] : 1.f);
        r[h] = i < L ? st[2 * n_rows + i] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + (e >> 1) * 8;
          const int j = k0 + 8 * t + c2 + (e & 1);
          const bool keep = i < L && j < L && (!CAUSAL || j <= i);
          p[t][e] = keep ? prob(scaled_logit(p[t][e]), m[e >> 1], inv_l[e >> 1]) : 0.f;
          ds[t][e] = keep ? ds_of(p[t][e], ds[t][e], r[e >> 1]) : 0.f;
        }
      }
      store_tiles<8>(p, 8, ps + 16 * warp * kLd, kLd, lane);
      store_tiles<8>(ds, 8, dss + 16 * warp * kLd, kLd, lane);
    }
    __syncthreads();

    // this warp's keys k0 + 16 warp .. + 15 over the chunk's rows (on the
    // diagonal only rows at or past them)
    for (int s = diag ? 16 * warp : 0; s < rows; s += 8) {
      mma_rows(dva, load_at(ps + s * kLd + 16 * warp, kLd, lane), G.at(s), lane);
      mma_rows(dka, load_at(dss + s * kLd + 16 * warp, kLd, lane), Q.at(s), lane);
    }
    __syncthreads();  // before the next chunk overwrites q, g, p and ds
  }
  store_rows(dk + blk.base, blk.W, k0 + 16 * warp, L, lane, dka);
  store_rows(dv + blk.base, blk.W, k0 + 16 * warp, L, lane, dva);
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

// bytes of f32 rows, and of split rows (two planes)
constexpr size_t rows_bytes(int rows) { return static_cast<size_t>(rows) * kLd * sizeof(float); }
constexpr size_t split_bytes(int rows) { return 2 * rows_bytes(rows); }

// 4-warp blocks (64 query rows) up to L = 128 (two or more blocks a
// multiprocessor), 8-warp blocks up to 272 (one block a multiprocessor: the
// split keys take 144 KB at L = 257), 4 beyond
template <int NT, bool C, int WARPS>
int launch_fwd(const float* q, const float* k, const float* v, float* out, int B, int L, int H,
               cudaStream_t s) {
  auto kernel = attn_fwd<NT, C, WARPS>;
  const size_t smem = rows_bytes(16 * WARPS) + split_bytes(round8(L));
  int tiles;
  unsigned blocks;
  if (const int e = prepare(kernel, B, L, H, smem, 16 * WARPS, &tiles, &blocks)) return e;
  kernel<<<blocks, WARPS * 32, smem, s>>>(q, k, v, out, L, H, tiles);
  return static_cast<int>(cudaGetLastError());
}

// SPLIT: q, g, k and v split in shared memory (up to kHeadMaxLen); else f32
// rows (up to L = 64, where p and ds fit in place of the f32 keys and values)
template <int NT, bool C>
int launch_fwd_small(const float* q, const float* k, const float* v, float* out, int B, int L,
                     int H, cudaStream_t s) {
  auto kernel = attn_fwd_small<NT, C>;
  const size_t smem = rows_bytes(16 + 2 * round8(L)) +
                      static_cast<size_t>(16) * (8 * NT + 4) * sizeof(float);
  int tiles;
  unsigned blocks;
  if (const int e = prepare(kernel, B, L, H, smem, 16, &tiles, &blocks)) return e;
  kernel<<<blocks, kSmallWarps * 32, smem, s>>>(q, k, v, out, L, H, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool C, bool SPLIT>
int launch_bwd_head(const float* q, const float* k, const float* v, const float* g, float* dq,
                    float* dk, float* dv, int B, int L, int H, cudaStream_t s) {
  static_assert(SPLIT || NT <= 8, "f32 rows hold p and ds only up to L = 64");
  auto kernel = attn_bwd_head<NT, C, SPLIT>;
  const int Lp = round16(L);
  const size_t smem = SPLIT ? split_bytes(4 * Lp) : rows_bytes(4 * Lp);
  int tiles;
  unsigned blocks;
  if (const int e = prepare(kernel, B, L, H, smem, Lp, &tiles, &blocks)) return e;
  kernel<<<blocks, 2 * Lp, smem, s>>>(q, k, v, g, dq, dk, dv, L, H);  // Lp / 16 warps
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool C, int WARPS>
int launch_bwd(const float* q, const float* k, const float* v, const float* g, float* dq,
               float* dk, float* dv, float* stats, int B, int L, int H, cudaStream_t s) {
  const long long n_rows = static_cast<long long>(B) * H * L;
  auto rows = attn_bwd_rows<NT, C, WARPS>;
  auto cols = attn_bwd_cols<C>;
  const size_t smem_rows = rows_bytes(2 * 16 * WARPS) + split_bytes(round8(L));
  const size_t smem_cols = rows_bytes(6 * kTile);
  int row_tiles, col_tiles;
  unsigned row_blocks, col_blocks;
  if (const int e = prepare(rows, B, L, H, smem_rows, 16 * WARPS, &row_tiles, &row_blocks)) {
    return e;
  }
  if (const int e = prepare(cols, B, L, H, smem_cols, kTile, &col_tiles, &col_blocks)) return e;
  rows<<<row_blocks, WARPS * 32, smem_rows, s>>>(q, k, v, g, dq, stats, L, H, row_tiles, n_rows);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  cols<<<col_blocks, kTile / 16 * 32, smem_cols, s>>>(q, k, v, g, dk, dv, stats, L, H,
                                                       col_tiles, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// NT, the n-tiles of 8 keys a warp keeps in registers, by length: 64, 128,
// 208 (ViT-B/16's 197), 272 (ViT-L/14's 257), 384
template <bool C>
int fwd_len(const float* q, const float* k, const float* v, float* out, int B, int L, int H,
            cudaStream_t s) {
  // fewer 4-warp blocks than multiprocessors: share each row group's work
  if (L <= kSmallMaxLen && static_cast<long long>(B) * H * ((L + 63) / 64) < 132) {
    return L <= 64 ? launch_fwd_small<8, C>(q, k, v, out, B, L, H, s)
                   : launch_fwd_small<16, C>(q, k, v, out, B, L, H, s);
  }
  if (L <= 64) return launch_fwd<8, C, 4>(q, k, v, out, B, L, H, s);
  if (L <= 128) return launch_fwd<16, C, 4>(q, k, v, out, B, L, H, s);
  if (L <= 208) return launch_fwd<26, C, 8>(q, k, v, out, B, L, H, s);
  if (L <= 272) return launch_fwd<34, C, 8>(q, k, v, out, B, L, H, s);
  return launch_fwd<48, C, 4>(q, k, v, out, B, L, H, s);
}

// one pass up to kHeadMaxLen (q, g, k and v split: 209 KB of shared memory
// at 96); beyond, pass 1 in 8-warp blocks, 2-warp ones beyond 272 (its split
// keys take 209 KB at L = 384)
template <bool C>
int bwd_len(const float* q, const float* k, const float* v, const float* g, float* dq,
            float* dk, float* dv, float* st, int B, int L, int H, cudaStream_t s) {
  if (L <= 64) return launch_bwd_head<8, C, false>(q, k, v, g, dq, dk, dv, B, L, H, s);
  if (L <= kHeadMaxLen) return launch_bwd_head<12, C, true>(q, k, v, g, dq, dk, dv, B, L, H, s);
  if (L <= 128) return launch_bwd<16, C, 8>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  if (L <= 208) return launch_bwd<26, C, 8>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  if (L <= 272) return launch_bwd<34, C, 8>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
  return launch_bwd<48, C, 2>(q, k, v, g, dq, dk, dv, st, B, L, H, s);
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
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? fwd_len<true>(Q, K, V, O, B, L, H, s) : fwd_len<false>(Q, K, V, O, B, L, H, s);
}

// The backward: dq, dk, dv (each like q) for the output gradient g (like
// q), stats a scratch of 3 * B * H * L floats (unused up to L = 96). One
// launch up to L = 96, else two, on `stream`; returns the first CUDA error.
extern "C" int seesaw_pair_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv,
                                         void* stats, int B, int L, int H, int causal,
                                         void* stream) {
  if (bad_shape(B, L, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* G = static_cast<const float*>(g);
  float* DQ = static_cast<float*>(dq);
  float* DK = static_cast<float*>(dk);
  float* DV = static_cast<float*>(dv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? bwd_len<true>(Q, K, V, G, DQ, DK, DV, st, B, L, H, s)
                : bwd_len<false>(Q, K, V, G, DQ, DK, DV, st, B, L, H, s);
}
