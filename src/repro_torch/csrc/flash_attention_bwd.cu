// The backward of GQA flash attention (causal or not, optionally
// sliding-window) on Hopper's tensor cores, float32 and bfloat16: dQ, dK
// and dV of out = softmax(scale * Q K^T + mask) V, query head h reading KV
// head h / (H / KVH), keys at positions 0..S-1, for the output gradient dO.
// Instances for head_dim 64, 128 and 256, causal and not.
//
// Replaces no TPU kernel: the TPU kernel (src/repro/kernels/
// flash_attention.py::_fa_kernel) has no backward, and the JAX package's
// impl="flash" path differentiates src/repro/models/layers.py::_attn_flash
// by autodiff.  This computes the same gradient from what the forward kernels
// save: out and each row's log-sum-exp (lse, natural log, float32), written
// by flash_attention.cu and flash_attention_bf16.cu.
//
// The algorithm is FlashAttention-2's, in three launches and no atomics, so
// that the result does not depend on the order in which blocks run:
//   1. D = rowsum(dO * O) in float32 (one warp a row, a fixed tree);
//   2. dK and dV: one block for each (batch, KV head, tile of 64 keys, block
//      of 64 output columns); it walks the live q tiles of all G query heads
//      of its KV head, so the sum over the heads stays in registers:
//        S^T = K Q^T, P^T = exp2(S^T * scale * log2(e) - lse * log2(e)),
//        dP^T = V dO^T, dS^T = P^T (dP^T - D),
//        dV += P^T dO, dK += scale * dS^T Q;
//   3. dQ: one block for each (batch, query head, tile of 64 queries, block
//      of up to 128 output columns); it walks the live KV tiles:
//        S = Q K^T, P, dP = dO V^T, dS = P (dP - D), dQ += scale * dS K.
// Both walks skip exactly the tiles that the causal triangle, the window or
// the ends of T and S leave without a live pair (the dQ kernel's is the
// forward's plan, kernels/flash_attention.py::kv_tile_range at these tiles;
// the dK/dV kernel's is its transpose, ::q_tile_range), and mask every
// element of the tiles they walk.
//
// What bounds it on the H100: operations.  A live (query, key) pair costs
// five products of 2*hd operations (S again, dP, dV, dK, dQ): 10*hd.  At
// qwen3-0.6b's training shape (q (2, 4096, 16, 128), KVH 8, causal) that is
// 3.44e11 operations, 0.348 ms on the tensor cores in bfloat16 (989e12/s)
// and 2.08 ms in split TF32 (three TF32 MMAs a product, 495e12/s).
//
// Design: a simple kernel that is right, not yet a fast one.
// * mma.sync, float32 accumulators.  bfloat16: m16n8k16, P and dS rounded to
//   bfloat16 for their products (as FlashAttention-2 does), dQ, dK and dV
//   rounded to bfloat16 at the end.  float32: m16n8k8 TF32 in split TF32,
//   as the forward (flash_attention.cu): each operand x = big + small, three
//   MMAs a product, the small*small term dropped; single-pass TF32 keeps 11
//   bits and FFMA runs at 67 TFLOP/s against the split's 165.
// * A block is four warps; each warp owns 16 of the block's 64 rows (keys
//   for dK/dV, queries for dQ) and sums S and dP over the whole head dim
//   itself, so no warp waits for another's partial sums.  The rows' two
//   operands (K and V, or Q and dO) stay in shared memory; the other side's
//   tiles of BC rows are loaded for each step with 16-byte loads, no
//   pipelining.  P and dS stay in registers and are the A operand of the
//   second products as they lie (the C fragment of two 8-column tiles is the
//   bfloat16 A fragment of a k16 step; in TF32 the columns (2t, 2t+1) of an
//   8-column tile are taken as the MMA's k = (t, t + 4), and the B rows are
//   read in that order).  Fragments are read from shared memory one 32-bit
//   word at a time; rows are padded by 16 bytes, which keeps those reads
//   free of bank conflicts.
// * The accumulators of a block are 64 output columns for dK and dV each
//   (128 for dQ): wider head dims take more blocks (grid z), each of which
//   computes S and dP again.  That keeps a thread's registers under 255 at
//   hd 256 at the price of S and dP computed hd/64 times in the dK/dV walk.
// * Tiles (BC, the other side's rows a step): 64, but 32 for float32 at hd
//   128 and 256 and for bfloat16 at hd 256 (shared memory: 200 KB at float32
//   hd 256).
// Not yet: wgmma, TMA, a pipelined ring, one pass over hd in dK/dV.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BR = 16 * WARPS;             // rows a block owns
constexpr float LOG2E = 1.4426950408889634f;

template <typename E, int HD>
struct Tile {
  static constexpr bool WIDE = sizeof(E) == 4 ? HD >= 128 : HD >= 256;
  static constexpr int BC = WIDE ? 32 : 64;           // the other side's rows
  static constexpr int CW_KV = 64;                    // dK, dV columns a block
  static constexpr int CW_Q = HD < 128 ? HD : 128;    // dQ columns a block
  static constexpr int LD = HD + 16 / (int)sizeof(E);  // padded row
  static constexpr int SMEM =
      (2 * BR + 2 * BC) * LD * (int)sizeof(E) + 2 * BC * 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [row0, row0 + NROWS) of a slab with row stride `stride` into a padded
// shared tile; rows at or past `nvalid` read as zeros
template <typename E, int HD, int NROWS, int LD>
__device__ __forceinline__ void load_rows(E* dst, const E* __restrict__ src,
                                          size_t stride, int row0,
                                          int nvalid) {
  constexpr int PER = 16 / (int)sizeof(E);
  constexpr int CH = HD / PER;             // 16-byte chunks a row
#pragma unroll 4
  for (int idx = threadIdx.x; idx < NROWS * CH; idx += THREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * PER;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nvalid)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride +
                                          c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// x = big + small: big rounded to TF32 (to nearest, ties away), small the
// exact remainder, whose low 13 bits the MMA ignores (flash_attention.cu)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a*b in split TF32: the small terms first, then big*big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bfloat16 values as one register, lo in the low half
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// x (16 x 8 NT) = A B^T over HD: A the warp's 16 rows, B 8 NT rows, both in
// shared memory with row stride LD; lane (g, t) gets rows g, g + 8 and
// columns 8n + 2t, 8n + 2t + 1
template <int HD, int LD, int NT>
__device__ __forceinline__ void gemm_nt(float (&x)[NT][4],
                                        const float* __restrict__ a,
                                        const float* __restrict__ b, int g,
                                        int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
  const float* a0 = a + g * LD + t;
  const float* b0 = b + g * LD + t;
#pragma unroll 2
  for (int d0 = 0; d0 < HD; d0 += 8) {
    uint32_t ab[4], as[4];
    split(a0[d0], ab[0], as[0]);
    split(a0[8 * LD + d0], ab[1], as[1]);
    split(a0[d0 + 4], ab[2], as[2]);
    split(a0[8 * LD + d0 + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb0, bs0, bb1, bs1;
      split(b0[8 * n * LD + d0], bb0, bs0);
      split(b0[8 * n * LD + d0 + 4], bb1, bs1);
      mma3(x[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

template <int HD, int LD, int NT>
__device__ __forceinline__ void gemm_nt(float (&x)[NT][4],
                                        const bf16* __restrict__ a,
                                        const bf16* __restrict__ b, int g,
                                        int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
  const bf16* a0 = a + g * LD + 2 * t;
  const bf16* b0 = b + g * LD + 2 * t;
#pragma unroll 2
  for (int d0 = 0; d0 < HD; d0 += 16) {
    const uint32_t af[4] = {ld32(a0 + d0), ld32(a0 + 8 * LD + d0),
                            ld32(a0 + d0 + 8), ld32(a0 + 8 * LD + d0 + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mma_bf16(x[n], af, ld32(b0 + 8 * n * LD + d0),
               ld32(b0 + 8 * n * LD + d0 + 8));
  }
}

// acc (16 x 8 NM) += R (16 x 8 NT, in registers as gemm_nt leaves x) times
// rows 0..8 NT - 1 of B (shared memory, row stride LD, from its column 0).
// In float32 each k-step's three MMAs start from zero and their sum is added
// to acc by FADD: an MMA cuts its sum toward zero, and dK and dV sum up to T
// G terms, where that bias, a k-step at a time into one accumulator, came
// to 8e-5 of max |g| at T = 4096, G = 2; added to nearest it stays under
// 1e-5
template <int LD, int NT, int NM>
__device__ __forceinline__ void gemm_rn(float (&acc)[NM][4],
                                        const float (&r)[NT][4],
                                        const float* __restrict__ b, int g,
                                        int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    // columns 8n + 2t and 8n + 2t + 1 of R as the MMA's k = t and t + 4
    uint32_t ab[4], as[4];
    split(r[n][0], ab[0], as[0]);
    split(r[n][2], ab[1], as[1]);
    split(r[n][1], ab[2], as[2]);
    split(r[n][3], ab[3], as[3]);
    const float* b0 = b + (8 * n + 2 * t) * LD + g;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      uint32_t bb0, bs0, bb1, bs1;
      split(b0[8 * m], bb0, bs0);
      split(b0[LD + 8 * m], bb1, bs1);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(c, ab, as, bb0, bb1, bs0, bs1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] += c[e];
    }
  }
}

template <int LD, int NT, int NM>
__device__ __forceinline__ void gemm_rn(float (&acc)[NM][4],
                                        const float (&r)[NT][4],
                                        const bf16* __restrict__ b, int g,
                                        int t) {
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    const uint32_t af[4] = {pack(r[2 * s][0], r[2 * s][1]),
                            pack(r[2 * s][2], r[2 * s][3]),
                            pack(r[2 * s + 1][0], r[2 * s + 1][1]),
                            pack(r[2 * s + 1][2], r[2 * s + 1][3])};
    const bf16* b0 = b + (16 * s + 2 * t) * LD + g;
#pragma unroll
    for (int m = 0; m < NM; ++m)
      mma_bf16(acc[m], af, pack(b0[8 * m], b0[LD + 8 * m]),
               pack(b0[8 * LD + 8 * m], b0[9 * LD + 8 * m]));
  }
}

// D = rowsum(dO * O) in float32, one warp a (b, t, h) row, written (B, H, T)
template <typename E, int HD>
__global__ void __launch_bounds__(256)
delta_kernel(const E* __restrict__ out, const E* __restrict__ dout,
             float* __restrict__ delta, int rows, int T, int H) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const E* o = out + (size_t)r * HD;
  const E* d = dout + (size_t)r * HD;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) s += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = r % H;
    const int bt = r / H;
    delta[((size_t)(bt / T) * H + h) * T + bt % T] = s;
  }
}

// DKV: the dK/dV walk (rows: keys; the other side: q tiles); else the dQ
// walk (rows: queries; the other side: KV tiles)
template <typename E, int HD, bool DKV, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
           const E* __restrict__ v, const E* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           E* __restrict__ dq, E* __restrict__ dk, E* __restrict__ dv, int T,
           int S, int H, int KVH, int window, float scale) {
  using L = Tile<E, HD>;
  constexpr int BC = L::BC;
  constexpr int LD = L::LD;
  constexpr int NT = BC / 8;
  constexpr int NM = (DKV ? L::CW_KV : L::CW_Q) / 8;
  extern __shared__ uint4 smem4[];
  E* ra = reinterpret_cast<E*>(smem4);     // own rows: K (dK/dV) or Q (dQ)
  E* rb = ra + BR * LD;                    // V or dO
  E* ca = rb + BR * LD;                    // the other side's tile: Q or K
  E* cb = ca + BC * LD;                    // dO or V
  float* c_lse = reinterpret_cast<float*>(cb + BC * LD);  // q tile's lse2
  float* c_del = c_lse + BC;                              // and D

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int G = H / KVH;
  const int c0 = blockIdx.z * NM * 8;      // this block's output columns
  const float scale_log2 = scale * LOG2E;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const E* wa = ra + warp * 16 * LD;       // this warp's rows
  const E* wb = rb + warp * 16 * LD;
  float acc0[NM][4], acc1[NM][4];          // dV and dK, or dQ
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[m][e] = acc1[m][e] = 0.f;
  float x[NT][4], y[NT][4];

  if (DKV) {
    const int k0 = blockIdx.x * BR;
    const int b = blockIdx.y / KVH;
    const int kvh = blockIdx.y % KVH;
    const size_t kv_off = ((size_t)b * S * KVH + kvh) * HD;
    load_rows<E, HD, BR, LD>(ra, k + kv_off, kv_stride, k0, S);
    load_rows<E, HD, BR, LD>(rb, v + kv_off, kv_stride, k0, S);
    // the q tiles with a live query for some key of the tile
    // (kernels/flash_attention.py::q_tile_range)
    const int nq = (T + BC - 1) / BC;
    const int k_last = min(k0 + BR, S) - 1;
    int j_lo = 0;
    int j_hi = nq - 1;
    if (CAUSAL) j_lo = k0 <= T - 1 ? k0 / BC : nq;
    if (window > 0) j_hi = min(j_hi, (k_last + window - 1) / BC);
    const int key0 = k0 + warp * 16 + g;   // this lane's keys: key0, key0 + 8
    for (int hg = 0; hg < G; ++hg) {
      const int h = kvh * G + hg;
      const size_t q_off = ((size_t)b * T * H + h) * HD;
      const float* lse_h = lse + ((size_t)b * H + h) * T;
      const float* del_h = delta + ((size_t)b * H + h) * T;
      for (int j = j_lo; j <= j_hi; ++j) {
        const int q0 = j * BC;
        __syncthreads();                   // the last step's readers are done
        load_rows<E, HD, BC, LD>(ca, q + q_off, q_stride, q0, T);
        load_rows<E, HD, BC, LD>(cb, dout + q_off, q_stride, q0, T);
        for (int i = threadIdx.x; i < BC; i += THREADS) {
          const bool ok = q0 + i < T;
          c_lse[i] = ok ? lse_h[q0 + i] * LOG2E : 0.f;
          c_del[i] = ok ? del_h[q0 + i] : 0.f;
        }
        __syncthreads();
        gemm_nt<HD, LD, NT>(x, wa, ca, g, t);     // S^T = K Q^T
        gemm_nt<HD, LD, NT>(y, wb, cb, g, t);     // dP^T = V dO^T
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * (e >> 1);
            const int jj = 8 * n + 2 * t + (e & 1);
            const int pq = q0 + jj;
            const bool live = pq < T && key < S && (!CAUSAL || pq >= key) &&
                              (window <= 0 || pq - key < window);
            const float p =
                live ? exp2f(x[n][e] * scale_log2 - c_lse[jj]) : 0.f;
            x[n][e] = p;                                  // P^T
            y[n][e] = p * (y[n][e] - c_del[jj]);          // dS^T
          }
        gemm_rn<LD, NT, NM>(acc0, x, cb + c0, g, t);  // dV += P^T dO
        gemm_rn<LD, NT, NM>(acc1, y, ca + c0, g, t);  // dK += dS^T Q
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= S) continue;
      const size_t row = kv_off + (size_t)key * kv_stride + c0 + 2 * t;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        store2(dv + row + 8 * m, acc0[m][2 * r], acc0[m][2 * r + 1]);
        store2(dk + row + 8 * m, acc1[m][2 * r] * scale,
               acc1[m][2 * r + 1] * scale);
      }
    }
  } else {
    // causal q tiles longest first
    const int nqt = (T + BR - 1) / BR;
    const int q0 = (CAUSAL ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x) * BR;
    const int b = blockIdx.y / H;
    const int h = blockIdx.y % H;
    const int kvh = h / G;
    const size_t q_off = ((size_t)b * T * H + h) * HD;
    const size_t kv_off = ((size_t)b * S * KVH + kvh) * HD;
    load_rows<E, HD, BR, LD>(ra, q + q_off, q_stride, q0, T);
    load_rows<E, HD, BR, LD>(rb, dout + q_off, q_stride, q0, T);
    const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8
    float lse2[2], del[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const size_t i = ((size_t)b * H + h) * T + row;
      lse2[r] = row < T ? lse[i] * LOG2E : 0.f;
      del[r] = row < T ? delta[i] : 0.f;
    }
    // the KV tiles with a live key for some row (kv_tile_range)
    const int q_last = min(q0 + BR, T) - 1;
    int j_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / BC;
    int j_hi = (S + BC - 1) / BC - 1;
    if (CAUSAL) j_hi = min(j_hi, q_last / BC);
    for (int j = j_lo; j <= j_hi; ++j) {
      const int kk0 = j * BC;
      __syncthreads();
      load_rows<E, HD, BC, LD>(ca, k + kv_off, kv_stride, kk0, S);
      load_rows<E, HD, BC, LD>(cb, v + kv_off, kv_stride, kk0, S);
      __syncthreads();
      gemm_nt<HD, LD, NT>(x, wa, ca, g, t);       // S = Q K^T
      gemm_nt<HD, LD, NT>(y, wb, cb, g, t);       // dP = dO V^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 8 * (e >> 1);
          const int key = kk0 + 8 * n + 2 * t + (e & 1);
          const bool live = row < T && key < S && (!CAUSAL || row >= key) &&
                            (window <= 0 || row - key < window);
          const float p =
              live ? exp2f(x[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
          y[n][e] = p * (y[n][e] - del[e >> 1]);        // dS
        }
      gemm_rn<LD, NT, NM>(acc0, y, ca + c0, g, t);    // dQ += dS K
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= T) continue;
      E* out = dq + q_off + (size_t)row * q_stride + c0 + 2 * t;
#pragma unroll
      for (int m = 0; m < NM; ++m)
        store2(out + 8 * m, acc0[m][2 * r] * scale, acc0[m][2 * r + 1] * scale);
    }
  }
}

template <typename E, int HD, bool DKV, bool CAUSAL>
int launch_walk(dim3 grid, const E* q, const E* k, const E* v, const E* dout,
                const float* lse, const float* delta, E* dq, E* dk, E* dv,
                int T, int S, int H, int KVH, int window, float scale,
                cudaStream_t stream) {
  constexpr int smem = Tile<E, HD>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<E, HD, DKV, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<E, HD, DKV, CAUSAL><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, T, S, H, KVH, window, scale);
  return (int)cudaGetLastError();
}

template <typename E, int HD, bool CAUSAL>
int launch(const E* q, const E* k, const E* v, const E* out, const E* dout,
           const float* lse, float* delta, E* dq, E* dk, E* dv, int B, int T,
           int S, int H, int KVH, int window, float scale,
           cudaStream_t stream) {
  using L = Tile<E, HD>;
  const int rows = B * T * H;
  delta_kernel<E, HD><<<(rows + 7) / 8, 256, 0, stream>>>(out, dout, delta,
                                                          rows, T, H);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_walk<E, HD, true, CAUSAL>(
      dim3((S + BR - 1) / BR, B * KVH, HD / L::CW_KV), q, k, v, dout, lse,
      delta, dq, dk, dv, T, S, H, KVH, window, scale, stream);
  if (err != 0) return err;
  return launch_walk<E, HD, false, CAUSAL>(
      dim3((T + BR - 1) / BR, B * H, HD / L::CW_Q), q, k, v, dout, lse, delta,
      dq, dk, dv, T, S, H, KVH, window, scale, stream);
}

template <typename E>
int launch_any(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int B, int T, int S, int H, int KVH, int hd,
               int causal, int window, float scale, void* stream) {
#define ARGS                                                                 \
  (const E*)q, (const E*)k, (const E*)v, (const E*)out, (const E*)dout,      \
      (const float*)lse, (float*)delta, (E*)dq, (E*)dk, (E*)dv, B, T, S, H, \
      KVH, window, scale, (cudaStream_t)stream
#define CASE(HD)                                                 \
  case HD:                                                       \
    return causal ? launch<E, HD, true>(ARGS) : launch<E, HD, false>(ARGS);
  switch (hd) {
    CASE(64)
    CASE(128)
    CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CASE
#undef ARGS
}

}  // namespace

// q, dq (B, T, H, hd), k, v, dk, dv (B, S, KVH, hd), out and dout like q, all
// float32 (or all bfloat16: the _bf16 entry), contiguous and 16-byte
// aligned; lse (B, H, T) float32 from the forward; delta (B, H, T) float32
// scratch.  causal != 0 masks keys after the query; window <= 0 means no
// window; scale 1/sqrt(head_dim) of the unpadded head dim.  head_dim must be
// 64, 128 or 256 (the wrapper zero-pads smaller ones); returns
// cudaErrorInvalidValue for another.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int T, int S, int H, int KVH, int hd, int causal,
    int window, float scale, void* stream) {
  return launch_any<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, T,
                           S, H, KVH, hd, causal, window, scale, stream);
}

extern "C" int flash_attention_backward_launch_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int T, int S, int H, int KVH, int hd, int causal,
    int window, float scale, void* stream) {
  return launch_any<bf16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, T,
                          S, H, KVH, hd, causal, window, scale, stream);
}
