// The backward of GQA flash attention in float32 (causal or not, optionally
// sliding-window) on Hopper's tensor cores: dQ, dK and dV of out =
// softmax(scale * Q K^T + mask) V, query head h reading KV head
// h / (H / KVH), keys at positions 0..S-1, for the output gradient dO.
// Instances for head_dim 64, 128 and 256, causal and not.  The bfloat16
// instance lives in flash_attention_bwd_bf16.cu.
//
// Replaces no TPU kernel: the TPU kernel (src/repro/kernels/
// flash_attention.py::_fa_kernel) has no backward, and the JAX package's
// impl="flash" path differentiates src/repro/models/layers.py::_attn_flash
// by autodiff.  This computes the same gradient from what the forward kernel
// (flash_attention.cu) saves: out and each row's log-sum-exp (lse, natural
// log, float32).
//
// The algorithm is FlashAttention-2's, in three launches and no atomics, so
// that the result does not depend on the order in which blocks run:
//   1. D = rowsum(dO * O) in float32 (16-byte loads, a fixed tree);
//   2. dK and dV: one block for each (batch, KV head, tile of 64 keys); it
//      walks the live q tiles of all G query heads of its KV head, so the
//      sum over the heads stays in registers:
//        S^T = K Q^T, P^T = exp2(S^T * scale * log2(e) - lse * log2(e)),
//        dP^T = V dO^T, dS^T = P^T (dP^T - D),
//        dV += P^T dO, dK += scale * dS^T Q;
//   3. dQ: one block for each (batch, query head, tile of 64 queries); it
//      walks the live KV tiles:
//        S = Q K^T, P, dP = dO V^T, dS = P (dP - D), dQ += scale * dS K.
// Both walks skip exactly the tiles that the causal triangle, the window or
// the ends of T and S leave without a live pair (the dQ walk's plan is
// kernels/flash_attention.py::kv_tile_range at these tiles, the dK/dV
// walk's its transpose, ::q_tile_range); a warp pair skips a tile without a
// live pair in its 16 rows, and only the tiles that the diagonal, the
// window's edge or the ends of T and S cut are masked.  Causal walks launch
// longest first; non-causal ones take their tiles in chunks of heads
// (flash_bwd.cuh's block_order), so that a chunk's other side stays in L2.
//
// What bounds it on the H100: operations.  A live (query, key) pair needs
// five products of 2*hd operations (S again, dP, dV, dK, dQ): 10*hd, 2.08
// ms at qwen3-0.6b's training shape (q (2, 4096, 16, 128), KVH 8, causal)
// in split TF32 (three TF32 MMAs a product, 495e12/s).  The dQ walk forms S
// and dP again, so the two walks do 14*hd: the ceiling is 0.71 of the bound.
//
// Design.  mma.sync.m16n8k8 in split TF32, as the forward: each operand x =
// big + small, big rounded to TF32 (to nearest, ties away), small the exact
// remainder, of which the MMA reads the top 11 bits; three MMAs a product,
// the small*small term dropped (single-pass TF32 keeps 11 bits; FFMA runs
// at 67 TFLOP/s against the split's 165).  wgmma's TF32 takes only K-major
// operands from shared memory, and dV += P^T dO and dK += dS^T Q reduce
// over the rows of dO and Q, which lie MN-major.
// * A block owns 64 rows (keys for dK/dV, queries for dQ) in row groups of
//   16, and S and dP are formed once per (key tile, q tile) pair at every
//   head dim; no grid axis runs over output columns:
//     hd 128 and 256: 8 warps, warps w and w + 4 (a pair) own the same 16
//       rows and split the products.  dK/dV: warp w forms S^T and P^T, hands
//       P^T to warp w + 4 through shared memory and accumulates dV; warp
//       w + 4 forms dP^T and dS^T and accumulates dK (hd/2 registers a
//       thread each: 128 at hd 256).  dQ: warp w forms S and P, warp w + 4
//       dP and dS; P goes one way, dS back, and each accumulates half of
//       dQ's columns.
//     hd 64 (SOLO): 4 warps, each forms every product of its 16 rows (dV
//       and dK, or dQ, hd/2 registers a thread each), and two blocks share
//       an SM; at hd 64 the pairs' hand-overs cost more than they save.
// * The block's own rows (K and V, or Q and dO) stay in shared memory; the
//   other side's tiles of BC rows stream through a two-stage cp.async ring,
//   tile j + 1 in flight while tile j is computed.  At hd 64 and 128 each
//   tile is split once when it lands: the ring holds its TF32 big and small
//   planes, so the inner loops load and multiply.  At hd 256 the planes do
//   not fit beside K and V (their 133 KB and a ring of 2 x 2 x 16 rows x 1
//   KB a plane), and the B operands are split as they are read.  The own
//   rows (the A operands of S and dP) are split as they are read, four
//   values a k-step for BC/8 MMA triples.  P^T and dS^T (and P, dS) are
//   split once a tile in registers.
// * Tiles (Tile<HD>): BC 32 at hd 64 and 128, 16 at hd 256; shared memory
//   103/102 KB (dK/dV, dQ) at hd 64, 207/214 KB at hd 128, 199/203 KB at hd
//   256.
// * Operands are read from shared memory one 32-bit word at a time; rows
//   are padded to hd + 4 floats, which keeps those reads free of bank
//   conflicts.  P and dS stay the A operand of the second products as they
//   lie: in TF32 the columns (2t, 2t+1) of an 8-column tile are taken as the
//   MMA's k = (t, t + 4), and the B rows are read in that order.
// * The second products add each k-step's three MMAs, started from zero, to
//   the accumulator by FADD (gemm_rn): an MMA cuts its sum toward zero, and
//   dK and dV sum up to T G terms, where that bias, a k-step at a time into
//   one accumulator, came to 8e-5 of max |g| at T = 4096, G = 2; added to
//   nearest it stays under 1e-5.
// Measured on NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's [kernel]
// flash_attention backward lines): 0.19 of the bound at qwen3-0.6b's
// training shape (11.1 ms), 0.15 at recurrentgemma-2b's hd-256 window,
// 0.19-0.20 at seamless-m4t-medium's hd-64 shapes; the walks reach 0.27 (dK/dV)
// and 0.26 (dQ) of their own bounds at qwen3-0.6b.  The dK/dV kernels spill
// a few loop-invariant values (4-80 bytes, [ptxas] lines) at hd 64 and 256.
#include <stdint.h>

#include "flash_bwd.cuh"

namespace {

constexpr int BR = 64;                     // rows a block owns
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tile {
  // SOLO (hd 64): each warp forms every product of its 16 rows, four warps
  // a block, two blocks an SM; else warp pairs split the products, 8 warps
  static constexpr bool SOLO = HD == 64;
  static constexpr int THREADS = SOLO ? 128 : 256;
  static constexpr int MIN_BLOCKS = SOLO ? 2 : 1;
  static constexpr bool PRE = HD <= 128;   // the ring holds TF32 planes
  static constexpr int BC = HD == 256 ? 16 : 32;
  static constexpr int LD = HD + 4;        // padded row, in floats
  static constexpr int PLANES = PRE ? 2 : 1;
  static constexpr int TILE = BC * LD;     // one plane of one tensor
  static constexpr int STAGE = 2 * PLANES * TILE;
  static constexpr int OWN = BR * LD;
  static constexpr int XCH = SOLO ? 0 : BR * BC;  // P (and dS) handed over
  template <bool DKV>
  static constexpr int smem() {
    return 4 * (2 * OWN + STAGES * STAGE + (DKV ? XCH + STAGES * 2 * BC
                                                : 2 * XCH));
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;            // 0 source bytes: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the two warps of row group rg: named barrier `id` over 64 threads
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// rows [row0, row0 + NROWS) of a slab with row stride `stride` into a
// padded shared tile, asynchronously; rows at or past `nvalid` read as zeros
template <int HD, int NROWS, int LD, int NTHR>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          size_t stride, int row0,
                                          int nvalid) {
  constexpr int CH = HD / 4;               // 16-byte chunks a row
#pragma unroll 1
  for (int idx = threadIdx.x; idx < NROWS * CH; idx += NTHR) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    const bool ok = row0 + r < nvalid;
    cp_async16(dst + r * LD + c,
               ok ? src + (size_t)(row0 + r) * stride + c : src, ok);
  }
}

// x = big + small: big rounded to TF32 (to nearest, ties away), small the
// exact remainder, whose low 13 bits the MMA ignores (flash_attention.cu)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// a landed tile of NROWS rows (at `big`) split in place into its big
// plane, its small plane TILE floats further
template <int HD, int NROWS, int LD, int TILE, int NTHR>
__device__ __forceinline__ void split_tile(float* big) {
  constexpr int CH = HD / 4;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < NROWS * CH; idx += NTHR) {
    float4* p = reinterpret_cast<float4*>(big + (idx / CH) * LD +
                                          (idx % CH) * 4);
    const float4 x = *p;
    uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
    split(x.x, b0, s0);
    split(x.y, b1, s1);
    split(x.z, b2, s2);
    split(x.w, b3, s3);
    *p = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                     __uint_as_float(b2), __uint_as_float(b3));
    p[TILE / 4] = make_float4(__uint_as_float(s0), __uint_as_float(s1),
                              __uint_as_float(s2), __uint_as_float(s3));
  }
}

// a B operand value: read from its planes (PRE, the small plane TILE
// floats after the big one), or read and split
template <bool PRE, int TILE>
__device__ __forceinline__ void get_b(const float* b, int off, uint32_t& big,
                                      uint32_t& small) {
  if (PRE) {
    big = __float_as_uint(b[off]);
    small = __float_as_uint(b[off + TILE]);
  } else {
    split(b[off], big, small);
  }
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

// x (16 x 8 NT) = A B^T over HD: A the warp's 16 rows (split as read), B
// 8 NT rows, both in shared memory with row stride LD; lane (g, t) gets
// rows g, g + 8 and columns 8n + 2t, 8n + 2t + 1
template <int HD, int LD, int NT, bool PRE, int TILE>
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
      get_b<PRE, TILE>(b0, 8 * n * LD + d0, bb0, bs0);
      get_b<PRE, TILE>(b0, 8 * n * LD + d0 + 4, bb1, bs1);
      mma3(x[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// acc (16 x 8 NM) += R (16 x 8 NT, in registers as gemm_nt leaves x) times
// rows 0..8 NT - 1 of B (shared memory, row stride LD, from its column 0).
// Each k-step's three MMAs start from zero and their sum is added to acc by
// FADD, to nearest (the header's note)
template <int LD, int NT, int NM, bool PRE, int TILE>
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
      get_b<PRE, TILE>(b0, 8 * m, bb0, bs0);
      get_b<PRE, TILE>(b0, LD + 8 * m, bb1, bs1);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(c, ab, as, bb0, bb1, bs0, bs1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] += c[e];
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

#define WALK_PARAMS                                                      \
  const float *__restrict__ q, const float *__restrict__ k,              \
      const float *__restrict__ v, const float *__restrict__ dout,       \
      const float *__restrict__ lse, const float *__restrict__ delta,    \
      float *__restrict__ dq, float *__restrict__ dk,                    \
      float *__restrict__ dv, int B, int T, int S, int H, int KVH,       \
      int window, float scale, int grp
#define WALK_ARGS \
  q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, KVH, window, scale, grp

// DKV: the dK/dV walk (rows: keys; the other side: q tiles); else the dQ
// walk (rows: queries; the other side: KV tiles)
template <int HD, bool DKV, bool CAUSAL>
__device__ __forceinline__ void walk(WALK_PARAMS) {
  using L = Tile<HD>;
  constexpr int BC = L::BC;
  constexpr int LD = L::LD;
  constexpr int NT = BC / 8;
  constexpr bool SOLO = L::SOLO;
  constexpr int NTHR = L::THREADS;
  constexpr int NM = (DKV || SOLO ? HD : HD / 2) / 8;
  constexpr bool PRE = L::PRE;
  constexpr int TILE = L::TILE;
  extern __shared__ float4 smem4[];
  float* ra = reinterpret_cast<float*>(smem4);  // own rows: K or Q
  float* rb = ra + L::OWN;                      // V or dO
  float* ring = rb + L::OWN;                    // the other side's tiles
  float* xch = ring + STAGES * L::STAGE;        // P^T, or P and dS
  float* c_ld = xch + L::XCH;                   // dK/dV: lse and D a stage

  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3;                 // row group: rows 16 rg..16 rg + 15
  const int second = SOLO ? 0 : warp >> 2;  // the pair's second warp
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int xi = (threadIdx.x & 127);      // this lane's slot in xch
  const int G = H / KVH;
  const float scale_log2 = scale * LOG2E;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const float* wa = (second ? rb : ra) + rg * 16 * LD;  // this warp's rows
  float acc[NM][4];                        // dV, dK or (half of) dQ
  float acc2[NM][4];                       // SOLO: dK beside dV
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = acc2[m][e] = 0.f;
  float x[NT][4], y[NT][4];                // y: SOLO's dP and dS

  if (DKV) {
    // key tiles longest first (under causal key tile 0 sees every query)
    int unit, kt;
    block_order(blockIdx.x, B * KVH, (S + BR - 1) / BR, grp, unit, kt);
    const int b = unit / KVH;
    const int kvh = unit % KVH;
    const int k0 = kt * BR;
    const int kr = k0 + rg * 16;           // this pair's first key
    const size_t kv_off = ((size_t)b * S * KVH + kvh) * HD;
    // the q tiles with a live query for some key of the tile
    // (kernels/flash_attention.py::q_tile_range)
    const int nq = (T + BC - 1) / BC;
    const int k_last = min(k0 + BR, S) - 1;
    int j_lo = 0;
    int j_hi = nq - 1;
    if (CAUSAL) j_lo = k0 <= T - 1 ? k0 / BC : nq;
    if (window > 0) j_hi = min(j_hi, (k_last + window - 1) / BC);
    const int nj = j_hi - j_lo + 1;
    const int steps = nj > 0 ? G * nj : 0;
    auto issue = [&](int s) {
      const int h = kvh * G + s / nj;
      const int q0 = (j_lo + s % nj) * BC;
      const size_t q_off = ((size_t)b * T * H + h) * HD;
      float* sp = ring + (s % STAGES) * L::STAGE;
      load_rows<HD, BC, LD, NTHR>(sp, q + q_off, q_stride, q0, T);
      load_rows<HD, BC, LD, NTHR>(sp + L::PLANES * TILE, dout + q_off,
                                  q_stride, q0, T);
      if (threadIdx.x < 2 * BC) {
        const int i = threadIdx.x % BC;
        const bool ok = q0 + i < T;
        const float* src = (threadIdx.x < BC ? lse : delta) +
                           ((size_t)b * H + h) * T + (ok ? q0 + i : 0);
        cp_async4(c_ld + (s % STAGES) * 2 * BC + threadIdx.x, src, ok);
      }
      cp_async_commit();
    };
    if (steps > 0) {
      load_rows<HD, BR, LD, NTHR>(ra, k + kv_off, kv_stride, k0, S);
      load_rows<HD, BR, LD, NTHR>(rb, v + kv_off, kv_stride, k0, S);
      issue(0);
    }
    const int key0 = kr + g;               // this lane's keys: key0, key0 + 8
    for (int s = 0; s < steps; ++s) {
      cp_async_wait_all();
      __syncthreads();                     // tile s is in; step s-1 is done
      if (s + 1 < steps) issue(s + 1);
      float* sp = ring + (s % STAGES) * L::STAGE;
      const float* cq = sp;
      const float* cdo = sp + L::PLANES * TILE;
      const float* cl = c_ld + (s % STAGES) * 2 * BC;
      if (PRE) {
        split_tile<HD, BC, LD, TILE, NTHR>(sp);
        split_tile<HD, BC, LD, TILE, NTHR>(sp + 2 * TILE);
        __syncthreads();
      }
      const int q0 = (j_lo + s % nj) * BC;
      if (!any_live<CAUSAL>(q0, q0 + BC, kr, kr + 16, T, S, window)) continue;
      const bool whole = all_live<CAUSAL>(q0, q0 + BC, kr, kr + 16, T, S,
                                          window);
      if constexpr (SOLO) {
        gemm_nt<HD, LD, NT, PRE, TILE>(x, ra + rg * 16 * LD, cq, g, t);
        gemm_nt<HD, LD, NT, PRE, TILE>(y, rb + rg * 16 * LD, cdo, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * n + 2 * t + (e & 1);
            const float p = exp2f(x[n][e] * scale_log2 - cl[c] * LOG2E);
            x[n][e] = whole || live<CAUSAL>(q0 + c, key0 + 8 * (e >> 1), T, S,
                                            window)
                          ? p : 0.f;
            y[n][e] = x[n][e] * (y[n][e] - cl[BC + c]);
          }
        gemm_rn<LD, NT, NM, PRE, TILE>(acc, x, cdo, g, t);   // dV += P^T dO
        gemm_rn<LD, NT, NM, PRE, TILE>(acc2, y, cq, g, t);   // dK += dS^T Q
      } else if (!second) {
        gemm_nt<HD, LD, NT, PRE, TILE>(x, wa, cq, g, t);     // S^T = K Q^T
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * n + 2 * t + (e & 1);
            const float p = exp2f(x[n][e] * scale_log2 - cl[c] * LOG2E);
            x[n][e] = whole || live<CAUSAL>(q0 + c, key0 + 8 * (e >> 1), T, S,
                                            window)
                          ? p : 0.f;
            xch[(4 * n + e) * 128 + xi] = x[n][e];            // P^T
          }
        pair_arrive(1 + rg);
        gemm_rn<LD, NT, NM, PRE, TILE>(acc, x, cdo, g, t);   // dV += P^T dO
      } else {
        gemm_nt<HD, LD, NT, PRE, TILE>(x, wa, cdo, g, t);    // dP^T = V dO^T
        pair_sync(1 + rg);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)                          // dS^T
            x[n][e] = xch[(4 * n + e) * 128 + xi] *
                      (x[n][e] - cl[BC + 8 * n + 2 * t + (e & 1)]);
        gemm_rn<LD, NT, NM, PRE, TILE>(acc, x, cq, g, t);    // dK += dS^T Q
      }
    }
    float* dst = second ? dk : dv;
    const float mul = second ? scale : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= S) continue;
      const size_t row = kv_off + (size_t)key * kv_stride + 2 * t;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        store2(dst + row + 8 * m, acc[m][2 * r] * mul,
               acc[m][2 * r + 1] * mul);
        if constexpr (SOLO)
          store2(dk + row + 8 * m, acc2[m][2 * r] * scale,
                 acc2[m][2 * r + 1] * scale);
      }
    }
  } else {
    // causal q tiles longest first
    const int nqt = (T + BR - 1) / BR;
    int unit, order;
    block_order(blockIdx.x, B * H, nqt, grp, unit, order);
    const int b = unit / H;
    const int h = unit % H;
    const int kvh = h / G;
    const int q0 = (CAUSAL ? nqt - 1 - order : order) * BR;
    const int qr = q0 + rg * 16;           // this pair's first row
    const size_t q_off = ((size_t)b * T * H + h) * HD;
    const size_t kv_off = ((size_t)b * S * KVH + kvh) * HD;
    const int row0 = qr + g;               // this lane's rows: row0, row0 + 8
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
    const int n = j_hi - j_lo + 1;
    auto issue = [&](int it) {
      float* sp = ring + (it % STAGES) * L::STAGE;
      const int kk0 = (j_lo + it) * BC;
      load_rows<HD, BC, LD, NTHR>(sp, k + kv_off, kv_stride, kk0, S);
      load_rows<HD, BC, LD, NTHR>(sp + L::PLANES * TILE, v + kv_off,
                                  kv_stride, kk0, S);
      cp_async_commit();
    };
    if (n > 0) {
      load_rows<HD, BR, LD, NTHR>(ra, q + q_off, q_stride, q0, T);
      load_rows<HD, BR, LD, NTHR>(rb, dout + q_off, q_stride, q0, T);
      issue(0);
    }
    float* xp = xch + xi;                  // P (first warp to second)
    float* xs = xch + L::XCH + xi;         // dS (second warp to first)
    for (int it = 0; it < n; ++it) {
      cp_async_wait_all();
      __syncthreads();
      if (it + 1 < n) issue(it + 1);
      float* sp = ring + (it % STAGES) * L::STAGE;
      const float* ck = sp;
      const float* cv = sp + L::PLANES * TILE;
      if (PRE) {
        split_tile<HD, BC, LD, TILE, NTHR>(sp);
        split_tile<HD, BC, LD, TILE, NTHR>(sp + 2 * TILE);
        __syncthreads();
      }
      const int kk0 = (j_lo + it) * BC;
      if (!any_live<CAUSAL>(qr, qr + 16, kk0, kk0 + BC, T, S, window))
        continue;
      const bool whole = all_live<CAUSAL>(qr, qr + 16, kk0, kk0 + BC, T, S,
                                          window);
      if constexpr (SOLO) {
        gemm_nt<HD, LD, NT, PRE, TILE>(x, ra + rg * 16 * LD, ck, g, t);
        gemm_nt<HD, LD, NT, PRE, TILE>(y, rb + rg * 16 * LD, cv, g, t);
#pragma unroll
        for (int n_ = 0; n_ < NT; ++n_)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(x[n_][e] * scale_log2 - lse2[e >> 1]);
            y[n_][e] = (whole || live<CAUSAL>(row0 + 8 * (e >> 1),
                                              kk0 + 8 * n_ + 2 * t + (e & 1),
                                              T, S, window)
                            ? p : 0.f) *
                       (y[n_][e] - del[e >> 1]);                 // dS
          }
        gemm_rn<LD, NT, NM, PRE, TILE>(acc, y, ck, g, t);    // dQ += dS K
      } else if (!second) {
        gemm_nt<HD, LD, NT, PRE, TILE>(x, wa, ck, g, t);     // S = Q K^T
#pragma unroll
        for (int n_ = 0; n_ < NT; ++n_)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(x[n_][e] * scale_log2 - lse2[e >> 1]);
            xp[(4 * n_ + e) * 128] =
                whole || live<CAUSAL>(row0 + 8 * (e >> 1),
                                      kk0 + 8 * n_ + 2 * t + (e & 1), T, S,
                                      window)
                    ? p : 0.f;
          }
        pair_arrive(1 + rg);
        pair_sync(5 + rg);                                     // dS is there
#pragma unroll
        for (int n_ = 0; n_ < NT; ++n_)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[n_][e] = xs[(4 * n_ + e) * 128];
        gemm_rn<LD, NT, NM, PRE, TILE>(acc, x, ck, g, t);    // dQ += dS K
      } else {
        gemm_nt<HD, LD, NT, PRE, TILE>(x, wa, cv, g, t);     // dP = dO V^T
        pair_sync(1 + rg);                                     // P is there
#pragma unroll
        for (int n_ = 0; n_ < NT; ++n_)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[n_][e] = xp[(4 * n_ + e) * 128] * (x[n_][e] - del[e >> 1]);
            xs[(4 * n_ + e) * 128] = x[n_][e];
          }
        pair_arrive(5 + rg);
        gemm_rn<LD, NT, NM, PRE, TILE>(acc, x, ck + HD / 2, g, t);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= T) continue;
      float* out = dq + q_off + (size_t)row * q_stride + second * (HD / 2) +
                   2 * t;
#pragma unroll
      for (int m = 0; m < NM; ++m)
        store2(out + 8 * m, acc[m][2 * r] * scale, acc[m][2 * r + 1] * scale);
    }
  }
}

// the two walks as kernels of their own names (a profile tells them apart)
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
    dkv_kernel(WALK_PARAMS) {
  walk<HD, true, CAUSAL>(WALK_ARGS);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
    dq_kernel(WALK_PARAMS) {
  walk<HD, false, CAUSAL>(WALK_ARGS);
}

#undef WALK_PARAMS
#undef WALK_ARGS

template <int HD, bool DKV, bool CAUSAL>
int launch_walk(int units, int tiles, int sms, const float* q,
                const float* k, const float* v, const float* dout,
                const float* lse, const float* delta, float* dq, float* dk,
                float* dv, int B, int T, int S, int H, int KVH, int window,
                float scale, cudaStream_t stream) {
  constexpr int smem = Tile<HD>::template smem<DKV>();
  const auto kernel = DKV ? dkv_kernel<HD, CAUSAL> : dq_kernel<HD, CAUSAL>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // non-causal walks in chunks of heads (block_order), causal ones all
  // longest first
  kernel<<<units * tiles, Tile<HD>::THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, B, T, S, H, KVH, window, scale,
      CAUSAL ? units : chunk_units(sms * Tile<HD>::MIN_BLOCKS, tiles));
  return (int)cudaGetLastError();
}

template <int HD, bool CAUSAL>
int launch(const float* q, const float* k, const float* v, const float* out,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int B, int T, int S, int H, int KVH,
           int window, float scale, cudaStream_t stream) {
  int device = 0, sms = 0;
  int err = (int)cudaGetDevice(&device);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (err != 0) return err;
  const int rows = B * T * H;
  delta_kernel<float, HD><<<DeltaShape<float, HD>::blocks(rows), 256, 0,
                            stream>>>(
      out, dout, delta, rows, T, H);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_walk<HD, true, CAUSAL>(B * KVH, (S + BR - 1) / BR, sms, q, k,
                                      v, dout, lse, delta, dq, dk, dv, B, T,
                                      S, H, KVH, window, scale, stream);
  if (err != 0) return err;
  return launch_walk<HD, false, CAUSAL>(B * H, (T + BR - 1) / BR, sms, q, k,
                                        v, dout, lse, delta, dq, dk, dv, B, T,
                                        S, H, KVH, window, scale, stream);
}

}  // namespace

// q, dq (B, T, H, hd), k, v, dk, dv (B, S, KVH, hd), out and dout like q, all
// float32, contiguous and 16-byte aligned; lse (B, H, T) float32 from the
// forward; delta (B, H, T) float32 scratch.  causal != 0 masks keys after
// the query; window <= 0 means no window; scale 1/sqrt(head_dim) of the
// unpadded head dim.  head_dim must be 64, 128 or 256 (the wrapper zero-pads
// smaller ones); returns cudaErrorInvalidValue for another.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int T, int S, int H, int KVH, int hd, int causal,
    int window, float scale, void* stream) {
#define ARGS                                                                  \
  (const float*)q, (const float*)k, (const float*)v, (const float*)out,       \
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq,       \
      (float*)dk, (float*)dv, B, T, S, H, KVH, window, scale,                 \
      (cudaStream_t)stream
#define CASE(HD)                                                              \
  case HD:                                                                    \
    return causal ? launch<HD, true>(ARGS) : launch<HD, false>(ARGS);
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
