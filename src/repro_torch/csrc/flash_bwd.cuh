// Pieces shared by the two backward kernels of flash attention
// (flash_attention_bwd.cu in float32, flash_attention_bwd_bf16.cu in
// bfloat16): which (query, key) pairs are live, the order in which blocks
// take their tiles, and D = rowsum(dO * O).  Everything is in an anonymous
// namespace: each source gets its own copy.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// whether rows r0..r1-1 and keys k0..k1-1 hold a live (query, key) pair,
// and whether every pair of them is live
template <bool CAUSAL>
__device__ __forceinline__ bool any_live(int r0, int r1, int k0, int k1,
                                         int T, int S, int window) {
  const int r_hi = min(r1, T) - 1;
  const int k_hi = min(k1, S) - 1;
  if (r0 > r_hi || k0 > k_hi) return false;
  if (CAUSAL && r_hi < k0) return false;
  return window <= 0 || r0 - k_hi < window;
}

template <bool CAUSAL>
__device__ __forceinline__ bool all_live(int r0, int r1, int k0, int k1,
                                         int T, int S, int window) {
  return r1 <= T && k1 <= S && (!CAUSAL || r0 >= k1 - 1) &&
         (window <= 0 || r1 - 1 - k0 < window);
}

template <bool CAUSAL>
__device__ __forceinline__ bool live(int pq, int pk, int T, int S,
                                     int window) {
  return pq < T && pk < S && (!CAUSAL || pq >= pk) &&
         (window <= 0 || pq - pk < window);
}

// Block `blk` of a grid of n_units x n_tiles (a unit: a batch row and
// head; a tile: the block's rows) taken in chunks of `grp` units, a chunk's
// tiles in order (tile 0 of each unit, then tile 1, ...): the blocks in
// flight share a chunk's few heads, whose other side stays in L2, while
// causal walks still run longest first within each chunk.
__device__ __forceinline__ void block_order(int blk, int n_units, int n_tiles,
                                            int grp, int& unit, int& tile) {
  const int chunk = blk / (grp * n_tiles);
  const int r = blk - chunk * grp * n_tiles;
  const int units = min(grp, n_units - chunk * grp);
  tile = r / units;
  unit = chunk * grp + r % units;
}

// grp for block_order: as many units as a wave of `resident` blocks holds
int chunk_units(int resident, int n_tiles) {
  return resident / n_tiles > 1 ? resident / n_tiles : 1;
}

// the sum of the products of two 16-byte chunks of floats or bfloat16s
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 u, v;
    memcpy(&u, &xs[i], 4);
    memcpy(&v, &ys[i], 4);
    const float2 f = __bfloat1622float2(u);
    const float2 g = __bfloat1622float2(v);
    s += f.x * g.x + f.y * g.y;
  }
  return s;
}

// D = rowsum(dO * O) in float32, written (B, H, T): each (b, t, h) row read
// in 16-byte chunks by LANES lanes of a warp (ROWS rows a warp, 8 warps a
// block), the chunks' sums added in a fixed tree
template <typename E, int HD>
struct DeltaShape {
  static constexpr int PER = 16 / (int)sizeof(E);     // elements a chunk
  static constexpr int CHUNKS = HD / PER;             // chunks a row
  static constexpr int LANES = CHUNKS < 32 ? CHUNKS : 32;
  static constexpr int ROWS = 32 / LANES;
  static int blocks(int rows) { return (rows + 8 * ROWS - 1) / (8 * ROWS); }
};

template <typename E, int HD>
__global__ void __launch_bounds__(256)
delta_kernel(const E* __restrict__ out, const E* __restrict__ dout,
             float* __restrict__ delta, int rows, int T, int H) {
  using D = DeltaShape<E, HD>;
  const int lane = threadIdx.x & 31;
  const int r = (blockIdx.x * 8 + (threadIdx.x >> 5)) * D::ROWS +
                lane / D::LANES;
  const int c = lane % D::LANES;
  float s = 0.f;
  if (r < rows) {
#pragma unroll
    for (int k = c; k < D::CHUNKS; k += D::LANES)
      s += dot16(out + (size_t)r * HD + k * D::PER,
                 dout + (size_t)r * HD + k * D::PER);
  }
#pragma unroll
  for (int off = D::LANES / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (r < rows && c == 0) {
    const int h = r % H;
    const int bt = r / H;
    delta[((size_t)(bt / T) * H + h) * T + bt % T] = s;
  }
}

}  // namespace
