// Causal (optionally sliding-window) GQA flash attention in float32, for
// Hopper.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// _fa_kernel (entry flash_attention): one q block per grid step, an online
// softmax over KV chunks with float32 m, l and acc, query head h reading KV
// head h / (H / KVH).
//
// What bounds it on the H100: float32 operations.  A live (query, key) pair
// costs 2*hd operations for its score and 2*hd for its share of P.V, and the
// kernel reads q, k, v once and writes out once; at head_dim 256 that is
// ~1000 operations per pair against a few bytes, far above the ridge of
// 67e12 / 3.35e12 = 20 operations per byte.  At recurrentgemma-2b's prefill
// shape (B=4, T=S=4096, H=10, KVH=1, window 2048) the 2.517e8 live pairs
// cost 2.58e11 operations, about 3.85 ms at the 67 TFLOP/s of float32 outside
// the tensor cores.  The float32 contract (2e-6 against the reference)
// rules out TF32 and the tensor cores, so every product is a plain FFMA.
//
// Design: one 256-thread block per (b*H + h, 64-row q tile).  The block keeps
// its Q tile and one 64-key K and V tile in shared memory (rows padded to
// hd + 4 floats; 212 KB at hd 256, so the dynamic size is raised with
// cudaFuncSetAttribute) and walks the KV tiles that the causal triangle and
// the window leave live; tiles wholly outside them are skipped, which at the
// shape above drops 62% of the (query, key) pairs.  Registers, not shared
// memory, bound the accumulator: hd = 256 floats per query row cannot sit in
// one thread, so a row is split across the 16 threads of a half warp.
// Thread (ty, tx) owns rows 4*ty..4*ty+3: for S = Q K^T it computes a 4x4
// block (columns tx + 16*j), reading four float4 of Q (a broadcast) and four
// of K per step, 8 loads per 64 FFMA; the row max and row sum of the online
// softmax are shuffles within the half warp; P goes through shared memory
// (transposed) so that for O += P V the thread owns the same 4 rows and
// hd / 16 columns (float4 groups tx*4 + 64*jj), 64 accumulators at hd 256.
// Masked scores are -1e30 and m starts at -1e30, as in the TPU kernel: a row
// whose first tiles are all masked adds exp(0) terms that the first live
// score scales by exp(-1e30 - m) = 0 exactly.  The kernel masks the ragged
// last q and KV tile itself (rows past T are not stored, keys past S are
// masked and read as zeros).  Loads are not overlapped with the arithmetic
// (one block per SM, no cp.async or TMA ring): that is a later change.
//
// The products are explicit fmaf() calls, which --fmad=false (the build's
// flag for the float64 kernels) leaves alone.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 4;       // padded row of Q, K, V tiles
  static constexpr int LDP = BQ + 4;      // padded row of P^T
  static constexpr int SMEM_FLOATS = BQ * LD + 2 * BKV * LD + BKV * LDP;
  static constexpr int NJ = HD / 64;      // float4 column groups per thread
};

// rows [row0, row0 + nrows) of a (rows, HD) slab with row stride `stride`
// into a padded shared tile; rows at or past `nvalid` read as zeros
template <int HD, int NROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          size_t stride, int row0,
                                          int nvalid) {
  constexpr int LD = Layout<HD>::LD;
  constexpr int N4 = NROWS * HD / 4;
#pragma unroll
  for (int it = 0; it < N4 / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / (HD / 4);
    const int d = (idx % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nvalid) {
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * stride + d);
    }
    *reinterpret_cast<float4*>(dst + r * LD + d) = v;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out, int T, int S, int H, int KVH,
                       int window, float scale) {
  using L = Layout<HD>;
  constexpr int LD = L::LD;
  constexpr int LDP = L::LDP;
  constexpr int NJ = L::NJ;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * LD;
  float* vs = ks + BKV * LD;
  float* pT = vs + BKV * LD;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KVH * HD;
  const float* qb = q + ((size_t)b * T * H + h) * HD;
  const float* kb = k + ((size_t)b * S * KVH + kvh) * HD;
  const float* vb = v + ((size_t)b * S * KVH + kvh) * HD;
  float* ob = out + ((size_t)b * T * H + h) * HD;

  // the KV tiles that hold a live key for some row of this q tile
  const int q_last = min(q0 + BQ, T) - 1;
  const int nkv = (S + BKV - 1) / BKV;
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / BKV;
  const int j_hi = min(nkv - 1, q_last / BKV);

  load_tile<HD, BQ>(qs, qb, q_stride, q0, T);

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * BKV;
    load_tile<HD, BKV>(ks, kb, kv_stride, k0, S);
    load_tile<HD, BKV>(vs, vb, kv_stride, k0, S);
    __syncthreads();

    // S = Q K^T for rows 4*ty + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax; a row's 64 scores live in the 16 threads of a half warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pq = q0 + ty * 4 + i;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pk = k0 + tx + 16 * j;
        const bool live = pk < S && pq >= pk &&
                          (window <= 0 || pq - pk < window);
        s[i][j] = live ? s[i][j] * scale : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (tx + 16 * j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // O += P V for rows 4*ty + i, columns tx*4 + 64*jj + (0..3)
#pragma unroll 2
    for (int c = 0; c < BKV; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pT + c * LDP + ty * 4);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vs + c * LD + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pr[i], vv.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pr[i], vv.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pr[i], vv.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pr[i], vv.w, acc[i][jj * 4 + 3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      float4 o;
      o.x = acc[i][jj * 4 + 0] * inv;
      o.y = acc[i][jj * 4 + 1] * inv;
      o.z = acc[i][jj * 4 + 2] * inv;
      o.w = acc[i][jj * 4 + 3] * inv;
      *reinterpret_cast<float4*>(ob + (size_t)row * q_stride + tx * 4 + 64 * jj) = o;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int T, int S, int H, int KVH, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<HD>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, T, S, H, KVH, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Always causal; window <= 0 means no window.  head_dim must be 64 (the
// reduced models of the tests) or 256 (recurrentgemma-2b).
// Returns cudaErrorInvalidValue for another head_dim.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int T,
                                      int S, int H, int KVH, int hd,
                                      int window, float scale,
                                      void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(qf, kf, vf, of, B, T, S, H, KVH, window, scale, st);
    case 256: return launch<256>(qf, kf, vf, of, B, T, S, H, KVH, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
