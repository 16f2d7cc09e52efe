// GQA flash attention in float32 (causal or not, optionally sliding-window)
// on Hopper's tensor cores.  Instances for head_dim 64, 128 and 256, causal
// and not.  The bfloat16 instance lives in flash_attention_bf16.cu.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// _fa_kernel (entry flash_attention): one q block per grid step, an online
// softmax over KV chunks with float32 m, l and acc, query head h reading KV
// head h / (H / KVH).
//
// What bounds it on the H100: operations.  A live (query, key) pair costs
// 2*hd operations for its score and 2*hd for its share of P.V, against a few
// bytes of q, k, v and out.  At recurrentgemma-2b's prefill shape (B=4,
// T=S=4096, H=10, KVH=1, hd=256, window 2048) the 2.517e8 live pairs cost
// 2.577e11 operations: 3.85 ms in FFMA at the 67 TFLOP/s of float32 outside
// the tensor cores.  Single-pass TF32 keeps 11 bits of each operand and
// misses the float32 contract (2e-5 against the plain version) by two orders
// of magnitude, so the products run in split TF32 ("3xTF32"): each operand
// is x = big + small, big = x rounded to TF32 (to nearest, ties away) and
// small = x - big exactly, of which the MMA reads the top 11 bits (it
// ignores the low 13 bits of a TF32 operand); a*b ~ small_a*big_b +
// big_a*small_b + big_a*big_b, three TF32 MMAs into a float32 accumulator,
// with the small*small term dropped (below 2^-21 of the product).  Three
// MMAs a product put the bound at 495/3 = 165 TFLOP/s, 1.56 ms at the shape
// above.  The split itself is three instructions a value (an integer add
// and mask, a float subtract), and every warp splits each Q, K, V and P
// value that it reads: the splits take more issue slots than the MMAs.
//
// Design.  mma.sync.m16n8k8 (tf32 in, f32 out): wgmma takes B only from
// shared memory, and the split needs both halves of K and V there, which
// hd 256 cannot afford beside the Q tile and the K/V ring.  One 256-thread
// block (8 warps) per (b*H + h, 64-row q tile).  Warps w and w + 4 share
// the rows 16w..16w+15 (w < 4) and split hd between them: each sums half
// of the dims of every score, the two partial sums meet in shared memory
// (a named barrier for the pair; a + b == b + a, so both warps then hold
// the same scores and run the same softmax), and each owns half of O's
// columns in MMA accumulators (hd/4 registers a thread).  An accumulator of
// all hd columns would take 128 registers at hd 256 and left 4 warps an SM
// at 255 registers with spills, twice as slow.  The block keeps its Q tile
// in shared memory and streams the live K and V tiles through a two-stage
// cp.async ring, so tile j+1 is in flight while tile j is computed:
//   hd 256: BKV 32, 217 KB, one block (8 warps) an SM;
//   hd 128: BKV 32, 121 KB, one block an SM;
//   hd 64:  BKV 32, 73 KB, two blocks an SM.
// Both products take their operands from shared memory as 16-byte loads,
// and the reduction axes are permuted so that they can:
// * S = Q K^T: within each 16-wide block of hd, lane (g, t) holds dims
//   4t..4t+3 of its Q rows and K keys; k-step 0 uses dims (4t, 4t+1) as the
//   MMA's k = (t, t+4), k-step 1 dims (4t+2, 4t+3).  Q and K rows are padded
//   to hd + 16 floats, which keeps the quarter-warp loads conflict-free.
// * O += P V: the S accumulator holds keys (2t, 2t+1) of each 8-key group
//   in lane (g, t); they are used in place as the A operand's k = (t, t+4),
//   so V rows are read in the same order (keys 2t and 2t+1).  The output
//   columns of O's n-tile 4m + jj are 32m + 4n + jj (n the MMA column), so
//   a lane reads V columns 32m + 4g..+3 for four n-tiles with one load and
//   stores out columns 32m + 8t..+7 as two float4.  V rows are padded to
//   hd + 4 floats.
// Every KV tile that the causal triangle, the window or the end of S leaves
// without a live key for the block's rows is skipped (62% of the pairs at the
// shape above), and only the tiles that the diagonal, the window's edge or
// the end of S cut are masked; causal blocks are launched longest first.
// The softmax runs in base 2 on scores scaled by scale * log2(e).  Masked
// scores are -1e30 and m starts at -1e30, as in the TPU kernel: a row whose
// first tiles are all masked adds exp2(0) terms that the first live score
// scales by exp2(-1e30 - m) = 0 exactly.  The kernel masks the ragged last
// q and KV tile itself (rows past T are not stored, keys past S are masked
// and read as zeros).  The row sum l is kept per lane and summed over the
// quad once, at the end.
// With a non-null `lse` the kernel also writes each row's log-sum-exp of its
// scaled live scores, (m + log2(l)) * ln(2) in float32 ((B, H, T)), which the
// backward (flash_attention_bwd.cu) reads to recompute P; `out` is the same
// with and without it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 64;                     // four row groups of 16
constexpr float NEG = -1e30f;

// keys a KV tile and blocks an SM, per head_dim
template <int HD> struct Tile;
template <> struct Tile<64> { static constexpr int BKV = 32, MIN_BLOCKS = 2; };
template <> struct Tile<128> { static constexpr int BKV = 32, MIN_BLOCKS = 1; };
template <> struct Tile<256> { static constexpr int BKV = 32, MIN_BLOCKS = 1; };

template <int HD>
struct Layout {
  static constexpr int BKV = Tile<HD>::BKV;
  static constexpr int STAGES = 2;
  static constexpr int LDQK = HD + 16;     // padded row of the Q and K tiles
  static constexpr int LDV = HD + 4;       // padded row of the V tile
  static constexpr int Q_FLOATS = BQ * LDQK;
  static constexpr int K_FLOATS = BKV * LDQK;
  static constexpr int V_FLOATS = BKV * LDV;
  static constexpr int X_FLOATS = WARPS * (BKV / 2) * 32;  // partial scores
  static constexpr int SMEM_BYTES =
      4 * (Q_FLOATS + STAGES * (K_FLOATS + V_FLOATS) + X_FLOATS);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;            // 0 source bytes: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two warps of row group rg (rg and rg + 4)
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg) : "memory");
}

// rows [row0, row0 + NROWS) of a (rows, HD) slab with row stride `stride`
// into a padded shared tile, asynchronously; rows at or past `nvalid` read
// as zeros
template <int HD, int NROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          size_t stride, int row0,
                                          int nvalid) {
  constexpr int CH = HD / 4;
  static_assert(NROWS * CH % THREADS == 0, "tile not a multiple of a pass");
#pragma unroll
  for (int it = 0; it < NROWS * CH / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    const bool ok = row0 + r < nvalid;
    cp_async16(dst + r * LD + c,
               src + (size_t)(ok ? row0 + r : 0) * stride + c, ok);
  }
}

// x = big + small: big = x rounded to TF32 (to nearest, ties away: what
// cvt.rna.tf32.f32 gives for every finite x and for infinities, as an
// integer add and mask, where the compiler wraps the cvt in a compare and
// a select), small the exact remainder, whose low 13 bits the MMA ignores
// (truncation)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
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
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, Tile<HD>::MIN_BLOCKS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out, float* __restrict__ lse,
                       int T, int S, int H, int KVH, int window,
                       float scale) {
  using L = Layout<HD>;
  constexpr int BKV = L::BKV;
  constexpr int STAGES = L::STAGES;
  constexpr int LDQK = L::LDQK;
  constexpr int LDV = L::LDV;
  constexpr int HH = HD / 2;               // the dims of a half
  constexpr int NT = BKV / 8;              // n-tiles of S (8 keys each)
  constexpr int NM = HH / 32;              // groups of four O n-tiles
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + L::Q_FLOATS;
  float* vs = ks + STAGES * L::K_FLOATS;
  float* xs = vs + STAGES * L::V_FLOATS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3;                 // row group
  const int half = warp >> 2;              // half of hd
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nq = (T + BQ - 1) / BQ;
  const int q0 = (CAUSAL ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x) * BQ;
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
  // (kernels/flash_attention.py::kv_tile_range)
  const int q_last = min(q0 + BQ, T) - 1;
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / BKV;
  int j_hi = (S + BKV - 1) / BKV - 1;
  if (CAUSAL) j_hi = min(j_hi, q_last / BKV);

  load_tile<HD, BQ, LDQK>(qs, qb, q_stride, q0, T);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (j_lo + st <= j_hi) {
      load_tile<HD, BKV, LDQK>(ks + st * L::K_FLOATS, kb, kv_stride,
                               (j_lo + st) * BKV, S);
      load_tile<HD, BKV, LDV>(vs + st * L::V_FLOATS, vb, kv_stride,
                              (j_lo + st) * BKV, S);
    }
    cp_async_commit();
  }

  const int row0 = q0 + rg * 16 + g;       // this lane's rows: row0, row0 + 8
  const float scale_log2 = scale * 1.4426950408889634f;
  float* x_own = xs + warp * (NT * 4 * 32) + lane;
  const float* x_other = xs + (warp ^ 4) * (NT * 4 * 32) + lane;
  const float* qw = qs + (rg * 16 + g) * LDQK + half * HH + 4 * t;
  float o[4 * NM][4];
#pragma unroll
  for (int c = 0; c < 4 * NM; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};

  for (int j = j_lo, it = 0; j <= j_hi; ++j, ++it) {
    const int jn = j + STAGES - 1;
    if (jn <= j_hi) {
      const int st = (it + STAGES - 1) % STAGES;
      load_tile<HD, BKV, LDQK>(ks + st * L::K_FLOATS, kb, kv_stride, jn * BKV,
                               S);
      load_tile<HD, BKV, LDV>(vs + st * L::V_FLOATS, vb, kv_stride, jn * BKV,
                              S);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const float* kt = ks + (it % STAGES) * L::K_FLOATS;
    const float* vt = vs + (it % STAGES) * L::V_FLOATS;

    // this warp's half of S = Q K^T (dims half*HH..), rows (row0, row0 + 8),
    // keys j*BKV + 8n + 2t + (0, 1)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const float* kw = kt + g * LDQK + half * HH + 4 * t;
#pragma unroll
    for (int d0 = 0; d0 < HH; d0 += 16) {
      const float4 qa = *reinterpret_cast<const float4*>(qw + d0);
      const float4 qc = *reinterpret_cast<const float4*>(qw + 8 * LDQK + d0);
      uint32_t ab0[4], as0[4], ab1[4], as1[4];
      split(qa.x, ab0[0], as0[0]);
      split(qc.x, ab0[1], as0[1]);
      split(qa.y, ab0[2], as0[2]);
      split(qc.y, ab0[3], as0[3]);
      split(qa.z, ab1[0], as1[0]);
      split(qc.z, ab1[1], as1[1]);
      split(qa.w, ab1[2], as1[2]);
      split(qc.w, ab1[3], as1[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kw + 8 * n * LDQK + d0);
        uint32_t bb[4], bs[4];
        split(kk.x, bb[0], bs[0]);
        split(kk.y, bb[1], bs[1]);
        split(kk.z, bb[2], bs[2]);
        split(kk.w, bb[3], bs[3]);
        mma3(s[n], ab0, as0, bb[0], bb[1], bs[0], bs[1]);
        mma3(s[n], ab1, as1, bb[2], bb[3], bs[2], bs[3]);
      }
    }
    // the full scores: add the other half's partial sums (a + b == b + a,
    // so both warps of the pair hold the same S and the same softmax)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_own[(4 * n + e) * 32] = s[n][e];
    pair_sync(rg);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += x_other[(4 * n + e) * 32];

    // online softmax in base 2 (scores scaled by scale * log2(e)); a row's
    // scores live in the 4 lanes of a quad.  Only the tiles that the causal
    // diagonal, the window's edge or the end of S cut need the mask.
    const int k0 = j * BKV;
    float mt[2] = {NEG, NEG};
    if (k0 + BKV <= S && (!CAUSAL || k0 + BKV - 1 <= q0) &&
        (window <= 0 || q0 + BQ - 1 - k0 < window)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale_log2;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pq = row0 + 8 * (e >> 1);
          const int pk = k0 + 8 * n + 2 * t + (e & 1);
          const bool live = pk < S && (!CAUSAL || pq >= pk) &&
                            (window <= 0 || pq - pk < window);
          s[n][e] = live ? s[n][e] * scale_log2 : NEG;
          mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
        }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int c = 0; c < 4 * NM; ++c) {
      o[c][0] *= corr[0];
      o[c][1] *= corr[0];
      o[c][2] *= corr[1];
      o[c][3] *= corr[1];
    }

    // this warp's columns of O += P V, one 8-key k-step per S n-tile
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t pb[4], ps[4];
      split(s[n][0], pb[0], ps[0]);
      split(s[n][2], pb[1], ps[1]);
      split(s[n][1], pb[2], ps[2]);
      split(s[n][3], pb[3], ps[3]);
      const float* v0 = vt + (8 * n + 2 * t) * LDV + half * HH + 4 * g;
#pragma unroll
      for (int mg = 0; mg < NM; ++mg) {
        const float4 x = *reinterpret_cast<const float4*>(v0 + 32 * mg);
        const float4 y = *reinterpret_cast<const float4*>(v0 + LDV + 32 * mg);
        const float xv[4] = {x.x, x.y, x.z, x.w};
        const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bb0, bs0, bb1, bs1;
          split(xv[jj], bb0, bs0);
          split(yv[jj], bb1, bs1);
          mma3(o[4 * mg + jj], pb, ps, bb0, bb1, bs0, bs1);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= T) continue;
    if (lse != nullptr && half == 0 && t == 0)
      lse[(size_t)bh * T + row] = (m[i] + log2f(l[i])) * 0.6931471805599453f;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = ob + (size_t)row * q_stride + half * HH + 8 * t;
#pragma unroll
    for (int mg = 0; mg < NM; ++mg) {
      const float4 lo = make_float4(
          o[4 * mg][2 * i] * inv, o[4 * mg + 1][2 * i] * inv,
          o[4 * mg + 2][2 * i] * inv, o[4 * mg + 3][2 * i] * inv);
      const float4 hi = make_float4(
          o[4 * mg][2 * i + 1] * inv, o[4 * mg + 1][2 * i + 1] * inv,
          o[4 * mg + 2][2 * i + 1] * inv, o[4 * mg + 3][2 * i + 1] * inv);
      *reinterpret_cast<float4*>(orow + 32 * mg) = lo;
      *reinterpret_cast<float4*>(orow + 32 * mg + 4) = hi;
    }
  }
}

template <int HD, bool CAUSAL>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B, int T, int S, int H, int KVH, int window,
           float scale, cudaStream_t stream) {
  constexpr int smem = Layout<HD>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_attention_kernel<HD, CAUSAL><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, lse, T, S, H, KVH, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int causal, const float* q, const float* k, const float* v,
              float* out, float* lse, int B, int T, int S, int H, int KVH,
              int window, float scale, cudaStream_t stream) {
  return causal ? launch<HD, true>(q, k, v, out, lse, B, T, S, H, KVH,
                                   window, scale, stream)
                : launch<HD, false>(q, k, v, out, lse, B, T, S, H, KVH,
                                    window, scale, stream);
}

}  // namespace

// causal != 0 masks keys after the query; window <= 0 means no window.
// lse may be null.  head_dim must be 64, 128 or 256 (the wrapper zero-pads
// smaller ones and passes their own scale); returns cudaErrorInvalidValue
// for another.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int T, int S, int H, int KVH,
                                      int hd, int causal, int window,
                                      float scale, void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)out;
  float* lf = (float*)lse;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return launch_hd<64>(causal, qf, kf, vf, of, lf, B, T, S, H, KVH,
                           window, scale, st);
    case 128:
      return launch_hd<128>(causal, qf, kf, vf, of, lf, B, T, S, H, KVH,
                            window, scale, st);
    case 256:
      return launch_hd<256>(causal, qf, kf, vf, of, lf, B, T, S, H, KVH,
                            window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
