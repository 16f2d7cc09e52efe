// GQA flash attention in bfloat16 on Hopper (causal or not, optionally
// sliding-window): q, k, v and out bfloat16, everything else float32, as
// the TPU kernel and the JAX package's _attn_flash compute for bfloat16
// inputs: s = q.k^T summed in float32 (the products of bfloat16 values are
// exact in float32), scaled and masked (-1e30); m and l in float32; p =
// exp(s - m) rounded to bfloat16 for P.V (p.astype(v.dtype)), while l sums
// the unrounded float32 p; P.V summed in float32; out = acc / max(l, 1e-30)
// rounded to bfloat16 (out.astype(q.dtype)).  Instances for head_dim 64,
// 128 and 256, causal and not.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
// _fa_kernel (entry flash_attention) for bfloat16 inputs; the float32
// instance lives in flash_attention.cu.
//
// What bounds it on the H100: operations, 4*hd a live (query, key) pair on
// the tensor cores' bfloat16 rate (989 TFLOP/s dense): 0.556 ms at
// qwen3-4b's prefill (q (4, 4096, 32, 128), causal), 0.278 ms a layer at
// chameleon-34b's (q (1, 4096, 64, 128), KVH 8).  Beside the products, each
// live pair costs one exp2 on the special-function units (16 a clock an
// SM) and about six float32 instructions of the online softmax: at hd 128
// one exp2 per 512 MMA operations, about half the MMA time unless the two
// overlap; at hd 64 as long as the MMAs.  mma.sync fed by ldmatrix reads
// each K and V tile once for every 16 query rows (13 operations a
// shared-memory byte, which caps it near 0.4 of the tensor rate); a wgmma
// of 64 rows reads it once for all 64.
//
// Design (warp-specialised, as FlashAttention-3):
// * A persistent grid, one block of three warpgroups (384 threads) an
//   SM, walks the (b*H + h, 128-row q tile) tiles: rounds of one tile a
//   block, every other round in reverse (tile_index), so that causal
//   tiles' unequal walks even out and the blocks in flight share a few KV
//   heads in L2; a tile's start (Q's load, the pipeline's fill) overlaps
//   the last one's drain.  Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 40) and one thread starts TMA loads, a tile's Q
//   once (as soon as both consumers have taken their last S of the tile
//   before, so that it loads during their epilogue), then each live KV
//   tile's K and V into a ring of STAGES stages that runs on across
//   tiles, each with full and empty mbarriers (K and V apart, so that S
//   can start before V arrives).  Warpgroups 1 and 2 are consumers of 64
//   query rows each (setmaxnreg 232).
// * S = Q K^T by wgmma m64n{BKV}k16 from shared memory (Q and K K-major,
//   128-byte swizzle, as TMA writes them): hd/16 instructions in order, one
//   aligned sum of 16 products each, as mma.sync's k-steps.  A wgmma of 64
//   rows reads each K byte once for all 64 rows.
// * O += P V by wgmma m64n{hd}k16 with P in registers: S's float32
//   accumulators rounded pairwise to bfloat16 are the A fragment (the
//   m64nN accumulator layout of two adjacent 8-key groups is the m64k16 A
//   layout); V is the MN-major B operand (the descriptor's transpose bit),
//   BKV/16 instructions in order.
// * Each consumer starts S(j+1) and P(j) V(j) together, then runs the
//   softmax of tile j+1 while P(j) V(j) is in flight; two named barriers
//   alternate the consumers' turns (ping-pong), so that one's softmax runs
//   while the other's products do.
// * Tiles: BQ 128 (64 a consumer), BKV 128 at hd 64 and 128, 64 at hd 256
//   (O alone takes 128 registers a thread there); shared memory
//   2 * (BQ + 2 * STAGES * BKV) * hd bytes:
//     hd 64:  BKV 128, 2 stages, 80 KB;
//     hd 128: BKV 128, 2 stages, 160 KB;
//     hd 256: BKV 64, 2 stages, 192 KB.
// * exp2 is ex2.approx.ftz: the special-function unit's MUFU.EX2, as
//   exp2f, without exp2f's fix-up for results below 2^-126 (a p that small
//   is lost in any float32 sum of the tile).
// * TMA tensor maps are 4-D (hd, heads, rows, batch), so rows past T or S
//   read as zeros within each batch row; a 128-byte swizzled box holds 64
//   bfloat16 columns, so a tile is hd/64 boxes.  The maps are encoded on
//   the host at each launch (cuTensorMapEncodeTiled, looked up through
//   the CUDA runtime).
// The tile walk, masks, base-2 softmax and -1e30 conventions are the
// float32 instance's (kernels/flash_attention.py::kv_tile_range with the
// bfloat16 tiles); only the tiles that the diagonal, the window's edge or
// the end of S cut are masked (decided for each consumer's 64 rows);
// causal q tiles come longest first.  The output is acc / l in
// float32 (a correctly rounded division), rounded to bfloat16 to nearest
// even and stored from registers.
// On NVIDIA H100 80GB HBM3 at 700 W it reaches 0.55-0.59 of the bound at hd
// 128 and 256, 0.63-0.72 with the softmax taken out (its ablation in
// tools/flash_bf16_ablation.py), 0.38-0.41 at hd 64.
// With a non-null `lse` each consumer warpgroup also writes its 64 rows'
// log-sum-exp of the scaled live scores in its epilogue, (m + log2(l)) *
// ln(2) in float32 ((B, H, T)), for the backward (flash_attention_bwd.cu);
// `out` is the same with and without it.
// Not yet: the query heads of one KV head packed into a block, TMA
// multicast of K and V over a cluster, a dynamic tile scheduler, a TMA
// store of the output.
#include "hopper.cuh"

namespace {

constexpr int WG_THREADS = 128;            // a warpgroup
constexpr int THREADS = 3 * WG_THREADS;    // the producer and two consumers
constexpr int WG_ROWS = 64;                // q rows a consumer
constexpr int BQ = 2 * WG_ROWS;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float NEG = -1e30f;

template <int HD> struct Tile;
template <> struct Tile<64> {
  static constexpr int BKV = 128, STAGES = 2;
};
template <> struct Tile<128> {
  static constexpr int BKV = 128, STAGES = 2;
};
template <> struct Tile<256> { static constexpr int BKV = 64, STAGES = 2; };

// shared memory: the Q tile, the K ring, the V ring (each tile hd/64 boxes
// of 128-byte rows, every box 1024-byte aligned as the swizzle needs), then
// the mbarriers: Q full and empty, and K full, K empty, V full, V empty a
// stage
template <int HD>
struct Layout {
  static constexpr int BKV = Tile<HD>::BKV;
  static constexpr int STAGES = Tile<HD>::STAGES;
  static constexpr int BOXES = HD / BOX;
  static constexpr int Q_BOX = BQ * ROW_BYTES;
  static constexpr int KV_BOX = BKV * ROW_BYTES;
  static constexpr int KV_TILE = BOXES * KV_BOX;
  static constexpr int K_OFF = BOXES * Q_BOX;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BARS = 2 + 4 * STAGES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 8 * BARS;  // + alignment
};

// the consumers' turns: warpgroup w waits on barrier 1 + w, which the
// other warpgroup's arrival completes
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q K^T for a consumer's 64 rows: hd/16 k-steps in order, the first
// setting S.  `q` the consumer's first row in the Q tile's first box, `k`
// the K tile; a k-step is 32 bytes into a 128-byte swizzled row.
template <int HD>
__device__ __forceinline__ void qk_gemm(float (&s)[Tile<HD>::BKV / 2],
                                        uint32_t q, uint32_t k) {
  using L = Layout<HD>;
  hold(s);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss<L::BKV>(s, desc(q + (ks / 4) * L::Q_BOX + col, 16, 1024),
                     desc(k + (ks / 4) * L::KV_BOX + col, 16, 1024), ks > 0);
  }
  wg_commit();
  hold(s);
}

// O += P V: BKV/16 k-steps of 16 keys in order; V MN-major (hd contiguous
// within a box, boxes KV_BOX bytes apart, 8 keys 1024 bytes apart)
template <int HD>
__device__ __forceinline__ void pv_gemm(float (&o)[HD / 2],
                                        uint32_t (&p)[Tile<HD>::BKV / 4],
                                        uint32_t v) {
  using L = Layout<HD>;
  hold(o);
  hold(p);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < L::BKV / 16; ++kk)
    wgmma_rs<HD>(o, p + 4 * kk,
                 desc(v + kk * 16 * ROW_BYTES, L::KV_BOX, 1024));
  wg_commit();
  hold(o);
  hold(p);
}

// The online softmax of one KV tile in base 2 (scores scaled by scale *
// log2(e)) for this lane's rows row0 and row0 + 8: s[4n + e] holds key
// k0 + 8n + 2t + (e & 1) of row row0 + 8 (e >> 1).  A row's scores live in
// the 4 lanes of a quad.  Only the tiles that the causal diagonal, the
// window's edge or the end of S cut for the rows qw..qw+63 need the mask.
// Leaves p in s and the old-to-new rescale of O in corr.
template <int BKV, bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int qw,
                                             int row0, int t, int S,
                                             int window, float scale_log2) {
  float mt[2] = {NEG, NEG};
  if (k0 + BKV <= S && (!CAUSAL || k0 + BKV - 1 <= qw) &&
      (window <= 0 || qw + WG_ROWS - 1 - k0 < window)) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      s[i] *= scale_log2;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int pq = row0 + 8 * ((i >> 1) & 1);
      const int pk = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const bool live = pk < S && (!CAUSAL || pq >= pk) &&
                        (window <= 0 || pq - pk < window);
      s[i] = live ? s[i] * scale_log2 : NEG;
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
}

// A q tile's work: tile t is (b * H + h) * nq + its index among the
// head's q tiles, causal ones longest first; the KV tiles that hold a live
// key for some of its rows (kernels/flash_attention.py::kv_tile_range)
struct Work {
  int q0, b, h, j_lo, n;                       // n >= 1: the wrapper's check
};

template <int BKV, bool CAUSAL>
__device__ __forceinline__ Work tile_work(int t, int nq, int T, int S, int H,
                                          int window) {
  const int bh = t / nq;
  const int qt = t % nq;
  Work w;
  w.q0 = (CAUSAL ? nq - 1 - qt : qt) * BQ;
  w.b = bh / H;
  w.h = bh % H;
  const int q_last = min(w.q0 + BQ, T) - 1;
  w.j_lo = 0;
  if (window > 0 && w.q0 - window + 1 > 0) w.j_lo = (w.q0 - window + 1) / BKV;
  int j_hi = (S + BKV - 1) / BKV - 1;
  if (CAUSAL) j_hi = min(j_hi, q_last / BKV);
  w.n = j_hi - w.j_lo + 1;
  return w;
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int B, int T, int S,
                            int H, int KVH, int window, float scale) {
  using L = Layout<HD>;
  constexpr int BKV = L::BKV;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + L::K_OFF;
  const uint32_t sv = sq + L::V_OFF;
  const uint32_t q_full = sq + L::BAR_OFF;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;          // + 8 * stage
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;
  const int p = blockIdx.x;
  const int G = gridDim.x;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);                     // one arrival a consumer
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 2);
      mbar_init(v_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    // the producer: one thread starts every load, the next tile's Q as
    // soon as both consumers have taken their last S of this one
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // the tile count is computed in each branch: computed before it, it
    // lived across setmaxnreg and spilled
    const int nq = (T + BQ - 1) / BQ;
    const int n_tiles = nq * B * H;
    if (threadIdx.x == 0) {
      uint32_t g = 0;                          // K/V tiles loaded
      for (int k = 0;; ++k) {
        const int t = tile_index(k, p, G);
        if (t >= n_tiles) break;
        const Work w = tile_work<BKV, CAUSAL>(t, nq, T, S, H, window);
        const int kvh = w.h / (H / KVH);
        mbar_wait(q_empty, (k & 1) ^ 1);
        mbar_expect_tx(q_full, L::BOXES * L::Q_BOX);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x)
          tma_load(sq + x * L::Q_BOX, &tq, q_full, x * BOX, w.h, w.q0, w.b);
        for (int it = 0; it < w.n; ++it, ++g) {
          const int st = g % STAGES;
          const uint32_t ph = (g / STAGES) & 1;
          const int k0 = (w.j_lo + it) * BKV;
          mbar_wait(k_empty + 8 * st, ph ^ 1);
          mbar_expect_tx(k_full + 8 * st, L::KV_TILE);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x)
            tma_load(sk + st * L::KV_TILE + x * L::KV_BOX, &tk,
                     k_full + 8 * st, x * BOX, kvh, k0, w.b);
          mbar_wait(v_empty + 8 * st, ph ^ 1);
          mbar_expect_tx(v_full + 8 * st, L::KV_TILE);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x)
            tma_load(sv + st * L::KV_TILE + x * L::KV_BOX, &tv,
                     v_full + 8 * st, x * BOX, kvh, k0, w.b);
        }
      }
    }
  } else {
    // a consumer: 64 query rows of each of the block's tiles
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int nq = (T + BQ - 1) / BQ;
    const int n_tiles = nq * B * H;
    const int wg = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int lrow = WG_ROWS * wg + 16 * (tid >> 5) + ((tid & 31) >> 2);
    const int t = tid & 3;
    const float scale_log2 = scale * 1.4426950408889634f;
    const uint32_t q_rows = sq + wg * WG_ROWS * ROW_BYTES;
    float s[BKV / 2];                          // S, then p, of one KV tile
    uint32_t p_[BKV / 4];                      // p as bfloat16 A fragments
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    if (wg == 0) turn_arrive(1);               // consumer 0 goes first

    uint32_t g = 0;                            // K/V tiles consumed
    for (int k = 0;; ++k) {
      const int tile = tile_index(k, p, G);
      if (tile >= n_tiles) break;
      const Work w = tile_work<BKV, CAUSAL>(tile, nq, T, S, H, window);
      const int qw = w.q0 + WG_ROWS * wg;      // this consumer's first row
      const int row0 = w.q0 + lrow;            // this lane's: row0, row0 + 8
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m[2] = {NEG, NEG};
      float l[2] = {0.f, 0.f};
      float corr[2];

      int st = g % STAGES;
      uint32_t ph = (g / STAGES) & 1;
      mbar_wait(q_full, k & 1);
      mbar_wait(k_full + 8 * st, ph);
      turn_sync(1 + wg);
      qk_gemm<HD>(s, q_rows, sk + st * L::KV_TILE);
      turn_arrive(2 - wg);
      wg_wait<0>();
      hold(s);
      if (tid == 0) {
        mbar_arrive(k_empty + 8 * st);
        if (w.n == 1) mbar_arrive(q_empty);
      }
      softmax_tile<BKV, CAUSAL>(s, m, l, corr, w.j_lo * BKV, qw, row0, t, S,
                                window, scale_log2);
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i)
        p_[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

      for (int it = 1; it < w.n; ++it) {
        // S of KV tile it and P V of tile it - 1 in one turn; tile it's
        // softmax while P V runs
        const int sn = (g + it) % STAGES;
        const uint32_t pn = ((g + it) / STAGES) & 1;
        mbar_wait(k_full + 8 * sn, pn);
        turn_sync(1 + wg);
        qk_gemm<HD>(s, q_rows, sk + sn * L::KV_TILE);
        mbar_wait(v_full + 8 * st, ph);
        pv_gemm<HD>(o, p_, sv + st * L::KV_TILE);
        turn_arrive(2 - wg);
        wg_wait<1>();
        hold(s);
        if (tid == 0) {
          mbar_arrive(k_empty + 8 * sn);
          if (it == w.n - 1) mbar_arrive(q_empty);
        }
        softmax_tile<BKV, CAUSAL>(s, m, l, corr, (w.j_lo + it) * BKV, qw,
                                  row0, t, S, window, scale_log2);
        wg_wait<0>();
        hold(o);
        hold(p_);
        if (tid == 0) mbar_arrive(v_empty + 8 * st);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < BKV / 4; ++i)
          p_[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        st = sn;
        ph = pn;
      }
      mbar_wait(v_full + 8 * st, ph);
      pv_gemm<HD>(o, p_, sv + st * L::KV_TILE);
      wg_wait<0>();
      hold(o);
      if (tid == 0) mbar_arrive(v_empty + 8 * st);
      g += w.n;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row0 + 8 * r;
        if (row >= T) continue;
        if (lse != nullptr && t == 0)
          lse[((size_t)w.b * H + w.h) * T + row] =
              (m[r] + log2f(l[r])) * 0.6931471805599453f;
        const float den = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            out + (((size_t)w.b * T + row) * H + w.h) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c)
          *reinterpret_cast<uint32_t*>(orow + 8 * c) =
              pack_bf16(o[4 * c + 2 * r] / den, o[4 * c + 2 * r + 1] / den);
      }
    }
    if (wg == 0) turn_sync(1);                 // consumer 1's last arrival
  }
}

template <int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int T, int S, int H, int KVH, int window, float scale,
           cudaStream_t stream) {
  using L = Layout<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, encode, q, B, T, H, HD, BQ) ||
      !make_map(&tk, encode, k, B, S, KVH, HD, L::BKV) ||
      !make_map(&tv, encode, v, B, S, KVH, HD, L::BKV))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = L::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM walks the tiles (a block a tile where
  // there are fewer tiles than SMs)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((T + BQ - 1) / BQ) * B * H;
  const int grid = (int)(tiles > sms ? (long)sms : tiles);
  flash_attention_bf16_kernel<HD, CAUSAL><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, B, T, S, H, KVH, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int causal, const void* q, const void* k, const void* v,
              void* out, float* lse, int B, int T, int S, int H, int KVH,
              int window, float scale, cudaStream_t stream) {
  return causal ? launch<HD, true>(q, k, v, out, lse, B, T, S, H, KVH,
                                   window, scale, stream)
                : launch<HD, false>(q, k, v, out, lse, B, T, S, H, KVH,
                                    window, scale, stream);
}

}  // namespace

// q (B, T, H, hd), k and v (B, S, KVH, hd), out like q, all bfloat16,
// contiguous and 16-byte aligned; lse (B, H, T) float32 or null.  causal !=
// 0 masks keys after the query; window <= 0 means no window.  head_dim must
// be 64, 128 or 256 (the wrapper zero-pads smaller ones and passes their own
// scale); returns cudaErrorInvalidValue for another.
extern "C" int flash_attention_launch_bf16(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int B, int T, int S,
                                           int H, int KVH, int hd, int causal,
                                           int window, float scale,
                                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* lf = (float*)lse;
  switch (hd) {
    case 64:
      return launch_hd<64>(causal, q, k, v, out, lf, B, T, S, H, KVH,
                           window, scale, st);
    case 128:
      return launch_hd<128>(causal, q, k, v, out, lf, B, T, S, H, KVH,
                            window, scale, st);
    case 256:
      return launch_hd<256>(causal, q, k, v, out, lf, B, T, S, H, KVH,
                            window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
