// The backward of GQA flash attention in bfloat16 on Hopper (causal or not,
// optionally sliding-window): dQ, dK and dV of out = softmax(scale * Q K^T
// + mask) V for the output gradient dO, query head h reading KV head
// h / (H / KVH), keys at positions 0..S-1.  q, k, v, out, dout and the
// gradients are bfloat16; lse, D and every sum are float32.  Instances for
// head_dim 64, 128 and 256, causal and not.  The float32 instance lives in
// flash_attention_bwd.cu.
//
// Replaces no TPU kernel: the TPU kernel (src/repro/kernels/
// flash_attention.py::_fa_kernel) has no backward, and the JAX package's
// impl="flash" path differentiates src/repro/models/layers.py::_attn_flash
// by autodiff.  This computes the same gradient from what the forward
// kernel (flash_attention_bf16.cu) saves: out and each row's log-sum-exp.
//
// What bounds it on the H100: operations.  A live (query, key) pair needs
// five products of 2*hd operations (S again, dP, dV, dK, dQ): 10*hd, 0.348
// ms at qwen3-0.6b's training shape (q (2, 4096, 16, 128), KVH 8, causal)
// on the tensor cores' bfloat16 rate (989 TFLOP/s dense).  The kernel does
// 14*hd: to keep the gradient free of atomics, and so the same from run to
// run, the dQ walk forms S and dP again (below), which puts its ceiling at
// 10/14 = 0.71 of the bound.  Beside the products each live pair costs two
// exp2 on the special-function units (one a walk) and a few float32
// instructions.
//
// The algorithm is FlashAttention-2's, in three launches and no atomics:
//   1. D = rowsum(dO * O) in float32 (16-byte loads, a fixed tree);
//   2. the dK/dV walk: one block for each (batch, KV head, tile of BK
//      keys); it walks the live q tiles of all G query heads of its KV
//      head, so the sum over the heads stays in registers;
//   3. the dQ walk: one block for each (batch, query head, tile of 128
//      queries); it walks the live KV tiles.
// Design (warp-specialised, after FlashAttention-3 and the forward):
// * Each block has a producer warpgroup and two consumer warpgroups (384
//   threads, one block an SM).  The producer gives up registers (setmaxnreg
//   24); one thread loads the block's own tiles once and the other side's
//   tiles by TMA into a ring of stages with full and empty mbarriers.  A
//   consumer reads the step's lse and D from global memory ahead of its
//   products (in the dK/dV walk each warp into a buffer of its own, so
//   that no barrier spans the warpgroup).
// * Every product is a wgmma of 64 rows with float32 accumulators: S^T =
//   K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T from shared memory (both
//   operands K-major, the 128-byte swizzle TMA writes); dV += P^T dO, dK +=
//   dS^T Q and dQ += dS K with P^T, dS^T or dS from registers, rounded
//   pairwise to bfloat16 (the m64nN accumulator of two adjacent 8-column
//   groups is the m64k16 A fragment), and dO, Q or K as MN-major B operands
//   (the descriptor's transpose bit), as the forward's P V does.
// * The dK/dV walk forms S^T and dP^T once per (key tile, q tile) pair at
//   every head dim:
//     hd 64 and 128: each consumer owns 64 of the block's 128 keys and forms
//       S^T, dP^T, P^T, dS^T and both products (dV and dK: hd registers a
//       thread);
//     hd 256, where dV and dK of 64 keys alone would take 256 registers a
//       thread: the consumers split the products over one 64-key tile.
//       Consumer 0 forms S^T and P^T, hands P^T (float32, in its register
//       order) to consumer 1 through shared memory and accumulates dV;
//       consumer 1 forms dP^T, dS^T = P^T (dP^T - D), and accumulates dK.
//       Two named barriers hand P^T over and back.
// * The dQ walk: each consumer owns 64 query rows of the block's and forms
//   S, dP, dS and dQ (hd/2 registers a thread); a consumer with no live
//   pair in a KV tile skips its products.  P is formed while dP is still
//   in flight.
// * Tiles (BwdTile): BK keys a dK/dV block, BQ q rows a step; BKV keys a
//   dQ step; shared memory (dK/dV, dQ):
//     hd 64:  BK 128, BQ 128, 4 stages; BKV 128: 177 KB and 97 KB;
//     hd 128: BK 128, BQ 64, 3 stages; BKV 64: 169 KB and 129 KB;
//     hd 256: BK 64, BQ 64, 2 stages; BKV 32: 209 KB and 193 KB.
// * Each walk skips exactly the tiles without a live pair
//   (kernels/flash_attention.py::q_tile_range and ::kv_tile_range at these
//   tiles) and masks only the tiles that the diagonal, the window's edge or
//   the end of T or S cut.  Causal walks launch a block a tile, longest
//   first: key tile 0 first in the dK/dV walk, the last q tile first in the
//   dQ walk.  Non-causal walks run on a persistent grid (one block an SM)
//   that takes its tiles in chunks of heads (flash_bwd.cuh's block_order),
//   so that a chunk's other side stays in L2 while its blocks run.
// * Arithmetic: S, dP and every sum in float32; P and dS rounded to bfloat16
//   (nearest even) for their products, as FlashAttention-2 and -3 do; dQ,
//   dK and dV rounded once, at the end.  exp2 is ex2.approx.ftz, as in the
//   forward.  Rows past T and keys past S read as zeros (TMA) and are
//   masked.
// Measured on NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's [kernel]
// flash_attention backward bfloat16 lines): 0.29 of the bound at
// qwen3-0.6b's training shape (1.20 ms), 0.26 at recurrentgemma-2b's hd-256
// window, 0.21-0.22 at seamless-m4t-medium's hd-64 encoder and cross
// attention; at qwen3-0.6b the dK/dV walk reaches 0.40 of its own 8*hd
// bound and the dQ walk 0.44 of its 6*hd one.
#include "flash_bwd.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 128;            // a warpgroup
constexpr int THREADS = 3 * WG_THREADS;    // the producer and two consumers
constexpr int WG_ROWS = 64;                // rows of a wgmma
constexpr int BQD = 2 * WG_ROWS;           // queries a dQ block
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

// The dK/dV walk: BK keys a block, BQ q rows a step, STAGES of Q and dO;
// SPLIT: the two consumers split the products over one 64-key tile, else
// each owns 64 of the block's keys.  The dQ walk: BKV keys a step,
// Q_STAGES of K and V.
template <int HD> struct BwdTile;
template <> struct BwdTile<64> {
  static constexpr int BK = 128, BQ = 128, STAGES = 4, BKV = 128, Q_STAGES = 2;
  static constexpr bool SPLIT = false;
};
template <> struct BwdTile<128> {
  static constexpr int BK = 128, BQ = 64, STAGES = 3, BKV = 64, Q_STAGES = 2;
  static constexpr bool SPLIT = false;
};
template <> struct BwdTile<256> {
  static constexpr int BK = 64, BQ = 64, STAGES = 2, BKV = 32, Q_STAGES = 2;
  static constexpr bool SPLIT = true;
};

// the dK/dV walk's shared memory: K and V (hd/64 boxes of BK rows each),
// the Q and dO rings (boxes of BQ rows), then P^T in float32 in the
// consumers' register order (SPLIT) or each consumer warp's two buffers of
// a step's lse * log2(e) and D, the mbarriers (K/V full; full and empty a
// stage)
template <int HD>
struct KvLayout {
  using Tile = BwdTile<HD>;
  static constexpr int BK = Tile::BK;
  static constexpr int BQ = Tile::BQ;
  static constexpr int STAGES = Tile::STAGES;
  static constexpr int BOXES = HD / BOX;
  static constexpr int K_BOX = BK * ROW_BYTES;
  static constexpr int KV_TILE = BOXES * K_BOX;
  static constexpr int Q_BOX = BQ * ROW_BYTES;
  static constexpr int Q_TILE = BOXES * Q_BOX;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_TILE;
  static constexpr int Q_OFF = 2 * KV_TILE;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_TILE;
  static constexpr int X_OFF = DO_OFF + STAGES * Q_TILE;
  static constexpr int X_BYTES =
      Tile::SPLIT ? BK * BQ * 4 : 2 * 4 * 2 * 2 * BQ * 4;
  static constexpr int BAR_OFF = X_OFF + X_BYTES;
  static constexpr int BARS = 2 + 2 * STAGES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 8 * BARS;
};

// the dQ walk's: Q and dO of the block (boxes of BQD rows), the K and V
// rings (boxes of BKV rows), the mbarriers (Q/dO full and empty; full and
// empty a stage)
template <int HD>
struct QLayout {
  static constexpr int BKV = BwdTile<HD>::BKV;
  static constexpr int STAGES = BwdTile<HD>::Q_STAGES;
  static constexpr int BOXES = HD / BOX;
  static constexpr int Q_BOX = BQD * ROW_BYTES;
  static constexpr int Q_TILE = BOXES * Q_BOX;
  static constexpr int KV_BOX = BKV * ROW_BYTES;
  static constexpr int KV_TILE = BOXES * KV_BOX;
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = Q_TILE;
  static constexpr int K_OFF = 2 * Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BARS = 2 + 2 * STAGES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 8 * BARS;
};

// d = A B^T over HD for 64 rows of A and N rows of B, both K-major tiles of
// hd/64 boxes (`a_box`, `b_box` bytes apart): hd/16 k-steps in order, the
// first setting d
template <int HD, int N>
__device__ __forceinline__ void ss_gemm(float (&d)[N / 2], uint32_t a,
                                        uint32_t a_box, uint32_t b,
                                        uint32_t b_box) {
  hold(d);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_ss<N>(d, desc(a + (ks / 4) * a_box + col, 16, 1024),
                desc(b + (ks / 4) * b_box + col, 16, 1024), ks > 0);
  }
  wg_commit();
  hold(d);
}

// d += R B: R (64 x K) the bfloat16 A fragments in registers, B the first
// K rows of an MN-major tile of hd/64 boxes `b_box` bytes apart; K/16
// k-steps in order
template <int HD, int K>
__device__ __forceinline__ void rs_gemm(float (&d)[HD / 2],
                                        uint32_t (&r)[K / 4], uint32_t b,
                                        uint32_t b_box) {
  hold(d);
  hold(r);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<HD>(d, r + 4 * kk, desc(b + kk * 16 * ROW_BYTES, b_box, 1024));
  wg_commit();
  hold(d);
  hold(r);
}

// A key tile's work in the dK/dV walk: its batch row, KV head and first
// key, and the live q tiles j_lo.. of each of the G query heads
// (kernels/flash_attention.py::q_tile_range); steps = G * nj
struct KvWork {
  int b, kvh, k0, j_lo, nj, steps;
};

template <int BK, int BQ, bool CAUSAL>
__device__ __forceinline__ KvWork kv_work(int tile, int B, int T, int S,
                                          int H, int KVH, int window,
                                          int grp) {
  KvWork w;
  int unit, kt;
  block_order(tile, B * KVH, (S + BK - 1) / BK, grp, unit, kt);
  w.b = unit / KVH;
  w.kvh = unit % KVH;
  w.k0 = kt * BK;
  const int nq = (T + BQ - 1) / BQ;
  const int k_last = min(w.k0 + BK, S) - 1;
  w.j_lo = 0;
  int j_hi = nq - 1;
  if (CAUSAL) w.j_lo = w.k0 <= T - 1 ? w.k0 / BQ : nq;
  if (window > 0) j_hi = min(j_hi, (k_last + window - 1) / BQ);
  w.nj = j_hi - w.j_lo + 1;
  w.steps = w.nj > 0 ? (H / KVH) * w.nj : 0;
  return w;
}

// A persistent grid: each block walks key tiles tile_index(k, block, grid),
// longest first.  The producer loads a tile's K and V as soon as both
// consumers are done with the last tile's (kv_empty), so the load runs
// behind their epilogue; the Q/dO ring runs on across tiles.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int T, int S,
           int H, int KVH, int window, float scale, int grp) {
  using L = KvLayout<HD>;
  constexpr int BK = L::BK;
  constexpr int BQ = L::BQ;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  float* xch = reinterpret_cast<float*>(sbase + L::X_OFF);
  const uint32_t kv_full = base + L::BAR_OFF;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8;           // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;
  const int n_tiles = ((S + BK - 1) / BK) * B * KVH;
  const int G = H / KVH;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);                    // one arrival a consumer
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t g = 0;                            // Q/dO steps loaded
      for (int i = 0;; ++i) {
        const int tile = tile_index(i, blockIdx.x, gridDim.x);
        if (tile >= n_tiles) break;
        const KvWork w = kv_work<BK, BQ, CAUSAL>(tile, B, T, S, H, KVH,
                                                 window, grp);
        auto load_step = [&](int s) {
          const int st = g % STAGES;
          const int h = w.kvh * G + s / w.nj;
          const int q0 = (w.j_lo + s % w.nj) * BQ;
          mbar_wait(empty + 8 * st, ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, 2 * L::Q_TILE);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load(base + L::Q_OFF + st * L::Q_TILE + x * L::Q_BOX, &tq,
                     full + 8 * st, x * BOX, h, q0, w.b);
            tma_load(base + L::DO_OFF + st * L::Q_TILE + x * L::Q_BOX, &tdo,
                     full + 8 * st, x * BOX, h, q0, w.b);
          }
          ++g;
        };
        // after a block's first tile, the tile's first steps go in behind
        // the last tile's, then its K and V once the consumers are done with
        // the last tile's
        const int pre = i == 0 ? 0 : w.steps < STAGES ? w.steps : STAGES;
        for (int s = 0; s < pre; ++s) load_step(s);
        mbar_wait(kv_empty, (i & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * L::KV_TILE);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load(base + L::K_OFF + x * L::K_BOX, &tk, kv_full, x * BOX,
                   w.kvh, w.k0, w.b);
          tma_load(base + L::V_OFF + x * L::K_BOX, &tv, kv_full, x * BOX,
                   w.kvh, w.k0, w.b);
        }
        for (int s = pre; s < w.steps; ++s) load_step(s);
      }
    }
  } else if (!L::Tile::SPLIT) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // each consumer owns 64 of the block's keys: S^T, dP^T, P^T, dS^T, dV
    // and dK
    constexpr int LOADS = 2 * BQ / 32;          // lse and D values a lane
    static_assert(LOADS * 32 == 2 * BQ, "lse and D over a warp's lanes");
    const int wg = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int g8 = (tid & 31) >> 2;
    const int t = tid & 3;
    const float scale_log2 = scale * LOG2E;
    const uint32_t ks = base + L::K_OFF + wg * WG_ROWS * ROW_BYTES;
    const uint32_t vs = base + L::V_OFF + wg * WG_ROWS * ROW_BYTES;
    float* bufs = xch + (wg * 4 + (tid >> 5)) * 4 * BQ;  // this warp's two
                                                 // steps' lse and D
    float dv_[HD / 2], dk_[HD / 2];
    float x[BQ / 2], y[BQ / 2];                  // S^T, P^T; dP^T, dS^T
    uint32_t ap[BQ / 4], ads[BQ / 4];            // P^T, dS^T in bfloat16
    int nc = 0;                                  // steps computed
    uint32_t g = 0;                              // Q/dO steps taken
    for (int i = 0;; ++i) {
      const int tile = tile_index(i, blockIdx.x, gridDim.x);
      if (tile >= n_tiles) break;
      const KvWork w = kv_work<BK, BQ, CAUSAL>(tile, B, T, S, H, KVH, window,
                                               grp);
      const int kw = w.k0 + WG_ROWS * wg;        // this consumer's first key
      const int key0 = kw + 16 * (tid >> 5) + g8;  // this lane's: key0, +8
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) dv_[e] = dk_[e] = 0.f;
      mbar_wait(kv_full, i & 1);
      for (int s = 0; s < w.steps; ++s, ++g) {
        const int st = g % STAGES;
        const int q0 = (w.j_lo + s % w.nj) * BQ;
        const uint32_t sq = base + L::Q_OFF + st * L::Q_TILE;
        const uint32_t sdo = base + L::DO_OFF + st * L::Q_TILE;
        const bool on_ = any_live<CAUSAL>(q0, q0 + BQ, kw, kw + WG_ROWS, T, S,
                                          window);
        // the step's lse * log2(e) and D (zeros past T), loaded ahead
        float ld[LOADS];
        const size_t row = ((size_t)w.b * H + w.kvh * G + s / w.nj) * T;
#pragma unroll
        for (int l = 0; l < LOADS; ++l) {
          const int c = (tid & 31) + 32 * l;       // lse: c < BQ, D after
          const int q = q0 + c % BQ;
          ld[l] = !on_ || q >= T ? 0.f
                  : c < BQ ? lse[row + q] * LOG2E : delta[row + q];
        }
        mbar_wait(full + 8 * st, (g / STAGES) & 1);
        if (on_) {
          // S^T and dP^T are never in flight together, and dS^T is formed
          // before dV's and dK's products start: with more in flight beside
          // dV and dK, ptxas serialises every wgmma (a WARPGROUP.DEPBAR
          // after each, seen in the SASS) and spills at hd 64
          ss_gemm<HD, BQ>(x, ks, L::K_BOX, sq, L::Q_BOX);   // S^T = K Q^T
          float* buf = bufs + (nc++ & 1) * 2 * BQ;
#pragma unroll
          for (int l = 0; l < LOADS; ++l) buf[(tid & 31) + 32 * l] = ld[l];
          __syncwarp();
          wg_wait<0>();
          hold(x);
          const bool whole = all_live<CAUSAL>(q0, q0 + BQ, kw, kw + WG_ROWS,
                                              T, S, window);
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {               // P^T
            const int cc = 8 * (e >> 2) + 2 * t + (e & 1);
            const float p = ex2(fmaf(x[e], scale_log2, -buf[cc]));
            x[e] = whole || live<CAUSAL>(q0 + cc, key0 + 8 * ((e >> 1) & 1),
                                         T, S, window)
                       ? p : 0.f;
          }
#pragma unroll
          for (int e = 0; e < BQ / 4; ++e)
            ap[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
          ss_gemm<HD, BQ>(y, vs, L::K_BOX, sdo, L::Q_BOX);  // dP^T = V dO^T
          wg_wait<0>();
          hold(y);
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {               // dS^T
            const int cc = 8 * (e >> 2) + 2 * t + (e & 1);
            y[e] = x[e] * (y[e] - buf[BQ + cc]);
          }
#pragma unroll
          for (int e = 0; e < BQ / 4; ++e)
            ads[e] = pack_bf16(y[2 * e], y[2 * e + 1]);
          rs_gemm<HD, BQ>(dv_, ap, sdo, L::Q_BOX);          // dV += P^T dO
          rs_gemm<HD, BQ>(dk_, ads, sq, L::Q_BOX);          // dK += dS^T Q
          wg_wait<0>();
          hold(dv_);
          hold(dk_);
        }
        if (tid == 0) mbar_arrive(empty + 8 * st);
      }
      if (tid == 0) mbar_arrive(kv_empty);       // K and V are read
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= S) continue;
        const size_t row =
            (((size_t)w.b * S + key) * KVH + w.kvh) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          *reinterpret_cast<uint32_t*>(dv + row + 8 * c) =
              pack_bf16(dv_[4 * c + 2 * r], dv_[4 * c + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dk + row + 8 * c) = pack_bf16(
              dk_[4 * c + 2 * r] * scale, dk_[4 * c + 2 * r + 1] * scale);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // SPLIT: consumer 0 forms S^T, P^T and dV, consumer 1 dP^T, dS^T and dK;
    // P^T goes from 0 to 1 through shared memory on named barrier 1, and
    // barrier 2 gives the buffer back (both run on across tiles)
    const int wg = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int g8 = (tid & 31) >> 2;
    const int t = tid & 3;
    const float scale_log2 = scale * LOG2E;
    const uint32_t own = base + (wg == 0 ? L::K_OFF : L::V_OFF);
    float acc[HD / 2];                         // dV or dK
    float x[BQ / 2];                           // S^T then P^T, or dP^T, dS^T
    uint32_t a[BQ / 4];                        // P^T or dS^T in bfloat16
    float cv[BQ / 4];       // this lane's columns' lse * log2(e), or D
    const float* rows = wg == 0 ? lse : delta;
    const float mul_ld = wg == 0 ? LOG2E : 1.f;
    float4* xp = reinterpret_cast<float4*>(xch) + tid;
    uint32_t g = 0;                            // Q/dO steps taken
    for (int i = 0;; ++i) {
      const int tile = tile_index(i, blockIdx.x, gridDim.x);
      if (tile >= n_tiles) break;
      const KvWork w = kv_work<BK, BQ, CAUSAL>(tile, B, T, S, H, KVH, window,
                                               grp);
      const int key0 = w.k0 + 16 * (tid >> 5) + g8;  // this lane's: key0, +8
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
      mbar_wait(kv_full, i & 1);
      for (int s = 0; s < w.steps; ++s, ++g) {
        const int st = g % STAGES;
        const int q0 = (w.j_lo + s % w.nj) * BQ;
        const uint32_t sq = base + L::Q_OFF + st * L::Q_TILE;
        const uint32_t sdo = base + L::DO_OFF + st * L::Q_TILE;
        const float* row = rows + ((size_t)w.b * H + w.kvh * G + s / w.nj) * T;
        mbar_wait(full + 8 * st, (g / STAGES) & 1);
        ss_gemm<HD, BQ>(x, own, L::K_BOX, wg == 0 ? sq : sdo, L::Q_BOX);
        // columns 8n + 2t + e of the step (zeros past T), while S^T or dP^T
        // is in flight
#pragma unroll
        for (int e = 0; e < BQ / 4; ++e) {
          const int c = q0 + 8 * (e >> 1) + 2 * t + (e & 1);
          cv[e] = c < T ? row[c] * mul_ld : 0.f;
        }
        wg_wait<0>();
        hold(x);
        if (wg == 0) {
          const bool whole = all_live<CAUSAL>(q0, q0 + BQ, w.k0, w.k0 + BK, T,
                                              S, window);
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {
            const int c = 8 * (e >> 2) + 2 * t + (e & 1);
            const bool on = whole || live<CAUSAL>(q0 + c,
                                                  key0 + 8 * ((e >> 1) & 1),
                                                  T, S, window);
            x[e] = on ? ex2(fmaf(x[e], scale_log2, -cv[2 * (e >> 2) + (e & 1)]))
                      : 0.f;
          }
          if (g > 0) bar_sync(2, 2 * WG_THREADS);  // consumer 1 has read
#pragma unroll
          for (int e = 0; e < BQ / 8; ++e)
            xp[e * WG_THREADS] =
                make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2], x[4 * e + 3]);
          bar_arrive(1, 2 * WG_THREADS);
        } else {
          bar_sync(1, 2 * WG_THREADS);             // P^T is there
#pragma unroll
          for (int e = 0; e < BQ / 8; ++e) {
            const float4 p = xp[e * WG_THREADS];
            const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int f = 0; f < 4; ++f) {
              const int j = 4 * e + f;
              x[j] = pe[f] * (x[j] - cv[2 * (j >> 2) + (j & 1)]);
            }
          }
          bar_arrive(2, 2 * WG_THREADS);
        }
#pragma unroll
        for (int e = 0; e < BQ / 4; ++e) a[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
        // dV += P^T dO, or dK += dS^T Q
        rs_gemm<HD, BQ>(acc, a, wg == 0 ? sdo : sq, L::Q_BOX);
        wg_wait<0>();
        hold(acc);
        if (tid == 0) mbar_arrive(empty + 8 * st);
      }
      if (tid == 0) mbar_arrive(kv_empty);     // K and V are read
      bf16* dst = wg == 0 ? dv : dk;
      const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= S) continue;
        bf16* out =
            dst + (((size_t)w.b * S + key) * KVH + w.kvh) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c)
          *reinterpret_cast<uint32_t*>(out + 8 * c) =
              pack_bf16(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
      }
    }
    if (wg == 0 && g > 0) bar_sync(2, 2 * WG_THREADS);  // the last give-back
  }
}

// A q tile's work in the dQ walk: its first row, batch row and query
// head, and its live KV tiles j_lo..j_lo + n - 1
// (kernels/flash_attention.py::kv_tile_range); causal q tiles longest first
struct QWork {
  int q0, b, h, j_lo, n;
};

template <int BKV, bool CAUSAL>
__device__ __forceinline__ QWork q_work(int tile, int B, int T, int S, int H,
                                        int window, int grp) {
  QWork w;
  const int nqt = (T + BQD - 1) / BQD;
  int unit, order;
  block_order(tile, B * H, nqt, grp, unit, order);
  w.b = unit / H;
  w.h = unit % H;
  w.q0 = (CAUSAL ? nqt - 1 - order : order) * BQD;
  const int q_last = min(w.q0 + BQD, T) - 1;
  w.j_lo = 0;
  if (window > 0 && w.q0 - window + 1 > 0) w.j_lo = (w.q0 - window + 1) / BKV;
  int j_hi = (S + BKV - 1) / BKV - 1;
  if (CAUSAL) j_hi = min(j_hi, q_last / BKV);
  w.n = j_hi - w.j_lo + 1;
  return w;
}

// As the dK/dV kernel: a block walks q tiles tile_index(k, block, grid)
// (one a block for causal walks); the producer loads a tile's Q and dO once
// both consumers are done with the last tile's (q_empty), behind the tile's
// first K/V stages.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int B, int T, int S, int H, int KVH,
          int window, float scale, int grp) {
  using L = QLayout<HD>;
  constexpr int BKV = L::BKV;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t q_empty = q_full + 8;
  const uint32_t full = q_empty + 8;            // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;
  const int n_tiles = ((T + BQD - 1) / BQD) * B * H;
  const int G = H / KVH;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);                     // one arrival a consumer
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < WG_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      uint32_t g = 0;                          // K/V steps loaded
      for (int i = 0;; ++i) {
        const int tile = tile_index(i, blockIdx.x, gridDim.x);
        if (tile >= n_tiles) break;
        const QWork w = q_work<BKV, CAUSAL>(tile, B, T, S, H, window, grp);
        const int kvh = w.h / G;
        auto load_step = [&](int it) {
          const int st = g % STAGES;
          const int kk0 = (w.j_lo + it) * BKV;
          mbar_wait(empty + 8 * st, ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * st, 2 * L::KV_TILE);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load(base + L::K_OFF + st * L::KV_TILE + x * L::KV_BOX, &tk,
                     full + 8 * st, x * BOX, kvh, kk0, w.b);
            tma_load(base + L::V_OFF + st * L::KV_TILE + x * L::KV_BOX, &tv,
                     full + 8 * st, x * BOX, kvh, kk0, w.b);
          }
          ++g;
        };
        const int pre = i == 0 ? 0 : w.n < STAGES ? w.n : STAGES;
        for (int it = 0; it < pre; ++it) load_step(it);
        mbar_wait(q_empty, (i & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::Q_TILE);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load(base + L::Q_OFF + x * L::Q_BOX, &tq, q_full, x * BOX, w.h,
                   w.q0, w.b);
          tma_load(base + L::DO_OFF + x * L::Q_BOX, &tdo, q_full, x * BOX,
                   w.h, w.q0, w.b);
        }
        for (int it = pre; it < w.n; ++it) load_step(it);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = threadIdx.x / WG_THREADS - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int t = tid & 3;
    const float scale_log2 = scale * LOG2E;
    const uint32_t sq = base + L::Q_OFF + wg * WG_ROWS * ROW_BYTES;
    const uint32_t sdo = base + L::DO_OFF + wg * WG_ROWS * ROW_BYTES;
    float acc[HD / 2];                         // dQ
    float s_[BKV / 2], dp[BKV / 2];
    uint32_t a[BKV / 4];                       // dS in bfloat16
    uint32_t g = 0;                            // K/V steps taken
    for (int i = 0;; ++i) {
      const int tile = tile_index(i, blockIdx.x, gridDim.x);
      if (tile >= n_tiles) break;
      const QWork w = q_work<BKV, CAUSAL>(tile, B, T, S, H, window, grp);
      const int qw = w.q0 + WG_ROWS * wg;      // this consumer's first row
      const int row0 = qw + 16 * (tid >> 5) + ((tid & 31) >> 2);
      float lse2[2], del[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const size_t j = ((size_t)w.b * H + w.h) * T + row;
        lse2[r] = row < T ? lse[j] * LOG2E : 0.f;
        del[r] = row < T ? delta[j] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
      mbar_wait(q_full, i & 1);
      for (int it = 0; it < w.n; ++it, ++g) {
        const int st = g % STAGES;
        const int kk0 = (w.j_lo + it) * BKV;
        const uint32_t sk = base + L::K_OFF + st * L::KV_TILE;
        const uint32_t sv = base + L::V_OFF + st * L::KV_TILE;
        mbar_wait(full + 8 * st, (g / STAGES) & 1);
        if (any_live<CAUSAL>(qw, qw + WG_ROWS, kk0, kk0 + BKV, T, S, window)) {
          ss_gemm<HD, BKV>(s_, sq, L::Q_BOX, sk, L::KV_BOX);   // S = Q K^T
          ss_gemm<HD, BKV>(dp, sdo, L::Q_BOX, sv, L::KV_BOX);  // dP = dO V^T
          wg_wait<1>();                        // S is in; P while dP runs
          hold(s_);
          const bool whole = all_live<CAUSAL>(qw, qw + WG_ROWS, kk0,
                                              kk0 + BKV, T, S, window);
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) {
            const int r = (e >> 1) & 1;
            const float p = ex2(fmaf(s_[e], scale_log2, -lse2[r]));
            s_[e] = whole || live<CAUSAL>(row0 + 8 * r,
                                          kk0 + 8 * (e >> 2) + 2 * t + (e & 1),
                                          T, S, window)
                        ? p : 0.f;
          }
          wg_wait<0>();
          hold(dp);
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e)
            dp[e] = s_[e] * (dp[e] - del[(e >> 1) & 1]);       // dS
#pragma unroll
          for (int e = 0; e < BKV / 4; ++e)
            a[e] = pack_bf16(dp[2 * e], dp[2 * e + 1]);
          rs_gemm<HD, BKV>(acc, a, sk, L::KV_BOX);             // dQ += dS K
          wg_wait<0>();
          hold(acc);
        }
        if (tid == 0) mbar_arrive(empty + 8 * st);
      }
      if (tid == 0) mbar_arrive(q_empty);      // Q and dO are read
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= T) continue;
        bf16* out = dq + (((size_t)w.b * T + row) * H + w.h) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c)
          *reinterpret_cast<uint32_t*>(out + 8 * c) = pack_bf16(
              acc[4 * c + 2 * r] * scale, acc[4 * c + 2 * r + 1] * scale);
      }
    }
  }
}

template <int HD, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int T, int S, int H, int KVH,
           int window, float scale, cudaStream_t stream) {
  using T_ = BwdTile<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the dK/dV walk's maps (q and dO in boxes of BQ rows, k and v of BK)
  // and the dQ walk's (q and dO of 128 rows, k and v of BKV)
  CUtensorMap kq, kdo, kk, kv, qq, qdo, qk, qv;
  if (!make_map(&kq, encode, q, B, T, H, HD, T_::BQ) ||
      !make_map(&kdo, encode, dout, B, T, H, HD, T_::BQ) ||
      !make_map(&kk, encode, k, B, S, KVH, HD, T_::BK) ||
      !make_map(&kv, encode, v, B, S, KVH, HD, T_::BK) ||
      !make_map(&qq, encode, q, B, T, H, HD, BQD) ||
      !make_map(&qdo, encode, dout, B, T, H, HD, BQD) ||
      !make_map(&qk, encode, k, B, S, KVH, HD, T_::BKV) ||
      !make_map(&qv, encode, v, B, S, KVH, HD, T_::BKV))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * T * H;
  delta_kernel<bf16, HD><<<DeltaShape<bf16, HD>::blocks(rows), 256, 0,
                            stream>>>(
      (const bf16*)out, (const bf16*)dout, delta, rows, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int kv_smem = KvLayout<HD>::SMEM_BYTES;
  err = cudaFuncSetAttribute(dkv_kernel<HD, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return (int)err;
  // non-causal: persistent, one block an SM walks the key tiles in chunks
  // of heads (block_order); causal: a block a tile, all longest first (the
  // hardware's block scheduler balances their unequal walks better than
  // rounds of a persistent grid: measured at qwen3-0.6b's shape)
  const int k_tiles = (S + T_::BK - 1) / T_::BK;
  const int kv_tiles = k_tiles * B * KVH;
  dkv_kernel<HD, CAUSAL><<<CAUSAL || kv_tiles < sms ? kv_tiles : sms,
                           THREADS, kv_smem, stream>>>(
      kq, kdo, kk, kv, lse, delta, dk, dv, B, T, S, H, KVH, window, scale,
      CAUSAL ? B * KVH : chunk_units(sms, k_tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int q_smem = QLayout<HD>::SMEM_BYTES;
  err = cudaFuncSetAttribute(dq_kernel<HD, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return (int)err;
  // as the dK/dV walk: persistent where non-causal
  const int q_tiles = ((T + BQD - 1) / BQD) * B * H;
  dq_kernel<HD, CAUSAL><<<CAUSAL || q_tiles < sms ? q_tiles : sms, THREADS,
                          q_smem, stream>>>(
      qq, qdo, qk, qv, lse, delta, dq, B, T, S, H, KVH, window, scale,
      CAUSAL ? B * H : chunk_units(sms, (T + BQD - 1) / BQD));
  return (int)cudaGetLastError();
}

}  // namespace

// q, dq (B, T, H, hd), k, v, dk, dv (B, S, KVH, hd), out and dout like q,
// all bfloat16, contiguous and 16-byte aligned; lse (B, H, T) float32 from
// the forward; delta (B, H, T) float32 scratch.  causal != 0 masks keys
// after the query; window <= 0 means no window; scale 1/sqrt(head_dim) of
// the unpadded head dim.  head_dim must be 64, 128 or 256 (the wrapper
// zero-pads smaller ones); returns cudaErrorInvalidValue for another.
extern "C" int flash_attention_backward_launch_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int T, int S, int H, int KVH, int hd, int causal,
    int window, float scale, void* stream) {
#define ARGS                                                             \
  q, k, v, out, dout, (const float*)lse, (float*)delta, (bf16*)dq,       \
      (bf16*)dk, (bf16*)dv, B, T, S, H, KVH, window, scale,              \
      (cudaStream_t)stream
#define CASE(HD)                                                         \
  case HD:                                                               \
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
