// Linear recurrence h_t = a_t * h_{t-1} + b_t along T, for Hopper, and its
// gradient (lru_scan_backward_kernel, below the forward).
//
// Replaces the TPU kernel of src/repro/kernels/lru_scan.py: _lru_kernel
// (entry lru_scan), which walks the sequence in chunks along a sequential
// grid axis and carries h from chunk to chunk in VMEM scratch.
//
// What bounds it on the H100: bytes.  Each element reads a and b and writes
// h (12 bytes) and does one multiply and one add, 1/6 operation per byte,
// far below the ridge of 67e12 / 3.35e12 = 20 float32 operations per byte.
// At recurrentgemma-2b's prefill shape (B=4, T=4096, W=2560) that is 503 MB,
// about 0.150 ms at 3.35 TB/s.  The dependent chain of one channel, 4096
// steps of a multiply and an add, takes about 20 us, far under that, so the
// time is set by how many bytes are in flight: Little's law at 3.35 TB/s
// and about 1 us of latency asks for some 3 MB on the card, 25 KB an SM.
//
// Design: Hopper runs blocks in no order, so nothing can carry h from one
// block to the next, and splitting T into chunks scanned in parallel and
// then fixed up (a two-pass scan) would reorder the products and lose the
// bit-for-bit agreement with the plain version.  So each channel's chain
// stays in one thread, in order, and the kernel fills the memory pipe with
// more, smaller blocks and a deep ring instead:
// * one warp a block, one channel a lane: 32 neighbouring channels of one
//   batch row (one 128-byte line of a, b and h per step), ceil(W / 32) * B
//   blocks (320 at the shape above, all resident at once);
// * each lane streams its channel's a and b through a shared-memory ring of
//   STAGES chunks of CHUNK steps with cp.async, STAGES - 1 chunks ahead of
//   the step it computes: 24 KB of loads in flight a warp, 58 KB an SM at
//   the shape above, without a register held for them;
// * each step's h is stored at once, a coalesced 128-byte line a warp.
// A lane reads back only what it copied itself, so the ring needs no
// barrier: cp.async.wait_group orders a lane's own copies.  Lanes past W
// return at once; the ragged last chunk of T is cut.
//
// The multiply and the add round separately (__fmul_rn, __fadd_rn, and the
// build's --fmad=false), as the plain PyTorch version's multiply and add do,
// so the two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int CHUNK = 32;     // time steps a ring stage holds
constexpr int STAGES = 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(LANES)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ h_seq,
                float* __restrict__ h_last, int T, int W) {
  __shared__ float ra[STAGES][CHUNK][LANES];
  __shared__ float rb[STAGES][CHUNK][LANES];
  const int lane = threadIdx.x;
  const int w = blockIdx.x * LANES + lane;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)bi * T * W + w;
  const int nchunks = (T + CHUNK - 1) / CHUNK;

  // chunk c into stage c % STAGES: this lane's a and b at steps c*CHUNK..
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int st = c % STAGES;
      const int t0 = c * CHUNK;
      const int n = min(CHUNK, T - t0);
      for (int u = 0; u < n; ++u) {
        const size_t at = base + (size_t)(t0 + u) * W;
        cp_async4(&ra[st][u][lane], a + at);
        cp_async4(&rb[st][u][lane], b + at);
      }
    }
    cp_async_commit();     // an empty group past the end keeps the count
  };

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  float h = h0[(size_t)bi * W + w];
  for (int c = 0; c < nchunks; ++c) {
    issue(c + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // chunk c has landed
    const int st = c % STAGES;
    const int t0 = c * CHUNK;
    const int n = min(CHUNK, T - t0);
    float* out = h_seq + base + (size_t)t0 * W;
    if (n == CHUNK) {
#pragma unroll 8
      for (int u = 0; u < CHUNK; ++u) {
        h = __fadd_rn(__fmul_rn(ra[st][u][lane], h), rb[st][u][lane]);
        out[(size_t)u * W] = h;
      }
    } else {
      for (int u = 0; u < n; ++u) {
        h = __fadd_rn(__fmul_rn(ra[st][u][lane], h), rb[st][u][lane]);
        out[(size_t)u * W] = h;
      }
    }
  }
  h_last[(size_t)bi * W + w] = h;
}

// The gradient of the scan (no TPU kernel stands behind it: JAX gets it by
// autodiff of _linear_scan_chunked, src/repro/models/layers.py).  With
// g_t = dL/dh_t through the whole chain:
//   g_{T-1} = dh_seq_{T-1} + dh_last,  g_t = dh_seq_t + a_{t+1} g_{t+1},
//   db_t = g_t,  da_t = g_t h_{t-1} (h_{-1} = h0),  dh0 = a_0 g_0.
// One lane a channel walks T in reverse, carrying c = a_{t+1} g_{t+1}.
// Bound by bytes as the forward is: a, dh_seq and h_{t-1} read, da and db
// written, 20 bytes and 3 operations an element.  It streams its three
// inputs through the forward's cp.async ring run backwards (the last chunk,
// ragged or not, first); three inputs a step make BSTAGES = 3 (36 KB of
// shared memory a block), which keeps the forward's 24 KB of loads in
// flight a warp.  The separate multiply and add match
// lru_scan_backward_plain's order bit for bit.
constexpr int BSTAGES = 3;

__global__ void __launch_bounds__(LANES)
lru_scan_backward_kernel(const float* __restrict__ a,
                         const float* __restrict__ h0,
                         const float* __restrict__ h_seq,
                         const float* __restrict__ dh_seq,
                         const float* __restrict__ dh_last,
                         float* __restrict__ da, float* __restrict__ db,
                         float* __restrict__ dh0, int T, int W) {
  __shared__ float ra[BSTAGES][CHUNK][LANES];
  __shared__ float rg[BSTAGES][CHUNK][LANES];   // dh_seq_t
  __shared__ float rh[BSTAGES][CHUNK][LANES];   // h_{t-1}
  const int lane = threadIdx.x;
  const int w = blockIdx.x * LANES + lane;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const size_t row = (size_t)bi * W + w;
  const size_t base = (size_t)bi * T * W + w;
  const int nchunks = (T + CHUNK - 1) / CHUNK;

  // the k-th chunk from the end (chunk nchunks - 1 - k) into stage k % BSTAGES
  auto fetch = [&](int k) {
    if (k < nchunks) {
      const int st = k % BSTAGES;
      const int t0 = (nchunks - 1 - k) * CHUNK;
      const int n = min(CHUNK, T - t0);
      for (int u = 0; u < n; ++u) {
        const size_t at = base + (size_t)(t0 + u) * W;
        cp_async4(&ra[st][u][lane], a + at);
        cp_async4(&rg[st][u][lane], dh_seq + at);
        cp_async4(&rh[st][u][lane], t0 + u == 0 ? h0 + row : h_seq + at - W);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < BSTAGES - 1; ++k) fetch(k);
  float c = dh_last[row];
  for (int k = 0; k < nchunks; ++k) {
    fetch(k + BSTAGES - 1);
    cp_async_wait<BSTAGES - 1>();
    const int st = k % BSTAGES;
    const int t0 = (nchunks - 1 - k) * CHUNK;
    const int n = min(CHUNK, T - t0);
    float* pda = da + base + (size_t)t0 * W;
    float* pdb = db + base + (size_t)t0 * W;
    for (int u = n - 1; u >= 0; --u) {
      const float g = __fadd_rn(rg[st][u][lane], c);
      pdb[(size_t)u * W] = g;
      pda[(size_t)u * W] = __fmul_rn(g, rh[st][u][lane]);
      c = __fmul_rn(ra[st][u][lane], g);
    }
  }
  dh0[row] = c;
}

}  // namespace

extern "C" int lru_scan_backward_launch(const void* a, const void* h0,
                                        const void* h_seq, const void* dh_seq,
                                        const void* dh_last, void* da,
                                        void* db, void* dh0, int B, int T,
                                        int W, void* stream) {
  dim3 grid((W + LANES - 1) / LANES, B);
  lru_scan_backward_kernel<<<grid, LANES, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h0, (const float*)h_seq,
      (const float*)dh_seq, (const float*)dh_last, (float*)da, (float*)db,
      (float*)dh0, T, W);
  return (int)cudaGetLastError();
}

extern "C" int lru_scan_launch(const void* a, const void* b, const void* h0,
                               void* h_seq, void* h_last, int B, int T, int W,
                               void* stream) {
  dim3 grid((W + LANES - 1) / LANES, B);
  lru_scan_kernel<<<grid, LANES, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h_seq,
      (float*)h_last, T, W);
  return (int)cudaGetLastError();
}
