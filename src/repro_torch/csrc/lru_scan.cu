// Linear recurrence h_t = a_t * h_{t-1} + b_t along T, for Hopper.
//
// Replaces the TPU kernel of src/repro/kernels/lru_scan.py: _lru_kernel
// (entry lru_scan), which walks the sequence in chunks along a sequential
// grid axis and carries h from chunk to chunk in VMEM scratch.
//
// What bounds it on the H100: bytes.  Each element reads a and b and writes
// h (12 bytes) and does one multiply and one add, 1/6 operation per byte,
// far below the ridge of 67e12 / 3.35e12 = 20 float32 operations per byte.
// At recurrentgemma-2b's prefill shape (B=4, T=4096, W=2560) that is 503 MB,
// about 0.150 ms at 3.35 TB/s.
//
// Design: Hopper runs blocks in no order, so nothing can carry h from one
// block to the next.  The time loop sits inside the thread instead: one
// thread per (b, w) channel holds h in a register and walks all T steps.
// Neighbouring threads own neighbouring w, so every load and store of a
// warp is one contiguous 128-byte line.  The loop reads UNROLL steps of a
// and b into registers before it computes them, so that the loads of a
// thread are in flight together and not one dependent step at a time.
// There are only B * W threads (10,240 at the shape above, 160 blocks of 64
// on 132 SMs), too few to hide the memory's latency: the kernel is bound by
// latency, not bandwidth.  A chunked two-pass scan (chunk-local scans in
// parallel, then a carry pass) would fill the card.
//
// Built with --fmad=false: h = a*h + b rounds the product and the sum
// separately, as the plain PyTorch version's multiply and add do, so the
// two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 16;

__global__ void lru_scan_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ h0,
                                float* __restrict__ h_seq,
                                float* __restrict__ h_last,
                                int T, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)bi * T * W + w;
  float h = h0[(size_t)bi * W + w];
  int t = 0;
  for (; t + UNROLL <= T; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = a[base + (size_t)(t + u) * W];
      bv[u] = b[base + (size_t)(t + u) * W];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = av[u] * h + bv[u];
      h_seq[base + (size_t)(t + u) * W] = h;
    }
  }
  for (; t < T; ++t) {
    h = a[base + (size_t)t * W] * h + b[base + (size_t)t * W];
    h_seq[base + (size_t)t * W] = h;
  }
  h_last[(size_t)bi * W + w] = h;
}

}  // namespace

extern "C" int lru_scan_launch(const void* a, const void* b, const void* h0,
                               void* h_seq, void* h_last, int B, int T, int W,
                               void* stream) {
  const int threads = 64;
  dim3 grid((W + threads - 1) / threads, B);
  lru_scan_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)h_seq,
      (float*)h_last, T, W);
  return (int)cudaGetLastError();
}
