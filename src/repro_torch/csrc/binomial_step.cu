// Blocked binomial backward induction (friction-free lattice) for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/binomial_step.py:
// _round_kernel_param (payoff as 11 scalars, entry lattice_round_param) and
// _round_kernel (put/call baked in, 6 scalars, entry lattice_round).
//
// What bounds it on the H100: float64 operations.  A round reads each node
// value about twice (its block and, as halo, the block to its left) and
// writes it once, and does ~levels * 14-22 float64 operations per node (one
// exp per node and level among them).  At levels = 50 that is about
// 50 * 22 / 16 B ~ 69 flop/B, above the H100's 34e12 / 3.35e12 ~ 10 flop/B
// ridge for float64 outside the tensor cores, so the round is bound by
// operations, not by memory; the exp costs tens of instructions where the
// count above takes one, and each CTA also steps its halo block, so the
// kernel runs well above that bound.
//
// Design: grid (nblk, rows); one CTA stages its block plus the clamped right
// halo (2*block lanes) in shared memory, runs `levels` steps with
// __syncthreads() between them, double-buffering so that lane i reads the
// old v[i+1], and writes its owned `block` lanes back.  Lane 2*block-1 reads
// lane 0 (the TPU kernel's wrapping roll); that lane is stale halo and never
// reaches an owned lane while levels <= block.  The simple design pays one
// HBM round trip per round, as the TPU kernel does.
//
// Built with --fmad=false so that the arithmetic rounds as the plain
// PyTorch version's separate multiplies and adds do.
#include <cuda_runtime.h>

namespace {

template <int KIND>  // 0: 4-parameter payoff, 1: put, 2: call
__global__ void lattice_round_kernel(const double* __restrict__ v,
                                     const double* __restrict__ scalars,
                                     double* __restrict__ out,
                                     int P, int block, int levels,
                                     int n_scalars) {
  extern __shared__ double smem[];
  double* buf0 = smem;
  double* buf1 = smem + 2 * block;
  const int blk = blockIdx.x;
  const int row = blockIdx.y;
  const int nblk = P / block;
  const int nxt = blk + 1 < nblk ? blk + 1 : nblk - 1;
  const double* vr = v + (size_t)row * P;
  const double* sc = scalars + (size_t)row * n_scalars;

  double lvl0, p_up, inv_r, s0, sig;
  double alpha = 0, zeta = 0, w1 = 0, w2 = 0, k1 = 0, k2 = 0, strike = 0;
  lvl0 = sc[0]; p_up = sc[1]; inv_r = sc[2];
  if (KIND == 0) {
    s0 = sc[3]; sig = sc[4];
    alpha = sc[5]; zeta = sc[6]; w1 = sc[7]; w2 = sc[8]; k1 = sc[9]; k2 = sc[10];
  } else {
    strike = sc[3]; s0 = sc[4]; sig = sc[5];
  }
  const double q = 1.0 - p_up;
  const int W = 2 * block;

  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    buf0[i] = i < block ? vr[(size_t)blk * block + i]
                        : vr[(size_t)nxt * block + (i - block)];
  }
  __syncthreads();

  double* cur = buf0;
  double* nw = buf1;
  for (int j = 0; j < levels; ++j) {
    const double lvl = lvl0 - (double)(j + 1);
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const double vi = cur[i];
      double res = vi;
      if (lvl >= 0.0) {
        const double up = cur[i + 1 < W ? i + 1 : 0];
        const double cont = (p_up * up + q * vi) * inv_r;
        const double idx = (double)blk * (double)block + (double)i;
        const double s = s0 * exp((2.0 * idx - lvl) * sig);
        double pay;
        if (KIND == 1) {
          pay = fmax(strike - s, 0.0);
        } else if (KIND == 2) {
          pay = fmax(s - strike, 0.0);
        } else {
          pay = alpha * k1 + w1 * fmax(s - k1, 0.0) + w2 * fmax(s - k2, 0.0)
                + zeta * s;
          pay = fmax(pay, 0.0);
        }
        res = fmax(pay, cont);
      }
      nw[i] = res;
    }
    __syncthreads();
    double* t = cur; cur = nw; nw = t;
  }
  double* outr = out + (size_t)row * P + (size_t)blk * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) outr[i] = cur[i];
}

}  // namespace

extern "C" int lattice_round_launch(const void* v, const void* scalars,
                                    void* out, int rows, int P, int block,
                                    int levels, int kind, void* stream) {
  const int nblk = P / block;
  dim3 grid(nblk, rows);
  const int threads = block < 256 ? ((block + 31) / 32) * 32 : 256;
  const size_t shmem = 4 * (size_t)block * sizeof(double);
  cudaStream_t st = (cudaStream_t)stream;
  const double* vp = (const double*)v;
  const double* sp = (const double*)scalars;
  double* op = (double*)out;
  if (kind == 0)
    lattice_round_kernel<0><<<grid, threads, shmem, st>>>(vp, sp, op, P, block, levels, 11);
  else if (kind == 1)
    lattice_round_kernel<1><<<grid, threads, shmem, st>>>(vp, sp, op, P, block, levels, 6);
  else
    lattice_round_kernel<2><<<grid, threads, shmem, st>>>(vp, sp, op, P, block, levels, 6);
  return (int)cudaGetLastError();
}
