// Blocked Roux–Zastawniak PWL rounds (transaction costs) for Hopper.
//
// Replaces the TPU kernel _rz_round_kernel of src/repro/kernels/rz_step.py
// (entry rz_round).  One launch advances every block of PWL lanes `levels`
// levels toward the root; per level and lane the fused seller/buyer step of
// core/rz.py::rz_level_step_lanes:
//
//   w = envelope2(z[i+1], z[i], max);  w = w / r
//   v = cone_infconv(w, (1+k) s, (1-k) s)               (no costs at level 0)
//   z = envelope2(expense(+-xi, +-zeta), v, max for the seller, min for the buyer)
//
// What bounds it on the H100: float64 operations, and branches.  A lane step
// does a few thousand f64 operations (binary searches, merges, crossings,
// compaction) on knot lists whose length differs lane to lane, so warps
// diverge; the bytes per lane step (two input records and one output
// record of K knots) are small beside that work.
//
// Design (simple and correct first):
// * one thread per (row, side, lane) item of a level; the grid is
//   (nblk, rows) and a CTA's threads loop over its S * W items, with
//   __syncthreads() between levels;
// * PWL state stays in global memory, double-buffered per level in a
//   per-CTA scratch area: a record of K = 48 knots is 768 bytes, so a
//   1502-lane level does not fit in 227 KB of shared memory;
// * a multi-block round stages its block and the clamped right neighbour
//   (W = 2 * block lanes) and writes back only the owned `block` lanes, so
//   stale halo lanes are never written out; lane W-1 reads lane 0, the TPU
//   kernel's wrapping roll;
// * each thread keeps its merge scratch (about 20 K doubles) in local
//   memory, and every loop runs over the valid knots only (padding knots
//   at +BIG never change a result);
// * the per-block max raw knot count over owned live lanes goes to
//   pieces[row, blk]; the wrapper reduces it.
//
// The arithmetic repeats the plain PyTorch version operation for
// operation.  It is built with --fmad=false: knot retention in compress
// and the crossings in the envelope and cone are threshold tests at a
// relative 1e-9, and a contracted multiply-add would round differently
// and could change a knot count, and with it max_pieces.
#include <cuda_runtime.h>

namespace {

constexpr double BIG = 1e30;
constexpr double REL = 1e-9;
constexpr double TINY = 1e-300;
constexpr int THREADS = 256;

struct View {          // a PWL whose first m knots are valid
  const double* xs;
  const double* ys;
  double sl, sr;
  int m;
};

struct Out {           // a PWL record of capacity K to write
  double* xs;
  double* ys;
  double sl, sr;
  int m;
};

// count of a[i] <= v (right) or a[i] < v (left) in ascending a[0..n)
__device__ __forceinline__ int ss_right(const double* a, int n, double v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int ss_left(const double* a, int n, double v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ double eval1(const View& f, double c) {
  const int cnt = ss_right(f.xs, f.m, c);
  if (cnt == 0) return f.ys[0] + f.sl * (c - f.xs[0]);
  if (cnt >= f.m) {
    const int il = f.m - 1;
    return f.ys[il] + f.sr * (c - f.xs[il]);
  }
  const int il = cnt - 1, ir = cnt;
  const double w = f.xs[ir] - f.xs[il];
  const bool ok = w > TINY;
  const double slope = (ok ? f.ys[ir] - f.ys[il] : 0.0) / (ok ? w : 1.0);
  return f.ys[il] + slope * (c - f.xs[il]);
}

// Dedupe, drop collinear knots and truncate the candidate list
// (cx, cy)[0..nc) -- entries at or beyond BIG/2 are invalid -- into `o`
// (capacity cap).  Compacts survivors in place.  Returns the raw count.
__device__ int compress(double* cx, double* cy, int nc, double sl, double sr,
                        int cap, Out& o) {
  int ns = 0;
  double prev_x = -BIG;
  bool prev_valid = false;
  for (int t = 0; t < nc; ++t) {
    const double x = cx[t];
    const bool valid = x < BIG / 2;
    const double y = valid ? cy[t] : 0.0;
    const bool dup = valid && prev_valid &&
                     (x - prev_x <= REL * (1.0 + fabs(prev_x)));
    if (valid && !dup) { cx[ns] = x; cy[ns] = y; ++ns; }
    prev_x = x;
    prev_valid = valid;
  }
  int m2 = 0;
  for (int q = 0; q < ns; ++q) {
    const double x = cx[q], y = cy[q];
    const double s_right = q < ns - 1
        ? (cy[q + 1] - y) / fmax(cx[q + 1] - x, TINY) : sr;
    const double s_left = q > 0
        ? (y - cy[q - 1]) / fmax(x - cx[q - 1], TINY) : sl;
    const double tol = REL * (1.0 + fmax(fabs(s_left), fabs(s_right)));
    if (fabs(s_right - s_left) > tol) {
      if (m2 < cap) { o.xs[m2] = x; o.ys[m2] = y; }
      ++m2;
    }
  }
  if (m2 == 0 && ns > 0) { o.xs[0] = cx[0]; o.ys[0] = cy[0]; m2 = 1; }
  for (int t = m2 < cap ? m2 : cap; t < cap; ++t) { o.xs[t] = BIG; o.ys[t] = 0.0; }
  o.sl = sl;
  o.sr = sr;
  o.m = m2 < cap ? m2 : cap;
  return m2;
}

// Envelope of f and g given the merged grid mx[0..mv) holding every valid
// knot of both and their values mvf / mvg on it.
__device__ int envelope_core(const View& f, const View& g, const double* mx,
                             const double* mvf, const double* mvg, int mv,
                             bool take_max, int cap, Out& o,
                             double* cx, double* cy) {
  int nc = 0;
  for (int i = 0; i <= mv; ++i) {
    const double lo = i == 0 ? -BIG : mx[i - 1];
    const double hi = i >= mv ? BIG : mx[i];
    double sf, sg;
    if (i >= mv) {
      sf = f.sr; sg = g.sr;
    } else if (i == 0) {
      sf = f.sl; sg = g.sl;
    } else {
      const double dx = mx[i] - mx[i - 1];
      const bool ok_dx = dx > TINY;
      const double inv_dx = 1.0 / (ok_dx ? dx : 1.0);
      sf = (ok_dx ? mvf[i] - mvf[i - 1] : 0.0) * inv_dx;
      sg = (ok_dx ? mvg[i] - mvg[i - 1] : 0.0) * inv_dx;
    }
    const double denom = sf - sg;
    const bool parallel = fabs(denom) <= REL * (1.0 + fmax(fabs(sf), fabs(sg)));
    const int ai = i > 0 ? i - 1 : 0;
    const double ax = mx[ai], avf = mvf[ai], avg = mvg[ai];
    const double x_cross = ax + (avg - avf) / (parallel ? 1.0 : denom);
    const double margin = REL * (1.0 + fabs(x_cross));
    if (!parallel && x_cross > lo + margin && x_cross < hi - margin) {
      cx[nc] = x_cross;
      cy[nc] = avf + sf * (x_cross - ax);
      ++nc;
    }
    if (i < mv) {
      cx[nc] = mx[i];
      cy[nc] = take_max ? fmax(mvf[i], mvg[i]) : fmin(mvf[i], mvg[i]);
      ++nc;
    }
  }
  int nvc = 0;
  for (int t = 0; t < nc; ++t) nvc += cx[t] < BIG / 2;
  const double pl = (nc > 0 ? cx[0] : BIG) - 1.0;
  const int ip = nvc > 0 ? nvc - 1 : 0;
  const double pr = (ip < nc ? cx[ip] : BIG) + 1.0;
  const double fl = eval1(f, pl), fr = eval1(f, pr);
  const double gl = eval1(g, pl), gr = eval1(g, pr);
  const bool tie_l = fabs(fl - gl) <= REL * (1.0 + fmax(fabs(fl), fabs(gl)));
  const bool tie_r = fabs(fr - gr) <= REL * (1.0 + fmax(fabs(fr), fabs(gr)));
  double sl, sr;
  if (take_max) {
    sl = tie_l ? fmin(f.sl, g.sl) : (fl > gl ? f.sl : g.sl);
    sr = tie_r ? fmax(f.sr, g.sr) : (fr > gr ? f.sr : g.sr);
  } else {
    sl = tie_l ? fmax(f.sl, g.sl) : (fl < gl ? f.sl : g.sl);
    sr = tie_r ? fmin(f.sr, g.sr) : (fr < gr ? f.sr : g.sr);
  }
  return compress(cx, cy, nc, sl, sr, cap, o);
}

// Pointwise max/min of f and g: stable merge of the valid knots (f first
// on ties) with each function's values riding along.
__device__ int envelope2(const View& f, const View& g, bool take_max, int cap,
                         Out& o, double* mx, double* mvf, double* mvg,
                         double* cx, double* cy) {
  int i = 0, j = 0, t = 0;
  while (i < f.m || j < g.m) {
    const bool take_f = j >= g.m || (i < f.m && !(g.xs[j] < f.xs[i]));
    if (take_f) {
      mx[t] = f.xs[i]; mvf[t] = f.ys[i]; mvg[t] = eval1(g, f.xs[i]); ++i;
    } else {
      mx[t] = g.xs[j]; mvf[t] = eval1(f, g.xs[j]); mvg[t] = g.ys[j]; ++j;
    }
    ++t;
  }
  return envelope_core(f, g, mx, mvf, mvg, f.m + g.m, take_max, cap, o, cx, cy);
}

// Slope restriction v = min(f, lower envelope of the cost cones).
__device__ int cone(const View& f, double a, double b, int cap, Out& o,
                    double* SA, double* PB, double* mx, double* mvf,
                    double* mvg, double* cx, double* cy) {
  const int m = f.m;
  double run = BIG;
  for (int j = m - 1; j >= 0; --j) {
    run = fmin(run, f.ys[j] + a * f.xs[j]);
    SA[j] = run;
  }
  run = BIG;
  for (int j = 0; j < m; ++j) {
    run = fmin(run, f.ys[j] + b * f.xs[j]);
    PB[j] = run;
  }
  const double denom = a - b;
  const bool par = fabs(denom) <= REL * (1.0 + fabs(a));
  int ne = 0;
  for (int j = 0; j < m; ++j) {
    mx[ne++] = f.xs[j];
    if (j + 1 < m) {
      const double nxt_x = f.xs[j + 1], nxt_SA = SA[j + 1];
      const double ystar = (nxt_SA - PB[j]) / (par ? 1.0 : denom);
      const double margin = REL * (1.0 + fabs(ystar));
      if (!par && nxt_SA < BIG / 2 && PB[j] < BIG / 2 &&
          ystar > f.xs[j] + margin && ystar < nxt_x - margin)
        mx[ne++] = ystar;
    }
  }
  for (int t = 0; t < ne; ++t) {
    const double c = mx[t];
    double env = 0.0;
    if (c < BIG / 2) {
      const int ge = ss_left(f.xs, m, c);
      const int le = ss_right(f.xs, m, c);
      const double SA_at = ge < m ? SA[ge] : BIG;
      const double PB_at = le > 0 ? PB[le - 1] : BIG;
      env = fmin(SA_at < BIG / 2 ? -a * c + SA_at : BIG,
                 PB_at < BIG / 2 ? -b * c + PB_at : BIG);
    }
    mvg[t] = env;
    mvf[t] = eval1(f, c);
  }
  View env{mx, mvg, -a, -b, ne};
  return envelope_core(f, env, mx, mvf, mvg, ne, false, cap, o, cx, cy);
}

struct Buf {           // one ping-pong buffer: S * W records
  double* xs; double* ys; double* sl; double* sr; int* m;
};

template <int KM>
__global__ void __launch_bounds__(THREADS)
rz_round_kernel(const double* __restrict__ xs_in, const double* __restrict__ ys_in,
                const double* __restrict__ sl_in, const double* __restrict__ sr_in,
                const int* __restrict__ m_in, const double* __restrict__ scalars,
                double* xs_out, double* ys_out, double* sl_out, double* sr_out,
                int* m_out, int* pieces_out,
                double* sxs, double* sys, double* ssl, double* ssr, int* sm,
                int S, int lanes, int K, int block, int levels,
                unsigned seller_mask) {
  const int blk = blockIdx.x, row = blockIdx.y, nblk = gridDim.x;
  const int W = nblk > 1 ? 2 * block : block;
  const int nxt = blk + 1 < nblk ? blk + 1 : nblk - 1;
  const int items = S * W;
  __shared__ int blk_pieces;
  if (threadIdx.x == 0) blk_pieces = 0;

  const double* sc = scalars + (size_t)row * 11;
  const double lvl0 = sc[0], s0 = sc[1], sig = sc[2], r = sc[3], k = sc[4];
  const double alpha = sc[5], zeta = sc[6], w1 = sc[7], w2 = sc[8];
  const double k1 = sc[9], k2 = sc[10];
  const double inv_r = 1.0 / r;
  const double offset = (double)blk * (double)block;

  Buf buf[2];
  for (int p = 0; p < 2; ++p) {
    const size_t rec = (((size_t)row * nblk + blk) * 2 + p) * (size_t)items;
    buf[p] = Buf{sxs + rec * K, sys + rec * K, ssl + rec, ssr + rec, sm + rec};
  }

  // stage this block and its clamped right halo into buffer 0
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int s = it / W, i = it % W;
    const int g = i < block ? blk * block + i : nxt * block + (i - block);
    const size_t src = ((size_t)row * S + s) * lanes + g;
    for (int t = 0; t < K; ++t) {
      buf[0].xs[(size_t)it * K + t] = xs_in[src * K + t];
      buf[0].ys[(size_t)it * K + t] = ys_in[src * K + t];
    }
    buf[0].sl[it] = sl_in[src];
    buf[0].sr[it] = sr_in[src];
    buf[0].m[it] = m_in[src];
  }
  __syncthreads();

  double wxs[KM], wys[KM], vxs[KM], vys[KM], SA[KM], PB[KM];
  double mx[2 * KM], mvf[2 * KM], mvg[2 * KM];
  double cx[4 * KM + 1], cy[4 * KM + 1];

  int cur = 0;
  for (int j = 0; j < levels; ++j) {
    const double lvl = lvl0 - (double)(j + 1);
    const Buf& in = buf[cur];
    const Buf& ob = buf[cur ^ 1];
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int s = it / W, i = it % W;
      const size_t me = (size_t)it;
      const size_t up = (size_t)s * W + (i + 1 < W ? i + 1 : 0);
      const double idx = offset + (double)i;
      if (!(idx <= lvl)) {
        for (int t = 0; t < K; ++t) {
          ob.xs[me * K + t] = in.xs[me * K + t];
          ob.ys[me * K + t] = in.ys[me * K + t];
        }
        ob.sl[me] = in.sl[me]; ob.sr[me] = in.sr[me]; ob.m[me] = in.m[me];
        continue;
      }
      const double sp = s0 * exp((2.0 * idx - lvl) * sig);
      const bool no_tc = lvl == 0.0;
      const double a = no_tc ? sp : (1.0 + k) * sp;
      const double b = no_tc ? sp : (1.0 - k) * sp;

      View zu{in.xs + up * K, in.ys + up * K, in.sl[up], in.sr[up], in.m[up]};
      View zc{in.xs + me * K, in.ys + me * K, in.sl[me], in.sr[me], in.m[me]};
      Out w{wxs, wys, 0.0, 0.0, 0};
      const int m1 = envelope2(zu, zc, true, K, w, mx, mvf, mvg, cx, cy);
      for (int t = 0; t < w.m; ++t) wys[t] = wys[t] * inv_r;
      View wv{wxs, wys, w.sl * inv_r, w.sr * inv_r, w.m};
      Out v{vxs, vys, 0.0, 0.0, 0};
      const int m2 = cone(wv, a, b, K, v, SA, PB, mx, mvf, mvg, cx, cy);

      const bool seller = (seller_mask >> s) & 1u;
      const double sign = seller ? 1.0 : -1.0;
      const double xi = sign * (alpha * k1 + w1 * fmax(sp - k1, 0.0)
                                + w2 * fmax(sp - k2, 0.0));
      const double ze = sign * zeta;
      View u{&ze, &xi, -a, -b, 1};
      View vv{vxs, vys, v.sl, v.sr, v.m};
      Out z{ob.xs + me * K, ob.ys + me * K, 0.0, 0.0, 0};
      const int m3 = envelope2(u, vv, seller, K, z, mx, mvf, mvg, cx, cy);
      ob.sl[me] = z.sl; ob.sr[me] = z.sr; ob.m[me] = z.m;
      if (i < block) {
        int pc = m1 > m2 ? m1 : m2;
        pc = pc > m3 ? pc : m3;
        atomicMax(&blk_pieces, pc);
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  // write back the owned lanes
  const Buf& fin = buf[cur];
  for (int it = threadIdx.x; it < S * block; it += blockDim.x) {
    const int s = it / block, i = it % block;
    const size_t me = (size_t)s * W + i;
    const size_t dst = ((size_t)row * S + s) * lanes + (size_t)blk * block + i;
    for (int t = 0; t < K; ++t) {
      xs_out[dst * K + t] = fin.xs[me * K + t];
      ys_out[dst * K + t] = fin.ys[me * K + t];
    }
    sl_out[dst] = fin.sl[me]; sr_out[dst] = fin.sr[me]; m_out[dst] = fin.m[me];
  }
  if (threadIdx.x == 0) pieces_out[(size_t)row * nblk + blk] = blk_pieces;
}

template <int KM>
cudaError_t launch(void* const* p, int R, int S, int lanes, int K, int block,
                   int nblk, int levels, unsigned mask, cudaStream_t st) {
  dim3 grid(nblk, R);
  rz_round_kernel<KM><<<grid, THREADS, 0, st>>>(
      (const double*)p[0], (const double*)p[1], (const double*)p[2],
      (const double*)p[3], (const int*)p[4], (const double*)p[5],
      (double*)p[6], (double*)p[7], (double*)p[8], (double*)p[9], (int*)p[10],
      (int*)p[11], (double*)p[12], (double*)p[13], (double*)p[14],
      (double*)p[15], (int*)p[16], S, lanes, K, block, levels, mask);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rz_round_launch(
    void* xs, void* ys, void* sl, void* sr, void* m, void* scalars,
    void* xs_o, void* ys_o, void* sl_o, void* sr_o, void* m_o, void* pieces,
    void* sxs, void* sys, void* ssl, void* ssr, void* sm,
    int R, int S, int lanes, int K, int block, int nblk, int levels,
    int seller_mask, void* stream) {
  void* p[17] = {xs, ys, sl, sr, m, scalars, xs_o, ys_o, sl_o, sr_o, m_o,
                 pieces, sxs, sys, ssl, ssr, sm};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned mask = (unsigned)seller_mask;
  cudaError_t err;
  if (K <= 16) err = launch<16>(p, R, S, lanes, K, block, nblk, levels, mask, st);
  else if (K <= 32) err = launch<32>(p, R, S, lanes, K, block, nblk, levels, mask, st);
  else if (K <= 48) err = launch<48>(p, R, S, lanes, K, block, nblk, levels, mask, st);
  else if (K <= 64) err = launch<64>(p, R, S, lanes, K, block, nblk, levels, mask, st);
  else if (K <= 128) err = launch<128>(p, R, S, lanes, K, block, nblk, levels, mask, st);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
