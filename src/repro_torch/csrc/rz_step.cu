// Blocked Roux–Zastawniak PWL rounds (transaction costs) for Hopper.
//
// Replaces the TPU kernel _rz_round_kernel of src/repro/kernels/rz_step.py
// (entry rz_round).  One launch advances a row of PWL lanes `levels` levels
// toward the root; per level and live lane the fused seller/buyer step of
// core/rz.py::rz_level_step_lanes:
//
//   w = envelope2(z[i+1], z[i], max);  w = w / r
//   v = cone_infconv(w, (1+k) s, (1-k) s)               (no costs at level 0)
//   z = envelope2(expense(+-xi, +-zeta), v, max for the seller, min for the buyer)
//
// The TPU kernel steps a buffer of its block and the clamped right block
// (one block and no halo when the round has one block) with a wrapping
// roll.  An owned lane after `levels` steps depends only on the `levels`
// lanes to its right, so a round is out[i] = F(V[i .. i+levels]) over a
// virtual row V: for one block, V[p] = z[p mod lanes] at level index
// p mod lanes (the roll); for several, V[p] = z[p] for p < lanes and
// z[p - block] past them (the last block's clamped halo), at index p.  The
// roll of a multi-block buffer never reaches an owned lane.  An index is a
// tree column counted from lane0, the column of the input's lane 0 (a shard
// of the node axis has lane0 > 0; its pieces count owned_lanes lanes).
//
// Float64 and float32 instances: the kernel is a template on the scalar T,
// with separate C entry points (rz_round_launch / rz_round_slots for double,
// the _f32 ones for float).  Every constant and math call is written in T
// (Lim, mx, mn, ab, ex below), so the float instance runs no float64
// instruction, and TINY follows the JAX package's _tiny(dtype).  A float
// record is half the bytes: the same tiles take half the shared memory.
//
// What bounds it on the H100: float64 operations (float32 in the float
// instance), and how fast each
// thread's chain of them can issue.  A lane step is a few hundred float64
// operations (merges, crossings, divisions, binary searches) per knot of
// its state, most waiting on the one before, on knot lists whose length
// differs lane to lane; the state is small (the paper's put holds about
// one knot a lane at capacity 48), so the bytes a round must move are far
// below its operations.  Hiding the chains' latency takes many resident
// warps: 3 CTAs of 256 threads an SM (80 registers a thread, 53 KB of
// shared memory a CTA).  The earlier design did work that followed the
// capacity K instead of the knots: it padded every intermediate list to
// K, copied K knots of every dead lane each level and kept about 20 K
// doubles of merge scratch a thread in local memory, in 256 CTAs that
// each walked a whole row with a barrier per level.
//
// Design:
// 1. Tiles with a recomputed halo.  The grid is (tiles, rows).  A CTA owns
//    `tile` lanes of one row, both sides, and loads the tile + `levels`
//    lanes of V they depend on, clipped at the first lane that is dead
//    from the round's first level (nothing past it reaches an owned lane).
//    Each level steps only the live lanes the owned ones still depend on,
//    so the stepped extent shrinks by one lane a level.  A lane that is not
//    stepped keeps its last value where it is: the value of lane i after
//    c steps lives in buffer min(c, nst[i]) & 1, nst[i] its count of steps,
//    so dead lanes are never copied.  The barrier between levels covers
//    one CTA's few hundred lanes.
// 2. Compact records in shared memory.  A lane record holds KS = 2 knots
//    inline (structure of arrays over the tile's lanes) and sl, sr, m: on
//    the put grid nearly every lane holds at most 2 knots, and a small
//    record leaves room for more CTAs (KS and the CTAs an SM were chosen
//    on the card: PERF.md, Findings).  A record with more than KS knots
//    keeps its knots at full capacity in a slot of device memory that the
//    CTA claims for its lifetime from a pool sized by the card's resident
//    CTAs (NSM x occupancy), so the pool does not grow with the grid.
//    Every loop runs to m; the BIG / 0 padding of the output format is
//    written once, at write-back.
// 3. Streamed candidate lists.  Each envelope generates its merged grid and
//    crossing candidates one at a time, with a one-element look-behind, and
//    feeds them to compress as they come: its dedupe compares a candidate
//    with the previous raw one, its slope test needs a survivor's two
//    neighbours, sl is fixed by the first candidate and sr by the last
//    valid one.  What stays in a thread's scratch are the records w and v
//    and the cone's suffix and prefix minima, touched up to their knots.
//
// The arithmetic repeats the plain PyTorch version operation for
// operation.  It is built with --fmad=false: knot retention in compress
// and the crossings in the envelope and cone are threshold tests at a
// relative 1e-9, and a contracted multiply-add would round differently
// and could change a knot count, and with it max_pieces.
#include <cuda_runtime.h>

namespace {

// Limits and math in the scalar's own precision: TINY is the positive-width
// guard of the PWL algebra, 1e-300 in float64 and float32's smallest normal
// in float32 (where 1e-300 underflows to 0), as the JAX package's _tiny.
template <class T> struct Lim;
template <> struct Lim<double> {
  static __device__ __forceinline__ double big() { return 1e30; }
  static __device__ __forceinline__ double rel() { return 1e-9; }
  static __device__ __forceinline__ double tiny() { return 1e-300; }
};
template <> struct Lim<float> {
  static __device__ __forceinline__ float big() { return 1e30f; }
  static __device__ __forceinline__ float rel() { return 1e-9f; }
  static __device__ __forceinline__ float tiny() { return 1.17549435e-38f; }
};
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double mn(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double ab(double a) { return fabs(a); }
__device__ __forceinline__ float ab(float a) { return fabsf(a); }
__device__ __forceinline__ double ex(double a) { return exp(a); }
__device__ __forceinline__ float ex(float a) { return expf(a); }

constexpr int THREADS = 256;
constexpr int EMAX = 256;       // lanes a tile holds: owned lanes and halo
constexpr int KS = 2;           // knots a shared-memory record holds inline
constexpr int NREC = 4;         // record sets: 2 buffers x 2 sides

// dynamic shared memory: xs, ys [NREC][KS][EMAX]; sl, sr [NREC][EMAX];
// m [NREC][EMAX]; nst [EMAX]
template <class T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (2 * NREC * KS * EMAX + 2 * NREC * EMAX)
         + sizeof(int) * (NREC * EMAX + EMAX);
}

template <class T>
struct View {          // a PWL whose first m knots are valid; knot t at [t*st]
  const T* xs;
  const T* ys;
  int st;
  T sl, sr;
  int m;
};

template <class T>
struct Pt {            // a merged-grid point and both functions' values on it
  T x, vf, vg;
};

// count of a[i] <= v (right) or a[i] < v (left) in ascending a[0..n)
template <class T>
__device__ __forceinline__ int ss_right(const T* a, int st, int n,
                                        T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid * st] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <class T>
__device__ __forceinline__ int ss_left(const T* a, int st, int n,
                                       T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid * st] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <class T>
__device__ T eval1(const View<T>& f, T c) {
  const int st = f.st;
  const int cnt = ss_right(f.xs, st, f.m, c);
  if (cnt == 0) return f.ys[0] + f.sl * (c - f.xs[0]);
  if (cnt >= f.m) {
    const int il = (f.m - 1) * st;
    return f.ys[il] + f.sr * (c - f.xs[il]);
  }
  const int il = (cnt - 1) * st, ir = cnt * st;
  const T w = f.xs[ir] - f.xs[il];
  const bool ok = w > Lim<T>::tiny();
  const T slope = (ok ? f.ys[ir] - f.ys[il] : T(0)) / (ok ? w : T(1));
  return f.ys[il] + slope * (c - f.xs[il]);
}

// Knots into a thread's array, values scaled (w = envelope / r) or not.
template <class T>
struct ArrOut {
  T* xs;
  T* ys;
  T scale;
  __device__ void put(int t, T x, T y) {
    xs[t] = x;
    ys[t] = y * scale;
  }
};

// Knots into a lane record: the first KS inline in shared memory (stride
// EMAX), all of them in the record's device-memory slot once there are more.
template <class T>
struct RecOut {
  T* ix;
  T* iy;
  T* wx;
  T* wy;
  __device__ void put(int t, T x, T y) {
    if (t < KS) {
      ix[t * EMAX] = x;
      iy[t * EMAX] = y;
      return;
    }
    if (t == KS) {
      for (int u = 0; u < KS; ++u) { wx[u] = ix[u * EMAX]; wy[u] = iy[u * EMAX]; }
    }
    wx[t] = x;
    wy[t] = y;
  }
};

// compress fed one raw candidate at a time: dedupe against the previous raw
// candidate, keep the survivors whose left and right slopes differ (the
// first survivor's left slope is sl, the last's right slope sr), truncate to
// cap; the first survivor anchors a list with no kink.  Returns the raw
// count.
template <class T, class O>
struct Compress {
  O& out;
  int cap;
  T sl = T(0);           // set before the second survivor arrives
  T prev_x = -Lim<T>::big();
  bool prev_valid = false;
  int ns = 0;                // survivors so far
  T fx = T(0), fy = T(0); // first survivor
  T px = T(0), py = T(0); // last survivor, not yet decided
  T s_left = T(0);       // its left slope when ns >= 2
  int m2 = 0;

  __device__ Compress(O& o, int c) : out(o), cap(c) {}

  __device__ void decide(T s_l, T s_r) {
    const T tol = Lim<T>::rel() * (T(1) + mx(ab(s_l), ab(s_r)));
    if (ab(s_r - s_l) > tol) {
      if (m2 < cap) out.put(m2, px, py);
      ++m2;
    }
  }
  __device__ void push(T x, T y0) {
    const bool valid = x < Lim<T>::big() / 2;
    const T y = valid ? y0 : T(0);
    const bool dup = valid && prev_valid &&
                     (x - prev_x <= Lim<T>::rel() * (T(1) + ab(prev_x)));
    prev_x = x;
    prev_valid = valid;
    if (!valid || dup) return;
    if (ns == 0) {
      fx = x;
      fy = y;
    } else {
      const T seg = (y - py) / mx(x - px, Lim<T>::tiny());
      decide(ns == 1 ? sl : s_left, seg);
      s_left = seg;
    }
    px = x;
    py = y;
    ++ns;
  }
  __device__ int finish(T sr) {
    if (ns > 0) decide(ns == 1 ? sl : s_left, sr);
    if (m2 == 0 && ns > 0) { out.put(0, fx, fy); m2 = 1; }
    return m2;
  }
};

// Envelope (max or min) of f and g over the merged grid that `src` yields
// in ascending order (every valid knot of both functions, with their
// values); g's end slopes are gsl, gsr and src evaluates g at the probes.
// The candidates stream into compress; returns the raw count and the
// envelope's end slopes.
template <class T, class Src, class O>
__device__ int envelope_stream(Src& src, const View<T>& f, T gsl, T gsr,
                               bool take_max, O& out, int cap, T& osl,
                               T& osr) {
  Compress<T, O> cp(out, cap);
  bool first = true, any_valid = false;
  T first_x = T(0), last_valid = T(0);
  auto emit = [&](T x, T y) {
    if (first) {     // the left end slope, from a probe left of everything
      first = false;
      first_x = x;
      const T pl = x - T(1);
      const T fl = eval1(f, pl), gl = src.g_left(pl);
      const bool tie = ab(fl - gl) <= Lim<T>::rel() * (T(1) + mx(ab(fl), ab(gl)));
      cp.sl = take_max ? (tie ? mn(f.sl, gsl) : (fl > gl ? f.sl : gsl))
                       : (tie ? mx(f.sl, gsl) : (fl < gl ? f.sl : gsl));
    }
    if (x < Lim<T>::big() / 2) { last_valid = x; any_valid = true; }
    cp.push(x, y);
  };
  // a crossing of f and g inside (lo, hi), anchored at point a
  auto cross = [&](T lo, T hi, T sf, T sg, const Pt<T>& a) {
    const T denom = sf - sg;
    const bool parallel = ab(denom) <= Lim<T>::rel() * (T(1) + mx(ab(sf), ab(sg)));
    const T x_cross = a.x + (a.vg - a.vf) / (parallel ? T(1) : denom);
    const T margin = Lim<T>::rel() * (T(1) + ab(x_cross));
    if (!parallel && x_cross > lo + margin && x_cross < hi - margin)
      emit(x_cross, a.vf + sf * (x_cross - a.x));
  };
  auto pick = [&](const Pt<T>& p) {
    return take_max ? mx(p.vf, p.vg) : mn(p.vf, p.vg);
  };
  Pt<T> cur = src.next();
  cross(-Lim<T>::big(), cur.x, f.sl, gsl, cur);
  emit(cur.x, pick(cur));
  while (src.more()) {
    const Pt<T> nx = src.next();
    const T dx = nx.x - cur.x;
    const bool ok_dx = dx > Lim<T>::tiny();
    const T inv_dx = T(1) / (ok_dx ? dx : T(1));
    const T sf = (ok_dx ? nx.vf - cur.vf : T(0)) * inv_dx;
    const T sg = (ok_dx ? nx.vg - cur.vg : T(0)) * inv_dx;
    cross(cur.x, nx.x, sf, sg, cur);
    emit(nx.x, pick(nx));
    cur = nx;
  }
  cross(cur.x, Lim<T>::big(), f.sr, gsr, cur);
  // the right end slope, from a probe right of the last valid candidate
  const T pr = (any_valid ? last_valid : first_x) + T(1);
  const T fr = eval1(f, pr), gr = src.g_right(pr);
  const bool tie = ab(fr - gr) <= Lim<T>::rel() * (T(1) + mx(ab(fr), ab(gr)));
  const T sr = take_max ? (tie ? mx(f.sr, gsr) : (fr > gr ? f.sr : gsr))
                             : (tie ? mn(f.sr, gsr) : (fr < gr ? f.sr : gsr));
  osl = cp.sl;
  osr = sr;
  return cp.finish(sr);
}

// The stable merge of f's and g's knots (f first on ties), each function
// evaluated at the other's knots.
template <class T>
struct MergeSrc {
  const View<T>& f;
  const View<T>& g;
  int i = 0, j = 0;
  __device__ MergeSrc(const View<T>& f_, const View<T>& g_) : f(f_), g(g_) {}
  __device__ bool more() const { return i < f.m || j < g.m; }
  __device__ Pt<T> next() {
    const bool take_f = j >= g.m || (i < f.m && !(g.xs[j * g.st] < f.xs[i * f.st]));
    Pt<T> p;
    if (take_f) {
      p.x = f.xs[i * f.st]; p.vf = f.ys[i * f.st]; p.vg = eval1(g, p.x); ++i;
    } else {
      p.x = g.xs[j * g.st]; p.vf = eval1(f, p.x); p.vg = g.ys[j * g.st]; ++j;
    }
    return p;
  }
  __device__ T g_left(T p) const { return eval1(g, p); }
  __device__ T g_right(T p) const { return eval1(g, p); }
};

// The cone's grid: f's knots and the crossings of its cost cones between
// them, with f and the cones' lower envelope env on each.  env's knots are
// this grid, so its values at the probes (left of the first point, right
// of the last) are its end rays through the first and last points.
template <class T>
struct ConeSrc {
  const View<T>& f;
  T a, b, denom;
  bool par;
  const T* SA;
  const T* PB;
  int j = 0;
  bool has_cross = false;
  T cross_x = T(0);
  bool started = false;
  Pt<T> first{T(0), T(0), T(0)}, last{T(0), T(0), T(0)};
  __device__ ConeSrc(const View<T>& f_, T a_, T b_, const T* sa,
                     const T* pb)
      : f(f_), a(a_), b(b_), denom(a_ - b_),
        par(ab(a_ - b_) <= Lim<T>::rel() * (T(1) + ab(a_))), SA(sa), PB(pb) {}
  __device__ bool more() const { return has_cross || j < f.m; }
  __device__ Pt<T> next() {
    const int st = f.st, m = f.m;
    T c;
    if (has_cross) {
      c = cross_x;
      has_cross = false;
    } else {
      c = f.xs[j * st];
      if (j + 1 < m) {
        const T nxt_x = f.xs[(j + 1) * st], nxt_SA = SA[j + 1];
        const T ystar = (nxt_SA - PB[j]) / (par ? T(1) : denom);
        const T margin = Lim<T>::rel() * (T(1) + ab(ystar));
        if (!par && nxt_SA < Lim<T>::big() / 2 && PB[j] < Lim<T>::big() / 2 &&
            ystar > f.xs[j * st] + margin && ystar < nxt_x - margin) {
          has_cross = true;
          cross_x = ystar;
        }
      }
      ++j;
    }
    T env = T(0);
    if (c < Lim<T>::big() / 2) {
      const int ge = ss_left(f.xs, st, m, c);
      const int le = ss_right(f.xs, st, m, c);
      const T SA_at = ge < m ? SA[ge] : Lim<T>::big();
      const T PB_at = le > 0 ? PB[le - 1] : Lim<T>::big();
      env = mn(SA_at < Lim<T>::big() / 2 ? -a * c + SA_at : Lim<T>::big(),
                 PB_at < Lim<T>::big() / 2 ? -b * c + PB_at : Lim<T>::big());
    }
    const Pt<T> p{c, eval1(f, c), env};
    if (!started) { first = p; started = true; }
    last = p;
    return p;
  }
  __device__ T g_left(T p) const { return first.vg + (-a) * (p - first.x); }
  __device__ T g_right(T p) const { return last.vg + (-b) * (p - last.x); }
};

// Slope restriction v = min(f, lower envelope of the cost cones).
template <class T, class O>
__device__ int cone(const View<T>& f, T a, T b, O& out, int cap,
                    T* SA, T* PB, T& osl, T& osr) {
  const int m = f.m, st = f.st;
  T run = Lim<T>::big();
  for (int j = m - 1; j >= 0; --j) {
    run = mn(run, f.ys[j * st] + a * f.xs[j * st]);
    SA[j] = run;
  }
  run = Lim<T>::big();
  for (int j = 0; j < m; ++j) {
    run = mn(run, f.ys[j * st] + b * f.xs[j * st]);
    PB[j] = run;
  }
  ConeSrc<T> src(f, a, b, SA, PB);
  return envelope_stream(src, f, -a, -b, false, out, cap, osl, osr);
}

// The tile's records in shared memory and their device-memory slots.
template <class T>
struct Recs {
  T* xs;    // [NREC][KS][EMAX]
  T* ys;
  T* sl;    // [NREC][EMAX]
  T* sr;
  int* m;
  T* wxs;   // this CTA's slot: [NREC][EMAX][K]
  T* wys;
  int K;
  __device__ View<T> view(int rec, int i) const {
    const int at = rec * EMAX + i;
    const int mm = m[at];
    if (mm <= KS) {
      const size_t o = (size_t)rec * KS * EMAX + i;
      return View<T>{xs + o, ys + o, EMAX, sl[at], sr[at], mm};
    }
    const size_t o = (size_t)at * K;
    return View<T>{wxs + o, wys + o, 1, sl[at], sr[at], mm};
  }
  __device__ RecOut<T> out(int rec, int i) const {
    const size_t o = (size_t)rec * KS * EMAX + i, w = (size_t)(rec * EMAX + i) * K;
    return RecOut<T>{xs + o, ys + o, wxs + w, wys + w};
  }
};

// A slot of the device-memory pool for this CTA's wide records: one bit a
// slot in `masks`; at most nslots CTAs are resident, so one is free or is
// being released.
__device__ int claim_slot(unsigned* masks, int nslots) {
  const int nw = (nslots + 31) >> 5;
  int w = (int)((blockIdx.x + (size_t)blockIdx.y * gridDim.x) % nw);
  for (;;) {
    for (int k = 0; k < nw; ++k, w = w + 1 == nw ? 0 : w + 1) {
      const int nb = nslots - 32 * w < 32 ? nslots - 32 * w : 32;
      const unsigned valid = nb == 32 ? 0xffffffffu : (1u << nb) - 1u;
      unsigned avail = ~atomicOr(&masks[w], 0u) & valid;
      while (avail) {
        const unsigned bit = 1u << (__ffs(avail) - 1);
        const unsigned old = atomicOr(&masks[w], bit);
        if (!(old & bit)) {
          __threadfence();
          return 32 * w + __ffs(bit) - 1;
        }
        avail = ~old & valid;
      }
    }
    __nanosleep(256);
  }
}

// Virtual row: the input lane behind position g and its level index, the
// tree column of the input's lane 0 being lane0.
__device__ __forceinline__ int src_lane(int g, int lanes_in, int halo_block) {
  if (halo_block == 0) return g % lanes_in;
  return g < lanes_in ? g : g - halo_block;
}
template <class T>
__device__ __forceinline__ T lane_index(int g, int lanes_in, int halo_block,
                                             int lane0) {
  return (T)(lane0 + (halo_block == 0 ? g % lanes_in : g));
}

template <class T, int KM>
__global__ void __launch_bounds__(THREADS, 3)
rz_round_kernel(const T* __restrict__ xs_in, const T* __restrict__ ys_in,
                const T* __restrict__ sl_in, const T* __restrict__ sr_in,
                const int* __restrict__ m_in, const T* __restrict__ scalars,
                T* xs_out, T* ys_out, T* sl_out, T* sr_out,
                int* m_out, int* pieces_out, T* wide, unsigned* masks,
                int nslots, int S, int lanes_in, int lanes_out, int owned_lanes,
                int lane0, int K, int halo_block, int levels, int tile,
                unsigned seller_mask) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const int owned = min(tile, lanes_out - t0);
  __shared__ int s_ext, s_pieces, s_slot;

  Recs<T> rec;
  rec.xs = smem;
  rec.ys = rec.xs + NREC * KS * EMAX;
  rec.sl = rec.ys + NREC * KS * EMAX;
  rec.sr = rec.sl + NREC * EMAX;
  rec.m = (int*)(rec.sr + NREC * EMAX);
  int* nst = rec.m + NREC * EMAX;
  rec.K = K;

  const T* sc = scalars + (size_t)row * 11;
  const T lvl0 = sc[0], s0 = sc[1], sig = sc[2], r = sc[3], k = sc[4];
  const T alpha = sc[5], zeta = sc[6], w1 = sc[7], w2 = sc[8];
  const T k1 = sc[9], k2 = sc[10];
  const T inv_r = T(1) / r;

  if (threadIdx.x == 0) {
    s_ext = owned + levels;
    s_pieces = 0;
    s_slot = claim_slot(masks, nslots);
  }
  __syncthreads();
  rec.wxs = wide + (size_t)s_slot * 2 * NREC * EMAX * K;
  rec.wys = rec.wxs + (size_t)NREC * EMAX * K;

  // clip the extent at the first lane that no level of the round steps
  for (int i = threadIdx.x; i < owned + levels; i += THREADS) {
    const T idx = lane_index<T>(t0 + i, lanes_in, halo_block, lane0);
    if (!(idx <= lvl0 - T(1))) atomicMin(&s_ext, i + 1);
  }
  __syncthreads();
  const int ext = s_ext;

  // steps of each lane: while it is live and an owned lane still needs it
  for (int i = threadIdx.x; i < ext; i += THREADS) {
    const T idx = lane_index<T>(t0 + i, lanes_in, halo_block, lane0);
    int n = 0;
    while (n < levels && i < ext - (n + 1) && idx <= lvl0 - (T)(n + 1)) ++n;
    nst[i] = n;
  }
  // load the extent into buffer 0
  const size_t row_s = (size_t)row * S;
  for (int it = threadIdx.x; it < S * ext; it += THREADS) {
    const int s = it / ext, i = it - s * ext;
    const size_t src = (row_s + s) * lanes_in
                       + src_lane(t0 + i, lanes_in, halo_block);
    const int mm = m_in[src], at = s * EMAX + i;
    rec.m[at] = mm;
    rec.sl[at] = sl_in[src];
    rec.sr[at] = sr_in[src];
    RecOut<T> o = rec.out(s, i);
    for (int t = 0; t < mm; ++t) o.put(t, xs_in[src * K + t], ys_in[src * K + t]);
  }
  __syncthreads();

  T wxs[KM], wys[KM], vxs[KM], vys[KM], SA[KM], PB[KM];
  int my_pieces = 0;
  for (int c = 1; c <= levels; ++c) {
    const int nact = ext - c;
    if (nact <= 0) break;
    const T lvl = lvl0 - (T)c;
    const int rin = (c - 1) & 1, rout = c & 1;
    for (int it = threadIdx.x; it < S * nact; it += THREADS) {
      const int s = it / nact, i = it - s * nact;
      if (c > nst[i]) continue;
      const T idx = lane_index<T>(t0 + i, lanes_in, halo_block, lane0);
      const T sp = s0 * ex((T(2) * idx - lvl) * sig);
      const bool no_tc = lvl == T(0);
      const T a = no_tc ? sp : (T(1) + k) * sp;
      const T b = no_tc ? sp : (T(1) - k) * sp;

      const int up_steps = min(c - 1, nst[i + 1]);
      const View<T> zu = rec.view(2 * (up_steps & 1) + s, i + 1);
      const View<T> zc = rec.view(2 * rin + s, i);
      ArrOut<T> wo{wxs, wys, inv_r};
      MergeSrc<T> m_src(zu, zc);
      T wsl, wsr;
      const int m1 = envelope_stream(m_src, zu, zc.sl, zc.sr, true, wo, K,
                                     wsl, wsr);
      const View<T> wv{wxs, wys, 1, wsl * inv_r, wsr * inv_r, m1 < K ? m1 : K};
      ArrOut<T> vo{vxs, vys, T(1)};
      T vsl, vsr;
      const int m2 = cone(wv, a, b, vo, K, SA, PB, vsl, vsr);
      const View<T> vv{vxs, vys, 1, vsl, vsr, m2 < K ? m2 : K};

      const bool seller = (seller_mask >> s) & 1u;
      const T sign = seller ? T(1) : -T(1);
      const T xi = sign * (alpha * k1 + w1 * mx(sp - k1, T(0))
                                + w2 * mx(sp - k2, T(0)));
      const T ze = sign * zeta;
      const View<T> u{&ze, &xi, 1, -a, -b, 1};
      const int ro = 2 * rout + s;
      RecOut<T> zo = rec.out(ro, i);
      MergeSrc<T> z_src(u, vv);
      T zsl, zsr;
      const int m3 = envelope_stream(z_src, u, vv.sl, vv.sr, seller, zo, K,
                                     zsl, zsr);
      const int at = ro * EMAX + i;
      rec.sl[at] = zsl;
      rec.sr[at] = zsr;
      rec.m[at] = m3 < K ? m3 : K;
      if (i < owned && t0 + i < owned_lanes) {
        int pc = m1 > m2 ? m1 : m2;
        pc = pc > m3 ? pc : m3;
        my_pieces = my_pieces > pc ? my_pieces : pc;
      }
    }
    __syncthreads();
  }
  if (my_pieces > 0) atomicMax(&s_pieces, my_pieces);

  // write back the owned lanes: their last values, BIG / 0 padded; a lane
  // no level stepped is copied from the input as it was
  for (int it = threadIdx.x; it < S * owned; it += THREADS) {
    const int s = it / owned, i = it - s * owned;
    const size_t dst = (row_s + s) * lanes_out + t0 + i;
    if (i < ext && nst[i] > 0) {
      const int at = (2 * (nst[i] & 1) + s) * EMAX + i;
      sl_out[dst] = rec.sl[at]; sr_out[dst] = rec.sr[at]; m_out[dst] = rec.m[at];
    } else {
      const size_t src = (row_s + s) * lanes_in
                         + src_lane(t0 + i, lanes_in, halo_block);
      sl_out[dst] = sl_in[src]; sr_out[dst] = sr_in[src]; m_out[dst] = m_in[src];
    }
  }
  for (int q = threadIdx.x; q < S * owned * K; q += THREADS) {
    const int lane = q / K, t = q - lane * K;
    const int s = lane / owned, i = lane - s * owned;
    const size_t dst = ((row_s + s) * lanes_out + t0 + i) * K + t;
    if (i < ext && nst[i] > 0) {
      const View<T> v = rec.view(2 * (nst[i] & 1) + s, i);
      const bool in = t < v.m;
      xs_out[dst] = in ? v.xs[t * v.st] : Lim<T>::big();
      ys_out[dst] = in ? v.ys[t * v.st] : T(0);
    } else {
      const size_t src = ((row_s + s) * lanes_in
                          + src_lane(t0 + i, lanes_in, halo_block)) * K + t;
      xs_out[dst] = xs_in[src];
      ys_out[dst] = ys_in[src];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    pieces_out[(size_t)row * gridDim.x + blockIdx.x] = s_pieces;
    atomicAnd(&masks[s_slot >> 5], ~(1u << (s_slot & 31)));
  }
}

template <class T, int KM>
cudaError_t prepare(int* slots) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      rz_round_kernel<T, KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, rz_round_kernel<T, KM>, THREADS, smem)) != cudaSuccess)
    return err;
  *slots = nsm * occ;
  return *slots > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <class T, int KM>
cudaError_t launch(void* const* p, int nslots, int R, int S, int lanes_in,
                   int lanes_out, int owned_lanes, int lane0, int K,
                   int halo_block, int levels, int tile, int tiles, unsigned mask,
                   cudaStream_t st) {
  int slots = 0;
  cudaError_t err = prepare<T, KM>(&slots);
  if (err != cudaSuccess) return err;
  if (slots > nslots) return cudaErrorInvalidValue;
  err = cudaMemsetAsync(p[13], 0, sizeof(unsigned) * ((nslots + 31) / 32), st);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, R);
  rz_round_kernel<T, KM><<<grid, THREADS, smem_bytes<T>(), st>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2],
      (const T*)p[3], (const int*)p[4], (const T*)p[5],
      (T*)p[6], (T*)p[7], (T*)p[8], (T*)p[9], (int*)p[10],
      (int*)p[11], (T*)p[12], (unsigned*)p[13], nslots, S, lanes_in,
      lanes_out, owned_lanes, lane0, K, halo_block, levels, tile, mask);
  return cudaGetLastError();
}

template <class T>
int slots_for(int K, int* slots) {
  cudaError_t err;
  if (K <= 16) err = prepare<T, 16>(slots);
  else if (K <= 32) err = prepare<T, 32>(slots);
  else if (K <= 48) err = prepare<T, 48>(slots);
  else if (K <= 64) err = prepare<T, 64>(slots);
  else if (K <= 128) err = prepare<T, 128>(slots);
  else err = cudaErrorInvalidValue;
  return (int)err;
}

template <class T>
int dispatch(void* const* p, int nslots, int R, int S, int lanes_in,
             int lanes_out, int owned_lanes, int lane0, int K, int halo_block,
             int levels, int tile, int tiles, int seller_mask, void* stream) {
  if (S < 1 || S > 2 || tile + levels > EMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned mask = (unsigned)seller_mask;
  cudaError_t err;
#define RZ_LAUNCH(KM) launch<T, KM>(p, nslots, R, S, lanes_in, lanes_out, \
                                    owned_lanes, lane0, K, halo_block, levels, \
                                    tile, tiles, mask, st)
  if (K <= 16) err = RZ_LAUNCH(16);
  else if (K <= 32) err = RZ_LAUNCH(32);
  else if (K <= 48) err = RZ_LAUNCH(48);
  else if (K <= 64) err = RZ_LAUNCH(64);
  else if (K <= 128) err = RZ_LAUNCH(128);
  else err = cudaErrorInvalidValue;
#undef RZ_LAUNCH
  return (int)err;
}

}  // namespace

// The number of wide-record slots (resident CTAs on this card) the launch
// at capacity K needs; the wrapper sizes the slot pool with it.  The _f32
// entries are the float instances (half the shared memory a CTA).
extern "C" int rz_round_slots(int K, int* slots) {
  return slots_for<double>(K, slots);
}

extern "C" int rz_round_slots_f32(int K, int* slots) {
  return slots_for<float>(K, slots);
}

// One launch: lanes [0, lanes_out) of the virtual row over the input's
// lanes_in lanes (halo_block 0: the row wraps; else the last halo_block
// lanes repeat past the end), advanced `levels` levels, in tiles of `tile`
// owned lanes; pieces over owned live lanes below owned_lanes, one int per
// (row, tile).  lane0 is the tree column of the input's lane 0 (a shard's
// offset on the node axis; 0 for a whole row).  Values, scalars and the
// wide-record pool are double here and float in rz_round_launch_f32; m and
// pieces are int in both.
#define RZ_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(                                                        \
      void* xs, void* ys, void* sl, void* sr, void* m, void* scalars,         \
      void* xs_o, void* ys_o, void* sl_o, void* sr_o, void* m_o,              \
      void* pieces, void* wide, void* masks, int nslots, int R, int S,        \
      int lanes_in, int lanes_out, int owned_lanes, int lane0, int K,         \
      int halo_block, int levels, int tile, int tiles, int seller_mask,       \
      void* stream) {                                                         \
    void* p[14] = {xs, ys, sl, sr, m, scalars, xs_o, ys_o, sl_o, sr_o, m_o,   \
                   pieces, wide, masks};                                      \
    return dispatch<T>(p, nslots, R, S, lanes_in, lanes_out, owned_lanes,     \
                       lane0, K, halo_block, levels, tile, tiles,             \
                       seller_mask, stream);                                  \
  }
RZ_ENTRY(rz_round_launch, double)
RZ_ENTRY(rz_round_launch_f32, float)
#undef RZ_ENTRY
