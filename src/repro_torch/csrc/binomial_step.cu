// Blocked binomial backward induction (friction-free lattice) for Hopper.
//
// Replaces the TPU kernels of src/repro/kernels/binomial_step.py:
// _round_kernel_param (payoff as 11 scalars, entry lattice_round_param) and
// _round_kernel (put/call baked in, 6 scalars, entry lattice_round).  One
// round advances every lane `levels` backward steps,
//
//   v[i] = max(g(2 i - lvl), (p v[i+1] + (1-p) v[i]) / r),  lvl = lvl0-1, ...
//
// where g(j) = intrinsic(s0 exp(j sig)); steps whose level is below 0 are
// no-ops.  The TPU kernel steps a 2*block buffer (its block and the clamped
// right block as halo) with a wrapping roll; an owned lane after `levels`
// steps depends only on the `levels` lanes to its right, so the round is
// out[i] = F(V[i .. i+levels]) over the virtual row V[p] = v[p] for p < P
// and V[p] = v[p - block] for P <= p < P + block (the last block's clamped
// halo), with the intrinsic taken at tree column lane0 + p in both cases
// (lane0 > 0 for a shard of the node axis).
//
// Float64 and float32 instances: the kernel is a template on the scalar T,
// with separate C entry points (lattice_round_launch for double,
// lattice_round_launch_f32 for float).  Every constant and math call is
// written in T (mx, ex below), so the float instance runs no float64
// instruction; the TPU kernel's float32 variant is the same program traced
// at float32.
//
// What bounds it on the H100: float64 operations (float32: the same count
// over the 67 TFLOP/s of float32 outside the tensor cores).  Per node and level the
// function needs 5 (p*up, q*v, their sum, *inv_r, the max); the intrinsic
// depends on j = 2i - lvl alone, so a round needs it at about 2 distinct j
// per lane, not one per lane and level.  At the main path's 50 levels that
// is ~250 operations per 16 bytes moved, far above the card's float64 ridge
// (34e12 / 3.35e12 ~ 10 per byte).  Built with --fmad=false (the plain
// version's rounding), each operation is its own instruction, so the
// practical floor is twice the bound taken at 34e12 operations/s.
//
// Tiling: R = 10 lanes a thread and 4 warps a CTA (PERF.md, Findings).
//
// Design:
// 1. No exp in the level loop.  A CTA owns `tile` lanes of one row and
//    first tabulates g[k] = intrinsic(s0 * exp((double)j * sig)) in shared
//    memory for k = j - jbase over the 2*(tile+levels) values of j its lanes
//    and levels reach: 2 exps per lane and round.  2i - lvl is an exact
//    integer in float64, so the entries are the plain version's values bit
//    for bit.  Each thread keeps the entries its lanes need in registers, one
//    window per parity of the step: lane r at step s+2 needs what lane r+1
//    needed at step s, so a window rotates by one slot every two steps and
//    refills one entry from the table (the rotation is unrolled, no moves).
//    The table is stored skewed so that a warp's refills do not collide on a
//    shared-memory bank.
// 2. A halo `levels` lanes wide, stepped as a shrinking trapezoid.  The CTA
//    loads lanes [t0, t0 + tile + levels) of V (the clamp included) and
//    computes, in each chunk of steps, only the lanes the owned ones still
//    depend on.  The wrapping lane of the TPU kernel never reaches an owned
//    lane, so the owned lanes are the plain version's bit for bit.
// 3. No block barrier per level.  A warp steps a window of W = 32*R
//    consecutive lanes, R in each thread's registers; the right neighbour of
//    a thread's last lane comes from the next thread by __shfl_down_sync.
//    Lane x of the window is exact after n steps while x + n < W, so a warp
//    keeps W - n lanes of each window; windows overlap by n lanes and need
//    nothing from each other.  Levels go in chunks of at most W/2 with one
//    __syncthreads() between chunks (the state in shared memory, double
//    buffered); at levels <= W/2, as on the main path, a round is one chunk
//    and the level loop has no barrier at all.
//
// lvl0 must be a level number, a whole number in float64, as every host
// round loop passes it: the table and the count of active steps take it as
// an integer.  Built with --fmad=false so that the arithmetic rounds as the
// plain PyTorch version's separate multiplies and adds do; the max is a
// compare and select (torch.maximum for inputs without NaN), three
// instructions where fmax's NaN handling takes four.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int R = 10;              // lanes a thread holds
constexpr int W = 32 * R;          // lanes a warp window holds
constexpr int WARPS = 4;           // warps a CTA

template <class T>
struct Round {
  T p_up, q, inv_r, s0, sig;
  T alpha, zeta, w1, w2, k1, k2, strike;
};

// max and exp in the scalar's own precision.  The float max propagates
// NaN (max.NaN.f32, sm_80 on), as torch.maximum and jnp.maximum do: a float32
// spot past 3.4e38 is inf, and the 4-parameter payoff's w * (s - k)^+ is then
// 0 * inf = NaN, which the plain version and the TPU kernel keep.  The
// double path has no overflow on the engines' inputs and keeps fmax and a
// compare and select.
__device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float mx(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ double pick(double pay, double cont) {
  return pay > cont ? pay : cont;
}
__device__ __forceinline__ float pick(float pay, float cont) {
  return mx(pay, cont);
}
__device__ __forceinline__ double ex(double a) { return exp(a); }
__device__ __forceinline__ float ex(float a) { return expf(a); }

template <int KIND, class T>  // KIND 0: 4-parameter payoff, 1: put, 2: call
__device__ __forceinline__ T intrinsic(const Round<T>& c, T s) {
  const T zero = T(0);
  if (KIND == 1) return mx(c.strike - s, zero);
  if (KIND == 2) return mx(s - c.strike, zero);
  const T pay = c.alpha * c.k1 + c.w1 * mx(s - c.k1, zero)
                + c.w2 * mx(s - c.k2, zero) + c.zeta * s;
  return mx(pay, zero);
}

// Table entry k lives at k + (k >> SKEW): thread t's refill index steps by
// 2R, and 2R >> SKEW is odd, so the 16 threads of a half warp refill from
// 16 distinct bank pairs (a plain layout puts 4 of them on one).
constexpr int SKEW = 2;
static_assert((2 * R) % (1 << SKEW) == 0 && ((2 * R) >> SKEW) % 2 == 1,
              "the skew must spread a half warp's refills over the banks");

__device__ __forceinline__ int tab(int k) { return k + (k >> SKEW); }

__host__ __device__ constexpr int table_size(int entries) {
  return entries + ((entries - 1) >> SKEW) + 1;
}

// One backward step of a thread's R lanes; lane r's intrinsic sits in
// slot (r + u) % R of the window w.
template <class T>
__device__ __forceinline__ void step(T (&v)[R], const T (&w)[R], int u,
                                     const Round<T>& c) {
  const T last = __shfl_down_sync(FULL, v[0], 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T up = r + 1 < R ? v[r + 1] : last;
    const T cont = (c.p_up * up + c.q * v[r]) * c.inv_r;
    const T pay = w[(r + u) % R];
    v[r] = pick(pay, cont);
  }
}

// One warp advances the window of W lanes of `src` at `start` by n steps
// (steps done+1 .. done+n) and writes its first W - n lanes, those below
// vout, to `dst`.  g[k] is the intrinsic of lane x at step s, k = 2x + s - 1.
template <class T>
__device__ __forceinline__ void warp_steps(
    const T* __restrict__ src, T* __restrict__ dst, const T* __restrict__ g,
    int nsrc, int start, int done, int n, int vout, const Round<T>& c) {
  const int base = start + (threadIdx.x & 31) * R;
  const int kmax = 2 * nsrc - 1;
  T v[R], e[R], o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = src[min(base + r, nsrc - 1)];
  int k = 2 * base + done;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    e[r] = g[tab(min(k + 2 * r, kmax))];
    o[r] = g[tab(min(k + 2 * r + 1, kmax))];
  }
  k += 2 * R;   // the last lane's entry two steps on
  for (int i = 0; i < n; i += 2 * R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (i + 2 * u >= n) break;
      step(v, e, u, c);
      e[u] = g[tab(min(k, kmax))];
      if (i + 2 * u + 1 >= n) break;
      step(v, o, u, c);
      o[u] = g[tab(min(k + 1, kmax))];
      k += 2;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int x = base + r;
    if (x - start < W - n && x < vout) dst[x] = v[r];
  }
}

template <int KIND, class T>
__global__ void __launch_bounds__(WARPS * 32)
lattice_round_kernel(const T* __restrict__ v, const T* __restrict__ scalars,
                     T* __restrict__ out, int P, int block, int levels,
                     int n_scalars, int tile, int lane0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nsrc = tile + levels;          // lanes the owned ones depend on
  T* src = smem;
  T* dst = smem + nsrc;
  T* g = smem + 2 * nsrc;                  // 2 * nsrc entries, skewed
  const int row = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * tile;
  const T* vr = v + (size_t)row * P;
  const T* sc = scalars + (size_t)row * n_scalars;

  Round<T> c{};
  const T lvl0 = sc[0];
  c.p_up = sc[1];
  c.inv_r = sc[2];
  if (KIND == 0) {
    c.s0 = sc[3]; c.sig = sc[4];
    c.alpha = sc[5]; c.zeta = sc[6]; c.w1 = sc[7]; c.w2 = sc[8];
    c.k1 = sc[9]; c.k2 = sc[10];
  } else {
    c.strike = sc[3]; c.s0 = sc[4]; c.sig = sc[5];
  }
  c.q = T(1) - c.p_up;
  // steps whose level lvl0 - s is >= 0; the rest of the round is no-ops
  const int active =
      lvl0 >= T(levels) ? levels : (lvl0 >= T(1) ? (int)lvl0 : 0);

  for (int x = threadIdx.x; x < nsrc; x += blockDim.x) {
    const long long p = t0 + x;
    T val = T(0);
    if (p < P) val = vr[p];
    else if (p < (long long)P + block) val = vr[p - block];
    src[x] = val;
    dst[x] = T(0);
  }
  if (active > 0) {
    // j = 2(lane0 + p) - (lvl0 - s) for local lane x = p - t0 at step s
    // is jbase + 2x + s - 1
    const long long jbase = 2 * (lane0 + t0) - (long long)lvl0 + 1;
    for (int k = threadIdx.x; k < 2 * nsrc; k += blockDim.x)
      g[tab(k)] = intrinsic<KIND>(c, c.s0 * ex((T)(jbase + k) * c.sig));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  for (int done = 0; done < active;) {
    const int n = min(active - done, W / 2);
    const int vout = nsrc - done - n;      // lanes still exact after the chunk
    const int keep = W - n;
    for (int start = warp * keep; start < vout; start += WARPS * keep)
      warp_steps(src, dst, g, nsrc, start, done, n, vout, c);
    __syncthreads();
    T* t = src; src = dst; dst = t;
    done += n;
  }
  T* outr = out + (size_t)row * P;
  for (int x = threadIdx.x; x < tile; x += blockDim.x) {
    const long long p = t0 + x;
    if (p < P) outr[p] = src[x];
  }
}

template <int KIND, class T>
int launch(const T* v, const T* sc, T* out, int rows, int P, int block,
           int levels, int n_scalars, int lane0, cudaStream_t st) {
  const int tile = WARPS * (W - (levels < W / 2 ? levels : W / 2));
  const int nsrc = tile + levels;
  const size_t shmem =
      (2 * (size_t)nsrc + table_size(2 * nsrc)) * sizeof(T);
  auto kern = lattice_round_kernel<KIND, T>;
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((P + tile - 1) / tile, rows);
  kern<<<grid, WARPS * 32, shmem, st>>>(v, sc, out, P, block, levels,
                                        n_scalars, tile, lane0);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const void* v, const void* scalars, void* out, int rows, int P,
             int block, int levels, int kind, int lane0, void* stream) {
  const T* vp = (const T*)v;
  const T* sp = (const T*)scalars;
  T* op = (T*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    return launch<0>(vp, sp, op, rows, P, block, levels, 11, lane0, st);
  if (kind == 1)
    return launch<1>(vp, sp, op, rows, P, block, levels, 6, lane0, st);
  return launch<2>(vp, sp, op, rows, P, block, levels, 6, lane0, st);
}

}  // namespace

// kind 0: the 4-parameter payoff (11 scalars a row); 1: put, 2: call (6).
// lane0 is the tree column of v's lane 0 (a shard's offset on the node
// axis; 0 for a whole row).  v, scalars and out are double here, float in
// lattice_round_launch_f32.
extern "C" int lattice_round_launch(const void* v, const void* scalars,
                                    void* out, int rows, int P, int block,
                                    int levels, int kind, int lane0,
                                    void* stream) {
  return dispatch<double>(v, scalars, out, rows, P, block, levels, kind,
                          lane0, stream);
}

extern "C" int lattice_round_launch_f32(const void* v, const void* scalars,
                                        void* out, int rows, int P, int block,
                                        int levels, int kind, int lane0,
                                        void* stream) {
  return dispatch<float>(v, scalars, out, rows, P, block, levels, kind,
                         lane0, stream);
}
