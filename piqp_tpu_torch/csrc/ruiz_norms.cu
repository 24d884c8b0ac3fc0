// The kernels of a Ruiz pass: the norms, the step, the scaling
// (ops/ruiz_norms.py; the pass loop of ruiz.py, the stage registration in
// multistage.py).
//
// Replace no TPU kernel: the JAX package's Ruiz equilibration
// (piqp_tpu/ruiz.py) is plain jnp.  They were added because the port's
// Ruiz, written as PyTorch ops, read the host once a pass and moved about
// 12x the blocks' bytes a pass (abs and amax of each block, Psub, A1 and A2
// twice; two broadcast multiplies; a select that wrote each block again),
// with some twenty small launches besides.  A pass is now three launches:
// the norms read the working copy of the blocks once; the step turns them
// into the pass's scalings; the scaling reads and writes the copy once,
// (M_rc d_r) d_c, rounded as the reference rounds it, so that every value
// is the previous port's bit for bit.  Maxima are exact, so each kernel is
// bitwise its plain version (ruiz_norms.py), NaN included (the maxima
// propagate NaN, as torch.amax and torch.maximum do).
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3): bytes.  dense128
// (B = 1024, n = 128, p = m = 64, float64): P, A, G 268.4 MB, norms 0.080
// ms, scaling 0.160 ms (read and write); chainmass5 (B = 1024, T = 40,
// D = 24, ra = 21, Da = rg = 0, float64): Pd, Psub, A1, A2 707.8 MB, norms
// 0.211 ms, scaling 0.423 ms.  The step kernel reads and writes vectors of
// (B, 2n + p + m), a few MB.
//
// Norm kernels.
//   dense: a block a problem (grid-stride).  A matrix is read row by row,
//     L lanes a row (the power of two that covers its n columns in vectors
//     of V values, at most 32), 16-byte vectors where every matrix of the
//     launch allows them, kUnroll rows of a lane group loaded before any is
//     used.  A lane keeps its columns' running maxima in registers; a row's
//     maximum is a shuffle reduction over its L lanes.  Both go into
//     accumulators in shared memory by atomicMax on the values' bits
//     (non-negative floats order as their bit patterns, any NaN above them
//     all); the block writes [columns | A's rows | G's rows].
//   stage: an item is a (problem, owned stage): its nine blocks, some
//     17 KB at chainmass5, too little for one block's loads to keep the
//     memory busy.  So a persistent block of 128 threads streams a run of
//     consecutive items through a ring of three slots in shared memory by
//     cp.async, two items in flight while it computes one, and computes
//     each from shared memory: a thread an output, each kind of output on
//     warps of its own (the stage's own columns, in two halves; the next
//     stage's share: A2's and G2's columns and Psub's rows; the arrow's:
//     Ag's and Gg's columns and Pa's rows; A's rows: A1, A2, Ag; G's rows),
//     four values at a time into four running maxima, one copy of the loop
//     for every output.  A slot keeps each block's rows at an odd stride,
//     so that the lanes that read a row each fall on distinct banks.  The
//     columns meet those of the items before and after in the output by
//     atomicMax on the bits (the output starts at zero).  Where two slots
//     do not fit, the blocks are read where they lie.
// Step kernel: a block a problem.  It joins x_b_scaling's column and
// P[g, g]'s into the norms, takes 1 / sqrt(limit(norm)) of every norm,
// scales the accumulated vectors, x_b_scaling and c, and reduces the
// pass's measure max |1 - step|.
// Scale kernel: a block a (problem, matrix), its threads on neighbouring
// values.  A problem whose active flag is 0 is skipped by every kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kUnroll = 4;

template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = unsigned int;
  static __device__ __forceinline__ U of(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float value(U u) { return __uint_as_float(u); }
};
template <> struct Bits<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double x) {
    return static_cast<U>(__double_as_longlong(x));
  }
  static __device__ __forceinline__ double value(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
};

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }

// max that propagates NaN, as torch.amax and torch.maximum do
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (b > a || b != b) ? b : a;
}

template <typename T> __device__ __forceinline__ T val(typename Bits<T>::U u) {
  return Bits<T>::value(u);
}

// limit_scaling (preconditioner.hpp:420-437): below 1e-4 reset to 1, above
// 1e4 clamped
template <typename T> __device__ __forceinline__ T limit(T v) {
  v = v < T(1e-4) ? T(1) : v;
  return v > T(1e4) ? T(1e4) : v;
}

template <typename T> __device__ __forceinline__ T step_of(T v) {
  return T(1) / sqrt(limit(v));
}

template <typename T, int V> __device__ __forceinline__ void load(const T* p, T (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
    const typename Vec<T>::type q = __ldg(reinterpret_cast<const typename Vec<T>::type*>(p));
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = e[j];
  }
}

// One R x C matrix M (rows packed), read by the `lanes` threads whose index
// among them is `tid` (a multiple of 32: a block or a warp):
// colacc[c] = max(colacc[c], max_r |M_rc|) and, when rowacc is not null,
// rowacc[r] = max(rowacc[r], max_c |M_rc|).  Every thread of the set calls
// it.
template <typename T, int V>
__device__ void scan(const T* __restrict__ M, int R, int C, typename Bits<T>::U* colacc,
                     typename Bits<T>::U* rowacc, int tid, int lanes) {
  const int need = (C + V - 1) / V;
  int L = 1;
  while (L < need && L < 32) L <<= 1;
  const int lane = tid & 31;
  const int gl = lane & (L - 1);
  const int g = tid / L;
  const int NG = lanes / L;
  for (int cb = 0; cb < C; cb += L * V) {
    const int c = cb + gl * V;
    const bool cok = c < C;
    T cm[V];
#pragma unroll
    for (int j = 0; j < V; ++j) cm[j] = T(0);
    for (int r0 = 0; r0 < R; r0 += NG * kUnroll) {
      T v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * NG + g;
        if (cok && r < R) {
          load<T, V>(M + static_cast<size_t>(r) * C + c, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) v[u][j] = T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        T rp = T(0);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const T x = absval(v[u][j]);
          cm[j] = nmax(cm[j], x);
          rp = nmax(rp, x);
        }
        if (rowacc) {
          for (int off = L >> 1; off > 0; off >>= 1)
            rp = nmax(rp, __shfl_xor_sync(0xffffffffu, rp, off, L));
          const int r = r0 + u * NG + g;
          if (gl == 0 && r < R) atomicMax(&rowacc[r], Bits<T>::of(rp));
        }
      }
    }
    // the lane groups of a warp hold the same columns
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) cm[j] = nmax(cm[j], __shfl_xor_sync(0xffffffffu, cm[j], off));
    }
    if (lane < L && cok) {
#pragma unroll
      for (int j = 0; j < V; ++j) atomicMax(&colacc[c + j], Bits<T>::of(cm[j]));
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void scan_matrix(const T* M, int R, int C, typename Bits<T>::U* colacc,
                                            typename Bits<T>::U* rowacc, int tid, int lanes) {
  if (R != 0 && C != 0) scan<T, V>(M, R, C, colacc, rowacc, tid, lanes);
}

// The block's max (sum when `sum`) of every thread's v; `scratch` holds 32
// values.  Every thread of the block calls it.
template <typename T> __device__ T block_reduce(T v, bool sum, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    v = sum ? v + o : nmax(v, o);
  }
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_xor_sync(0xffffffffu, v, off);
      v = sum ? v + o : nmax(v, o);
    }
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  return scratch[0];
}

// ---------------------------------------------------------------------------
// norms
// ---------------------------------------------------------------------------

template <typename T> struct DenseArgs {
  const T* P;
  const T* A;
  const T* G;
  const unsigned char* active;
  T* out;
  long long B, n, p, m, sP, sA, sG;
};

// V: values a lane loads at once, 16 bytes' worth where every matrix's
// base, batch stride and rows are 16-byte aligned (the launcher checks), else 1
template <typename T, int V> __global__ void dense_kernel(const DenseArgs<T> a) {
  using U = typename Bits<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  U* acc = reinterpret_cast<U*>(smem);  // [n columns | p rows of A | m rows of G]
  const int n = a.n, p = a.p, m = a.m, w = n + p + m;
  const int tid = threadIdx.x, lanes = blockDim.x;
  for (long long b = blockIdx.x; b < a.B; b += gridDim.x) {
    T* out = a.out + b * w;
    if (!a.active[b]) {
      for (int i = tid; i < w; i += lanes) out[i] = T(0);
      continue;
    }
    for (int i = tid; i < w; i += lanes) acc[i] = 0;
    __syncthreads();
    scan_matrix<T, V>(a.P + b * a.sP, n, n, acc, nullptr, tid, lanes);
    scan_matrix<T, V>(a.A + b * a.sA, p, n, acc, acc + n, tid, lanes);
    scan_matrix<T, V>(a.G + b * a.sG, m, n, acc, acc + n + p, tid, lanes);
    __syncthreads();
    for (int i = tid; i < w; i += lanes) out[i] = val<T>(acc[i]);
    __syncthreads();
  }
}

// One value from device to shared memory without staging it in a
// register, so that every copy of an item is in flight at once
template <typename T> __device__ __forceinline__ void copy1(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N> __device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T> struct StageArgs {
  const T* M[9];  // Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg: the owned stages
  const unsigned char* active;
  T* out;
  long long B, Tl, horizon, start, D, Da, ra, rg;
  long long sM[9];  // batch strides; a stage is R x C values
  int R[9], C[9];
  int ld[9];        // the blocks' row strides in a slot: C, or C + 1 where C is even
  int off[9];       // the blocks' offsets in a slot, in values
  int slot;         // a slot's values
};

constexpr int kStageThreads = 128;

// An item's nine blocks, in a slot or where they lie, and their row strides
template <typename T> struct Blocks {
  const T* p[9];
  int ld[9];
};

// An item's nine blocks, (problem b, owned stage tl), into its slot, a
// value at a time so that the rows land on the slot's odd strides.  Every
// thread of the block calls it.
template <typename T>
__device__ void load_item(const StageArgs<T>& a, long long b, long long tl, T* slot) {
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll 1
  for (int k = 0; k < 9; ++k) {
    const int C = a.C[k], n = a.R[k] * C, S = a.ld[k];
    if (n == 0) continue;
    const T* src = a.M[k] + b * a.sM[k] + tl * n;
    T* dst = slot + a.off[k];
    int r = tid / C, c = tid - r * C;
    const int dr = nt / C, dc = nt - dr * C;
    for (int i = tid; i < n; i += nt) {
      copy1(dst + r * S + c, src + i);
      r += dr;
      c += dc;
      if (c >= C) {
        c -= C;
        ++r;
      }
    }
  }
}

// A run of n values M[i * step] of a block: a column (step: the row
// stride) or a row (step 1)
template <typename T> struct Run {
  const T* M;
  int n, step;
};

// max_i |M[i * step]|, four values at a time into four running maxima, so
// that their loads overlap (maxima are exact: their order changes nothing)
template <typename T> __device__ __forceinline__ T run_max(const T* p, int n, int step) {
  T m[4] = {T(0), T(0), T(0), T(0)};
  int i = 0;
  for (; i + 4 <= n; i += 4, p += 4 * step) {
#pragma unroll
    for (int u = 0; u < 4; ++u) m[u] = nmax(m[u], absval(p[u * step]));
  }
  for (; i < n; ++i, p += step) m[0] = nmax(m[0], absval(*p));
  return nmax(nmax(m[0], m[1]), nmax(m[2], m[3]));
}

// One item's norms from its blocks m into the output: a thread an output,
// each kind of output on warps of its own: the stage's own columns, in two
// halves (Pd's and Psub's; Pa's, A1's and G1's; D each), the next stage's
// share (A2's and G2's columns, Psub's rows; D), the arrow's (Ag's and
// Gg's columns, Pa's rows; Da), A's rows (A1, A2, Ag; ra), G's rows (G1,
// G2, Gg; rg).  An output is the maximum of its (at most three) runs,
// written by atomicMax on the bits: the output starts at zero, and the
// columns meet those of the items before and after (and the halves each
// other).  In a slot, the rows' odd strides put the lanes that read rows
// on distinct banks.
template <typename T>
__device__ void stage_item(const StageArgs<T>& a, long long b, long long tl, const Blocks<T>& m) {
  using U = typename Bits<T>::U;
  const int D = a.D, Da = a.Da, ra = a.ra, rg = a.rg;
  const long long Tl = a.Tl;
  const bool next = a.start + tl + 1 < a.horizon;
  const long long xw = (Tl + (a.start + Tl < a.horizon)) * D;
  U* o = reinterpret_cast<U*>(a.out) + b * (xw + Da + Tl * (ra + rg));
  U* oy = o + xw + Da + tl * ra;
  U* oz = o + xw + Da + Tl * ra + tl * rg;
  auto warps = [](int k) { return (k + 31) / 32 * 32; };
  const int g1 = warps(D), g2 = g1 + warps(D), g3 = g2 + warps(D), g4 = g3 + warps(Da);
  const int g5 = g4 + warps(ra), total = g5 + warps(rg);
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    Run<T> r0{m.p[0], 0, 1}, r1 = r0, r2 = r0;
    U* dst = nullptr;
    if (q < g2) {  // own column c
      const int c = q < g1 ? q : q - g1;
      if (c < D) {
        if (q < g1) {
          r0 = {m.p[0] + c, D, m.ld[0]};
          r1 = {m.p[1] + c, D, m.ld[1]};
        } else {
          r0 = {m.p[2] + c, Da, m.ld[2]};
          r1 = {m.p[3] + c, ra, m.ld[3]};
          r2 = {m.p[6] + c, rg, m.ld[6]};
        }
        dst = o + tl * D + c;
      }
    } else if (q < g3) {  // the next stage's column c
      const int c = q - g2;
      if (c < D && next) {
        r0 = {m.p[4] + c, ra, m.ld[4]};
        r1 = {m.p[7] + c, rg, m.ld[7]};
        r2 = {m.p[1] + c * m.ld[1], D, 1};
        dst = o + (tl + 1) * D + c;
      }
    } else if (q < g4) {  // arrow column g
      const int g = q - g3;
      if (g < Da) {
        r0 = {m.p[5] + g, ra, m.ld[5]};
        r1 = {m.p[8] + g, rg, m.ld[8]};
        r2 = {m.p[2] + g * m.ld[2], D, 1};
        dst = o + xw + g;
      }
    } else {  // A's (q < g5) or G's row r: A1, A2, Ag or G1, G2, Gg
      const bool isA = q < g5;
      const int r = q - (isA ? g4 : g5);
      if (r < (isA ? ra : rg)) {
        r0 = {(isA ? m.p[3] : m.p[6]) + r * (isA ? m.ld[3] : m.ld[6]), D, 1};
        r1 = {(isA ? m.p[4] : m.p[7]) + r * (isA ? m.ld[4] : m.ld[7]), D, 1};
        r2 = {(isA ? m.p[5] : m.p[8]) + r * (isA ? m.ld[5] : m.ld[8]), Da, 1};
        dst = (isA ? oy : oz) + r;
      }
    }
    if (!dst) continue;
    // one copy of the loop serves every run of every output, so that the
    // warps of a block, whatever outputs they hold, run the same few
    // instructions
    T x = T(0);
#pragma unroll 1
    for (int k = 0; k < 3; ++k)
      x = nmax(x, run_max(k == 0 ? r0.M : k == 1 ? r1.M : r2.M,
                          k == 0 ? r0.n : k == 1 ? r1.n : r2.n,
                          k == 0 ? r0.step : k == 1 ? r1.step : r2.step));
    atomicMax(dst, Bits<T>::of(x));
  }
}

// A problem and an owned stage, and whether the problem is active; next()
// moves to the next item (one read of the flags a problem)
template <typename T> struct Cursor {
  long long b, tl;
  bool on;
  __device__ Cursor(const StageArgs<T>& a, long long item)
      : b(item / a.Tl), tl(item - b * a.Tl), on(a.active[b]) {}
  __device__ void next(const StageArgs<T>& a) {
    if (++tl < a.Tl) return;
    tl = 0;
    if (++b < a.B) on = a.active[b];
  }
};

// A persistent block takes a run of consecutive items and streams them
// through a ring of kSlots slots in shared memory, kSlots - 1 items in
// flight while it computes one.  kMats false: the blocks are too large for
// two slots, and are read where they lie.
template <typename T, int kSlots, bool kMats>
__global__ void __launch_bounds__(kStageThreads) stage_kernel(const StageArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* smem = reinterpret_cast<T*>(smem_bytes);
  const long long items = a.B * a.Tl, per = (items + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per, count = min(items, first + per) - first;
  if (count <= 0) return;
  Cursor<T> in(a, first), at = in;  // the next item to load, the next to compute
  long long loaded = 0;
  auto prepare = [&](int slot) {
    if (loaded++ < count) {
      if (kMats && in.on) load_item<T>(a, in.b, in.tl, smem + slot * a.slot);
      in.next(a);
    }
    commit();
  };
#pragma unroll 1
  for (int s = 0; s + 1 < kSlots; ++s) prepare(s);
#pragma unroll 1
  for (long long k = 0; k < count; ++k) {
    prepare(static_cast<int>((k + kSlots - 1) % kSlots));
    wait_group<kSlots - 1>();
    __syncthreads();
    if (at.on) {
      const T* slot = smem + static_cast<int>(k % kSlots) * a.slot;
      Blocks<T> m;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        m.p[j] = kMats ? slot + a.off[j] : a.M[j] + at.b * a.sM[j] + at.tl * a.R[j] * a.C[j];
        m.ld[j] = kMats ? a.ld[j] : a.C[j];
      }
      stage_item<T>(a, at.b, at.tl, m);
    }
    at.next(a);
    __syncthreads();
  }
  wait_group<0>();
}

// ---------------------------------------------------------------------------
// steps
// ---------------------------------------------------------------------------

template <typename T> struct StepArgs {
  const T* norms;  // (B, n + pm)
  const T* Pc;     // (B, Da, Da), rows packed: the scaled P[g, g]
  T* d;            // (B, 2n + pm)
  T* s;            // (B, 2n + pm): the pass's scalings
  T* xb;           // (B, n)
  T* cvec;         // (B, n)
  T* measure;
  const unsigned char* active;
  long long B, n, pm, Da, sPc;
};

constexpr int kStepThreads = 256;

// P[g, g]'s column norms into pcn[0, Da)
template <typename T> __device__ void pc_norms(const T* Pc, int Da, T* pcn) {
  for (int c = threadIdx.x; c < Da; c += blockDim.x) {
    T mx = T(0);
    for (int r = 0; r < Da; ++r) mx = nmax(mx, absval(Pc[r * Da + c]));
    pcn[c] = mx;
  }
}

template <typename T> __global__ void step_kernel(const StepArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* scratch = reinterpret_cast<T*>(smem);  // 32 values, then P[g, g]'s column norms
  T* pcn = scratch + 32;
  const int n = a.n, pm = a.pm, Da = a.Da, g0 = n - Da;
  for (long long b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (!a.active[b]) continue;
    const T* nb = a.norms + b * (n + pm);
    T* d = a.d + b * (2 * n + pm);
    T* s = a.s + b * (2 * n + pm);
    T* xb = a.xb + b * n;
    T* cv = a.cvec + b * n;
    pc_norms<T>(a.Pc + b * a.sPc, Da, pcn);
    __syncthreads();
    T meas = T(0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      T nx = nb[i];
      if (i >= g0) nx = nmax(nx, pcn[i - g0]);
      const T x = xb[i];
      nx = nmax(nx, x);
      const T sx = step_of(nx), sb = step_of(x);
      s[i] = sx;
      s[n + pm + i] = sb;
      d[i] *= sx;
      d[n + pm + i] *= sb;
      xb[i] = x * sb * sx;
      cv[i] *= sx;
      meas = nmax(meas, absval(T(1) - sx));
      meas = nmax(meas, absval(T(1) - sb));
    }
    for (int j = threadIdx.x; j < pm; j += blockDim.x) {
      const T sy = step_of(nb[n + j]);
      s[n + j] = sy;
      d[n + j] *= sy;
      meas = nmax(meas, absval(T(1) - sy));
    }
    meas = block_reduce(meas, false, scratch);
    if (threadIdx.x == 0) a.measure[b] = meas;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// scale
// ---------------------------------------------------------------------------

// A batch of matrices scaled in place: problem b's K stages (rows packed,
// R x C a stage, batch stride sM); the factor of row i of stage k is
// r[b * rb + k * rk + i], of column j c[b * cb + k * ck + j], 0 where
// rnext (cnext) and stage start + k + 1 lies past the horizon
template <typename T> struct ScaleMat {
  T* M;
  const T* r;
  const T* c;
  long long sM, rb, cb;
  int K, R, C, rk, ck, rnext, cnext;
};

template <typename T> struct ScaleArgs {
  ScaleMat<T> m[9];
  const unsigned char* active;
  long long B, start, horizon;
};

constexpr int kScaleThreads = 256;

// A block a (problem, matrix), its threads on neighbouring values, four
// values a thread loaded before any is used: M <- (M r_i) c_j, rounded as
// the reference rounds it.  An inactive problem's matrices are neither
// read nor written.
template <typename T> __global__ void __launch_bounds__(kScaleThreads)
    scale_kernel(const ScaleArgs<T> a) {
  const long long b = blockIdx.x;
  const ScaleMat<T>& m = a.m[blockIdx.y];
  if (!a.active[b]) return;
  const int R = m.R, C = m.C, RC = R * C, N = m.K * RC;
  T* M = m.M + b * m.sM;
  const T* r = m.r + b * m.rb;
  const T* c = m.c + b * m.cb;
  constexpr int kU = 4;
  for (int e0 = threadIdx.x; e0 < N; e0 += kU * blockDim.x) {
    T v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < N ? M[e] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= N) break;
      const int k = e / RC, q = e - k * RC, i = q / C, j = q - i * C;
      const bool past = a.start + k + 1 >= a.horizon;
      const T ri = m.rnext && past ? T(0) : r[k * m.rk + i];
      const T cj = m.cnext && past ? T(0) : c[k * m.ck + j];
      M[e] = v[u] * ri * cj;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kDenseThreads = 256;
constexpr size_t kSmemLimit = 232448;

struct Fit {
  const void* kernel;
  size_t smem;
  int threads, dev;
  long long blocks;
};

// The blocks of `kernel` that are resident on the device at once, `threads`
// and `smem` bytes of shared memory each: asked of the runtime (and the
// shared memory allowed) at the first launch of each kernel, size and
// device, and kept for the later ones
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, long long* blocks) {
  static std::mutex mu;
  static std::vector<Fit> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const Fit& f : known)
    if (f.kernel == key && f.smem == smem && f.threads == threads && f.dev == dev) {
      *blocks = f.blocks;
      return cudaSuccess;
    }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  known.push_back({key, smem, threads, dev, *blocks});
  return cudaSuccess;
}

template <typename Kernel, typename Args>
int run(Kernel kernel, const Args& args, long long blocks, int threads, size_t smem,
        void* stream) {
  if (blocks == 0) return 0;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  long long fit = 0;
  const cudaError_t err = resident_blocks(kernel, threads, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(blocks < fit ? blocks : fit);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// whether a batch of matrices of C columns (rows packed) at M, batch stride
// s values, takes 16-byte loads
template <typename T> bool aligned(const T* M, long long s, long long C) {
  return (reinterpret_cast<uintptr_t>(M) & 15) == 0 && ((s * sizeof(T)) & 15) == 0 &&
         ((C * sizeof(T)) & 15) == 0;
}

// ptrs: P, A, G, active, out; dims: B, n, p, m, and the batch strides of
// P, A, G
template <typename T>
int norms_dense(const void* const* ptrs, const long long* dims, void* stream) {
  DenseArgs<T> a;
  a.P = static_cast<const T*>(ptrs[0]);
  a.A = static_cast<const T*>(ptrs[1]);
  a.G = static_cast<const T*>(ptrs[2]);
  a.active = static_cast<const unsigned char*>(ptrs[3]);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[4]));
  a.B = dims[0]; a.n = dims[1]; a.p = dims[2]; a.m = dims[3];
  a.sP = dims[4]; a.sA = dims[5]; a.sG = dims[6];
  const size_t smem = static_cast<size_t>(a.n + a.p + a.m) * sizeof(typename Bits<T>::U);
  const bool vec = aligned<T>(a.P, a.sP, a.n) && aligned<T>(a.A, a.sA, a.n) &&
                   aligned<T>(a.G, a.sG, a.n);
  return vec ? run(dense_kernel<T, Vec<T>::n>, a, a.B, kDenseThreads, smem, stream)
             : run(dense_kernel<T, 1>, a, a.B, kDenseThreads, smem, stream);
}

// ptrs: Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg, active, out (zeroed); dims: B,
// Tl, T, start, D, Da, ra, rg, and the nine blocks' batch strides
template <typename T>
int norms_stage(const void* const* ptrs, const long long* dims, void* stream) {
  StageArgs<T> a;
  for (int k = 0; k < 9; ++k) a.M[k] = static_cast<const T*>(ptrs[k]);
  a.active = static_cast<const unsigned char*>(ptrs[9]);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[10]));
  a.B = dims[0]; a.Tl = dims[1]; a.horizon = dims[2]; a.start = dims[3];
  a.D = dims[4]; a.Da = dims[5]; a.ra = dims[6]; a.rg = dims[7];
  for (int k = 0; k < 9; ++k) a.sM[k] = dims[8 + k];
  const long long R[9] = {a.D, a.D, a.Da, a.ra, a.ra, a.ra, a.rg, a.rg, a.rg};
  const long long C[9] = {a.D, a.D, a.D, a.D, a.D, a.Da, a.D, a.D, a.Da};
  long long mats = 0;
  for (int k = 0; k < 9; ++k) {
    a.R[k] = static_cast<int>(R[k]);
    a.C[k] = static_cast<int>(C[k]);
    a.ld[k] = static_cast<int>(C[k] % 2 == 0 ? C[k] + 1 : C[k]);
    a.off[k] = static_cast<int>(mats);
    mats += R[k] * a.ld[k];
  }
  // a slot rounded to 16 bytes
  const long long per16 = 16 / static_cast<long long>(sizeof(T));
  const long long slot = (mats + per16 - 1) / per16 * per16;
  const long long bytes = slot * static_cast<long long>(sizeof(T)), items = a.B * a.Tl;
  a.slot = static_cast<int>(slot);
  // three slots where they leave room for two blocks an SM, else two, else
  // the blocks are read where they lie
  if (3 * bytes <= static_cast<long long>(kSmemLimit) / 2)
    return run(stage_kernel<T, 3, true>, a, items, kStageThreads, 3 * bytes, stream);
  if (2 * bytes <= static_cast<long long>(kSmemLimit))
    return run(stage_kernel<T, 2, true>, a, items, kStageThreads, 2 * bytes, stream);
  a.slot = 0;
  return run(stage_kernel<T, 1, false>, a, items, kStageThreads, 0, stream);
}

// ptrs: norms, Pc, d, s, xb, cvec, measure, active; dims: B, n, p + m, Da,
// Pc's batch stride
template <typename T> int step(const void* const* ptrs, const long long* dims, void* stream) {
  StepArgs<T> a;
  a.norms = static_cast<const T*>(ptrs[0]);
  a.Pc = static_cast<const T*>(ptrs[1]);
  a.d = static_cast<T*>(const_cast<void*>(ptrs[2]));
  a.s = static_cast<T*>(const_cast<void*>(ptrs[3]));
  a.xb = static_cast<T*>(const_cast<void*>(ptrs[4]));
  a.cvec = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.measure = static_cast<T*>(const_cast<void*>(ptrs[6]));
  a.active = static_cast<const unsigned char*>(ptrs[7]);
  a.B = dims[0]; a.n = dims[1]; a.pm = dims[2]; a.Da = dims[3]; a.sPc = dims[4];
  const size_t smem = static_cast<size_t>(32 + a.Da) * sizeof(T);
  return run(step_kernel<T>, a, a.B, kStepThreads, smem, stream);
}

// One launch over nm matrices: a block a (problem, matrix)
template <typename T> int run_scale(const ScaleArgs<T>& a, int nm, void* stream) {
  if (a.B == 0 || nm == 0) return 0;
  const dim3 grid(static_cast<unsigned>(a.B), static_cast<unsigned>(nm));
  scale_kernel<T><<<grid, kScaleThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
ScaleMat<T> scale_mat(void* M, long long sM, long long K, long long R, long long C, const T* r,
                      long long rb, long long rk, const T* c, long long cb, long long ck,
                      int rnext, int cnext) {
  ScaleMat<T> m;
  m.M = static_cast<T*>(M);
  m.sM = sM; m.K = static_cast<int>(K); m.R = static_cast<int>(R); m.C = static_cast<int>(C);
  m.r = r; m.rb = rb; m.rk = static_cast<int>(rk);
  m.c = c; m.cb = cb; m.ck = static_cast<int>(ck);
  m.rnext = rnext; m.cnext = cnext;
  return m;
}

// ptrs: P, A, G, dx, dy, dz, active; dims: B, n, p, m, ldx, ldy, ldz, and
// the batch strides of P, A, G
template <typename T>
int scale_dense(const void* const* ptrs, const long long* dims, void* stream) {
  ScaleArgs<T> a;
  const T* dx = static_cast<const T*>(ptrs[3]);
  const T* dy = static_cast<const T*>(ptrs[4]);
  const T* dz = static_cast<const T*>(ptrs[5]);
  a.active = static_cast<const unsigned char*>(ptrs[6]);
  a.B = dims[0]; a.start = 0; a.horizon = 1;
  const long long n = dims[1], rows[3] = {dims[1], dims[2], dims[3]};
  const T* rf[3] = {dx, dy, dz};
  const long long ld[3] = {dims[4], dims[5], dims[6]};
  int nm = 0;
  for (int k = 0; k < 3; ++k)
    if (rows[k] * n > 0)
      a.m[nm++] = scale_mat<T>(const_cast<void*>(ptrs[k]), dims[7 + k], 1, rows[k], n, rf[k],
                               ld[k], 0, dx, dims[4], 0, 0, 0);
  return run_scale(a, nm, stream);
}

// ptrs: Pd, Psub, Pa, A1, A2, Ag, G1, G2, Gg, dx, dg, dy, dz, active; dims:
// B, Tl, T, start, D, Da, ra, rg, ldx, ldg, ldy, ldz, and the nine blocks'
// batch strides
template <typename T>
int scale_stage(const void* const* ptrs, const long long* dims, void* stream) {
  ScaleArgs<T> a;
  const T* dx = static_cast<const T*>(ptrs[9]);
  const T* dg = static_cast<const T*>(ptrs[10]);
  const T* dy = static_cast<const T*>(ptrs[11]);
  const T* dz = static_cast<const T*>(ptrs[12]);
  a.active = static_cast<const unsigned char*>(ptrs[13]);
  a.B = dims[0]; a.start = dims[3]; a.horizon = dims[2];
  const long long Tl = dims[1], s0 = dims[3], D = dims[4], Da = dims[5], ra = dims[6],
                  rg = dims[7], ldx = dims[8], ldg = dims[9], ldy = dims[10], ldz = dims[11];
  const T* xo = dx + s0 * D;        // the owned stages' dx
  const T* xn = dx + (s0 + 1) * D;  // the next stages' (zero past the horizon)
  const T* yo = dy + s0 * ra;
  const T* zo = dz + s0 * rg;
  // rows (factor, batch stride, stage stride, next), columns likewise
  struct Spec { long long R, C; const T* r; long long rb, rk; int rn; const T* c; long long cb, ck; int cn; };
  const Spec spec[9] = {
      {D, D, xo, ldx, D, 0, xo, ldx, D, 0},      // Pd
      {D, D, xn, ldx, D, 1, xo, ldx, D, 0},      // Psub = P[t+1, t]
      {Da, D, dg, ldg, 0, 0, xo, ldx, D, 0},     // Pa = P[g, t]
      {ra, D, yo, ldy, ra, 0, xo, ldx, D, 0},    // A1
      {ra, D, yo, ldy, ra, 0, xn, ldx, D, 1},    // A2: columns of t+1
      {ra, Da, yo, ldy, ra, 0, dg, ldg, 0, 0},   // Ag
      {rg, D, zo, ldz, rg, 0, xo, ldx, D, 0},    // G1
      {rg, D, zo, ldz, rg, 0, xn, ldx, D, 1},    // G2
      {rg, Da, zo, ldz, rg, 0, dg, ldg, 0, 0}};  // Gg
  int nm = 0;
  for (int k = 0; k < 9; ++k) {
    const Spec& q = spec[k];
    if (Tl * q.R * q.C > 0)
      a.m[nm++] = scale_mat<T>(const_cast<void*>(ptrs[k]), dims[12 + k], Tl, q.R, q.C, q.r, q.rb,
                               q.rk, q.c, q.cb, q.ck, q.rn, q.cn);
  }
  return run_scale(a, nm, stream);
}

}  // namespace

#define PIQP_RUIZ_ENTRY(name, fn, T)                                                  \
  extern "C" int name(const void* const* ptrs, const long long* dims, void* stream) { \
    return fn<T>(ptrs, dims, stream);                                                 \
  }

PIQP_RUIZ_ENTRY(piqp_ruiz_norms_dense_f32, norms_dense, float)
PIQP_RUIZ_ENTRY(piqp_ruiz_norms_dense_f64, norms_dense, double)
PIQP_RUIZ_ENTRY(piqp_ruiz_norms_stage_f32, norms_stage, float)
PIQP_RUIZ_ENTRY(piqp_ruiz_norms_stage_f64, norms_stage, double)
PIQP_RUIZ_ENTRY(piqp_ruiz_step_f32, step, float)
PIQP_RUIZ_ENTRY(piqp_ruiz_step_f64, step, double)
PIQP_RUIZ_ENTRY(piqp_ruiz_scale_dense_f32, scale_dense, float)
PIQP_RUIZ_ENTRY(piqp_ruiz_scale_dense_f64, scale_dense, double)
PIQP_RUIZ_ENTRY(piqp_ruiz_scale_stage_f32, scale_stage, float)
PIQP_RUIZ_ENTRY(piqp_ruiz_scale_stage_f64, scale_stage, double)
