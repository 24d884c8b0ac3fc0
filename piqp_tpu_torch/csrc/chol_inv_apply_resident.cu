// Batched Cholesky with fused triangular inverse and apply (K2), the
// resident route: one block per matrix, the matrix and its right-hand
// block resident in shared memory and eliminated together.
//
// Replaces the TPU kernel piqp_tpu/ops/pallas_chol.py::_chol_inv_apply_kernel
// for every n > 32 (and every smaller n whose right-hand block is too wide
// for the small kernel) whose working set below fits one block's 227 KB of
// shared memory: with r = 2n + 4, n <= 138 in float32 and n <= 97 in
// float64.  Wider shapes up to n = 256 take the split route (K1's kernel,
// then chol_inv_apply_product.cu); n <= 32 with a narrow right-hand block takes
// chol_inv_apply_small.cu (ops/chol_inv.py routes by shape).  For each SPD
// block K (n x n) of an (N, n, n) batch and its right-hand block RHS (n x r)
// it writes
//
//   L = chol(K)        strict upper triangle zero,
//   Linv = L^-1        upper triangle zero,
//   Y = Linv^T (Linv RHS) = K^-1 RHS.
//
// Only K's lower triangle is read.  A pivot <= 0 gives rsqrt of a
// non-positive number and non-finite L, Linv and Y for its block only;
// nothing clamps it (the cyclic-reduction level's ok flag reads it).
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them).  The kernel
// must read K's lower triangle and RHS once and write L, Linv and Y once,
// N (n(n+1)/2 + 2n^2 + 2nr) elements, against about 2n^3/3 + 2n^2 r flops a
// block.  At the D = 48 multistage fleet's first cyclic-reduction level,
// N = 2,560, n = 48, r = 100: 157.5 MB f32 (47.0 us) or 315.1 MB f64
// (94.0 us) against 1.37 GFLOP (20.4 us); at n = 64, r = 132: 83.0 / 166.1
// us against 3.22 GFLOP (48.0 us).  Bound by bytes in both types; what
// sets the pace instead is each block's chain of n / 8 panels with two
// barriers each, overlapped only by the other blocks resident on its SM.
//
// Algorithm: K1's resident elimination (chol_inv_resident.cu) of one
// n x (n + r) work square M = [K | RHS].  Column j of the elimination forms
// row j of Linv (left of the diagonal), 1/d and column j of L (below it),
// and, right of the n x n square, row j of Z = Linv RHS: the right-hand
// columns are eliminated by the same row updates as the carried identity,
// which is the forward substitution L Z = RHS.  So Z comes out of the
// updates that build Linv, and the first of the two products disappears.
// The columns go in panels of kNb = 8.  Per panel [j0, j1):
//   A. one warp factors the 8 x 8 diagonal block and inverts its factor in
//      registers, every lane on the same values (K1's phase A, unchanged);
//   B. one thread per column x outside the panel, right-hand columns
//      included, forms the panel rows' strip: Linv_pp M[panel, x] left of
//      the panel and right of the square, Linv_pp M[x, panel]^T below it.
//      A thread below the panel also writes its row's panel columns,
//      -L[x, panel] Linv_pp, which K1 leaves to phase C;
//   C. the rows below take the rank-8 update from the strip.  A warp owns
//      kRows = 4 rows by its lanes' columns, held in registers across the 8
//      strip rows.  The tile's columns are a run of virtual columns: the
//      square's columns up to its last row, then the r right-hand columns,
//      so at most 31 lanes of a tile row idle; a run wider than the
//      instance's register tile (4 chunks of 32 in f32, 6 in f64) is taken
//      in pieces.  The strip loop has no masks: a lane whose cell is not
//      its row's (past the run, above the diagonal, in the panel, or a row
//      past n) reads a clamped cell and never stores.  Warp 0 updates the
//      next panel's rows first and factors its diagonal block while the
//      others finish (lookahead), so a panel costs two __syncthreads.
// Then Y = Linv^T Z, one product over the lower triangle, from shared
// memory: a warp's tile is kRows rows of Y by its lanes' columns, summed
// in registers over the rows l >= i of Linv and Z (Linv[l, i] broadcast,
// Z[l, :] across the lanes), and stored straight to device memory, so no
// in-place order is needed.  Tiles are dealt to the warps in a snake over
// row groups, longest first, so every warp gets about as many terms.
// K's lower triangle and RHS come in by cp.async of one element each (the
// odd pitch rules out 16-byte copies), all in flight at once; L (M's strict
// upper triangle, transposed) and Linv (its lower triangle) are each
// written once, row by row, before the product starts.
//
// Where the time goes (scripts/phase_probe.py: the global timer read by
// one block's thread 0 after each barrier, under the full launch; PERF.md
// keeps the numbers): every phase is slower than its own instruction
// chain, because the SM's warps share its issue slots; the panels' phases
// C and A take about half of a block's time, phase B and the product a
// quarter.  The element-wise async copies and the mask-free phase C cut
// the f32 time at D = 48 by 13% against loads staged through registers
// and a masked strip loop.
//
// Placement: blocks of apply_threads(n) threads: 128 up to n = 64, 256
// above.  Shared memory is apply_smem_bytes(n, r, elem), the n x (n + r)
// square with an odd row pitch ((n + r) | 1, so the column reads of phase B
// and the store pass hit 32 banks) and diag(L):
//   n = 48, r = 100:  28,800 B f32 (7 blocks an SM by shared memory),
//                     57,600 B f64 (3);
//   n = 64, r = 132:  50,688 B f32 (4), 101,376 B f64 (2);
// (228 KB an SM, 1 KB reserved per block).  __launch_bounds__ asks for 7
// blocks of 128 threads in f32 and 3 in f64, for 2 of 256 threads in f32
// and 1 in f64.  ptxas: f32 72 registers at 128 threads, 96 at 256; f64
// 167 at both; no spills.  The f32 tile and block count were chosen with
// scripts/time_kernel.py K2 over variants of this file, before the async
// copies (device ms at N = 2,560, D = 48 / 64, NVIDIA H100 80GB HBM3,
// 700 W): a 4-chunk tile at 7 blocks 0.2858 / 0.6614; a 6-chunk tile at 7
// (72 registers, 460 bytes spilled) 0.2958 / 0.6733, at 6 (80) 0.3075 /
// 0.6302; an 8-chunk tile at 7 (676 bytes spilled) 0.2979 / 0.6774, at 6
// 0.3161 / 0.6414, at 5 (96 registers) 0.3078 / 0.6389.  So blocks an SM
// count for more than spills at D = 48, the fleet's shape.
//
// Rounding: rsqrt pivots and blocked sums, as K1, so the last bits differ
// from the plain version's; chip_smoke.py holds L to 5e-5 / 1e-11 of
// max |L| and Y to 1e-5 / 1e-13 of max |Y| (f32 / f64).

#include <cuda_runtime.h>

namespace {

constexpr int kNb = 8;         // panel width
constexpr int kRows = 4;       // rows of a warp's tile in phase C and in the product
constexpr int kMaxN = 256;
constexpr int kSmallBlockN = 64;       // the largest n of a 128-thread block
constexpr int kSmemPerBlock = 232448;  // dynamic shared memory a block may opt into

constexpr int apply_smem_bytes(int n, int r, int elem) { return (n * ((n + r) | 1) + n) * elem; }

constexpr int apply_threads(int n) { return n <= kSmallBlockN ? 128 : 256; }

// blocks per SM the instance's registers are budgeted for
constexpr int min_blocks(int threads, int elem) {
  return threads == 128 ? (elem == 4 ? 7 : 3) : (elem == 4 ? 2 : 1);
}

// column chunks of 32 in a warp's register tile
template <typename T>
constexpr int kTileChunks = sizeof(T) == 4 ? 4 : 6;

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

// Copy one element from device to shared memory without staging it in a
// register (cp.async of 4 or 8 bytes: any alignment), so every copy of the
// block is in flight at once; the caller waits with cp.async.wait_all.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  }
}

// K's lower triangle (one warp per row, lanes on neighbouring columns) and
// RHS (n x r, contiguous, neighbouring threads on neighbouring elements)
// into M, issued without waiting
template <typename T, int kThreads>
__device__ __forceinline__ void load_async(const T* __restrict__ K, const T* __restrict__ RHS,
                                           T* M, int n, int r, int P) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < n; row += kWarps) {
    for (int c = lane; c <= row; c += 32) {
      copy_async(M + row * P + c, K + static_cast<size_t>(row) * n + c);
    }
  }
  const int total = n * r;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int row = idx / r;
    copy_async(M + row * P + n + idx - row * r, RHS + idx);
  }
}

// L (M's strict upper triangle transposed, diag on the diagonal) and Linv
// (M's lower triangle) row by row, zeros included
template <typename T, int kWarps>
__device__ __forceinline__ void store_factors(const T* M, const T* diag, T* __restrict__ L,
                                              T* __restrict__ Li, int n, int P) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += kWarps) {
    for (int c = lane; c < n; c += 32) {
      T l = T(0), li = T(0);
      if (c < r) {
        l = M[c * P + r];
        li = M[r * P + c];
      } else if (c == r) {
        l = diag[r];
        li = M[r * P + r];
      }
      L[static_cast<size_t>(r) * n + c] = l;
      Li[static_cast<size_t>(r) * n + c] = li;
    }
  }
}

// Phase A, one warp (K1's): factor the nbp x nbp diagonal block at j0 and
// invert its factor in registers by the carried-identity elimination;
// L_pp^T into M's upper block, d into diag, Linv_pp into M's lower block
template <typename T>
__device__ __forceinline__ void factor_diagonal_block(T* M, T* diag, int P, int j0, int nbp) {
  const int lane = threadIdx.x & 31;
  T a[kNb][kNb];
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      a[i][k] = i < nbp ? M[(j0 + i) * P + j0 + k] : T(i == k ? 1 : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const T dinv = rsqrt_of(a[k][k]);
    if (lane == k && k < nbp) diag[j0 + k] = a[k][k] * dinv;
#pragma unroll
    for (int c = 0; c < k; ++c) a[k][c] *= dinv;
    a[k][k] = dinv;
    T v[kNb];
#pragma unroll
    for (int i = k + 1; i < kNb; ++i) {
      v[i] = a[i][k] * dinv;
      a[i][k] = T(0);
      if (lane == i && i < nbp) M[(j0 + k) * P + j0 + i] = v[i];
    }
#pragma unroll
    for (int i = k + 1; i < kNb; ++i) {
#pragma unroll
      for (int c = 0; c <= i; ++c) a[i][c] -= v[i] * (c < k ? a[k][c] : (c == k ? dinv : v[c]));
    }
  }
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    if (i == lane && i < nbp) {
#pragma unroll
      for (int k = 0; k <= i; ++k) M[(j0 + i) * P + j0 + k] = a[i][k];
    }
  }
}

// Phase C for kRows rows g.. of one warp over KC chunks of virtual columns
// from e0: virtual column e is the square's column e below cut (the
// tile's last row + 1) and right-hand column e - cut after it.
// M[i, c] -= sum_s S[s, i] S[s, c] over the kNb strip rows S = M[j0 + s, :]
// (phase C runs only after a whole panel: a narrower one is the last), for
// c <= i in the square outside the panel and every right-hand column; the
// panel's own columns come from phase B.  A lane whose column lies past
// the run or is not its row's reads a clamped column and never stores, so
// the strip loop needs no masks: rows past n read cells of M or diag.
template <typename T, int KC>
__device__ __forceinline__ void update_chunks(T* M, int P, int n, int g, int j0, int e0,
                                              int cut, int ncols) {
  const int lane = threadIdx.x & 31;
  const int j1 = j0 + kNb;
  int col[KC];  // physical column, -1 past the run
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int e = e0 + lane + 32 * k;
    col[k] = e < cut ? e : (e < ncols ? e - cut + n : -1);
  }
  T acc[kRows][KC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = col[k];
      const int i = g + q;
      const bool mine = i < n && c >= 0 && (c >= n || (c <= i && (c < j0 || c >= j1)));
      acc[q][k] = mine ? M[i * P + c] : T(0);
    }
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) col[k] = max(col[k], 0);
#pragma unroll
  for (int s = 0; s < kNb; ++s) {
    const T* srow = M + (j0 + s) * P;
    T u[kRows], v[KC];
#pragma unroll
    for (int q = 0; q < kRows; ++q) u[q] = srow[g + q];
#pragma unroll
    for (int k = 0; k < KC; ++k) v[k] = srow[col[k]];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[q][k] -= u[q] * v[k];
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int e = e0 + lane + 32 * k;
      const int c = e < cut ? e : e - cut + n;
      const int i = g + q;
      if (i < n && e < ncols && (c >= n || (c <= i && (c < j0 || c >= j1)))) {
        M[i * P + c] = acc[q][k];
      }
    }
  }
}

// update_chunks with a run-time chunk count kc, uniform across the warp,
// mapped to a compile-time KC
template <typename T, int KC>
__device__ __forceinline__ void update_upto(T* M, int P, int n, int g, int j0, int e0, int cut,
                                            int ncols, int kc) {
  if constexpr (KC < kTileChunks<T>) {
    if (kc == KC) {
      update_chunks<T, KC>(M, P, n, g, j0, e0, cut, ncols);
    } else {
      update_upto<T, KC + 1>(M, P, n, g, j0, e0, cut, ncols, kc);
    }
  } else {
    update_chunks<T, KC>(M, P, n, g, j0, e0, cut, ncols);
  }
}

// Phase C for the tile of rows g..: its run of virtual columns, in pieces
// of at most kTileChunks<T> chunks
template <typename T>
__device__ __forceinline__ void update_tile(T* M, int P, int n, int r, int g, int j0) {
  constexpr int kSpan = 32 * kTileChunks<T>;
  const int cut = min(g + kRows, n);
  const int ncols = cut + r;
  for (int e0 = 0; e0 < ncols; e0 += kSpan) {
    const int kc = min(kTileChunks<T>, (ncols - e0 + 31) / 32);
    update_upto<T, 1>(M, P, n, g, j0, e0, cut, ncols, kc);
  }
}

// Y[i0 + q, e0 + lane + 32 k] = sum_{l >= i0 + q} Linv[l, i0 + q] Z[l, ...]
// for KC chunks of right-hand columns, summed in registers and stored.  The
// first kRows rows l mask the cells above the diagonal; a lane past the
// last column reads a clamped one and does not store.
template <typename T, int KC>
__device__ __forceinline__ void apply_chunks(const T* M, T* __restrict__ Y, int P, int n, int r,
                                             int i0, int e0) {
  const int lane = threadIdx.x & 31;
  int col[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) col[k] = n + min(e0 + lane + 32 * k, r - 1);
  T acc[kRows][KC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[q][k] = T(0);
  }
#pragma unroll
  for (int d = 0; d < kRows; ++d) {
    const int l = i0 + d;
    if (l < n) {
      const T* row = M + l * P;
      T u[kRows], v[KC];
#pragma unroll
      for (int q = 0; q < kRows; ++q) u[q] = q <= d ? row[i0 + q] : T(0);
#pragma unroll
      for (int k = 0; k < KC; ++k) v[k] = row[col[k]];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[q][k] += u[q] * v[k];
      }
    }
  }
#pragma unroll 2
  for (int l = i0 + kRows; l < n; ++l) {
    const T* row = M + l * P;
    T u[kRows], v[KC];
#pragma unroll
    for (int q = 0; q < kRows; ++q) u[q] = row[i0 + q];
#pragma unroll
    for (int k = 0; k < KC; ++k) v[k] = row[col[k]];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[q][k] += u[q] * v[k];
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = e0 + lane + 32 * k;
      if (i0 + q < n && c < r) Y[static_cast<size_t>(i0 + q) * r + c] = acc[q][k];
    }
  }
}

template <typename T, int KC>
__device__ __forceinline__ void apply_upto(const T* M, T* __restrict__ Y, int P, int n, int r,
                                           int i0, int e0, int kc) {
  if constexpr (KC < kTileChunks<T>) {
    if (kc == KC) {
      apply_chunks<T, KC>(M, Y, P, n, r, i0, e0);
    } else {
      apply_upto<T, KC + 1>(M, Y, P, n, r, i0, e0, kc);
    }
  } else {
    apply_chunks<T, KC>(M, Y, P, n, r, i0, e0);
  }
}

// Y = Linv^T Z over the block's warps: tiles (row group t, column piece p)
// in order of decreasing length, dealt in a snake (warps 0..W-1, then
// W-1..0, ...)
template <typename T, int kWarps>
__device__ __forceinline__ void apply_transpose(const T* M, T* __restrict__ Y, int n, int r,
                                                int P) {
  constexpr int kSpan = 32 * kTileChunks<T>;
  const int warp = threadIdx.x >> 5;
  const int pieces = (r + kSpan - 1) / kSpan;
  const int tiles = ((n + kRows - 1) / kRows) * pieces;
  for (int round = 0; round * kWarps < tiles; ++round) {
    const int it = round * kWarps + ((round & 1) ? kWarps - 1 - warp : warp);
    if (it >= tiles) continue;
    const int i0 = (it / pieces) * kRows;
    const int e0 = (it % pieces) * kSpan;
    const int kc = min(kTileChunks<T>, (r - e0 + 31) / 32);
    apply_upto<T, 1>(M, Y, P, n, r, i0, e0, kc);
  }
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, min_blocks(kThreads, sizeof(T)))
chol_inv_apply_resident_kernel(const T* __restrict__ K, const T* __restrict__ RHS,
                               T* __restrict__ L_out, T* __restrict__ Linv_out,
                               T* __restrict__ Y_out, int n, int r) {
  static_assert(kNb % kRows == 0 && kNb <= 32, "warp 0 takes the next panel's rows whole");
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int P = (n + r) | 1;
  T* diag = M + n * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t roffset = static_cast<size_t>(blockIdx.x) * n * r;

  load_async<T, kThreads>(K + offset, RHS + roffset, M, n, r, P);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (warp == 0) factor_diagonal_block<T>(M, diag, P, 0, min(kNb, n));
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += kNb) {
    const int nbp = min(kNb, n - j0);
    const int j1 = j0 + nbp;

    // B: the panel rows' strip, one thread per column outside the panel:
    // columns left of it and right-hand columns along the panel rows,
    // columns below it along the panel columns (transposed).  A row i below
    // the panel also gets its panel columns, which phase C would start from
    // 0: Z[i, j0 + c] = -sum_{s >= c} L[i, j0 + s] Linv_pp[s, c].
    for (int x = tid; x < n - nbp + r; x += kThreads) {
      const int col = x < j0 ? x : x + nbp;
      const bool along = col < j0 || col >= n;
      T m[kNb];
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        m[k] = k >= nbp ? T(0) : (along ? M[(j0 + k) * P + col] : M[col * P + j0 + k]);
      }
      T y[kNb];
#pragma unroll
      for (int s = 0; s < kNb; ++s) {
        const T* ipp = M + (j0 + s) * P + j0;
        y[s] = T(0);
#pragma unroll
        for (int k = 0; k <= s; ++k) y[s] += (s < nbp ? ipp[k] : T(0)) * m[k];
      }
#pragma unroll
      for (int s = 0; s < kNb; ++s) {
        if (s < nbp) M[(j0 + s) * P + col] = y[s];
      }
      if (!along) {
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          T z = T(0);
#pragma unroll
          for (int s = c; s < kNb; ++s) z -= (s < nbp ? M[(j0 + s) * P + j0 + c] : T(0)) * y[s];
          if (c < nbp) M[col * P + j0 + c] = z;
        }
      }
    }
    __syncthreads();

    // C: rows i >= j1; warp 0 takes the next panel's rows and then factors
    // its diagonal block, the other warps the rest
    if (warp == 0) {
      const int next = min(kNb, n - j1);
      for (int g = j1; g < j1 + next; g += kRows) update_tile<T>(M, P, n, r, g, j0);
      if (next > 0) {
        __syncwarp();
        factor_diagonal_block<T>(M, diag, P, j1, next);
      }
    } else {
      for (int g = j1 + kNb + kRows * (warp - 1); g < n; g += kRows * (kWarps - 1)) {
        update_tile<T>(M, P, n, r, g, j0);
      }
    }
    __syncthreads();
  }
  store_factors<T, kWarps>(M, diag, L_out + offset, Linv_out + offset, n, P);
  apply_transpose<T, kWarps>(M, Y_out + roffset, n, r, P);
}

template <typename T, int kThreads>
cudaError_t launch_threads(const T* K, const T* RHS, T* L, T* Linv, T* Y, int N, int n, int r,
                           cudaStream_t stream) {
  const int smem = apply_smem_bytes(n, r, sizeof(T));
  auto kernel = chol_inv_apply_resident_kernel<T, kThreads>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<N, kThreads, smem, stream>>>(K, RHS, L, Linv, Y, n, r);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* K, const T* RHS, T* L, T* Linv, T* Y, int N, int n, int r, void* stream) {
  // the shared-memory check in 64 bits: a wide r would overflow int
  const long long smem = (static_cast<long long>(n) * ((n + static_cast<long long>(r)) | 1) + n) *
                         static_cast<long long>(sizeof(T));
  if (N < 0 || n < 1 || n > kMaxN || r < 0 || smem > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(apply_threads(n) == 128
                              ? launch_threads<T, 128>(K, RHS, L, Linv, Y, N, n, r, s)
                              : launch_threads<T, 256>(K, RHS, L, Linv, Y, N, n, r, s));
}

}  // namespace

// Plain C interface (bound with ctypes).  K, L and Linv are contiguous
// (N, n, n) device buffers, RHS and Y contiguous (N, n, r) ones; the launch
// goes on `stream` and does not synchronise.  Returns the cudaError_t of
// the shared-memory attribute call or of the launch, 0 on success, and
// cudaErrorInvalidValue for a shape whose working set exceeds a block's
// shared memory.
extern "C" int piqp_chol_inv_apply_resident_f32(const float* K, const float* RHS, float* L,
                                                float* Linv, float* Y, int N, int n, int r,
                                                void* stream) {
  return launch<float>(K, RHS, L, Linv, Y, N, n, r, stream);
}

extern "C" int piqp_chol_inv_apply_resident_f64(const double* K, const double* RHS, double* L,
                                                double* Linv, double* Y, int N, int n, int r,
                                                void* stream) {
  return launch<double>(K, RHS, L, Linv, Y, N, n, r, stream);
}
