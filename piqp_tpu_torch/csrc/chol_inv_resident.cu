// Batched Cholesky factorization with fused triangular inverse (K1), with
// the matrix resident in shared memory.
//
// Replaces the TPU kernel piqp_tpu/ops/pallas_chol.py::_chol_inv_kernel for
// every n whose working set fits in one block's shared memory (float32
// n <= 240, float64 n <= 169; ops/chol_inv.py routes by shape).  Larger n up
// to 256 take the cluster route, the unsigned instance of
// signed_chol_inv_resident.cu, which spreads this elimination's rows over a
// thread-block cluster.  For each SPD matrix K of a (B, n, n) batch it
// writes L = chol(K), with its strict upper triangle zero, and
// Linv = L^-1, lower.  One block per matrix; the grid is the batch.
//
// Algorithm: right-looking Cholesky of K carried together with forward
// elimination of L X = I, in one n x n work square M that starts as K's
// lower triangle.  Column j of the elimination forms the vector
//
//   v[c] = Z[j, c] / d    for c < j     (row j of Linv)
//   v[j] = 1 / d                        (d = sqrt(W[j, j]) = L[j, j])
//   v[c] = W[c, j] / d    for c > j     (column j of L)
//
// (W the trailing Schur complement, Z the inverse's rows still being
// eliminated), stores it as row j of M and subtracts v[i] v[c] from every
// later row i over its whole lower part, c <= i, column j counting as 0.
// So the factor and the inverse are eliminated together by updates that
// run in parallel over rows and columns, with no chain of dependent loads.
// When the loop ends, M's lower triangle holds Linv, its strict upper
// triangle holds L^T, and the n-vector diag holds d = diag(L).
//
// The columns go in panels of kNb = 8.  Per panel [j0, j1):
//   A. one warp factors the 8 x 8 diagonal block and inverts its factor
//      by the same elimination, all in registers, every lane on the same
//      values: L_pp^T and Linv_pp go into the block, d into diag;
//   B. one thread per column x outside the panel forms the panel rows'
//      strip: Linv[panel, x] = Linv_pp Z[panel, x] left of the panel, and
//      L[x, panel]^T = Linv_pp W[x, panel]^T below it;
//   C. the rows below take the rank-8 update from the strip S:
//      M[i, c] -= sum_r S[r, i] S[r, c] (panel columns start from 0 and
//      take only the strip rows at or below them).  A warp owns a tile of
//      kRows = 4 rows by its lanes' columns (lane, lane + 32, ...), held in
//      registers across the 8 strip rows, so each FMA costs a fraction of
//      a shared-memory access instead of a load and a store.
// Warp 0 updates the next panel's rows first and then runs phase A for
// that panel while the other warps finish phase C (lookahead), so a panel
// costs two __syncthreads and phase A is mostly off the critical path.
//
// Layout: M has an odd row pitch (n | 1), so the column reads of phase B
// and of the store pass hit 32 different banks; with diag it takes
// (n * (n | 1) + n) * sizeof(T) bytes of dynamic shared memory: 65 KB in
// float32 and 130 KB in float64 at n = 128, so three blocks (float32) or
// one (float64) share an SM.  The largest n under the 227 KB a block may
// use is 240 in float32 and 169 in float64.  Blocks have 256 threads;
// __launch_bounds__ asks for as many blocks per SM as the shared memory
// of the instance's largest n allows, up to 3 in float32 and 2 in float64
// (more would spill registers).  The kernel is instantiated for 1, 2 and 4
// column chunks and the type's largest count (8 in float32, 6 in float64),
// and n takes the first that covers ceil(n / 32); phase C picks its
// register tile's chunk count at run time within the instance.  n = 128
// runs the same 4-chunk instance as with one instance per count, which
// built in twice the time.  (At n = 128, one instance per run of counts
// sharing a min_blocks was 3% slower in float64, which it puts on the
// 6-chunk instance; a phase C over all of the instance's chunks was
// 10-30% slower.)
//
// Load and store: K's lower triangle is read once with 16-byte vector
// loads (float4 / double2), four rows in flight per lane, when rows are
// 16-byte aligned, else with scalar coalesced loads.  A row's last vector
// also brings up to 16 / sizeof(T) - 1 elements of K's strict upper
// triangle into M's upper part, where phase B or the diagonal block's
// factor overwrites them before they are read; the scalar path reads none.
// L and Linv are each written once, row by row, with neighbouring lanes
// on neighbouring addresses, zeros of the upper triangles included.
//
// Rounding: the pivots use rsqrt (rsqrtf is within 2 ulp in float32) and
// the blocked updates sum in another order than the plain version, so
// the last bits differ; chip_smoke.py holds the
// result to the same tolerance as before (5e-5 in float32, 1e-11 in
// float64, relative to max |L|).  float32 stays on FFMA in full precision.
// A pivot <= 0 gives rsqrt of a non-positive number and non-finite output
// for that problem only; nothing clamps it.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them): at B = 1024,
// n = 128 the kernel must read K's lower triangle once and write L and
// Linv once, n(n+1)/2 + 2n^2 elements per matrix: 168 MB in float32
// (50 us) or 336 MB in float64 (100 us), against about 2n^3/3 flops per
// matrix (21 us): bound by bytes.  What sets its pace instead is
// the latency of each block's chain of 16 panels (two barriers each) with
// at most 3 blocks per SM to overlap them (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNb = 8;         // panel width
constexpr int kRows = 4;       // rows of a warp's tile in phase C
constexpr int kRStep = 4;      // strip rows whose loads phase C issues together
constexpr int kSmemPerBlock = 232448;  // dynamic shared memory a block may opt into

constexpr int resident_smem_bytes(int n, int elem) { return (n * (n | 1) + n) * elem; }

// 240 in float32, 169 in float64
constexpr int max_resident_n(int elem) {
  int n = 1;
  while (resident_smem_bytes(n + 1, elem) <= kSmemPerBlock) ++n;
  return n;
}

// blocks per SM that an instance for n <= 32 * kChunks can have: what the
// SM's 228 KB of shared memory holds (1 KB of it reserved per block), at
// most 3 in float32 and 2 in float64, whose registers are twice as many
constexpr int min_blocks(int n, int elem) {
  const int fit = 233472 / (resident_smem_bytes(n, elem) + 1024);
  const int cap = elem == 4 ? 3 : 2;
  return fit < 1 ? 1 : (fit < cap ? fit : cap);
}

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

// Copy K's lower triangle into M, one warp per row.  On the vector path a
// row's last vector also copies up to kW - 1 cells right of the diagonal;
// M's upper part is overwritten before it is read (see the note above).
template <typename T>
__device__ __forceinline__ void load_lower(const T* __restrict__ A, T* M, int n, int P) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (n % kW == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0) {
    // a lane's vectors of four rows are loaded before any is stored, so
    // four loads per lane are in flight
    const int nv = n / kW;  // vectors per row
    for (int r0 = warp; r0 < n; r0 += 4 * kWarps) {
      for (int v0 = lane; v0 < nv; v0 += 32) {
        V v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + q * kWarps;
          if (r < n && v0 * kW <= r) {
            v[q] = reinterpret_cast<const V*>(A + static_cast<size_t>(r) * n)[v0];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = r0 + q * kWarps;
          if (r < n && v0 * kW <= r) {
            const T* e = reinterpret_cast<const T*>(&v[q]);
#pragma unroll
            for (int k = 0; k < kW; ++k) M[r * P + v0 * kW + k] = e[k];
          }
        }
      }
    }
  } else {
    for (int r = warp; r < n; r += kWarps) {
      for (int c = lane; c <= r; c += 32) M[r * P + c] = A[static_cast<size_t>(r) * n + c];
    }
  }
}

// Write L (M's strict upper triangle transposed, diag on the diagonal) and
// Linv (M's lower triangle, diagonal included) row by row, zeros included.
template <typename T>
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

// Phase A of a panel, run by one warp: factor the panel's nbp x nbp
// diagonal block D = L_pp L_pp^T and invert L_pp, all in registers, by
// the same carried-identity elimination as the whole matrix, so the
// inverse adds no steps to the chain of pivots; every lane does the same
// arithmetic on the same values.  L_pp^T goes into M's upper block as it
// is formed, d into diag, Linv_pp into M's lower block.  Rows past nbp are
// padded with the identity.
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

// Phase C for kRows rows g.. of one warp, over the first KC column chunks:
// M[i, c] -= sum_r S[r, i] S[r, c] for c <= i, with S the nbp panel rows
// of M (rows j0.., kNb of them, the rows past nbp masked out).  Panel
// columns j0 <= c < j1 start from 0 and take only the rows r with
// j0 + r >= c, whose S[r, c] is Linv_pp[r, c - j0].
template <typename T, int KC>
__device__ __forceinline__ void update_rows(T* M, int P, int n, int g, int j0, int nbp) {
  const int lane = threadIdx.x & 31;
  const int j1 = j0 + nbp;
  T acc[kRows][KC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      const int i = g + q;
      acc[q][k] = (i < n && c <= i && (c < j0 || c >= j1)) ? M[i * P + c] : T(0);
    }
  }
#pragma unroll 1
  for (int r0 = 0; r0 < kNb; r0 += kRStep) {
#pragma unroll
    for (int r = r0; r < r0 + kRStep; ++r) {
      const T* srow = M + (j0 + r) * P;
      T u[kRows], s[KC];
#pragma unroll
      for (int q = 0; q < kRows; ++q) u[q] = (r < nbp && g + q < n) ? srow[g + q] : T(0);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c = lane + 32 * k;
        s[k] = (r < nbp && c < n && (c <= j0 + r || c >= j1)) ? srow[c] : T(0);
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[q][k] -= u[q] * s[k];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      const int i = g + q;
      if (i < n && c <= i) M[i * P + c] = acc[q][k];
    }
  }
}

// update_rows over the chunks that reach the tile's last row: kc of them,
// a run-time value uniform across the warp, mapped to a compile-time KC
template <typename T, int KC, int kChunks>
__device__ __forceinline__ void update_rows_upto(T* M, int P, int n, int g, int j0, int nbp,
                                                 int kc) {
  if constexpr (KC < kChunks) {
    if (kc == KC) {
      update_rows<T, KC>(M, P, n, g, j0, nbp);
    } else {
      update_rows_upto<T, KC + 1, kChunks>(M, P, n, g, j0, nbp, kc);
    }
  } else {
    update_rows<T, kChunks>(M, P, n, g, j0, nbp);
  }
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads, min_blocks(32 * kChunks, sizeof(T)))
chol_inv_resident_kernel(const T* __restrict__ K, T* __restrict__ L_out,
                         T* __restrict__ Linv_out, int n) {
  static_assert(kNb % kRows == 0 && kNb <= 32, "warp 0 takes the next panel's rows whole");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int P = n | 1;
  T* diag = M + n * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;

  load_lower<T>(K + offset, M, n, P);
  __syncthreads();
  if (warp == 0) factor_diagonal_block<T>(M, diag, P, 0, min(kNb, n));
  __syncthreads();

  for (int j0 = 0; j0 < n; j0 += kNb) {
    const int nbp = min(kNb, n - j0);
    const int j1 = j0 + nbp;

    // B: the panel rows' strip, one thread per column x outside the panel:
    // Linv[panel, x] = Linv_pp M[panel, x] left of the panel, and
    // L[x, panel]^T = Linv_pp M[x, panel]^T below it
    for (int x = tid; x < n - nbp; x += kThreads) {
      const int col = x < j0 ? x : x + nbp;
      T m[kNb];
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        m[k] = k >= nbp ? T(0) : (col < j0 ? M[(j0 + k) * P + col] : M[col * P + j0 + k]);
      }
      T y[kNb];
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        const T* ipp = M + (j0 + r) * P + j0;
        y[r] = T(0);
#pragma unroll
        for (int k = 0; k <= r; ++k) y[r] += (r < nbp ? ipp[k] : T(0)) * m[k];
      }
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        if (r < nbp) M[(j0 + r) * P + col] = y[r];
      }
    }
    __syncthreads();

    // C: rows i >= j1.  Warp 0 takes the next panel's rows and then
    // factors its diagonal block; the other warps take the rest, kRows rows
    // at a time.  (One loop for both, with per-warp bounds, was 2-3% slower
    // in float32 at n = 128.)
    if (warp == 0) {
      const int next = min(kNb, n - j1);
      for (int g = j1; g < j1 + next; g += kRows) {
        update_rows_upto<T, 1, kChunks>(M, P, n, g, j0, nbp, (min(g + kRows, n) - 1) / 32 + 1);
      }
      if (next > 0) {
        __syncwarp();
        factor_diagonal_block<T>(M, diag, P, j1, next);
      }
    } else {
      for (int g = j1 + kNb + kRows * (warp - 1); g < n; g += kRows * (kWarps - 1)) {
        update_rows_upto<T, 1, kChunks>(M, P, n, g, j0, nbp, (min(g + kRows, n) - 1) / 32 + 1);
      }
    }
    __syncthreads();
  }
  store_factors<T>(M, diag, L_out + offset, Linv_out + offset, n, P);
}

template <typename T, int kChunks>
cudaError_t launch_chunks(const T* K, T* L, T* Linv, int B, int n, cudaStream_t stream) {
  const int smem = resident_smem_bytes(n, sizeof(T));
  auto kernel = chol_inv_resident_kernel<T, kChunks>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(K, L, Linv, n);
  return cudaGetLastError();
}

// launch_chunks on the instance for ceil(n / 32) column chunks rounded up
// to a power of two, or to the type's largest count
template <typename T, int KC = 1>
cudaError_t launch_instance(const T* K, T* L, T* Linv, int B, int n, cudaStream_t stream) {
  constexpr int kMaxChunks = (max_resident_n(sizeof(T)) + 31) / 32;
  if constexpr (KC < kMaxChunks) {
    if ((n + 31) / 32 > KC) {
      return launch_instance<T, (2 * KC < kMaxChunks ? 2 * KC : kMaxChunks)>(K, L, Linv, B, n,
                                                                           stream);
    }
  }
  return launch_chunks<T, KC>(K, L, Linv, B, n, stream);
}

template <typename T>
int launch(const T* K, T* L, T* Linv, int B, int n, void* stream) {
  if (B < 0 || n < 1 || n > max_resident_n(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  return static_cast<int>(launch_instance<T>(K, L, Linv, B, n, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C interface (bound with ctypes).  Inputs and outputs are contiguous
// (B, n, n) device buffers; the launch goes on `stream` and does not
// synchronise.  Returns the cudaError_t of the shared-memory attribute call
// or of the launch, 0 on success, and cudaErrorInvalidValue for an n whose
// working set exceeds a block's shared memory.
extern "C" int piqp_chol_inv_resident_f32(const float* K, float* L, float* Linv,
                                          int B, int n, void* stream) {
  return launch<float>(K, L, Linv, B, n, stream);
}

extern "C" int piqp_chol_inv_resident_f64(const double* K, double* L, double* Linv,
                                          int B, int n, void* stream) {
  return launch<double>(K, L, Linv, B, n, stream);
}
