// Batched signed Cholesky with fused triangular inverse (K3), with the
// matrix resident in the shared memory of a thread-block cluster, and its
// unsigned instance, K1's cluster route.
//
// The signed instance (kSigned = true, signed_chol_inv_resident_kernel)
// replaces the TPU kernel piqp_tpu/ops/pallas_chol.py::_signed_chol_inv_kernel
// for every n <= 256 (ops/signed_chol_inv.py routes by shape).  For each
// quasi-definite matrix K of a (B, n, n) batch and one sign vector
// S = diag(signs) shared by the batch, it writes L with K = L S L^T (lower,
// strict upper triangle zero, diag(L) = sqrt|pivot|) and Linv = L^-1, lower.
//
// The unsigned instance (kSigned = false, every sign +1,
// chol_inv_cluster_kernel) replaces piqp_tpu/ops/pallas_chol.py::_chol_inv_kernel
// above the one-block limit of chol_inv_resident.cu, n 241-256 in float32 and 170-256 in float64
// (ops/chol_inv.py's "cluster" route): L = chol(K) and Linv = L^-1 of each
// SPD matrix.  It reads no sign vector, keeps none in shared memory and
// multiplies by none, so its blocks are n elements smaller; otherwise the
// two instances are one code path.
//
// Algorithm: chol_inv_resident.cu's (K1's) carried-identity elimination
// with the sign woven in.  Column j forms the unsigned vector
//
//   v[c] = Z[j, c] / d    for c < j     (row j of Linv)
//   v[j] = 1 / d                        (d = sqrt(s_j W[j, j]) = L[j, j])
//   v[c] = W[c, j] / d    for c > j     (s_j times column j of L)
//
// (W the trailing Schur complement, Z the inverse's rows still being
// eliminated), stores it as row j of the work square M and subtracts
// s_j v[i] v[c] from every later row i over its whole lower part, c <= i,
// column j counting as 0.  When the loop ends, M's lower triangle holds
// Linv, its strict upper triangle the unsigned v's (S L^T), and the
// n-vector diag holds d; the store pass applies the signs to L.  With
// every sign +1 this is chol_inv_resident.cu's elimination exactly.
//
// Layout: one n x (n | 1) square would take 264 KB in float32 and 528 KB
// in float64 at n = 256, more than a block's 227 KB, so the rows are
// spread over a cluster of c blocks: panels of kNb = 8 rows are dealt to
// the blocks round-robin (panel q to block q mod c, which keeps the
// shrinking trailing work balanced), and each block keeps its whole rows
// (lower part and S L^T part), a strip of kNb rows when c > 1, diag and,
// in K3, the signs: resident_smem_bytes below.  c is the smallest cluster
// whose blocks fit (cluster_size): at n = 256, 2 blocks of 139 KB in
// float32 and 3 of 197 KB in float64, so one block per SM; the unsigned
// instance takes 2 blocks in float64 up to n = 225, K3 up to 224.  The
// grid is B * c, one cluster per matrix, launched with cudaLaunchKernelEx
// and a cluster-dimension attribute.  Blocks have 512 threads in float32 and 256
// in float64 (kThreads): 512 left float64 at the 128-register cap with
// spills and was 14% slower, 256 made float32 6% slower, and 4-block
// clusters were twice as slow (PERF.md).
//
// The columns go in panels of kNb = 8, the same panels whose rows are
// dealt out.  Per panel [j0, j1), owned by block o:
//   A. one warp of o factors the 8 x 8 diagonal block with the signs and
//      inverts its factor by the same elimination, all in registers, every
//      lane on the same values: S L_pp^T and Linv_pp go into o's rows,
//      d into diag.  Cluster barrier.
//   B. the panel rows' strip V (8 x n): every other block first copies
//      Linv_pp from o (distributed shared memory) into its strip; then o
//      forms Linv[panel, x] = Linv_pp Z[panel, x] for x < j0, and every
//      block forms V[:, x] = Linv_pp W[x, panel]^T for its own rows
//      x >= j1, one thread per x, each writing its 8 values into every
//      block's copy of the strip: o's own panel rows, the others' strips.
//      Cluster barrier.
//   C. local to each block: the rows below take the signed rank-8 update
//      from the block's copy, M[i, c] -= sum_r s_r V[r, i] V[r, c] (panel
//      columns start from 0 and take only the strip rows at or below
//      them).  A warp owns a tile of kRows = 4 rows by its lanes' columns
//      (lane, lane + 32, ...), held in registers across the 8 strip rows.
//      Warp 0 of the next panel's owner updates that panel's rows first
//      and then runs its phase A (lookahead).  Cluster barrier.
// So a panel costs two cluster barriers.  The barrier after C also keeps
// the next panel's strip writes of B from overtaking this panel's reads.
// (Pushing Linv_pp into a second strip during the lookahead, which saves
// the copy and a block barrier per panel, and splitting the next panel's
// rows over two warps each moved the time by less than 1%: not kept.)
//
// Load and store: each block reads its rows of K's lower triangle once
// with 16-byte loads when rows are 16-byte aligned (a row's last vector
// also brings a few cells of K's upper triangle into M's upper part,
// which A or B overwrites before it is read), else with scalar coalesced
// loads.  It writes its rows of Linv, row by row with neighbouring lanes
// on neighbouring addresses, and the 8-column runs of L under its own
// panels: L[i, col] for col in the panel, one 32-byte (float32) or 64-byte
// (float64) run per row of L, with 16-byte stores when n is a multiple of
// 8.  So no block reads another's rows to store, and the zeros of both
// upper triangles go out in the same pass.  (Gathering whole rows of L
// through distributed shared memory before a coalesced store, the other
// way, would read n (c - 1) / c remote values per row; it was not built.)
//
// Rounding: rsqrt pivots and blocked sums differ from the plain version in
// the last bits; chip_smoke.py holds L and Linv to 5e-5 (float32) and
// 1e-11 (float64) relative to their largest entries.  float32 stays on
// FFMA in full precision.  A pivot whose sign disagrees with its entry of
// S (in K1, a pivot <= 0) gives rsqrt of a negative number or of 0 and
// non-finite output for that problem's cluster only; nothing clamps it.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them): at the
// dense_ldlt fleet's B = 256, n = 256 (and the n = 256 dense fleet's, for
// K1) the kernel must read K's lower triangle (and K3 the signs) once and
// write L and Linv once, n(n+1)/2 + 2n^2 elements per matrix: 168 MB in
// float32 (50 us) or 336 MB in float64 (100 us), against about 2n^3/3
// flops per matrix (43 us): bound by bytes.
// What sets its pace instead is each cluster's chain of 32 panels, two
// cluster barriers each, with one block per SM (PERF.md).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

__device__ __forceinline__ float4 vec16(const float* e) {
  return make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ double2 vec16(const double* e) { return make_double2(e[0], e[1]); }

// threads of a block: 512 in float32, 256 in float64 (see the note above)
template <typename T>
constexpr int kThreads = sizeof(T) == 4 ? 512 : 256;
constexpr int kNb = 8;           // panel width: rows dealt to the blocks, columns eliminated
constexpr int kRows = 4;         // rows of a warp's tile in phase C
constexpr int kRStep = 4;        // strip rows whose loads phase C issues together
constexpr int kMaxN = 256;
constexpr int kMaxCluster = 3;  // the largest cluster_size below, for n <= kMaxN
constexpr int kSmemPerBlock = 232448;  // dynamic shared memory a block may opt into

// Shared memory of one block of a c-block cluster: its rows (the panels
// dealt to it, ceil(ceil(n / 8) / c) of them), a strip of 8 rows when c > 1,
// diag and, when sgn (K3), the signs.
constexpr int resident_smem_bytes(int n, int elem, int c, bool sgn) {
  return ((((n + 7) / 8 + c - 1) / c + (c > 1)) * 8 * (n | 1) + (1 + sgn) * n) * elem;
}

// the smallest cluster whose blocks hold the matrix: for K3 1 up to n = 239
// in float32 and n = 168 in float64, then 2, and 3 in float64 from n = 225;
// unsigned, 3 in float64 from n = 226
constexpr int cluster_size(int n, int elem, bool sgn) {
  int c = 1;
  while (c < kMaxCluster && resident_smem_bytes(n, elem, c, sgn) > kSmemPerBlock) ++c;
  return c;
}

// s_x, the sign of row x: its entry of the sign vector in K3, +1 in K1
template <bool kSigned, typename T>
__device__ __forceinline__ T sign_of(const T* sgn, int x) {
  if constexpr (kSigned) {
    return sgn[x];
  } else {
    return T(1);
  }
}

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

// global row of a block's local row
__device__ __forceinline__ int global_row(int lr, int b, int c) {
  return ((lr / kNb) * c + b) * kNb + lr % kNb;
}

// Copy the lower triangle of the block's own rows of K into M, one warp
// per row, four rows in flight per lane on the 16-byte path.  A row's last
// vector also copies up to kW - 1 cells right of the diagonal; M's upper
// part is overwritten before it is read.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ A, T* M, int n, int P, int rows,
                                          int b, int c) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  constexpr int kWarps = kThreads<T> / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (n % kW == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0) {
    const int nv = n / kW;
    for (int r0 = warp; r0 < rows; r0 += 4 * kWarps) {
      for (int v0 = lane; v0 < nv; v0 += 32) {
        V v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int lr = r0 + q * kWarps;
          const int i = global_row(lr, b, c);
          if (lr < rows && i < n && v0 * kW <= i) {
            v[q] = reinterpret_cast<const V*>(A + static_cast<size_t>(i) * n)[v0];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int lr = r0 + q * kWarps;
          const int i = global_row(lr, b, c);
          if (lr < rows && i < n && v0 * kW <= i) {
            const T* e = reinterpret_cast<const T*>(&v[q]);
#pragma unroll
            for (int k = 0; k < kW; ++k) M[lr * P + v0 * kW + k] = e[k];
          }
        }
      }
    }
  } else {
    for (int lr = warp; lr < rows; lr += kWarps) {
      const int i = global_row(lr, b, c);
      if (i >= n) continue;
      for (int x = lane; x <= i; x += 32) M[lr * P + x] = A[static_cast<size_t>(i) * n + x];
    }
  }
}

// Write the block's rows of Linv (M's lower triangle, zeros above) and the
// 8-column runs of L under its panels: L[i, col] = s_col M[col, i] for
// col < i, diag[col] on the diagonal, zeros above, one run per row i.
template <typename T, bool kSigned>
__device__ __forceinline__ void store_factors(const T* M, const T* diag, const T* sgn,
                                              T* __restrict__ L, T* __restrict__ Li, int n,
                                              int P, int rows, int b, int c) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  constexpr int kWarps = kThreads<T> / 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int lr = warp; lr < rows; lr += kWarps) {
    const int i = global_row(lr, b, c);
    if (i >= n) continue;
    for (int x = lane; x < n; x += 32) {
      Li[static_cast<size_t>(i) * n + x] = x <= i ? M[lr * P + x] : T(0);
    }
  }
  const bool vec = n % kNb == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  for (int lq = 0; lq * kNb < rows; ++lq) {
    const int col0 = (lq * c + b) * kNb;
    if (col0 >= n) break;
    for (int i = tid; i < n; i += kThreads<T>) {
      T out[kNb];
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const int col = col0 + k;
        out[k] = col < i ? sign_of<kSigned>(sgn, col) * M[(lq * kNb + k) * P + i]
                         : (col == i ? diag[col] : T(0));
      }
      T* dst = L + static_cast<size_t>(i) * n + col0;
      if (vec) {
#pragma unroll
        for (int k = 0; k < kNb; k += kW) {
          reinterpret_cast<V*>(dst)[k / kW] = vec16(out + k);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          if (col0 + k < n) dst[k] = out[k];
        }
      }
    }
  }
}

// Phase A of a panel, run by one warp: factor the panel's nbp x nbp
// diagonal block D = L_pp S_pp L_pp^T (rows at local row lr0, columns at
// j0) and invert L_pp, all in registers, by the same carried-identity
// elimination as the whole matrix; every lane does the same arithmetic on
// the same values.  S_pp L_pp^T goes into M's upper block as it is formed,
// d into diag, Linv_pp into M's lower block.  Rows past nbp are padded
// with the identity and sign +1.
template <typename T, bool kSigned>
__device__ __forceinline__ void factor_diagonal_block(T* M, T* diag, const T* sgn, int P,
                                                      int lr0, int j0, int nbp) {
  const int lane = threadIdx.x & 31;
  T a[kNb][kNb];
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
#pragma unroll
    for (int k = 0; k <= i; ++k) {
      a[i][k] = i < nbp ? M[(lr0 + i) * P + j0 + k] : T(i == k ? 1 : 0);
    }
  }
#pragma unroll
  for (int k = 0; k < kNb; ++k) {
    const T sk = k < nbp ? sign_of<kSigned>(sgn, j0 + k) : T(1);
    const T dinv = rsqrt_of(sk * a[k][k]);
    if (lane == k && k < nbp) diag[j0 + k] = sk * a[k][k] * dinv;
#pragma unroll
    for (int c = 0; c < k; ++c) a[k][c] *= dinv;
    a[k][k] = dinv;
    T v[kNb];
#pragma unroll
    for (int i = k + 1; i < kNb; ++i) {
      v[i] = a[i][k] * dinv;
      a[i][k] = T(0);
      if (lane == i && i < nbp) M[(lr0 + k) * P + j0 + i] = v[i];
    }
#pragma unroll
    for (int i = k + 1; i < kNb; ++i) {
      const T sv = sk * v[i];
#pragma unroll
      for (int c = 0; c <= i; ++c) a[i][c] -= sv * (c < k ? a[k][c] : (c == k ? dinv : v[c]));
    }
  }
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    if (i == lane && i < nbp) {
#pragma unroll
      for (int k = 0; k <= i; ++k) M[(lr0 + i) * P + j0 + k] = a[i][k];
    }
  }
}

// Phase C for kRows rows g.. (local rows lr..) of one warp, over the first
// KC column chunks: M[i, c] -= sum_r s_r V[r, i] V[r, c] for c <= i, with V
// the nbp strip rows S (rows past nbp masked out).  Panel columns
// j0 <= c < j1 start from 0 and take only the rows r with j0 + r >= c,
// whose V[r, c] is Linv_pp[r, c - j0].
template <typename T, bool kSigned, int KC>
__device__ __forceinline__ void update_rows(T* M, const T* S, const T* sgn, int P, int n,
                                            int lr, int g, int j0, int nbp) {
  const int lane = threadIdx.x & 31;
  const int j1 = j0 + nbp;
  T acc[kRows][KC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = lane + 32 * k;
      const int i = g + q;
      acc[q][k] = (i < n && c <= i && (c < j0 || c >= j1)) ? M[(lr + q) * P + c] : T(0);
    }
  }
#pragma unroll 1
  for (int r0 = 0; r0 < kNb; r0 += kRStep) {
#pragma unroll
    for (int r = r0; r < r0 + kRStep; ++r) {
      const T* srow = S + r * P;
      const T sr = r < nbp ? sign_of<kSigned>(sgn, j0 + r) : T(0);
      T u[kRows], s[KC];
#pragma unroll
      for (int q = 0; q < kRows; ++q) u[q] = (r < nbp && g + q < n) ? sr * srow[g + q] : T(0);
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
      if (i < n && c <= i) M[(lr + q) * P + c] = acc[q][k];
    }
  }
}

// update_rows over the chunks that reach the tile's last row: kc of them,
// a run-time value uniform across the warp, mapped to a compile-time KC
template <typename T, bool kSigned, int KC, int kChunks>
__device__ __forceinline__ void update_rows_upto(T* M, const T* S, const T* sgn, int P, int n,
                                                 int lr, int g, int j0, int nbp, int kc) {
  if constexpr (KC < kChunks) {
    if (kc == KC) {
      update_rows<T, kSigned, KC>(M, S, sgn, P, n, lr, g, j0, nbp);
    } else {
      update_rows_upto<T, kSigned, KC + 1, kChunks>(M, S, sgn, P, n, lr, g, j0, nbp, kc);
    }
  } else {
    update_rows<T, kSigned, kChunks>(M, S, sgn, P, n, lr, g, j0, nbp);
  }
}

// the body of both instances; signs is read only when kSigned
template <typename T, bool kSigned>
__device__ __forceinline__ void factor_resident(const T* __restrict__ K,
                                                const T* __restrict__ signs,
                                                T* __restrict__ L_out, T* __restrict__ Linv_out,
                                                int n) {
  constexpr int kWarps = kThreads<T> / 32;
  static_assert(kNb % kRows == 0 && kNb <= 32, "warp 0 takes the next panel's rows whole");
  static_assert(kNb % (16 / sizeof(T)) == 0, "L's runs are whole 16-byte vectors");
  constexpr int kChunks = (kMaxN + 31) / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = n | 1;
  const int rows = ((n + kNb - 1) / kNb + c - 1) / c * kNb;
  T* M = reinterpret_cast<T*>(smem_raw);
  T* strip = M + rows * P;
  T* diag = strip + (c > 1 ? kNb * P : 0);
  T* sgn = kSigned ? diag + n : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t offset = static_cast<size_t>(blockIdx.x / c) * n * n;

  if constexpr (kSigned) {
    for (int x = tid; x < n; x += kThreads<T>) sgn[x] = signs[x];
  }
  load_rows<T>(K + offset, M, n, P, rows, b, c);
  __syncthreads();
  if (b == 0 && warp == 0) {
    factor_diagonal_block<T, kSigned>(M, diag, sgn, P, 0, 0, min(kNb, n));
  }
  cluster.sync();

  const int panels = (n + kNb - 1) / kNb;
  for (int p = 0; p < panels; ++p) {
    const int j0 = p * kNb;
    const int nbp = min(kNb, n - j0);
    const int j1 = j0 + nbp;
    const int o = p % c;
    const bool own = o == b;
    T* panel_rows = M + (p / c) * kNb * P;  // the owner's rows of the panel
    const T* S = own ? panel_rows : strip;
    // local row of the block's first row below the panel
    const int first = (p - b + c) / c * kNb;

    // B: the other blocks copy the diagonal block (Linv_pp) from the owner
    if (!own) {
      if (tid < kNb * kNb) {
        const int r = tid / kNb;
        const int k = tid % kNb;
        if (k <= r && r < nbp) {
          strip[r * P + j0 + k] = *cluster.map_shared_rank(panel_rows + r * P + j0 + k, o);
        }
      }
      __syncthreads();
    }
    T* dst[kMaxCluster];
#pragma unroll
    for (int rb = 0; rb < kMaxCluster; ++rb) {
      dst[rb] = rb < c ? cluster.map_shared_rank(rb == o ? panel_rows : strip, rb) : nullptr;
    }
    // one thread per x: the owner's columns x < j0, then every block's
    // rows x >= j1
    const int lead = own ? j0 : 0;
    for (int t = tid; t < lead + rows - first; t += kThreads<T>) {
      int x;
      T m[kNb];
      if (t < lead) {
        x = t;
#pragma unroll
        for (int k = 0; k < kNb; ++k) m[k] = k < nbp ? panel_rows[k * P + x] : T(0);
      } else {
        const int lr = first + t - lead;
        x = global_row(lr, b, c);
        if (x >= n) continue;
#pragma unroll
        for (int k = 0; k < kNb; ++k) m[k] = k < nbp ? M[lr * P + j0 + k] : T(0);
      }
      T y[kNb];
#pragma unroll
      for (int r = 0; r < kNb; ++r) {
        const T* ipp = S + r * P + j0;
        y[r] = T(0);
#pragma unroll
        for (int k = 0; k <= r; ++k) y[r] += (r < nbp ? ipp[k] : T(0)) * m[k];
      }
#pragma unroll
      for (int rb = 0; rb < kMaxCluster; ++rb) {
        if (rb < c) {
#pragma unroll
          for (int r = 0; r < kNb; ++r) {
            if (r < nbp) dst[rb][r * P + x] = y[r];
          }
        }
      }
    }
    cluster.sync();

    // C: the block's rows below the panel, kRows at a time.  Warp 0 of the
    // next panel's owner takes that panel's rows and then factors its
    // diagonal block; the other warps take the rest.
    const bool lookahead = j1 < n && (p + 1) % c == b;
    const int tiles = (rows - first) / kRows;
    auto update_tile = [&](int t) {
      const int lr = first + t * kRows;
      const int g = global_row(lr, b, c);
      if (g < n) {
        update_rows_upto<T, kSigned, 1, kChunks>(M, S, sgn, P, n, lr, g, j0, nbp,
                                        (min(g + kRows, n) - 1) / 32 + 1);
      }
    };
    if (lookahead && warp == 0) {
      for (int t = 0; t < kNb / kRows; ++t) update_tile(t);
      __syncwarp();
      factor_diagonal_block<T, kSigned>(M, diag, sgn, P, first, j1, min(kNb, n - j1));
    } else {
      const int t0 = lookahead ? kNb / kRows + warp - 1 : warp;
      const int step = lookahead ? kWarps - 1 : kWarps;
      for (int t = t0; t < tiles; t += step) update_tile(t);
    }
    cluster.sync();
  }
  store_factors<T, kSigned>(M, diag, sgn, L_out + offset, Linv_out + offset, n, P, rows, b, c);
}

// K3 and K1 launch under names of their own, so a profile tells them apart
template <typename T>
__global__ void __launch_bounds__(kThreads<T>, 1)
signed_chol_inv_resident_kernel(const T* __restrict__ K, const T* __restrict__ signs,
                                T* __restrict__ L_out, T* __restrict__ Linv_out, int n) {
  factor_resident<T, true>(K, signs, L_out, Linv_out, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads<T>, 1)
chol_inv_cluster_kernel(const T* __restrict__ K, const T* __restrict__ signs,
                        T* __restrict__ L_out, T* __restrict__ Linv_out, int n) {
  factor_resident<T, false>(K, nullptr, L_out, Linv_out, n);
}

template <typename T, bool kSigned>
int launch(const T* K, const T* signs, T* L, T* Linv, int B, int n, int c, void* stream) {
  if (B < 0 || n < 1 || n > kMaxN || c != cluster_size(n, sizeof(T), kSigned)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int smem = resident_smem_bytes(n, sizeof(T), c, kSigned);
  auto kernel = kSigned ? signed_chol_inv_resident_kernel<T> : chol_inv_cluster_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * c);
  cfg.blockDim = dim3(kThreads<T>);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, K, signs, L, Linv, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  K, L and Linv are contiguous
// (B, n, n) device buffers, signs a contiguous (n,) device buffer of the
// same type; `cluster` is the number of blocks per matrix, which must be
// cluster_size(n, ..., sgn) above (mirrored in ops/signed_chol_inv.py for
// K3 and ops/chol_inv.py for K1).  The launch goes on `stream` and does not
// synchronise.  Returns the cudaError_t of the attribute call or of the
// launch, 0 on success, and cudaErrorInvalidValue for an n above 256 or
// another cluster size.
extern "C" int piqp_signed_chol_inv_resident_f32(const float* K, const float* signs, float* L,
                                                 float* Linv, int B, int n, int cluster,
                                                 void* stream) {
  return launch<float, true>(K, signs, L, Linv, B, n, cluster, stream);
}

extern "C" int piqp_signed_chol_inv_resident_f64(const double* K, const double* signs,
                                                 double* L, double* Linv, int B, int n,
                                                 int cluster, void* stream) {
  return launch<double, true>(K, signs, L, Linv, B, n, cluster, stream);
}

// K1's cluster route: the unsigned instance, no sign vector
extern "C" int piqp_chol_inv_cluster_f32(const float* K, float* L, float* Linv, int B, int n,
                                         int cluster, void* stream) {
  return launch<float, false>(K, nullptr, L, Linv, B, n, cluster, stream);
}

extern "C" int piqp_chol_inv_cluster_f64(const double* K, double* L, double* Linv, int B,
                                         int n, int cluster, void* stream) {
  return launch<double, false>(K, nullptr, L, Linv, B, n, cluster, stream);
}
