// The product half of K2's split route: Y = Linv^T (Linv RHS) for a batch
// of lower-triangular inverse factors.
//
// Replaces, together with K1's factor kernel that runs first, the TPU
// kernel piqp_tpu/ops/pallas_chol.py::_chol_inv_apply_kernel for every
// shape up to n = 256 that neither the small nor the resident K2 kernel
// takes: those whose n x (n + r) work square [K | RHS] exceeds one block's
// shared memory (with r = 2n + 4: n >= 139 in float32, n >= 98 in float64;
// with r = 4n + 4: n >= 108 / 76; any n with a wide enough r).  The split
// call (ops/chol_inv.py) launches K1's kernel on the route kernel_route
// names (chol_inv_resident.cu up to n = 240 f32 / 169 f64, the cluster
// instance of signed_chol_inv_resident.cu above), which writes L and
// Linv, two of K2's outputs, and then this kernel, which reads Linv and
// RHS and writes
//
//   Z = Linv RHS,   Y = Linv^T Z = K^-1 RHS.
//
// Only Linv's lower triangle is read: the strict upper triangle is
// zero-filled in shared memory, whatever the buffer holds there.  A
// non-finite Linv (K1's answer to an indefinite block) gives a non-finite Y
// for that block only.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them).  The split
// route as a whole must read K's lower triangle and RHS once and write L,
// Linv and Y once, N (n(n+1)/2 + 2n^2 + 2nr) elements, against about
// 2n^3/3 + 2n^2 r flops a block.  At the D = 144 multistage fleet's first
// cyclic-reduction level, N = 1,280, n = 144, r = 292: 696 MB f32
// (0.2079 ms) against 18.0 GFLOP (0.2694 ms), bound by operations;
// 1,393 MB f64 (0.4157 ms), bound by bytes.  The two products are 86% of
// those flops, so in f32 this kernel sets the route's floor, and it has to
// run at the f32 FMA rate; in f64 only DMMA reaches the 67 TFLOP/s.
//
// Design: one block of 4 warps per (matrix, tile of kCols right-hand
// columns), blockIdx.x = matrix * tiles + tile, so a matrix's tiles run
// together and read Linv from the L2 after the first.  The block keeps the
// tile's n x kCols block of RHS, then of Z, in shared memory (Zs), and
// streams Linv through a two-slot ring of panels with cp.async:
//   phase 1, Z = Linv RHS: column panels Linv[k0 <= i < n, k0 : k0 + kDepth],
//     only the rows at or below the panel's diagonal block;
//   phase 2, Y = Linv^T Z: row panels Linv[l0 : l0 + kDepth, 0 <= i <= l],
//     only the columns left of the panel's diagonal block's end.
// So only the lower triangle moves, and the tiles above the diagonal are
// skipped in the arithmetic too, which halves the flops.  Each warp owns
// a strip of the tile's columns over ALL of its rows, so every warp does
// the same triangle of work and the skips are uniform within a warp.  Z
// goes back into Zs between the phases (Zs held RHS); Y goes from
// registers straight to device memory.
//   float32: FFMA register tiles in full f32 (no TF32).  A lane (g =
//     lane / 4, t = lane % 4) owns 4 columns, 16w + 4t, of warp w's 16.
//     Phase 1: rows 8 mi + g; per 4 k's, 4 float4 loads of RHS rows feed
//     16 FMAs per row for each float4 load of Linv (4 k's of one row).
//     Phase 2: row quads 32 mq + 4 g + (0..3); per l, one float4 of Z and
//     one float4 of Linv's row l (4 rows of Y) per 16 FMAs.
//   float64: DMMA, mma.sync.m8n8k4 f64 on the tensor cores.  Warp w owns
//     one n8 strip of the tile's 8 w .. 8 w + 7 columns and every m8 row
//     fragment; per 4 k's, one B fragment of Zs serves all row fragments.
// Panel pitches are chosen so that every fragment load is free of bank
// conflicts: the column panel's rows are kDepth + 4 apart, the row panel's
// rows + 4 (a multiple of 16 doubles plus 4), Zs's kCols + 4.
//
// Loads: 16-byte cp.async where the rows allow it (Linv when n is a
// multiple of 16 / sizeof(T), RHS and Y when r is, with 16-byte aligned
// base pointers), else element-wise cp.async; both zero-fill what lies
// outside the matrix, above Linv's diagonal or right of r (src-size 0), so
// ragged shapes (n = 139 with r = 282, a last column tile of 4) take the
// same arithmetic.  The launcher picks the vector path per tensor.
//
// Placement: 128 threads; kCols = 64 in f32 and 32 in f64; panels of
// kDepth = 16 (f32) or 8 (f64) Linv columns or rows; the tile's rows are n
// rounded up to 32 (f32: phase 2's row quads) or 16 (f64).  Shared memory
// product_smem_bytes(n, elem): Zs plus two panel slots, at n = 144
// 69,120 B in both types (3 blocks an SM), at n = 256 110,592 B f32 (2)
// and 122,880 B f64 (1).  One instance per count of row groups (32 rows
// in f32, 16 in f64), so the register tile covers only the tile's rows, and
// the panel loops take the groups a panel touches as template bounds: no
// branch in them, so the compiler issues later rows' shared-memory loads
// ahead of earlier rows' FMAs.  ptxas at n = 144: 148 registers f32, 144
// f64, no spills.
//
// Where the time goes (chip_smoke.py phase 2b, NVIDIA H100 80GB HBM3,
// 700 W; PERF.md keeps the numbers): at the fleet's first level this
// kernel takes 0.78 ms f32 and 1.08 ms f64, 3.4x and 3.7x the bound of the
// products alone (15.5 GFLOP; 484 / 968 MB), and K1's factor 0.56 / 0.97
// ms, so the product sets the route's pace in both types, by a little in
// f64.  A first version with a uniform branch around each row block took
// 1.23 / 1.56 ms: its SASS waited on each block's own shared-memory load.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxN = 256;
constexpr int kSmemPerBlock = 232448;  // dynamic shared memory a block may opt into

// right-hand columns of a block's tile: 64 in float32 (4 warps x 16), 32
// in float64 (4 warps x one n8 fragment)
__host__ __device__ constexpr int tile_cols(int elem) { return 256 / elem; }

// Linv columns (phase 1) or rows (phase 2) of a streamed panel
__host__ __device__ constexpr int panel_depth(int elem) { return 64 / elem; }

// rows of a group, the unit in which the tile's rows are rounded and the
// panels skip the triangle: 32 in float32 (phase 2's row quads), 16 in
// float64 (two m8 fragments)
__host__ __device__ constexpr int group_rows(int elem) { return 128 / elem; }

// rows of the tile in shared memory: n rounded up to a group
__host__ __device__ constexpr int tile_rows(int n, int elem) {
  return (n + group_rows(elem) - 1) / group_rows(elem) * group_rows(elem);
}

// Zs (rows x (kCols + 4)) and two panel slots of rows x (kDepth + 4); a
// row panel, kDepth x (rows + 4), fits a slot because kDepth <= rows
__host__ __device__ constexpr int product_smem_bytes(int n, int elem) {
  return (tile_rows(n, elem) * (tile_cols(elem) + 4)
          + 2 * tile_rows(n, elem) * (panel_depth(elem) + 4)) * elem;
}

static_assert(product_smem_bytes(kMaxN, 8) <= kSmemPerBlock, "the largest f64 tile fits");
static_assert(product_smem_bytes(kMaxN, 4) <= kSmemPerBlock, "the largest f32 tile fits");

// 16 bytes from device to shared memory, or 16 zero bytes when !valid
// (src-size 0 reads nothing; src must still be a device address)
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned bytes = valid ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// one element, or a zero when !valid
template <typename T>
__device__ __forceinline__ void copy1(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned bytes = valid ? static_cast<unsigned>(sizeof(T)) : 0u;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most one group (the panel just issued) is in flight
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A run of kV = 16 / sizeof(T) elements from src to dst, the first
// `valid` of them copied and the rest zero-filled: one 16-byte copy when
// the run is all in or all out and vec allows it, else one per element.
// base is an aligned address inside the tensor, read by no zero fill.
template <typename T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, const T* base, int valid,
                                         bool vec) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  if (vec && (valid <= 0 || valid >= kV)) {
    copy16(dst, valid > 0 ? src : base, valid > 0);
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) copy1(dst + e, e < valid ? src + e : base, e < valid);
  }
}

// RHS[:, c0 : c0 + kCols] into Zs, zeros past row n and column r
template <typename T>
__device__ __forceinline__ void load_rhs(const T* __restrict__ B, T* Zs, int n, int r, int c0,
                                         int rows, bool vec) {
  constexpr int kCols = tile_cols(sizeof(T));
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kRuns = kCols / kV;
  const int total = rows * kRuns;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int row = idx / kRuns;
    const int c = (idx - row * kRuns) * kV;
    const int hi = row < n ? r - c0 - c : 0;
    copy_run(Zs + row * (kCols + 4) + c, B + static_cast<size_t>(row) * r + c0 + c, B, hi, vec);
  }
}

// Phase 1's panel kb (k0 = kb * kDepth): Linv[i, k0 + kk] for kk < kDepth
// and the rows i of the groups at and below the one holding row k0, zero
// above the diagonal and past row n; stored at P[i * (kDepth + 4) + kk]
template <typename T>
__device__ __forceinline__ void load_column_panel(const T* __restrict__ Li, T* P, int n, int rows,
                                                  int kb, bool vec) {
  constexpr int kDepth = panel_depth(sizeof(T));
  constexpr int kGroup = group_rows(sizeof(T));
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  constexpr int kRuns = kDepth / kV;
  const int k0 = kb * kDepth;
  const int i0 = k0 / kGroup * kGroup;
  const int total = (rows - i0) * kRuns;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int i = i0 + idx / kRuns;
    const int kk = (idx % kRuns) * kV;
    // element e is column k0 + kk + e: valid while it is <= i, in a row < n
    const int hi = i < n ? i - (k0 + kk) + 1 : 0;
    copy_run(P + i * (kDepth + 4) + kk, Li + static_cast<size_t>(i) * n + k0 + kk, Li, hi, vec);
  }
}

// Phase 2's panel lb (l0 = lb * kDepth): Linv[l0 + l, i] for l < kDepth and
// the columns i of the groups up to the one holding row l0 + kDepth - 1,
// zero above the diagonal and past row n; stored at P[l * (rows + 4) + i]
template <typename T>
__device__ __forceinline__ void load_row_panel(const T* __restrict__ Li, T* P, int n, int rows,
                                               int lb, bool vec) {
  constexpr int kDepth = panel_depth(sizeof(T));
  constexpr int kGroup = group_rows(sizeof(T));
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int l0 = lb * kDepth;
  const int runs = ((l0 + kDepth - 1) / kGroup + 1) * kGroup / kV;
  const int total = kDepth * runs;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int l = idx / runs;
    const int i = (idx - l * runs) * kV;
    const int row = l0 + l;
    const int hi = row < n ? row - i + 1 : 0;
    copy_run(P + l * (rows + 4) + i, Li + static_cast<size_t>(row) * n + i, Li, hi, vec);
  }
}

// Issue panel q of the 2 np panels (phase 1's np column panels, then phase
// 2's np row panels) into ring slot q % 2, and commit a group either way,
// so that every panel has its own group.
template <typename T>
__device__ __forceinline__ void issue_panel(const T* __restrict__ Li, T* ring, int slot, int n,
                                            int rows, int np, int q, bool vec) {
  T* P = ring + (q & 1) * slot;
  if (q < np) {
    load_column_panel(Li, P, n, rows, q, vec);
  } else if (q < 2 * np) {
    load_row_panel(Li, P, n, rows, q - np, vec);
  }
  commit();
}

// Start panel p: issue panel p + 1 into the other slot (its last reader,
// panel p - 1, ended with a barrier), wait for panel p's copies and let
// every thread see them.  Returns panel p's slot; the caller ends the
// panel with a barrier.
template <typename T>
__device__ __forceinline__ const T* next_panel(const T* __restrict__ Li, T* ring, int slot, int n,
                                               int rows, int np, int p, bool vec) {
  issue_panel(Li, ring, slot, n, rows, np, p + 1, vec);
  wait_all_but_one();
  __syncthreads();
  return ring + (p & 1) * slot;
}

// The panel functions below take the groups a panel touches as template
// bounds, so their loops carry no branch and the compiler can issue the
// shared-memory loads of later rows ahead of the FMAs of earlier ones.
// Each calls its own instance for the panel's first (phase 1) or last
// (phase 2) group kQ.

// ---------------------------------------------------------------------------
// float32: FFMA register tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// Phase 1, panel kb (k0 = kDepth kb): acc[mi] (row 8 mi + g, the lane's 4
// columns) += Linv[row, k0 : k0 + kDepth] RHS[k0 : k0 + kDepth, columns]
// for the octets of the groups from kQ = k0 / 32 on
template <int kG, int kQ = 0>
__device__ __forceinline__ void column_panel_f32(float (&acc)[4 * kG][4], const float* P,
                                                 const float* Zs, int kb) {
  constexpr int kDepth = panel_depth(4);
  if constexpr (kQ + 1 < kG) {
    if (kb * kDepth / 32 > kQ) {
      column_panel_f32<kG, kQ + 1>(acc, P, Zs, kb);
      return;
    }
  }
  constexpr int kPitchZ = tile_cols(4) + 4;
  constexpr int kPitchP = kDepth + 4;
  const int lane = threadIdx.x & 31;
  const int col = 16 * (threadIdx.x >> 5) + 4 * (lane & 3);
  const float* zb = Zs + kb * kDepth * kPitchZ + col;
  const float* pa = P + (lane >> 2) * kPitchP;
#pragma unroll 1
  for (int k4 = 0; k4 < kDepth; k4 += 4) {
    float4 b[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      b[kk] = *reinterpret_cast<const float4*>(zb + (k4 + kk) * kPitchZ);
    }
#pragma unroll
    for (int mi = 4 * kQ; mi < 4 * kG; ++mi) {
      const float4 a = *reinterpret_cast<const float4*>(pa + 8 * mi * kPitchP + k4);
      fma4(acc[mi], a.x, b[0]);
      fma4(acc[mi], a.y, b[1]);
      fma4(acc[mi], a.z, b[2]);
      fma4(acc[mi], a.w, b[3]);
    }
  }
}

// Phase 2, panel lb (l0 = kDepth lb): acc[mq][j] (row 32 mq + 4 g + j) +=
// sum_l Linv[l0 + l, row] Z[l0 + l, columns] for the quads of the groups up
// to kQ = (l0 + kDepth - 1) / 32
template <int kG, int kQ = 0>
__device__ __forceinline__ void row_panel_f32(float (&acc)[kG][4][4], const float* P,
                                              const float* Zs, int rows, int lb) {
  constexpr int kDepth = panel_depth(4);
  if constexpr (kQ + 1 < kG) {
    if ((lb * kDepth + kDepth - 1) / 32 > kQ) {
      row_panel_f32<kG, kQ + 1>(acc, P, Zs, rows, lb);
      return;
    }
  }
  constexpr int kPitchZ = tile_cols(4) + 4;
  const int lane = threadIdx.x & 31;
  const int col = 16 * (threadIdx.x >> 5) + 4 * (lane & 3);
  const float* zb = Zs + lb * kDepth * kPitchZ + col;
  const float* pa = P + 4 * (lane >> 2);
  const int pitch = rows + 4;
#pragma unroll 1
  for (int l4 = 0; l4 < kDepth; l4 += 4) {
#pragma unroll
    for (int ll = 0; ll < 4; ++ll) {
      const int l = l4 + ll;
      const float4 b = *reinterpret_cast<const float4*>(zb + l * kPitchZ);
#pragma unroll
      for (int mq = 0; mq <= kQ; ++mq) {
        const float4 a = *reinterpret_cast<const float4*>(pa + l * pitch + 32 * mq);
        fma4(acc[mq][0], a.x, b);
        fma4(acc[mq][1], a.y, b);
        fma4(acc[mq][2], a.z, b);
        fma4(acc[mq][3], a.w, b);
      }
    }
  }
}

template <int kG>
__device__ __forceinline__ void product_f32(const float* __restrict__ Li,
                                            const float* __restrict__ B, float* __restrict__ Yg,
                                            float* Zs, float* ring, int n, int r, int c0,
                                            bool vec_li, bool vec_r) {
  constexpr int kPitchZ = tile_cols(4) + 4;
  constexpr int kDepth = panel_depth(4);
  constexpr int rows = 32 * kG;
  constexpr int slot = rows * (kDepth + 4);
  const int np = (n + kDepth - 1) / kDepth;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int col = 16 * (threadIdx.x >> 5) + 4 * (lane & 3);

  load_rhs(B, Zs, n, r, c0, rows, vec_r);  // in panel 0's group
  issue_panel(Li, ring, slot, n, rows, np, 0, vec_li);
  {
    float acc[4 * kG][4];
#pragma unroll
    for (int mi = 0; mi < 4 * kG; ++mi) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][c] = 0.f;
    }
    for (int kb = 0; kb < np; ++kb) {
      column_panel_f32<kG>(acc, next_panel(Li, ring, slot, n, rows, np, kb, vec_li), Zs, kb);
      __syncthreads();
    }
    // every read of RHS is done: Z takes its place (zeros past row n)
#pragma unroll
    for (int mi = 0; mi < 4 * kG; ++mi) {
      *reinterpret_cast<float4*>(Zs + (8 * mi + g) * kPitchZ + col) =
          make_float4(acc[mi][0], acc[mi][1], acc[mi][2], acc[mi][3]);
    }
  }

  float acc[kG][4][4];
#pragma unroll
  for (int mq = 0; mq < kG; ++mq) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mq][j][c] = 0.f;
    }
  }
  for (int lb = 0; lb < np; ++lb) {  // the first panel's barrier publishes Z
    row_panel_f32<kG>(acc, next_panel(Li, ring, slot, n, rows, np, np + lb, vec_li), Zs, rows,
                      lb);
    __syncthreads();
  }

  const int c = c0 + col;
#pragma unroll
  for (int mq = 0; mq < kG; ++mq) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 32 * mq + 4 * g + j;
      if (row >= n) continue;
      float* y = Yg + static_cast<size_t>(row) * r + c;
      if (vec_r && c < r) {
        *reinterpret_cast<float4*>(y) =
            make_float4(acc[mq][j][0], acc[mq][j][1], acc[mq][j][2], acc[mq][j][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < r) y[e] = acc[mq][j][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float64: DMMA (mma.sync.aligned.m8n8k4, f64 on the tensor cores).  A
// lane holds A[g][t], B[t][g] and C[g][2t], C[g][2t + 1] (g = lane / 4,
// t = lane % 4) of the 8 x 4, 4 x 8 and 8 x 8 fragments.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
      : "=d"(c[0]), "=d"(c[1])
      : "d"(a), "d"(b), "d"(c[0]), "d"(c[1]));
}

// Phase 1, panel kb (k0 = kDepth kb): row fragment mi (rows 8 mi ..) +=
// Linv[rows, k0 : k0 + kDepth] RHS[k0 : k0 + kDepth, the warp's 8 columns]
// for the fragments of the groups from kQ = k0 / 16 on
template <int kG, int kQ = 0>
__device__ __forceinline__ void column_panel_f64(double (&acc)[2 * kG][2], const double* P,
                                                 const double* Zs, int kb) {
  constexpr int kDepth = panel_depth(8);
  if constexpr (kQ + 1 < kG) {
    if (kb * kDepth / 16 > kQ) {
      column_panel_f64<kG, kQ + 1>(acc, P, Zs, kb);
      return;
    }
  }
  constexpr int kPitchZ = tile_cols(8) + 4;
  constexpr int kPitchP = kDepth + 4;
  constexpr int kSteps = kDepth / 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const double* zb = Zs + (kb * kDepth + t) * kPitchZ + 8 * (threadIdx.x >> 5) + g;
  double b[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) b[s] = zb[4 * s * kPitchZ];
  const double* pa = P + g * kPitchP + t;
#pragma unroll
  for (int mi = 2 * kQ; mi < 2 * kG; ++mi) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) dmma(acc[mi], pa[8 * mi * kPitchP + 4 * s], b[s]);
  }
}

// Phase 2, panel lb (l0 = kDepth lb): row fragment mi of Y += Linv[l0 :
// l0 + kDepth, rows]^T Z[l0 : l0 + kDepth, the warp's columns] for the
// fragments of the groups up to kQ = (l0 + kDepth - 1) / 16
template <int kG, int kQ = 0>
__device__ __forceinline__ void row_panel_f64(double (&acc)[2 * kG][2], const double* P,
                                              const double* Zs, int rows, int lb) {
  constexpr int kDepth = panel_depth(8);
  if constexpr (kQ + 1 < kG) {
    if ((lb * kDepth + kDepth - 1) / 16 > kQ) {
      row_panel_f64<kG, kQ + 1>(acc, P, Zs, rows, lb);
      return;
    }
  }
  constexpr int kPitchZ = tile_cols(8) + 4;
  constexpr int kSteps = kDepth / 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int pitch = rows + 4;
  const double* zb = Zs + (lb * kDepth + t) * kPitchZ + 8 * (threadIdx.x >> 5) + g;
  double b[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) b[s] = zb[4 * s * kPitchZ];
  const double* pa = P + t * pitch + g;
#pragma unroll
  for (int mi = 0; mi < 2 * kQ + 2; ++mi) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) dmma(acc[mi], pa[4 * s * pitch + 8 * mi], b[s]);
  }
}

template <int kG>
__device__ __forceinline__ void product_f64(const double* __restrict__ Li,
                                            const double* __restrict__ B,
                                            double* __restrict__ Yg, double* Zs, double* ring,
                                            int n, int r, int c0, bool vec_li, bool vec_r) {
  constexpr int kPitchZ = tile_cols(8) + 4;
  constexpr int kDepth = panel_depth(8);
  constexpr int rows = 16 * kG;
  constexpr int slot = rows * (kDepth + 4);
  const int np = (n + kDepth - 1) / kDepth;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int col = 8 * (threadIdx.x >> 5) + 2 * (lane & 3);

  load_rhs(B, Zs, n, r, c0, rows, vec_r);  // in panel 0's group
  issue_panel(Li, ring, slot, n, rows, np, 0, vec_li);
  {
    double acc[2 * kG][2];
#pragma unroll
    for (int mi = 0; mi < 2 * kG; ++mi) acc[mi][0] = acc[mi][1] = 0.0;
    for (int kb = 0; kb < np; ++kb) {
      column_panel_f64<kG>(acc, next_panel(Li, ring, slot, n, rows, np, kb, vec_li), Zs, kb);
      __syncthreads();
    }
    // every read of RHS is done: Z takes its place (zeros past row n)
#pragma unroll
    for (int mi = 0; mi < 2 * kG; ++mi) {
      *reinterpret_cast<double2*>(Zs + (8 * mi + g) * kPitchZ + col) =
          make_double2(acc[mi][0], acc[mi][1]);
    }
  }

  double acc[2 * kG][2];
#pragma unroll
  for (int mi = 0; mi < 2 * kG; ++mi) acc[mi][0] = acc[mi][1] = 0.0;
  for (int lb = 0; lb < np; ++lb) {  // the first panel's barrier publishes Z
    row_panel_f64<kG>(acc, next_panel(Li, ring, slot, n, rows, np, np + lb, vec_li), Zs, rows,
                      lb);
    __syncthreads();
  }

  const int c = c0 + col;
#pragma unroll
  for (int mi = 0; mi < 2 * kG; ++mi) {
    const int row = 8 * mi + g;
    if (row >= n) continue;
    double* y = Yg + static_cast<size_t>(row) * r + c;
    if (vec_r && c < r) {
      *reinterpret_cast<double2*>(y) = make_double2(acc[mi][0], acc[mi][1]);
    } else {
      if (c < r) y[0] = acc[mi][0];
      if (c + 1 < r) y[1] = acc[mi][1];
    }
  }
}

// kG groups of group_rows(sizeof(T)) rows: 1-8 in float32, 1-16 in
// float64.  Three blocks an SM hold up to 160 rows' registers.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, kG * group_rows(sizeof(T)) <= 160 ? 3 : 2)
chol_inv_apply_product_kernel(const T* __restrict__ Linv, const T* __restrict__ RHS,
                              T* __restrict__ Y, int n, int r, int tiles, int vec_li, int vec_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kElem = static_cast<int>(sizeof(T));
  T* Zs = reinterpret_cast<T*>(smem_raw);
  T* ring = Zs + kG * group_rows(kElem) * (tile_cols(kElem) + 4);
  const int mat = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - mat * tiles) * tile_cols(kElem);
  const T* Li = Linv + static_cast<size_t>(mat) * n * n;
  const T* B = RHS + static_cast<size_t>(mat) * n * r;
  T* Yg = Y + static_cast<size_t>(mat) * n * r;
  if constexpr (sizeof(T) == 4) {
    product_f32<kG>(Li, B, Yg, Zs, ring, n, r, c0, vec_li != 0, vec_r != 0);
  } else {
    product_f64<kG>(Li, B, Yg, Zs, ring, n, r, c0, vec_li != 0, vec_r != 0);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename T, int kG>
int launch_groups(const T* Linv, const T* RHS, T* Y, int N, int n, int r, void* stream) {
  constexpr int kElem = static_cast<int>(sizeof(T));
  if constexpr (kG * group_rows(kElem) < kMaxN) {
    if (tile_rows(n, kElem) > kG * group_rows(kElem)) {
      return launch_groups<T, kG + 1>(Linv, RHS, Y, N, n, r, stream);
    }
  }
  constexpr int kV = 16 / kElem;
  const int tiles = (r + tile_cols(kElem) - 1) / tile_cols(kElem);
  const long long blocks = static_cast<long long>(N) * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = product_smem_bytes(n, kElem);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(chol_inv_apply_product_kernel<T, kG>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_li = n % kV == 0 && aligned16(Linv);
  const int vec_r = r % kV == 0 && aligned16(RHS) && aligned16(Y);
  chol_inv_apply_product_kernel<T, kG>
      <<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          Linv, RHS, Y, n, r, tiles, vec_li, vec_r);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* Linv, const T* RHS, T* Y, int N, int n, int r, void* stream) {
  if (N < 0 || n < 1 || n > kMaxN || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0 || r == 0) return 0;
  return launch_groups<T, 1>(Linv, RHS, Y, N, n, r, stream);
}

}  // namespace

// Plain C interface (bound with ctypes).  Linv is a contiguous (N, n, n)
// device buffer (only its lower triangle is read), RHS and Y contiguous
// (N, n, r) ones; the launch goes on `stream` and does not synchronise.
// Returns the cudaError_t of the launch, 0 on success.
extern "C" int piqp_chol_inv_apply_product_f32(const float* Linv, const float* RHS, float* Y,
                                               int N, int n, int r, void* stream) {
  return launch<float>(Linv, RHS, Y, N, n, r, stream);
}

extern "C" int piqp_chol_inv_apply_product_f64(const double* Linv, const double* RHS,
                                               double* Y, int N, int n, int r, void* stream) {
  return launch<double>(Linv, RHS, Y, N, n, r, stream);
}
