// The column recurrence of K2's general kernel (chol_inv_apply.cu): factor
// K = L L^T in place and build Linv = L^-1 row by row, for one matrix per
// thread block.  The general kernel now takes only the shapes whose work
// square [K | RHS] is too large for chol_inv_apply_resident.cu (with
// r = 2n + 4: n 139-256 in float32, 98-256 in float64); no fleet's shape
// reaches it.
//
//   d        = sqrt(W[j, j])            (W: running workspace)
//   L[i, j]  = W[i, j] / d              for i >= j
//   W[i, k] -= L[i, j] W[k, j] / d      for j < k <= i
//   Linv[j,] = (e_j - L[j, :j] Linv[:j, :]) / d
//
// This is the TPU kernel's recurrence (pallas_chol.py:65).  A pivot <= 0
// gives sqrt of a non-positive number: the problem's outputs come out
// non-finite, and nothing clamps it.
//
// W and Li may live in shared or device memory (generic addressing); col
// and row are n-entry shared scratch.  On entry W holds K and Li is zero;
// on exit the lower triangle of W holds L (its strict upper triangle
// still holds K's entries) and Li holds L^-1.  W, Li, col and row do not
// overlap.  Every thread of the block calls this; blockDim.x is a multiple
// of 32.

#pragma once

#include <cuda_runtime.h>

namespace piqp {

template <typename T>
__device__ __forceinline__ void chol_inv_recurrence(T* __restrict__ W, T* __restrict__ Li, int n,
                                                    T* __restrict__ col, T* __restrict__ row) {
  const int tid = threadIdx.x;
  const int nthreads = static_cast<int>(blockDim.x);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;

  for (int j = 0; j < n; ++j) {
    // phase 1: pivot, scaled column j (rows >= j), row j of L
    const T dinv = T(1) / sqrt(W[j * n + j]);
    for (int i = j + tid; i < n; i += nthreads) col[i] = W[i * n + j] * dinv;
    for (int k = tid; k < j; k += nthreads) row[k] = W[j * n + k];
    __syncthreads();

    // phase 2a: column j of L and the downdate of the lower trailing
    // block, one warp per row so that a warp's lanes touch neighbouring
    // addresses
    for (int i = j + tid; i < n; i += nthreads) W[i * n + j] = col[i];
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const T li = col[i];
      T* Wrow = W + i * n;
      for (int k = j + 1 + lane; k <= i; k += 32) Wrow[k] -= li * col[k];
    }
    // phase 2b: row j of Linv by forward substitution against rows < j
    for (int c = tid; c <= j; c += nthreads) {
      T acc = T(0);
      for (int k = c; k < j; ++k) acc += row[k] * Li[k * n + c];
      Li[j * n + c] = ((c == j ? T(1) : T(0)) - acc) * dinv;
    }
    __syncthreads();
  }
}

}  // namespace piqp
