// Batched signed Cholesky with fused triangular inverse (K3), streamed
// through device memory: the first port of the TPU kernel
// piqp_tpu/ops/pallas_chol.py::_signed_chol_inv_kernel.  The route now takes
// the cluster-resident kernel of signed_chol_inv_resident.cu for every
// n <= 256; this one stays as a hand-written comparator, reached only
// through ops/signed_chol_inv.py's private _launch(K, signs, "streamed").
// For each quasi-definite matrix K of a (B, n, n) batch and one sign vector
// S = diag(signs), signs in {+1, -1} shared by the batch, it computes the
// lower factor L with K = L S L^T (diag(L) = sqrt|pivot|, strict upper
// triangle zeroed) and Linv = L^-1, by K1's column recurrence with the sign
// woven into the pivot, the column scaling and the downdate
// (chol_recurrence.cuh).  The dense_ldlt backend factors the full 3-block
// KKT matrix with it: +1 on the n primal rows, -1 on the p+m dual rows.
//
// A pivot whose sign disagrees with its entry of S gives sqrt of a
// negative number: that problem's outputs come out non-finite, which the
// KKT layer reads as a failed factorization; nothing clamps it.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them, the highest rate
// of each type).  At the dense_ldlt fleet's shape, B = 256 and n = 256,
// the kernel must read K once and write L and Linv once: 3 B n^2
// elements, 201 MB in f32 (60 us) or 403 MB in f64 (120 us).  It does
// about 2n^3/3 flops per matrix (n^3/3 for the signed factor, n^3/3 for
// the triangular inverse), 2.9 GFLOP in all: 43 us in either type.  So it
// is bound by bytes in both types.
//
// Design: K1's.  One block of 256 threads per matrix, so the grid is the
// batch and no padding slots are needed (the TPU launcher's sign-consistent
// identity padding existed for its sequential grid of batch tiles).  One
// n = 256 matrix is 256 KB in f32 and 512 KB in f64, more than a block's
// 227 KB of shared memory, so the workspace lives in the L output buffer in
// device memory, and the 256 blocks' working sets mostly stay in the 50 MB
// L2.  The sign vector is read once per block into shared memory.
// Shared-memory tiles and tensor-core trailing updates are later work.

#include <cuda_runtime.h>

#include "chol_recurrence.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
signed_chol_inv_kernel(const T* __restrict__ K, const T* __restrict__ signs,
                       T* __restrict__ L_out, T* __restrict__ Linv_out, int n) {
  __shared__ T s[kMaxN];
  __shared__ T col[kMaxN];
  __shared__ T row[kMaxN];

  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const T* A = K + offset;
  T* L = L_out + offset;
  T* Li = Linv_out + offset;
  const int tid = threadIdx.x;
  const int nn = n * n;

  for (int i = tid; i < n; i += kThreads) s[i] = signs[i];
  for (int idx = tid; idx < nn; idx += kThreads) {
    L[idx] = A[idx];
    Li[idx] = T(0);
  }
  __syncthreads();

  piqp::chol_inv_recurrence<T, kThreads>(L, Li, s, n, col, row);

  // the strict upper triangle of L still holds K's entries
  for (int idx = tid; idx < nn; idx += kThreads) {
    if (idx % n > idx / n) L[idx] = T(0);
  }
}

template <typename T>
int launch(const T* K, const T* signs, T* L, T* Linv, int B, int n,
           void* stream) {
  if (B < 0 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  signed_chol_inv_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      K, signs, L, Linv, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  K, L and Linv are contiguous
// (B, n, n) device buffers, signs a contiguous (n,) device buffer of the
// same type; the launch goes on `stream` and does not synchronise.
// Returns the cudaError_t of the launch, 0 on success.
extern "C" int piqp_signed_chol_inv_streamed_f32(const float* K, const float* signs,
                                                 float* L, float* Linv, int B, int n,
                                                 void* stream) {
  return launch<float>(K, signs, L, Linv, B, n, stream);
}

extern "C" int piqp_signed_chol_inv_streamed_f64(const double* K, const double* signs,
                                                 double* L, double* Linv, int B, int n,
                                                 void* stream) {
  return launch<double>(K, signs, L, Linv, B, n, stream);
}
