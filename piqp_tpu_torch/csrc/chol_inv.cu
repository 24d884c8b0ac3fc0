// Batched Cholesky factorization with fused triangular inverse (K1), with
// the workspace streamed through device memory.
//
// Replaces the TPU kernel piqp_tpu/ops/pallas_chol.py::_chol_inv_kernel for
// the n whose working set does not fit in a block's shared memory, up to
// 256 (float32 n > 240, float64 n > 169); smaller n take the resident
// kernel of chol_inv_resident.cu (ops/chol_inv.py routes by shape).
// For each SPD matrix K of a (B, n, n) batch it computes the lower factor
// L = chol(K), with its strict upper triangle zeroed, and Linv = L^-1, by
// the TPU kernel's per-column recurrence:
//
//   d        = sqrt(W[j, j])                        (W: running workspace)
//   L[i, j]  = W[i, j] / d                          for i >= j
//   W[i, k] -= L[i, j] L[k, j]                      for j < k <= i
//   Linv[j,] = (e_j - L[j, :j] Linv[:j, :]) / d
//
// A pivot d^2 <= 0 is neither clamped nor guarded: its problem's outputs
// come out non-finite, which the KKT layer reads as a failed factorization
// and answers by raising the regularization.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them, the highest rate
// of each type).  The kernel must read K once and write L and Linv once,
// 3 B n^2 elements, against about 2n^3/3 flops per matrix (n^3/3 for the
// factor, n^3/3 for the triangular inverse); at B = 1024 and n = 128 that
// is 201 MB in f32 (60 us) or 403 MB in f64 (120 us) against 1.4 GFLOP
// (21 us in either type), so it is bound by bytes in both types.
//
// Design: one thread block of 256 threads per matrix, so the grid is the
// batch and no padding is needed (the TPU's batch tiles existed for its
// sequential grid).  The recurrence itself is chol_recurrence.cuh, shared
// with K2 and K3.  The workspace lives in the L output buffer in device
// memory, since at these n one matrix does not fit in a block's 227 KB of
// shared memory (256 KB in f32 at n = 256), and stays mostly in the 50 MB
// L2.  The pivot column and row j of L are staged in shared memory.  Each
// step has two phases split by __syncthreads: (1) read the pivot and stage
// the scaled column and row j; (2) write the column, apply the rank-1
// update to the lower trailing block and form row j of Linv, each entry a
// dot product over earlier rows read from device memory, so each step
// waits on a chain of dependent loads (PERF.md times this kernel beside
// the resident one at n = 128).

#include <cuda_runtime.h>

#include "chol_recurrence.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_inv_kernel(const T* __restrict__ K, T* __restrict__ L_out,
                T* __restrict__ Linv_out, int n) {
  __shared__ T col[kMaxN];
  __shared__ T row[kMaxN];

  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const T* A = K + offset;
  T* L = L_out + offset;
  T* Li = Linv_out + offset;
  const int tid = threadIdx.x;
  const int nn = n * n;

  for (int idx = tid; idx < nn; idx += kThreads) {
    L[idx] = A[idx];
    Li[idx] = T(0);
  }
  __syncthreads();

  piqp::chol_inv_recurrence<T, kThreads>(L, Li, nullptr, n, col, row);

  // the strict upper triangle of L still holds K's entries
  for (int idx = tid; idx < nn; idx += kThreads) {
    if (idx % n > idx / n) L[idx] = T(0);
  }
}

template <typename T>
int launch(const T* K, T* L, T* Linv, int B, int n, void* stream) {
  if (B < 0 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  chol_inv_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      K, L, Linv, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  Inputs and outputs are contiguous
// (B, n, n) device buffers; the launch goes on `stream` and does not
// synchronise.  Returns the cudaError_t of the launch, 0 on success.
extern "C" int piqp_chol_inv_streamed_f32(const float* K, float* L, float* Linv,
                                          int B, int n, void* stream) {
  return launch<float>(K, L, Linv, B, n, stream);
}

extern "C" int piqp_chol_inv_streamed_f64(const double* K, double* L, double* Linv,
                                          int B, int n, void* stream) {
  return launch<double>(K, L, Linv, B, n, stream);
}
