// Batched Cholesky with fused triangular inverse and apply (K2), the
// general route: one thread block per matrix.
//
// Replaces the TPU kernel piqp_tpu/ops/pallas_chol.py::_chol_inv_apply_kernel
// for the shapes up to n = 256 that neither of the other two K2 kernels
// takes: those whose n x (n + r) work square exceeds one block's shared
// memory (with r = 2n + 4: n >= 139 in float32, n >= 98 in float64, and
// any n with a wide enough r, such as n = 32 with r = 1800 in float32).
// Every other n > 32 takes chol_inv_apply_resident.cu, n <= 32 with a
// narrow right-hand block chol_inv_apply_small.cu (ops/chol_inv.py routes
// by shape); no fleet's shape reaches this kernel any more (the D = 48
// multistage fleet's n = 48, r = 100 runs on the resident route).
// For each SPD block K (n x n) of an (N, n, n) batch and its right-hand
// block RHS (n x r) it computes K1's factor L = chol(K) (strict upper
// triangle zeroed) and Linv = L^-1 (chol_recurrence.cuh), then, in the same
// kernel body, both substitution products
//
//   Z = Linv RHS,   Y = Linv^T Z = K^-1 RHS.
//
// It is the chain step of the multistage backend's cyclic reduction: each
// level factors all odd diagonal blocks of every problem at once and needs
// Do^-1 [S_in | S_out^T | Eo^T] from the same pass (multistage.py).
//
// A pivot <= 0 gives non-finite output for its block only; nothing clamps
// it, and the KKT layer reads it as a failed factorization.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them, the highest rate
// of each type).  At the multistage fleet's shape, N = 256 problems x 50
// odd blocks = 12,800 blocks with n = 8 and r = 2n + 4 = 20, the kernel
// must read K and RHS once and write L, Linv and Y once: N (3 n^2 + 2 n r)
// elements, 26 MB in f32 (7.8 us) or 52 MB in f64 (15.6 us).  It does
// about 2n^3/3 + 2 n^2 r flops per block (factor and triangular inverse,
// then two triangular products), 37 MFLOP in all (0.6 us).  So it is
// bound by bytes in both types.
//
// Design: one thread block per matrix, sized by the problem:
// the block has max(n, r) threads rounded up to a warp (at most 256), so an
// n = 8 block runs one warp instead of leaving 224 of 256 threads idle.
// While K, Linv and the right-hand block fit in the 227 KB of shared
// memory (n = 8: 2.4 KB in f64; up to n = 64 with r = 2n + 4), they live
// there and only the outputs go to device memory; larger blocks keep the
// workspace in the output buffers.  The products run one thread
// per right-hand column, in place: rows in descending order for Z = Linv
// RHS (row i needs the RHS rows <= i, not yet overwritten), then ascending
// for Y = Linv^T Z (row i needs the Z rows >= i).  At the fleet's n = 8
// this kernel is bound by latency (8.7x / 4.8x the bound in f32 / f64),
// which is what chol_inv_apply_small.cu's design answers.

#include <cuda_runtime.h>

#include "chol_recurrence.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxN = 256;
constexpr size_t kMaxSmem = 232448;  // a block's share of an SM, H100

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
chol_inv_apply_kernel(const T* __restrict__ K, const T* __restrict__ RHS,
                      T* __restrict__ L_out, T* __restrict__ Linv_out,
                      T* __restrict__ Y_out, int n, int r, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);
  T* row = col + n;

  const size_t offset = static_cast<size_t>(blockIdx.x) * n * n;
  const size_t roffset = static_cast<size_t>(blockIdx.x) * n * r;
  T* L = L_out + offset;
  T* Lig = Linv_out + offset;
  T* Yg = Y_out + roffset;
  T* W = in_smem ? row + n : L;
  T* Li = in_smem ? W + n * n : Lig;
  T* Y = in_smem ? Li + n * n : Yg;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int nn = n * n;
  const int nr = n * r;

  for (int idx = tid; idx < nn; idx += nthreads) {
    W[idx] = K[offset + idx];
    Li[idx] = T(0);
  }
  for (int idx = tid; idx < nr; idx += nthreads) Y[idx] = RHS[roffset + idx];
  __syncthreads();

  piqp::chol_inv_recurrence<T>(W, Li, n, col, row);

  // Z = Linv RHS, then Y = Linv^T Z, in place, one thread per column
  for (int k = tid; k < r; k += nthreads) {
    for (int i = n - 1; i >= 0; --i) {
      T acc = T(0);
      for (int l = 0; l <= i; ++l) acc += Li[i * n + l] * Y[l * r + k];
      Y[i * r + k] = acc;
    }
    for (int i = 0; i < n; ++i) {
      T acc = T(0);
      for (int l = i; l < n; ++l) acc += Li[l * n + i] * Y[l * r + k];
      Y[i * r + k] = acc;
    }
  }
  __syncthreads();

  // L keeps its lower triangle; the strict upper one still holds K
  for (int idx = tid; idx < nn; idx += nthreads) {
    L[idx] = (idx % n > idx / n) ? T(0) : W[idx];
    if (in_smem) Lig[idx] = Li[idx];
  }
  if (in_smem) {
    for (int idx = tid; idx < nr; idx += nthreads) Yg[idx] = Y[idx];
  }
}

template <typename T>
int launch(const T* K, const T* RHS, T* L, T* Linv, T* Y, int N, int n, int r,
           void* stream) {
  if (N < 0 || n < 1 || n > kMaxN || r < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const int want = n > r ? n : r;
  int threads = ((want + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t full = (2 * static_cast<size_t>(n) + 2 * static_cast<size_t>(n) * n +
                       static_cast<size_t>(n) * r) * sizeof(T);
  const int in_smem = full <= kMaxSmem;
  const size_t smem = in_smem ? full : 2 * static_cast<size_t>(n) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_inv_apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_inv_apply_kernel<T><<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, RHS, L, Linv, Y, n, r, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes).  K, L and Linv are contiguous
// (N, n, n) device buffers, RHS and Y contiguous (N, n, r) ones; the launch
// goes on `stream` and does not synchronise.  Returns the cudaError_t of
// the launch, 0 on success.
extern "C" int piqp_chol_inv_apply_f32(const float* K, const float* RHS,
                                       float* L, float* Linv, float* Y, int N,
                                       int n, int r, void* stream) {
  return launch<float>(K, RHS, L, Linv, Y, N, n, r, stream);
}

extern "C" int piqp_chol_inv_apply_f64(const double* K, const double* RHS,
                                       double* L, double* Linv, double* Y,
                                       int N, int n, int r, void* stream) {
  return launch<double>(K, RHS, L, Linv, Y, N, n, r, stream);
}
