// Batched Cholesky with fused triangular inverse and apply (K2) for small
// blocks, n <= 32: many matrices per thread block, each factored in
// registers by a group of lanes.
//
// Replaces the TPU kernel piqp_tpu/ops/pallas_chol.py::_chol_inv_apply_kernel
// for n <= 32 (ops/chol_inv.py routes by shape; 33 <= n <= 256 take the
// resident kernel or the split route).  For each SPD block K (n x n) of an
// (N, n, n) batch and its right-hand block RHS (n x r) it writes
//
//   L = chol(K)        strict upper triangle zero,
//   Linv = L^-1        upper triangle zero,
//   Y = Linv^T (Linv RHS) = K^-1 RHS.
//
// Only K's lower triangle is read.  A pivot <= 0 gives non-finite L, Linv
// and Y for its block only; nothing clamps it.
//
// Bound on an H100 SXM (data sheet: 3.35 TB/s HBM3; 67 TFLOP/s in f32
// outside the tensor cores and 67 TFLOP/s in f64 on them).  At the
// multistage fleet's shape, N = 12,800 blocks with n = 8 and r = 2n + 4 =
// 20, the kernel must read K's lower triangle and RHS once and write L,
// Linv and Y once: N (n(n+1)/2 + 2n^2 + 2nr) elements, 24.8 MB in f32
// (7.4 us) or 49.6 MB in f64 (14.8 us), against about 2n^3/3 + 2n^2 r flops
// a block, 37 MFLOP in all (0.6 us).  So it is bound by bytes in both
// types.  The old general kernel (one 32-thread block per matrix, two block
// barriers per column, one thread per right-hand column walking both
// triangular products) takes 8.7x / 4.8x that bound: it is bound by
// latency, not by bytes.
//
// Design.  The times below are device times at N = 12,800, n = 8, r = 20,
// f32 / f64, on an NVIDIA H100 80GB HBM3 at 700 W (scripts/time_kernel.py
// K2 over checkouts of each variant; PERF.md keeps them).
// - Placement: a block of small_threads(n, r, elem) threads (64 unless
//   the shared memory below exceeds 227 KB, then halved) takes M =
//   threads / g consecutive matrices, g = group_lanes(n), the power of two
//   >= n (at least 4).  At n = 8, r = 20: g = 8, M = 8, 1,600 blocks for
//   the fleet's 12,800 matrices.  Blocks of 64 threads beat 128 and 256
//   (0.0133 / 0.0278 ms against 0.0140 / 0.0303 and 0.0158 / 0.0316; 32
//   threads matched 64 here and were 8-12% slower at n = 23): 400 blocks
//   of 256 spread 3 or 4 to an SM, and in f64 only 3 fit, so 4 ran in a
//   second wave; 1,600 small blocks spread evenly.
// - Staging: the block copies its K run (M n^2 elements) and RHS run
//   (M n r) into shared memory with 16-byte cp.async copies when the run
//   starts on a 16-byte boundary (scalar copies otherwise, and for the
//   tail), and writes its Y run back with 16-byte stores when the matrices
//   are done.  The ragged last block copies only its matrices.  L's and
//   Linv's columns go from registers straight to device memory, a group's
//   lanes on neighbouring addresses (whole 32-byte sectors at n = 8); Y
//   stored the same way, at a stride of r, was slower (0.0154 / 0.0416 ms).
//   Shared memory is small_smem_bytes(n, r, elem, M): K's region, RHS's
//   (then Y's), each rounded up to 16 bytes, and two broadcast rows of
//   step_cols(r, elem) x g values per matrix:
//     n = 8,  r = 20, M = 8:  9,216 B f32 (22 blocks an SM), 16,384 B f64 (13);
//     n = 23, r = 50, M = 2: 14,464 B f32 (15 blocks an SM), 28,912 B f64 (7);
//   (228 KB an SM, 1 KB reserved per block; registers allow ~23 blocks at
//   n = 8 and 9 / 5 at n = 23).  At n = 8 all 1,600 blocks are resident at
//   once and issue all of K and RHS (13.5 MB f32, 27 MB f64), far more than
//   the ~3 MB that Little's law asks for at 3.35 TB/s.
// - Factor and inverse: lane i of a group holds row i of the symmetric
//   work matrix in g registers (rows past n are the identity's) and its
//   diagonal entry apart, and the inverse is eliminated beside the factor,
//   as in K1's resident kernel (chol_inv_resident.cu).  At column j, lane j
//   forms
//     v[c] = row_j[c] / d for c != j,  v[j] = 1 / d,  d = sqrt(row_j[j]),
//   i.e. row j of Linv left of the diagonal and column j of L right of it,
//   keeps it as its row and writes it to the group's broadcast row in
//   shared memory (16-byte stores); after a __syncwarp every later row i
//   reads it back (16-byte loads, one address per group) and subtracts
//   v[i] v over the whole row, column j counting as 0.  So each lane ends
//   with Linv's row i (c <= i) and L's column i (c > i) in registers, and
//   d = L[i, i].  No block barrier in the factor; no chain of dependent
//   selects (the pivot is the lane's own diagonal register).  A first
//   version broadcast the row by g __shfl_sync and picked the pivot by a
//   chain of selects (0.0198 / 0.0386 ms at 256 threads).
// - Products: Linv's rows go through K's region (free after the factor) so
//   that lane i reads Linv's column i back into registers.  Then KB =
//   step_cols(r, elem) right-hand columns a step (a 16- or 8-byte vector):
//   lane i forms Z[i, k:k+KB] = Linv[i, :] RHS[:, k:k+KB] (g vector loads,
//   one address per group), writes it to the group's broadcast row, and
//   after a __syncwarp forms Y[i, k:k+KB] = Linv[:, i] . Z[:, k:k+KB] and
//   writes it over RHS[i, k:k+KB], which no lane reads again.  No lane walks
//   a chain longer than g terms, KB chains run side by side, and the
//   accumulators are registers.  Each group starts at step (group mod
//   steps), so the groups of a warp read different banks.
// wgmma and TMA are not used: the products are n x n by n x r with n <= 32
// and bytes, not flops, bound the kernel.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kSmallThreads = 64;
constexpr int kMaxSmallN = 32;
constexpr int kSmemPerBlock = 232448;  // dynamic shared memory a block may opt into
constexpr int kMaxDevices = 64;

// lanes per matrix: the power of two >= n, at least 4
constexpr int group_lanes(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32; }

// right-hand columns a lane takes per step: a 16-byte vector's worth when
// the rows' length r allows, else an 8-byte one, else one
constexpr int step_cols(int r, int elem) {
  return r % (16 / elem) == 0 ? 16 / elem : (r % (8 / elem) == 0 ? 8 / elem : 1);
}

// K and RHS (then Y) of m matrices, each region rounded up to 16 bytes,
// and two broadcast rows of step_cols(r, elem) x g values per matrix
constexpr int small_smem_bytes(int n, int r, int elem, int m) {
  return ((m * n * n * elem + 15) / 16 + (m * n * r * elem + 15) / 16) * 16 +
         2 * m * group_lanes(n) * step_cols(r, elem) * elem;
}

// threads of a block: 256, halved while its matrices' shared memory does
// not fit; 0 when one warp's does not
constexpr int small_threads(int n, int r, int elem) {
  int t = kSmallThreads;
  while (t > 32 && small_smem_bytes(n, r, elem, t / group_lanes(n)) > kSmemPerBlock) t /= 2;
  return small_smem_bytes(n, r, elem, t / group_lanes(n)) > kSmemPerBlock ? 0 : t;
}

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

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

// count elements from src (device memory) to dst (shared memory, 16-byte
// aligned) by the whole block: cp.async of 16 bytes where src is aligned,
// then scalar copies; the caller waits with cp.async.wait_all
template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const T* __restrict__ src, int count) {
  constexpr int kV = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = count / kV;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + v * kV));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + v * kV));
    }
    done = nvec * kV;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

// count elements from src (shared memory, 16-byte aligned) to dst (device
// memory) by the whole block, 16-byte stores where dst is aligned
template <typename T>
__device__ __forceinline__ void stage_out(T* __restrict__ dst, const T* src, int count) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nvec = count / kV;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      reinterpret_cast<V*>(dst)[v] = reinterpret_cast<const V*>(src)[v];
    }
    done = nvec * kV;
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

// KB consecutive values of T moved as one vector (KB = 1: a scalar)
template <typename T, int KB>
struct VecOf;
template <typename T>
struct VecOf<T, 1> {
  using type = T;
};
template <>
struct VecOf<float, 2> {
  using type = float2;
};
template <>
struct VecOf<float, 4> {
  using type = float4;
};
template <>
struct VecOf<double, 2> {
  using type = double2;
};

template <typename T, int KB>
struct Cols {
  T v[KB];
};

template <typename T, int KB>
__device__ __forceinline__ Cols<T, KB> load_cols(const T* p) {
  using V = typename VecOf<T, KB>::type;
  const V x = *reinterpret_cast<const V*>(p);
  Cols<T, KB> c;
  memcpy(c.v, &x, sizeof(V));
  return c;
}

template <typename T, int KB>
__device__ __forceinline__ void store_cols(T* p, const T (&v)[KB]) {
  using V = typename VecOf<T, KB>::type;
  V x;
  memcpy(&x, v, sizeof(V));
  *reinterpret_cast<V*>(p) = x;
}

template <typename T, int G, int KB>
__global__ void __launch_bounds__(kSmallThreads)
chol_inv_apply_small_kernel(const T* __restrict__ K, const T* __restrict__ RHS,
                            T* __restrict__ L_out, T* __restrict__ Linv_out,
                            T* __restrict__ Y_out, int N, int n, int r, int M) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = n * n;
  const int nr = n * r;
  const int k_bytes = (M * nn * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const int r_bytes = (M * nr * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Rs = reinterpret_cast<T*>(smem_raw + k_bytes);
  T* Bs = reinterpret_cast<T*>(smem_raw + k_bytes + r_bytes);

  const long long m0 = static_cast<long long>(blockIdx.x) * M;
  const int mb = static_cast<int>(N - m0 < M ? N - m0 : M);
  stage_in(Ks, K + m0 * nn, mb * nn);
  stage_in(Rs, RHS + m0 * nr, mb * nr);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the group's matrix and this lane's row; groups past the batch's end
  // compute on stale shared memory and store nothing
  const int grp = threadIdx.x / G;
  const int i = threadIdx.x % G;
  const bool live = grp < mb && i < n;
  T* Km = Ks + grp * nn;
  T* Rm = Rs + grp * nr;
  T* buf = Bs + grp * 2 * KB * G;  // two rows of the group's broadcasts

  // row i of the symmetric K from its lower triangle, and its diagonal
  // entry apart; the identity's rows and columns past n
  T w[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    T x = c == i ? T(1) : T(0);
    if (c < n && i < n) x = c <= i ? Km[i * n + c] : Km[c * n + i];
    w[c] = x;
  }
  T dg = i < n ? Km[i * n + i] : T(1);
  constexpr int kV = 16 / sizeof(T);

  // factor and inverse eliminated together: lane j scales row j into v
  // and broadcasts it through shared memory; every later row subtracts
  // v[i] v, column j counting as 0
  T d = T(0);
  for (int j = 0; j < n; ++j) {
    T* row = buf + (j & 1) * G;
    if (i == j) {
      const T dinv = rsqrt_of(dg);
      d = dg * dinv;
#pragma unroll
      for (int c = 0; c < G; ++c) w[c] = c == j ? dinv : w[c] * dinv;
#pragma unroll
      for (int c = 0; c < G; c += kV) {
        T part[kV];
#pragma unroll
        for (int q = 0; q < kV; ++q) part[q] = w[c + q];
        store_cols<T, kV>(row + c, part);
      }
    }
    __syncwarp();
    if (i > j) {
      const T vi = row[i];
#pragma unroll
      for (int c = 0; c < G; c += kV) {
        const Cols<T, kV> v = load_cols<T, kV>(row + c);
#pragma unroll
        for (int q = 0; q < kV; ++q) {
          w[c + q] = (c + q == j ? T(0) : w[c + q]) - vi * v.v[q];
        }
      }
      dg -= vi * vi;
    }
  }

  // Linv's row i (c <= i) through K's region to read its column i back;
  // L's column i (c > i, and d) and Linv's column i go straight to device
  // memory, the group's lanes on neighbouring addresses
  __syncwarp();
  if (i < n) {
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (c < n) Km[i * n + c] = c <= i ? w[c] : T(0);
    }
  }
  __syncwarp();
  T u[G];
#pragma unroll
  for (int c = 0; c < G; ++c) u[c] = (c < n && i < n) ? Km[c * n + i] : T(0);
  if (live) {
    T* Lg = L_out + (m0 + grp) * nn;
    T* Lig = Linv_out + (m0 + grp) * nn;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (c < n) {
        Lg[c * n + i] = c > i ? w[c] : (c == i ? d : T(0));
        Lig[c * n + i] = u[c];
      }
    }
  }

  // KB right-hand columns a step: Z[i, k:k+KB] = Linv[i, :] RHS[:, k:k+KB],
  // broadcast through shared memory, then Y[i, k:k+KB] = Linv[:, i] .
  // Z[:, k:k+KB] over RHS[i, k:k+KB], which no lane reads again.  Each
  // group starts at step (group mod steps), so the groups of a warp read
  // different banks.
  const int steps = r / KB;
  int s = steps > 0 ? grp % steps : 0;
  for (int t = 0; t < steps; ++t) {
    const int k = s * KB;
    T z[KB];
#pragma unroll
    for (int q = 0; q < KB; ++q) z[q] = T(0);
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (c < n && c <= i) {
        const Cols<T, KB> x = load_cols<T, KB>(Rm + c * r + k);
#pragma unroll
        for (int q = 0; q < KB; ++q) z[q] += w[c] * x.v[q];
      }
    }
    T* zb = buf + (t & 1) * KB * G;
    store_cols<T, KB>(zb + i * KB, z);
    __syncwarp();
    T y[KB];
#pragma unroll
    for (int q = 0; q < KB; ++q) y[q] = T(0);
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const Cols<T, KB> x = load_cols<T, KB>(zb + c * KB);
#pragma unroll
      for (int q = 0; q < KB; ++q) y[q] += u[c] * x.v[q];
    }
    if (i < n) store_cols<T, KB>(Rm + i * r + k, y);
    s = s + 1 == steps ? 0 : s + 1;
  }
  __syncthreads();
  stage_out(Y_out + m0 * nr, Rs, mb * nr);
}

template <typename T, int G, int KB>
cudaError_t launch_group(const T* K, const T* RHS, T* L, T* Linv, T* Y, int N, int n, int r,
                         cudaStream_t stream) {
  const int threads = small_threads(n, r, sizeof(T));
  const int M = threads / G;
  const int smem = small_smem_bytes(n, r, sizeof(T), M);
  auto kernel = chol_inv_apply_small_kernel<T, G, KB>;
  // raise the instance's shared-memory limit on each device once to the
  // largest asked for, so that a launch captured into a CUDA graph makes no
  // other call
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  const int blocks = static_cast<int>((static_cast<long long>(N) + M - 1) / M);
  kernel<<<blocks, threads, smem, stream>>>(K, RHS, L, Linv, Y, N, n, r, M);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_cols(const T* K, const T* RHS, T* L, T* Linv, T* Y, int N, int n, int r,
                        cudaStream_t stream) {
  const int kb = step_cols(r, sizeof(T));
  if constexpr (sizeof(T) == 4) {
    if (kb == 4) return launch_group<T, G, 4>(K, RHS, L, Linv, Y, N, n, r, stream);
  }
  return kb == 2 ? launch_group<T, G, 2>(K, RHS, L, Linv, Y, N, n, r, stream)
                 : launch_group<T, G, 1>(K, RHS, L, Linv, Y, N, n, r, stream);
}

template <typename T>
int launch(const T* K, const T* RHS, T* L, T* Linv, T* Y, int N, int n, int r, void* stream) {
  if (N < 0 || n < 1 || n > kMaxSmallN || r < 0 || small_threads(n, r, sizeof(T)) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (group_lanes(n)) {
    case 4: err = launch_cols<T, 4>(K, RHS, L, Linv, Y, N, n, r, s); break;
    case 8: err = launch_cols<T, 8>(K, RHS, L, Linv, Y, N, n, r, s); break;
    case 16: err = launch_cols<T, 16>(K, RHS, L, Linv, Y, N, n, r, s); break;
    default: err = launch_cols<T, 32>(K, RHS, L, Linv, Y, N, n, r, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface (bound with ctypes).  K, L and Linv are contiguous
// (N, n, n) device buffers, RHS and Y contiguous (N, n, r) ones; the launch
// goes on `stream` and does not synchronise.  Returns the cudaError_t of the
// shared-memory attribute call or of the launch, 0 on success, and
// cudaErrorInvalidValue for n > 32 or an r whose one-warp block does not fit
// in shared memory.
extern "C" int piqp_chol_inv_apply_small_f32(const float* K, const float* RHS, float* L,
                                             float* Linv, float* Y, int N, int n, int r,
                                             void* stream) {
  return launch<float>(K, RHS, L, Linv, Y, N, n, r, stream);
}

extern "C" int piqp_chol_inv_apply_small_f64(const double* K, const double* RHS, double* L,
                                             double* Linv, double* Y, int N, int n, int r,
                                             void* stream) {
  return launch<double>(K, RHS, L, Linv, Y, N, n, r, stream);
}
