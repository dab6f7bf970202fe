// Shared pieces of the kernels: the structured-hex cell arithmetic
// (matvec.cu, eval.cu) and the shared-memory opt-in (and smoother.cu).
//
// Layouts (all fields row-major, the flat node axis M innermost):
//   dof vector u          [3, M]      grid-major, u[j*M + n]
//   QP field of k comps   [k, 8, M]   f[(s*8 + q)*M + n]
//   gradient table dN     [8, 8, 3]   dN[(q*8 + a)*3 + i], one for every cell
// A cell sits at its origin node n; corner a = dx + 2 dy + 4 dz sits at the
// flat node n + dx*s0 + dy*s1 + dz, with s0 = (Y+1)(Z+1) and s1 = Z+1.
#pragma once

#include <cuda_runtime.h>

namespace fct {

constexpr int kThreads = 128;  // threads per block of the window kernels
constexpr int kVs = 3;         // displacement components
constexpr int kNodes = 8;      // hex corners
constexpr int kCorner = kNodes * kVs;  // 24 corner dof channels
constexpr int kQ = 8;          // 2x2x2 Gauss points
constexpr int kS = 6;          // Mandel components
constexpr int kTab = kQ * kNodes * 3;  // entries of the gradient table
constexpr int kMaxDevices = 64;  // devices a process may launch on

// precise (IEEE-rounded or libdevice) math in the working type; no fast math
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return ::exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return ::fabs(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return ::fmax(a, b); }

// The 24 corner dofs of the cell at origin n; nodes past the end read as 0
// (the right zero-padding of the plain version's corner gather).
template <typename T>
__device__ __forceinline__ void load_corners(const T* __restrict__ u, int n, int M,
                                             int s0, int s1, T (&U)[kCorner]) {
#pragma unroll
  for (int a = 0; a < kNodes; ++a) {
    const int idx = n + (a & 1) * s0 + ((a >> 1) & 1) * s1 + ((a >> 2) & 1);
#pragma unroll
    for (int j = 0; j < kVs; ++j) {
      U[a * kVs + j] = idx < M ? u[j * M + idx] : T(0);
    }
  }
}

// Mandel strain of the FULL constraint at one Gauss point, masked by m, from
// its gradient table d = dN[q] ([a][i], in shared memory):
//   H[i][j] = sum_a d[a][i] U[a][j],  e = (H00, H11, H22, c (H01 + H10),
//   c (H02 + H20), c (H12 + H21)) * m,   c = 1/sqrt(2).
// This is KEPS_c @ U summed in another order: 72 multiply-adds, not 144.
template <typename T>
__device__ __forceinline__ void strain_at(const T* d, const T (&U)[kCorner], T c, T m,
                                          T (&e)[kS]) {
  T H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = T(0);
  }
#pragma unroll
  for (int a = 0; a < kNodes; ++a) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i][j] += d[a * 3 + i] * U[a * kVs + j];
    }
  }
  e[0] = H[0][0] * m;
  e[1] = H[1][1] * m;
  e[2] = H[2][2] * m;
  e[3] = c * (H[0][1] + H[1][0]) * m;
  e[4] = c * (H[0][2] + H[2][0]) * m;
  e[5] = c * (H[1][2] + H[2][1]) * m;
}

// The divergence of one Gauss point's (masked) stress into the corner
// forces: with T = w Mandel^T(sig) (symmetric), Fa[a][j] += sum_i d[a][i]
// T[i][j]. This is KDIV_c @ sig summed in another order: 72 multiply-adds.
template <typename T>
__device__ __forceinline__ void add_divergence(const T* d, T w, T c, const T (&sig)[kS],
                                               T (&Fa)[kCorner]) {
  const T wc = w * c;
  const T Tm[3][3] = {{w * sig[0], wc * sig[3], wc * sig[4]},
                      {wc * sig[3], w * sig[1], wc * sig[5]},
                      {wc * sig[4], wc * sig[5], w * sig[2]}};
#pragma unroll
  for (int a = 0; a < kNodes; ++a) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = Fa[a * kVs + j];
#pragma unroll
      for (int i = 0; i < 3; ++i) acc += d[a * 3 + i] * Tm[i][j];
      Fa[a * kVs + j] = acc;
    }
  }
}

// Copy the gradient table [q][a][i] and the weights [q] into this block's
// shared memory. Each launch passes its own geometry's tables, so two
// geometries in one process never share them.
template <typename T>
__device__ __forceinline__ void load_tables(const T* __restrict__ dn, const T* __restrict__ w,
                                            T* dq, T* wq) {
  for (int i = threadIdx.x; i < kTab; i += blockDim.x) dq[i] = dn[i];
  for (int i = threadIdx.x; i < kQ; i += blockDim.x) wq[i] = w[i];
  __syncthreads();
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after opting in). The attribute belongs to the current device, so
// `opted` (one array per kernel) keeps the size set on each device.
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t bytes, size_t (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) opted[dev] = bytes;
  return e;
}

}  // namespace fct

// cudaError_t name of a code returned by an entry point
extern "C" const char* fct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
