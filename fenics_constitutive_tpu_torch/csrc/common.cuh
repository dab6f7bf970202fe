// Shared pieces of the structured-hex kernels (matvec.cu, eval.cu).
//
// Layouts (all fields row-major, the flat node axis M innermost):
//   dof vector u          [3, M]      grid-major, u[j*M + n]
//   QP field of k comps   [k, 8, M]   f[(s*8 + q)*M + n]
//   per-corner forces F   [24, M]     F[(a*3 + j)*M + n]
//   KEPS_c                [48, 24]    row s*8+q, column a*3+j
//   KDIV_c                [24, 48]    row a*3+j, column s*8+q (weights folded)
// One thread owns one cell origin n; corner a = dx + 2 dy + 4 dz sits at the
// flat node n + dx*s0 + dy*s1 + dz, with s0 = (Y+1)(Z+1) and s1 = Z+1.
#pragma once

#include <cuda_runtime.h>

namespace fct {

constexpr int kThreads = 128;  // threads per block
constexpr int kVs = 3;         // displacement components
constexpr int kNodes = 8;      // hex corners
constexpr int kCorner = kNodes * kVs;  // 24 corner dof channels
constexpr int kQ = 8;          // 2x2x2 Gauss points
constexpr int kS = 6;          // Mandel components
constexpr int kCh = kS * kQ;   // 48 strain/stress channels
constexpr int kMat = kCh * kCorner;  // entries of KEPS_c (and of KDIV_c)

inline int num_blocks(int M) { return (M + kThreads - 1) / kThreads; }

// precise (IEEE-rounded or libdevice) math in the working type; no fast math
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return ::exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return ::fabs(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return ::fmax(a, b); }

// Copy KEPS_c and KDIV_c into this block's shared memory. Each launch passes
// its own geometry's matrices, so two geometries in one process never share
// them (unlike __constant__ memory, which is global to the module).
template <typename T>
__device__ __forceinline__ void load_matrices(const T* __restrict__ keps,
                                              const T* __restrict__ kdiv,
                                              T* sk, T* sd) {
  for (int i = threadIdx.x; i < kMat; i += blockDim.x) {
    sk[i] = keps[i];
    sd[i] = kdiv[i];
  }
  __syncthreads();
}

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

// Mandel strain at Gauss point q: e[s] = (KEPS_c[s*8+q, :] . U) * m.
template <typename T>
__device__ __forceinline__ void strain_at(const T* sk, const T (&U)[kCorner], int q,
                                          T m, T (&e)[kS]) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const T* row = sk + (s * kQ + q) * kCorner;
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < kCorner; ++c) acc += row[c] * U[c];
    e[s] = acc * m;
  }
}

// F[c] += sum_s KDIV_c[c, s*8+q] * sig[s]
template <typename T>
__device__ __forceinline__ void add_forces(const T* sd, const T (&sig)[kS], int q,
                                           T (&Fa)[kCorner]) {
#pragma unroll
  for (int c = 0; c < kCorner; ++c) {
    const T* row = sd + c * kCh + q;
    T acc = Fa[c];
#pragma unroll
    for (int s = 0; s < kS; ++s) acc += row[s * kQ] * sig[s];
    Fa[c] = acc;
  }
}

}  // namespace fct

// cudaError_t name of a code returned by an entry point
extern "C" const char* fct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
