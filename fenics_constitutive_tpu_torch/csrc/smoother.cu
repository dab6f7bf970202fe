// Damped-Jacobi smoothing sweeps of the multigrid levels (structured hex grids).
//
// Replaces the TPU kernel fenics_constitutive_tpu/ops/pallas_smoother.py::
// build_fused_smoother. A level's chain is nu sweeps
//   x <- x + inv_d * (b - A x)
// of the constant-coefficient elastic operator A, optionally followed by the
// free-masked residual r = [inv_d != 0] * (b - A x). A is applied per cell
// origin c with the constant element matrix Ke [24, 24] on the masked corner
// dofs and summed onto the nodes:
//   (A x)[j, n] = sum_{a=0..7} sum_{col} Ke[a*3+j, col] * mask[c] * x[col @ c],
//   c = n - off_a, corners past the end of the grid reading 0.
//
// Design. The TPU kept a level's whole iterate in VMEM (~1.7 MB at 50^3) and
// ran every sweep of a chain in one kernel. An H100 block has at most 227 KB
// of shared memory, so a sweep needs a grid-wide barrier before the next one:
// this file takes ONE LAUNCH PER SWEEP, with two ping-pong buffers that the
// wrapper allocates with torch.empty (a cooperative launch with a grid sync is
// the alternative, left for a later change). Each thread owns one node and
// GATHERS (A x) at its 3 dofs from its up-to-8 cells in the fixed order
// a = 0..7, so there are no atomics and two launches are bit-equal. Ke sits in
// shared memory. A zero-start chain pays no launch for its first sweep: the
// next launch reads x1 = inv_d * b at the neighbours on the fly.
//
// What bounds it on the H100: operations. One apply is 24 x 24 multiply-adds
// per valid cell (~144 MFLOP at 50^3), against ~13 values per node read or
// written once per chain (~7 MB in float32): the chain is bound by arithmetic,
// at 67 TFLOP/s (float32) or 34 TFLOP/s (float64) outside the tensor cores.
// This first version re-reads each cell's 24 corner values from L1/L2 for
// each of the 8 nodes that touch it and runs on the CUDA cores; the tensor
// cores (DMMA, wgmma) are later work.
#include "common.cuh"

namespace {

using fct::kCorner;
using fct::kNodes;
using fct::kThreads;
using fct::kVs;

constexpr int kKe = kCorner * kCorner;  // 576 entries of Ke

// x at dof (j, node idx): the iterate, or x1 = inv_d * b on the fly
template <typename T, bool kFromB>
__device__ __forceinline__ T x_at(const T* __restrict__ x, const T* __restrict__ b,
                                  const T* __restrict__ invd, int i) {
  if constexpr (kFromB) {
    return invd[i] * b[i];
  } else {
    return x[i];
  }
}

// kResidual = false: xout = x + inv_d * (b - A x)
// kResidual = true:  rout = [inv_d != 0] * (b - A x); with kFromB also xout = x
template <typename T, bool kFromB, bool kResidual>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ x, const T* __restrict__ b,
             const T* __restrict__ invd, const T* __restrict__ ke,
             const T* __restrict__ mask, T* __restrict__ xout, T* __restrict__ rout,
             int M, int s0, int s1) {
  __shared__ T sk[kKe];
  for (int i = threadIdx.x; i < kKe; i += blockDim.x) sk[i] = ke[i];
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= M) return;

  T acc[kVs] = {T(0), T(0), T(0)};
  // one cell at a time: the 24 corner values stay in registers
#pragma unroll 1
  for (int a = 0; a < kNodes; ++a) {
    const int c = n - ((a & 1) * s0 + ((a >> 1) & 1) * s1 + ((a >> 2) & 1));
    if (c < 0) continue;
    const T m = mask[c];
    if (m == T(0)) continue;
    T U[kCorner];
#pragma unroll
    for (int bb = 0; bb < kNodes; ++bb) {
      const int idx = c + (bb & 1) * s0 + ((bb >> 1) & 1) * s1 + ((bb >> 2) & 1);
#pragma unroll
      for (int k = 0; k < kVs; ++k) {
        U[bb * kVs + k] = idx < M ? x_at<T, kFromB>(x, b, invd, k * M + idx) * m : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < kVs; ++j) {
      const T* row = sk + (a * kVs + j) * kCorner;
      T s = T(0);
#pragma unroll
      for (int col = 0; col < kCorner; ++col) s += row[col] * U[col];
      acc[j] += s;
    }
  }

#pragma unroll
  for (int j = 0; j < kVs; ++j) {
    const int i = j * M + n;
    const T d = invd[i];
    const T rj = b[i] - acc[j];
    if constexpr (kResidual) {
      rout[i] = d != T(0) ? rj : T(0);
      if constexpr (kFromB) xout[i] = d * b[i];
    } else {
      xout[i] = x_at<T, kFromB>(x, b, invd, i) + d * rj;
    }
  }
}

template <typename T>
int launch(const void* x, const void* b, const void* invd, const void* ke,
           const void* mask, void* xout, void* rout, int from_b, int residual, int M,
           int s0, int s1, void* stream) {
  const dim3 grid(fct::num_blocks(M));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* bp = static_cast<const T*>(b);
  const auto* dp = static_cast<const T*>(invd);
  const auto* kp = static_cast<const T*>(ke);
  const auto* mp = static_cast<const T*>(mask);
  auto* xo = static_cast<T*>(xout);
  auto* ro = static_cast<T*>(rout);
  if (from_b && residual) {
    sweep_kernel<T, true, true><<<grid, kThreads, 0, st>>>(xp, bp, dp, kp, mp, xo, ro, M, s0, s1);
  } else if (from_b) {
    sweep_kernel<T, true, false><<<grid, kThreads, 0, st>>>(xp, bp, dp, kp, mp, xo, ro, M, s0, s1);
  } else if (residual) {
    sweep_kernel<T, false, true><<<grid, kThreads, 0, st>>>(xp, bp, dp, kp, mp, xo, ro, M, s0, s1);
  } else {
    sweep_kernel<T, false, false><<<grid, kThreads, 0, st>>>(xp, bp, dp, kp, mp, xo, ro, M, s0, s1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t.
// x, b, inv_d, xout, rout are grid-major [3, M]; ke is [24, 24] row-major;
// mask is [M]. ``from_b`` reads x as inv_d * b (x unused); ``residual``
// writes rout (and, with from_b, xout = inv_d * b) instead of a sweep into
// xout. xout must not alias x. Returns cudaGetLastError() after the launch.
extern "C" int fct_smooth_f32(const void* x, const void* b, const void* invd,
                              const void* ke, const void* mask, void* xout, void* rout,
                              int from_b, int residual, int M, int s0, int s1,
                              void* stream) {
  return launch<float>(x, b, invd, ke, mask, xout, rout, from_b, residual, M, s0, s1,
                       stream);
}

extern "C" int fct_smooth_f64(const void* x, const void* b, const void* invd,
                              const void* ke, const void* mask, void* xout, void* rout,
                              int from_b, int residual, int M, int s0, int s1,
                              void* stream) {
  return launch<double>(x, b, invd, ke, mask, xout, rout, from_b, residual, M, s0, s1,
                        stream);
}
