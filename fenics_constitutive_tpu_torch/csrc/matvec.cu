// Fused CG operator apply of the structured hex engine (P1, 2x2x2 Gauss).
//
// Replaces the TPU kernel fenics_constitutive_tpu/ops/pallas_matvec.py::
// build_pallas_matvec. Per cell origin n it computes, in registers:
//   U = the 24 corner dofs of u (the corner gather, fused here);
//   e = KEPS_c @ U, masked;  sig = (kappa - beta/3) tr(e) I + beta e
//   + gamma (n . e) n, masked;  F = KDIV_c @ sig   (24 per-corner forces).
// The corner scatter r[j, n] = sum_a F[(a,j), n - off_a] is left to the
// caller's deterministic shifted adds (no float atomics).
//
// What bounds it on the H100: bytes. One apply reads u (3 M values, mostly
// from L2 since the 8 corners of neighbouring threads overlap), the tangent
// fields beta, gamma [8, M] and n [48, M] and the mask, and writes F [24, M]:
// about 92 M values, against about 2300 multiply-adds per cell. The design
// keeps the [48, M] strain and stress channel fields (which the plain path
// writes and reads back) entirely in registers, reads every field with
// neighbouring threads on neighbouring addresses (M innermost), and serves
// KEPS_c/KDIV_c to all threads of a block from shared memory as broadcasts.
// A uniform tangent (scalar beta and gamma, one n) reads no tangent field.
#include "common.cuh"

namespace {

using namespace fct;

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ u, const T* __restrict__ beta,
              const T* __restrict__ gamma, const T* __restrict__ nfield,
              const T* __restrict__ mask, const T* __restrict__ keps,
              const T* __restrict__ kdiv, T* __restrict__ F, T kappa, T beta_u,
              T gamma_u, int uniform, int M, int s0, int s1) {
  __shared__ T sk[kMat];
  __shared__ T sd[kMat];
  load_matrices(keps, kdiv, sk, sd);

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= M) return;

  T U[kCorner];
  load_corners(u, n, M, s0, s1, U);
  const T m = mask[n];

  T Fa[kCorner];
#pragma unroll
  for (int c = 0; c < kCorner; ++c) Fa[c] = T(0);

  // one Gauss point at a time: unrolling this loop as well spilled the
  // float32 build (255 registers) and ran 1.5x slower on the H100
#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    T e[kS];
    strain_at(sk, U, q, m, e);

    T b, g, nq[kS];
    if (uniform) {
      b = beta_u;
      g = gamma_u;
#pragma unroll
      for (int s = 0; s < kS; ++s) nq[s] = nfield[s];
    } else {
      b = beta[q * M + n];
      g = gamma[q * M + n];
#pragma unroll
      for (int s = 0; s < kS; ++s) nq[s] = nfield[(s * kQ + q) * M + n];
    }

    const T tr = e[0] + e[1] + e[2];
    T ndote = nq[0] * e[0];
#pragma unroll
    for (int s = 1; s < kS; ++s) ndote += nq[s] * e[s];
    const T gn = g * ndote;
    const T corr = (kappa - b / T(3)) * tr;

    T sig[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      T v = b * e[s] + gn * nq[s];
      if (s < 3) v += corr;
      sig[s] = v * m;
    }
    add_forces(sd, sig, q, Fa);
  }

#pragma unroll
  for (int c = 0; c < kCorner; ++c) F[c * M + n] = Fa[c];
}

template <typename T>
int launch(const void* u, const void* beta, const void* gamma, const void* nfield,
           const void* mask, const void* keps, const void* kdiv, void* F,
           double kappa, double beta_u, double gamma_u, int uniform, int M, int s0,
           int s1, void* stream) {
  matvec_kernel<T><<<num_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(beta),
      static_cast<const T*>(gamma), static_cast<const T*>(nfield),
      static_cast<const T*>(mask), static_cast<const T*>(keps),
      static_cast<const T*>(kdiv), static_cast<T*>(F), static_cast<T>(kappa),
      static_cast<T>(beta_u), static_cast<T>(gamma_u), uniform, M, s0, s1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t.
// ``beta``/``gamma`` are [8, M] fields and ``nfield`` is [6, 8, M] unless
// ``uniform`` is set: then ``beta_u``/``gamma_u`` are used and ``nfield``
// holds 6 values. Returns cudaGetLastError() after the launch.
extern "C" int fct_matvec_f32(const void* u, const void* beta, const void* gamma,
                              const void* nfield, const void* mask, const void* keps,
                              const void* kdiv, void* F, double kappa, double beta_u,
                              double gamma_u, int uniform, int M, int s0, int s1,
                              void* stream) {
  return launch<float>(u, beta, gamma, nfield, mask, keps, kdiv, F, kappa, beta_u,
                       gamma_u, uniform, M, s0, s1, stream);
}

extern "C" int fct_matvec_f64(const void* u, const void* beta, const void* gamma,
                              const void* nfield, const void* mask, const void* keps,
                              const void* kdiv, void* F, double kappa, double beta_u,
                              double gamma_u, int uniform, int M, int s0, int s1,
                              void* stream) {
  return launch<double>(u, beta, gamma, nfield, mask, keps, kdiv, F, kappa, beta_u,
                        gamma_u, uniform, M, s0, s1, stream);
}
