// Fused CG operator apply of the structured hex engine (P1, 2x2x2 Gauss).
//
// Replaces the TPU kernel fenics_constitutive_tpu/ops/pallas_matvec.py::
// build_pallas_matvec. Per cell origin c it computes, in registers:
//   U = the 24 corner dofs of u (the corner gather, fused here);
//   e = KEPS_c @ U, masked;  sig = (kappa - beta/3) tr(e) I + beta e
//   + gamma (n . e) n, masked;  F = KDIV_c @ sig   (24 per-corner forces),
// and then the node sums r[j, n] = sum_{a=0..7} F[(a,j), n - off_a], taken in
// the order a = 0..7 of the plain version's shifted adds: the kernel writes
// r [3, M], and no [24, M] intermediate reaches device memory.
//
// Design. Each block owns a brick of B0 x B1 x B2 nodes (z fastest; the
// wrapper picks the brick: 4 x 8 x 17 at 51^3, where 1.44x the grid's cells
// are computed, 2 blocks per SM in float32). It computes the corner forces
// of the (B0+1)(B1+1)(B2+1) cells that touch the brick (its own cells and the
// low-side halo layer, which the neighbouring block computes as well) and
// keeps them in shared memory, [24][cells]; then each node's thread sums its
// 8 cells' contributions in the fixed order. No atomics: two launches are
// bit-equal. The products with KEPS_c and KDIV_c use their structure on the
// hex: with the physical gradients dN[a, i, q] of the 8 corners at Gauss
// point q (one table for every cell of the uniform grid) and the Mandel map
// of the FULL constraint,
//   H[i][j] = sum_a dN[a,i,q] U[a,j],  e = Mandel(sym H),
//   T = w_q Mandel^T(sig),             F[a,j] += sum_i dN[a,i,q] T[i][j],
// which is KEPS_c @ U and KDIV_c @ sig summed in another order: 150 instead
// of 288 multiply-adds per Gauss point, and 24 table values (read as
// broadcasts from shared memory) instead of 288 matrix entries. One Gauss
// point at a time (#pragma unroll 1): unrolling that loop spilled the float32
// build of the first version at 255 registers and ran 1.5x slower.
//
// What bounds it on the H100: bytes. One apply reads u (3 M values, the
// corners of neighbouring cells overlap in L1/L2), the tangent fields beta,
// gamma [8, M] and n [48, M] and the mask, and writes r [3, M]: about 71 M
// values, against about 1300 multiply-adds per cell (x the halo's
// recompute). Every field is read with neighbouring threads on neighbouring
// addresses (M innermost). A uniform tangent (scalar beta and gamma, one n)
// reads no tangent field. kappa and a uniform tangent's beta and gamma come
// from device memory (3 values of the working type): a coefficient that
// follows dt (an SLS law's) is read at each replay of a captured step, with
// the rounding of the eager step.
#include "common.cuh"

namespace {

using namespace fct;

constexpr int kThreadsMv = 256;

// the 24 corner forces of the valid cell at origin n (mask m != 0); dq is
// the gradient table [q][a][i] and wq the weights [q], in shared memory
template <typename T>
__device__ __forceinline__ void cell_forces(const T* __restrict__ u, const T* __restrict__ beta,
                                            const T* __restrict__ gamma,
                                            const T* __restrict__ nfield, const T* dq,
                                            const T* wq, T kappa, T beta_u, T gamma_u,
                                            int uniform, T c, int n, int M, int s0, int s1, T m,
                                            T (&Fa)[kCorner]) {
  T U[kCorner];
  load_corners(u, n, M, s0, s1, U);
  // one Gauss point at a time (see the note at the top)
#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    const T* d = dq + q * kNodes * 3;
    T e[kS];
    strain_at(d, U, c, m, e);

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
    add_divergence(d, wq[q], c, sig, Fa);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsMv)
matvec_kernel(const T* __restrict__ u, const T* __restrict__ beta,
              const T* __restrict__ gamma, const T* __restrict__ nfield,
              const T* __restrict__ mask, const T* __restrict__ dn, const T* __restrict__ w,
              T* __restrict__ r, const T* __restrict__ coef, T c, int uniform, int n0,
              int n1, int n2, int b0, int b1, int b2) {
  const T kappa = coef[0], beta_u = coef[1], gamma_u = coef[2];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dq = reinterpret_cast<T*>(smem_raw);
  T* wq = dq + kTab;
  T* Fs = wq + kQ;  // [24][cells]
  load_tables(dn, w, dq, wq);

  const int M = n0 * n1 * n2, s1 = n2, s0 = n1 * n2;
  const int h1n = b1 + 1, h2n = b2 + 1, cells = (b0 + 1) * h1n * h2n;
  const int o0 = blockIdx.z * b0, o1 = blockIdx.y * b1, o2 = blockIdx.x * b2;

  // the corner forces of every cell that touches the brick (origin o - 1 + h)
  for (int lc = threadIdx.x; lc < cells; lc += blockDim.x) {
    const int h0 = lc / (h1n * h2n), rem = lc - h0 * (h1n * h2n);
    const int h1 = rem / h2n, h2 = rem - h1 * h2n;
    const int g0 = o0 + h0 - 1, g1 = o1 + h1 - 1, g2 = o2 + h2 - 1;
    T Fa[kCorner];
#pragma unroll
    for (int k = 0; k < kCorner; ++k) Fa[k] = T(0);
    if (g0 >= 0 && g1 >= 0 && g2 >= 0 && g0 < n0 && g1 < n1 && g2 < n2) {
      const int n = g0 * s0 + g1 * s1 + g2;
      const T m = mask[n];
      if (m != T(0)) {
        cell_forces(u, beta, gamma, nfield, dq, wq, kappa, beta_u, gamma_u, uniform, c, n, M,
                    s0, s1, m, Fa);
      }
    }
#pragma unroll
    for (int k = 0; k < kCorner; ++k) Fs[k * cells + lc] = Fa[k];
  }
  __syncthreads();

  // each node sums its 8 cells' forces in the order a = 0..7
  for (int ln = threadIdx.x; ln < b0 * b1 * b2; ln += blockDim.x) {
    const int l0 = ln / (b1 * b2), rem = ln - l0 * (b1 * b2);
    const int l1 = rem / b2, l2 = rem - l1 * b2;
    const int g0 = o0 + l0, g1 = o1 + l1, g2 = o2 + l2;
    if (g0 >= n0 || g1 >= n1 || g2 >= n2) continue;
    const int n = g0 * s0 + g1 * s1 + g2;
#pragma unroll
    for (int j = 0; j < kVs; ++j) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < kNodes; ++a) {
        const int h = ((l0 + 1 - (a & 1)) * h1n + (l1 + 1 - ((a >> 1) & 1))) * h2n
                      + (l2 + 1 - ((a >> 2) & 1));
        acc += Fs[(a * kVs + j) * cells + h];
      }
      r[j * M + n] = acc;
    }
  }
}

template <typename T>
size_t smem_bytes(int b0, int b1, int b2) {
  const size_t cells = static_cast<size_t>(b0 + 1) * (b1 + 1) * (b2 + 1);
  return (kTab + kQ + kCorner * cells) * sizeof(T);
}

template <typename T>
int launch(const void* u, const void* beta, const void* gamma, const void* nfield,
           const void* mask, const void* dn, const void* w, void* r, const void* coef,
           double c, int uniform, int n0, int n1, int n2, int b0, int b1, int b2,
           void* stream) {
  // above 48 KB only as opted-in dynamic shared memory, once per device
  const size_t bytes = smem_bytes<T>(b0, b1, b2);
  static size_t opted[kMaxDevices] = {};
  const cudaError_t e = opt_in_smem(matvec_kernel<T>, bytes, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n2 + b2 - 1) / b2, (n1 + b1 - 1) / b1, (n0 + b0 - 1) / b0);
  matvec_kernel<T><<<grid, kThreadsMv, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(beta), static_cast<const T*>(gamma),
      static_cast<const T*>(nfield), static_cast<const T*>(mask), static_cast<const T*>(dn),
      static_cast<const T*>(w), static_cast<T*>(r), static_cast<const T*>(coef),
      static_cast<T>(c), uniform, n0, n1, n2, b0, b1, b2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t.
// u and r are grid-major [3, M] on the node grid n0 x n1 x n2 (M = n0 n1 n2,
// z fastest). ``beta``/``gamma`` are [8, M] fields and ``nfield`` is
// [6, 8, M] unless ``uniform`` is set: then ``coef[1]``/``coef[2]`` are the
// tangent's beta and gamma and ``nfield`` holds 6 values. ``coef`` holds 3
// values of the working type on the device: kappa, beta, gamma. ``dn`` is
// the gradient table [8 q][8 a][3 i] of the cells, ``w`` the 8 quadrature
// weights, ``c`` the Mandel shear
// factor 1/sqrt(2); b0 x b1 x b2 is the brick of nodes of one block. Returns
// cudaGetLastError() after the launch.
extern "C" int fct_matvec_f32(const void* u, const void* beta, const void* gamma,
                              const void* nfield, const void* mask, const void* dn,
                              const void* w, void* r, const void* coef, double c, int uniform,
                              int n0, int n1, int n2, int b0, int b1, int b2, void* stream) {
  return launch<float>(u, beta, gamma, nfield, mask, dn, w, r, coef, c, uniform, n0, n1, n2,
                       b0, b1, b2, stream);
}

extern "C" int fct_matvec_f64(const void* u, const void* beta, const void* gamma,
                              const void* nfield, const void* mask, const void* dn,
                              const void* w, void* r, const void* coef, double c, int uniform,
                              int n0, int n1, int n2, int b0, int b1, int b2, void* stream) {
  return launch<double>(u, beta, gamma, nfield, mask, dn, w, r, coef, c, uniform, n0, n1, n2,
                        b0, b1, b2, stream);
}
