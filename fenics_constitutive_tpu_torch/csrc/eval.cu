// Fused constitutive eval + element assembly of the structured hex engine:
// strain -> VonMises3D radial return (exponential hardening) -> weighted
// divergence, for P1 hexes with 2x2x2 Gauss points and the FULL constraint.
//
// Replaces the TPU kernel fenics_constitutive_tpu/ops/pallas_eval.py::
// build_pallas_eval. Per cell origin n, one thread loads the 24 corner dofs
// of the displacement increment (the corner gather, fused here) and, for each
// Gauss point, forms the masked strain e = KEPS_c @ U, runs the radial return
// and accumulates F += KDIV_c @ (sigma' * mask) into 24 per-corner forces. It
// writes sigma', eps_p', alpha', the tangent fields beta, gamma, n and F. The
// corner scatter is left to the caller's deterministic shifted adds.
//
// The local Newton: the TPU ran a fixed trip count with a per-lane active
// mask because its lanes are SIMD; here a thread whose point has converged
// leaves the loop. A converged point never changes again, so the result is
// the same; trip cap and tolerances are those of models/packed_models.py.
//
// What bounds it on the H100: bytes. It reads the old stress and plastic
// strain ([48, M] each), alpha [8, M], the increment [3, M] and the mask, and
// writes F [24, M], sigma', eps_p', n ([48, M] each) and alpha', beta,
// gamma ([8, M] each): about 300 M values per call. The strain channels never
// reach device memory, every access is coalesced (M innermost), and the
// element matrices are shared-memory broadcasts. Points that stay elastic
// skip the Newton entirely; plastic ones take a handful of exp-bound trips.
#include "common.cuh"

namespace {

using namespace fct;

constexpr double kSq23 = 0.816496580927726;  // sqrt(2/3)

// Model constants, folded on the host in double exactly as the plain
// PyTorch version folds its Python-float scalars.
template <typename T>
struct Consts {
  T ka, two_mu, neg_two_mu, y0, dy, neg_w, dfk, four_mu2;
  T tol, rtol, eight_eps;
  int max_it;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
eval_kernel(const T* __restrict__ du, const T* __restrict__ sig,
            const T* __restrict__ epsn, const T* __restrict__ alpha,
            const T* __restrict__ mask, const T* __restrict__ keps,
            const T* __restrict__ kdiv, T* __restrict__ F, T* __restrict__ sig_out,
            T* __restrict__ epsn_out, T* __restrict__ alpha_out,
            T* __restrict__ beta_out, T* __restrict__ gamma_out,
            T* __restrict__ n_out, Consts<T> p, int M, int s0, int s1) {
  __shared__ T sk[kMat];
  __shared__ T sd[kMat];
  load_matrices(keps, kdiv, sk, sd);

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= M) return;

  T U[kCorner];
  load_corners(du, n, M, s0, s1, U);
  const T m = mask[n];
  const T sq23 = T(kSq23);

  T Fa[kCorner];
#pragma unroll
  for (int c = 0; c < kCorner; ++c) Fa[c] = T(0);

#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    T e[kS];
    strain_at(sk, U, q, m, e);

    T sq[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) sq[s] = sig[(s * kQ + q) * M + n];
    const T al = alpha[q * M + n];

    // deviatoric split of the strain increment and the old stress
    const T tr_e = e[0] + e[1] + e[2];
    const T tr_s = sq[0] + sq[1] + sq[2];
    T ed[kS], sigtr[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      ed[s] = s < 3 ? e[s] - tr_e / T(3) : e[s];
      const T sd_s = s < 3 ? sq[s] - tr_s / T(3) : sq[s];
      sigtr[s] = sd_s + p.two_mu * ed[s];
    }
    T n2 = sigtr[0] * sigtr[0];
#pragma unroll
    for (int s = 1; s < kS; ++s) n2 += sigtr[s] * sigtr[s];
    const T sigtrn = dsqrt(n2);

    const T phitr = sigtrn - sq23 * (p.y0 + p.dy * (T(1) - dexp(p.neg_w * al)));
    const bool plastic = phitr > T(0);
    const T safe = sigtrn > T(0) ? sigtrn : T(1);
    const T tol_abs = dmax(p.eight_eps * (p.y0 + sigtrn), p.tol);

    // radial-return Newton on the plastic multiplier
    T g = T(0);
    bool act = plastic && (T(1) > tol_abs);
    for (int it = 0; it <= p.max_it && act; ++it) {
      const T g0 = g;
      const T ex = dexp(p.neg_w * (al + sq23 * g0));
      const T fx = sigtrn - p.two_mu * g0 - sq23 * (p.y0 + p.dy * (T(1) - ex));
      const T dfx = p.neg_two_mu - p.dfk * ex;
      g = g0 - fx / dfx;
      act = (dabs(fx) > tol_abs) && (dabs(g - g0) > p.rtol * dabs(g));
    }
    const T gam = plastic ? g : T(0);

    const T exg = dexp(p.neg_w * (al + sq23 * gam));
    const T xg = p.neg_two_mu - p.dfk * exg;
    const T xc1 = plastic ? T(-1) / xg : T(0);
    const T xc2 = plastic ? gam / safe : T(0);
    const T two_mu_g = p.two_mu * gam;

    T sig_m[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int o = (s * kQ + q) * M + n;
      const T xn = plastic ? sigtr[s] / safe : T(0);
      T s_new = s < 3 ? sq[s] + p.ka * tr_e : sq[s];
      s_new = s_new + p.two_mu * ed[s] - two_mu_g * xn;
      sig_out[o] = s_new;
      epsn_out[o] = epsn[o] + gam * xn;
      n_out[o] = xn;
      sig_m[s] = s_new * m;
    }
    alpha_out[q * M + n] = al + sq23 * gam;
    beta_out[q * M + n] = p.two_mu * (T(1) - p.two_mu * xc2);
    gamma_out[q * M + n] = p.four_mu2 * (xc2 - xc1);

    add_forces(sd, sig_m, q, Fa);
  }

#pragma unroll
  for (int c = 0; c < kCorner; ++c) F[c * M + n] = Fa[c];
}

template <typename T>
int launch(const void* du, const void* sig, const void* epsn, const void* alpha,
           const void* mask, const void* keps, const void* kdiv, void* F,
           void* sig_out, void* epsn_out, void* alpha_out, void* beta_out,
           void* gamma_out, void* n_out, double ka, double mu, double y0, double y00,
           double w, double tol, double rtol, int max_it, double eps, int M, int s0,
           int s1, void* stream) {
  Consts<T> p;
  p.ka = static_cast<T>(ka);
  p.two_mu = static_cast<T>(2.0 * mu);
  p.neg_two_mu = static_cast<T>(-2.0 * mu);
  p.y0 = static_cast<T>(y0);
  p.dy = static_cast<T>(y00 - y0);
  p.neg_w = static_cast<T>(-w);
  p.dfk = static_cast<T>((2.0 / 3.0) * (y00 - y0) * w);
  p.four_mu2 = static_cast<T>(4.0 * mu * mu);
  p.tol = static_cast<T>(tol);
  p.rtol = static_cast<T>(rtol);
  p.eight_eps = static_cast<T>(8.0 * eps);
  p.max_it = max_it;
  eval_kernel<T><<<num_blocks(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(du), static_cast<const T*>(sig),
      static_cast<const T*>(epsn), static_cast<const T*>(alpha),
      static_cast<const T*>(mask), static_cast<const T*>(keps),
      static_cast<const T*>(kdiv), static_cast<T*>(F), static_cast<T*>(sig_out),
      static_cast<T*>(epsn_out), static_cast<T*>(alpha_out),
      static_cast<T*>(beta_out), static_cast<T*>(gamma_out),
      static_cast<T*>(n_out), p, M, s0, s1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t.
// Inputs du [3, M], sig/epsn [6, 8, M], alpha [8, M], mask [M]; outputs F
// [24, M], sig_out/epsn_out/n_out [6, 8, M], alpha_out/beta_out/gamma_out
// [8, M]. (ka, mu, y0, y00, w) are the model parameters; tol/rtol/max_it the
// local Newton controls; eps the working type's machine epsilon. Returns
// cudaGetLastError() after the launch.
#define FCT_EVAL_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* du, const void* sig, const void* epsn,           \
                      const void* alpha, const void* mask, const void* keps,       \
                      const void* kdiv, void* F, void* sig_out, void* epsn_out,    \
                      void* alpha_out, void* beta_out, void* gamma_out,            \
                      void* n_out, double ka, double mu, double y0, double y00,    \
                      double w, double tol, double rtol, int max_it, double eps,   \
                      int M, int s0, int s1, void* stream) {                       \
    return launch<T>(du, sig, epsn, alpha, mask, keps, kdiv, F, sig_out, epsn_out, \
                     alpha_out, beta_out, gamma_out, n_out, ka, mu, y0, y00, w,    \
                     tol, rtol, max_it, eps, M, s0, s1, stream);                   \
  }

FCT_EVAL_ENTRY(fct_eval_f32, float)
FCT_EVAL_ENTRY(fct_eval_f64, double)
