// K9: Drucker-Prager's implicit return map, one thread a quadrature point:
// the trial stress, the yield check, the local Newton on (sigma, lam,
// alpha), the consistent tangent and the plastic strain increment in one
// launch an evaluation.
//
// Replaces no TPU kernel: the JAX package runs this map as XLA-fused array
// ops (models/plasticity_general.py, vmap of jacfwd), and the port ran it as
// a device loop of hundreds of small strided elementwise, cat and batched
// solve launches over every point a trip. Its plain twin is
// models/plasticity_general.py::implicit_return_map, which the CPU runs.
//
// The law (models/drucker_prager.py), Mandel notation, C = 2 mu P_dev +
// 3 kappa P_vol:
//   f = sqrt(J2t) + b I1 - a,   g = b_flow I2 + s / (2 sqrt(J2t)),
//   J2 = s.s / 2, J2t = max(J2, 1e-30) (the cone) or J2 + d^2 (hyperbolic).
// Residual of the unknowns x = (sigma, lam, alpha), as the plain map's:
//   r_s = sigma - sigma_tr + lam C g,  r_f = f,
//   r_a = alpha - alpha_0 - lam sqrt(2/3) |g|.
// Its Jacobian, written out (h = 1 / (2 sqrt(J2t)), m = 1 where J2t has a
// derivative, the clamp's 0 below 1e-30):
//   H = dg/dsigma = h P_dev - m h / (2 J2t) s s^T,  n = df/dsigma = b I2 + m h s,
//   J = [[I + lam C H, C g, 0], [n^T, 0, 0],
//        [-lam sqrt(2/3) (H g)^T / |g|, -sqrt(2/3) |g|, 1]].
// No row but the last depends on alpha, so each trip factors the 7 x 7 block
// of (sigma, lam) by Gaussian elimination with partial pivoting and takes
// alpha's increment from the last row: the same solve as the plain map's
// 8 x 8 LU. The stopping rule is the plain map's, per point: a plastic
// point iterates while the residual stored at the iterate before the last
// update has norm >= atol, some component of the last increment exceeds
// atol + rtol |x| (the first test against x + 1), and it has made fewer than
// maxit trips. The tangent solves J X = [C; 0] at the final iterate, with J
// evaluated there again, and keeps the stress block; the plastic strain
// increment takes the exact compliance, del_eps - C^-1 (sigma_1 - sigma_0).
// Associated and non-associated flow, the cone and the hyperbolic apex are
// the same code: the runtime flag `cone` picks the J2t term.
//
// Layouts: sigma_0 and del_eps [Q, 6] and alpha_0 [Q, 1] are read through
// their strides (under the generic dense-tangent adapter sigma_0 and
// alpha_0 are views of [6, Q] and [1, Q] buffers, so neighbouring threads
// read neighbouring addresses); sigma_1 and del_eps_p are written [6, Q],
// alpha_1 [Q], and the tangent as [Q][column][row], each point's 6 x 6
// column-major: the memory order of the plain map's batched solve, which
// the adapter wraps as a DenseTangent and the dense operator reads a column
// (48 contiguous bytes) at a time (row-major, the same operator took 188
// against 142 ms a step of the dp-maxwell cell on the H100). A block
// stages its 128 points' tangents in shared memory (an odd stride of 37
// values, so the threads' stores meet no bank twice) and writes them out as
// one run.
//
// What bounds it on the H100: an evaluation reads 13 values a point and
// writes 49 (496 bytes in float64: 262 MB and 78 us at 3.35 TB/s over
// 529,200 points); the local Newton costs a few thousand f64 operations a
// plastic point (~0.1 ms at the card's f64 rate). Registers are the limit
// in float64: the 7 x 7 system lives in them, fully unrolled with static
// indices, the pivot rows swapped by selects. Each point's arithmetic is
// one thread's fixed sequence, with no atomics and no host read, so two
// launches agree bit for bit and a CUDA graph replays the eager result.
#include "common.cuh"

namespace {

using namespace fct;

constexpr int kThreadsRm = 128;  // points a block
constexpr int kStage = 37;       // shared-memory stride of a point's 36 tangent values
constexpr int kN = 7;            // the (sigma, lam) block of the local system

// Everything a launch takes by value: C by its three distinct entries (in the
// working dtype, as the plain map forms C), the exact compliance's factors,
// the law's parameters, the Newton controls, and the inputs' strides.
struct Args {
  double c_d, c_o, c_s;    // C: normal diagonal, normal off-diagonal, shear diagonal
  double inv_2mu, inv_9k;  // C^-1 = P_dev / (2 mu) + P_vol / (3 kappa)
  double a, b, b_flow, d2;
  double atol, rtol;
  int maxit, cone;
  long long Q;
  long long s_q, s_k, e_q, e_k, a_q;  // sigma_0, del_eps [Q, 6]; alpha_0 [Q, 1]
};

template <typename T>
struct Law {
  T c_d, c_o, c_s, a, b, b_flow, d2;
  bool cone;
};

// y = C x for the isotropic C, summed over the columns in order
template <typename T>
__device__ __forceinline__ void apply_c(const Law<T>& L, const T (&x)[6], T (&y)[6]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T c0 = i == 0 ? L.c_d : L.c_o;
    const T c1 = i == 1 ? L.c_d : L.c_o;
    const T c2 = i == 2 ? L.c_d : L.c_o;
    y[i] = c0 * x[0] + c1 * x[1] + c2 * x[2];
  }
#pragma unroll
  for (int i = 3; i < 6; ++i) y[i] = L.c_s * x[i];
}

// The residual r at x = (sigma [6], lam, alpha), and the Jacobian: M, the 7 x 7
// block of the stress and yield rows over (sigma, lam), and j8, the hardening
// row over them (its alpha entry is 1; no other row has one).
template <typename T>
__device__ __forceinline__ void residual(const Law<T>& L, const T (&x)[8], const T (&sig_tr)[6],
                                         T alpha0, T (&r)[8], T (&M)[kN][kN], T (&j8)[kN]) {
  const T sq23 = T(0.816496580927726);  // sqrt(2/3)
  const T i1 = x[0] + x[1] + x[2];
  const T vol = i1 / T(3);
  const T dev[6] = {x[0] - vol, x[1] - vol, x[2] - vol, x[3], x[4], x[5]};
  T j2 = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) j2 += dev[k] * dev[k];
  j2 = T(0.5) * j2;
  const T tiny = T(1e-30);
  // the clamp keeps a NaN (as torch.clamp does) and passes no derivative below it
  const T j2t = L.cone ? (j2 < tiny ? tiny : j2) : j2 + L.d2;
  const T m = (!L.cone || j2 >= tiny) ? T(1) : T(0);
  const T sq = dsqrt(j2t);
  const T h = T(0.5) / sq;
  T g[6], cg[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = (k < 3 ? L.b_flow : T(0)) + h * dev[k];
  apply_c(L, g, cg);
  const T lam = x[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = (x[k] - sig_tr[k]) + lam * cg[k];
  r[6] = (sq + L.b * i1) - L.a;
  T gg = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) gg += g[k] * g[k];
  const T gn = dsqrt(gg);
  r[7] = (x[7] - alpha0) - lam * (sq23 * gn);

  // H[j][k] = h P_dev[j][k] - q dev[j] dev[k]
  const T q = m * h / (T(2) * j2t);
  const T pd = T(2.0 / 3.0), po = T(-1.0 / 3.0);
  auto H = [&](int j, int k) {
    const T p = j == k ? (j < 3 ? pd : T(1)) : (j < 3 && k < 3 ? po : T(0));
    return h * p - q * dev[j] * dev[k];
  };
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T ch = (i == 0 ? L.c_d : L.c_o) * H(0, k) + (i == 1 ? L.c_d : L.c_o) * H(1, k) +
                   (i == 2 ? L.c_d : L.c_o) * H(2, k);
      M[i][k] = (i == k ? T(1) : T(0)) + lam * ch;
    }
#pragma unroll
    for (int i = 3; i < 6; ++i) M[i][k] = (i == k ? T(1) : T(0)) + lam * (L.c_s * H(i, k));
    M[6][k] = (k < 3 ? L.b : T(0)) + m * h * dev[k];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) M[i][6] = cg[i];
  M[6][6] = T(0);
  // d|g|/dsigma = H g / |g|, 0 where g is 0
  const T sc = gn > T(0) ? -lam * sq23 / gn : T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    T hg = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) hg += H(k, j) * g[j];
    j8[k] = sc * hg;
  }
  j8[6] = -(sq23 * gn);
}

// LU with partial pivoting in place: a row below the pivot that is larger in
// the pivot column swaps with it (whole rows, the multipliers included), so
// the pivot ends as the column's first largest; `swaps` keeps each decision
// (bit k (2N - k - 1) / 2 + i - k - 1). The diagonal keeps U's reciprocals.
template <typename T>
__device__ __forceinline__ unsigned lu_factor(T (&a)[kN][kN]) {
  unsigned swaps = 0;
  int bit = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int i = k + 1; i < kN; ++i, ++bit) {
      const bool sw = dabs(a[i][k]) > dabs(a[k][k]);
      swaps |= static_cast<unsigned>(sw) << bit;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const T t = a[i][j];
        a[i][j] = sw ? a[k][j] : t;
        a[k][j] = sw ? t : a[k][j];
      }
    }
    const T inv = T(1) / a[k][k];
    a[k][k] = inv;
#pragma unroll
    for (int i = k + 1; i < kN; ++i) {
      const T l = a[i][k] * inv;
      a[i][k] = l;
#pragma unroll
      for (int j = k + 1; j < kN; ++j) a[i][j] -= l * a[k][j];
    }
  }
  return swaps;
}

// b <- A^-1 b from lu_factor's result: the row swaps in their order, then L
// (unit lower) and U.
template <typename T>
__device__ __forceinline__ void lu_solve(const T (&a)[kN][kN], unsigned swaps, T (&b)[kN]) {
  int bit = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int i = k + 1; i < kN; ++i, ++bit) {
      const bool sw = (swaps >> bit) & 1u;
      const T t = b[i];
      b[i] = sw ? b[k] : t;
      b[k] = sw ? t : b[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int i = k + 1; i < kN; ++i) b[i] -= a[i][k] * b[k];
  }
#pragma unroll
  for (int k = kN - 1; k >= 0; --k) {
    T t = b[k];
#pragma unroll
    for (int j = k + 1; j < kN; ++j) t -= a[k][j] * b[j];
    b[k] = t * a[k][k];
  }
}

template <typename T>
__device__ __forceinline__ T norm8(const T (&r)[8]) {
  T s = T(0);
#pragma unroll
  for (int k = 0; k < 8; ++k) s += r[k] * r[k];
  return dsqrt(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreadsRm)
    dp_return_map_kernel(const T* __restrict__ sig0, const T* __restrict__ deps,
                         const T* __restrict__ alpha0p, T* __restrict__ sig1,
                         T* __restrict__ tangent, T* __restrict__ alpha1,
                         T* __restrict__ depsp, Args p) {
  __shared__ T stage[kThreadsRm * kStage];
  const Law<T> L{T(p.c_d), T(p.c_o), T(p.c_s), T(p.a), T(p.b), T(p.b_flow), T(p.d2),
                 p.cone != 0};
  const long long Q = p.Q;
  const long long first = static_cast<long long>(blockIdx.x) * kThreadsRm;
  const long long pt = first + threadIdx.x;
  T* X = stage + threadIdx.x * kStage;  // this point's tangent, [column][row]
  if (pt < Q) {
    T s0[6], de[6], st[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      s0[k] = sig0[pt * p.s_q + k * p.s_k];
      de[k] = deps[pt * p.e_q + k * p.e_k];
    }
    const T a0 = alpha0p[pt * p.a_q];
    apply_c(L, de, st);
#pragma unroll
    for (int k = 0; k < 6; ++k) st[k] = s0[k] + st[k];
    T x[8] = {st[0], st[1], st[2], st[3], st[4], st[5], T(0), a0};
    T r[8], M[kN][kN], j8[kN];
    residual(L, x, st, a0, r, M, j8);
    if (!(r[6] > T(0))) {  // elastic: f(sigma_tr) <= 0
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          X[i * 6 + k] = i < 3 && k < 3 ? (i == k ? L.c_d : L.c_o) : (i == k ? L.c_s : T(0));
        }
        sig1[i * Q + pt] = st[i];
        depsp[i * Q + pt] = T(0);
      }
      alpha1[pt] = a0;
    } else {
      const T atol = T(p.atol), rtol = T(p.rtol);
      T res_norm = norm8(r);
      bool inc_ok = true;
#pragma unroll
      for (int k = 0; k < 8; ++k) inc_ok &= dabs(x[k] - (x[k] + T(1))) <= atol + rtol * dabs(x[k]);
      for (int it = 0; !(res_norm < atol) && !inc_ok && it < p.maxit; ++it) {
        residual(L, x, st, a0, r, M, j8);
        const unsigned swaps = lu_factor(M);
        T d[kN];
#pragma unroll
        for (int k = 0; k < kN; ++k) d[k] = r[k];
        lu_solve(M, swaps, d);
        T da = r[7];
#pragma unroll
        for (int k = 0; k < kN; ++k) da -= j8[k] * d[k];
        inc_ok = true;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const T xn = x[k] - (k < kN ? d[k < kN ? k : 0] : da);
          inc_ok &= dabs(xn - x[k]) <= atol + rtol * dabs(xn);
          x[k] = xn;
        }
        res_norm = norm8(r);
      }
      // the consistent tangent from J at the final iterate: J X = [C; 0]
      residual(L, x, st, a0, r, M, j8);
      const unsigned swaps = lu_factor(M);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T col[kN];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          col[i] = i < 3 && c < 3 ? (i == c ? L.c_d : L.c_o) : (i == c ? L.c_s : T(0));
        }
        col[6] = T(0);
        lu_solve(M, swaps, col);
#pragma unroll
        for (int i = 0; i < 6; ++i) X[c * 6 + i] = col[i];
      }
      // del_eps_p = del_eps - C^-1 (sigma_1 - sigma_0)
      T ds[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) ds[k] = x[k] - s0[k];
      const T tr = ds[0] + ds[1] + ds[2];
      const T inv_2mu = T(p.inv_2mu), vol = tr * T(p.inv_9k), third = tr / T(3);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const T ee = k < 3 ? (ds[k] - third) * inv_2mu + vol : ds[k] * inv_2mu;
        sig1[k * Q + pt] = x[k];
        depsp[k * Q + pt] = de[k] - ee;
      }
      alpha1[pt] = x[7];
    }
  }
  __syncthreads();
  // the block's tangents as one contiguous run of [Q, 6, 6]
  const long long left = Q - first;
  const int n = 36 * static_cast<int>(left < kThreadsRm ? left : kThreadsRm);
  T* out = tangent + first * 36;
  for (int e = threadIdx.x; e < n; e += kThreadsRm) out[e] = stage[(e / 36) * kStage + e % 36];
}

template <typename T>
int launch(const void* sig0, const void* deps, const void* alpha0, void* sig1, void* tangent,
           void* alpha1, void* depsp, const Args& args, void* stream) {
  const long long blocks = (args.Q + kThreadsRm - 1) / kThreadsRm;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dp_return_map_kernel<T><<<static_cast<unsigned>(blocks), kThreadsRm, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(sig0), static_cast<const T*>(deps), static_cast<const T*>(alpha0),
      static_cast<T*>(sig1), static_cast<T*>(tangent), static_cast<T*>(alpha1),
      static_cast<T*>(depsp), args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer a device pointer but ``stream``, a cudaStream_t.
// sig0 and deps [Q, 6] with strides (s_q, s_k) and (e_q, e_k), alpha0 [Q, 1]
// with stride a_q, in elements; sig1 and depsp [6, Q], alpha1 [Q] and
// tangent [Q][column][row] contiguous. C's entries (c_d, c_o, c_s) in the working
// dtype; cone 1 for J2t = max(J2, 1e-30), 0 for J2 + d2. Returns
// cudaGetLastError() after the one launch (none for Q = 0).
#define FCT_RETURN_MAP_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* sig0, const void* deps, const void* alpha0, void* sig1,    \
                      void* tangent, void* alpha1, void* depsp, double c_d, double c_o,      \
                      double c_s, double inv_2mu, double inv_9k, double a, double b,         \
                      double b_flow, double d2, double atol, double rtol, int maxit,         \
                      int cone, long long Q, long long s_q, long long s_k, long long e_q,    \
                      long long e_k, long long a_q, void* stream) {                          \
    const Args args{c_d, c_o, c_s, inv_2mu, inv_9k, a, b, b_flow, d2, atol, rtol, maxit,     \
                    cone, Q, s_q, s_k, e_q, e_k, a_q};                                       \
    if (Q <= 0) return 0;                                                                    \
    return launch<T>(sig0, deps, alpha0, sig1, tangent, alpha1, depsp, args, stream);        \
  }

FCT_RETURN_MAP_ENTRY(fct_dp_return_map_f32, float)
FCT_RETURN_MAP_ENTRY(fct_dp_return_map_f64, double)
