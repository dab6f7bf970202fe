// Fused constitutive eval + assembly of the structured hex engine:
// strain -> VonMises3D radial return (exponential hardening) -> weighted
// divergence -> node sums, for P1 hexes with 2x2x2 Gauss points and the FULL
// constraint, in ONE launch that writes the new state and the assembled
// residual r [3, M].
//
// Replaces the TPU kernel fenics_constitutive_tpu/ops/pallas_eval.py::
// build_pallas_eval, and the corner scatter the TPU left outside it.
//
// Design: one cooperative launch (eval_kernel), two phases split by a
// grid-wide barrier, both walking the flat index in order (grid-stride):
//  1. every cell origin n (masked or not), one thread: the 24 corner dofs of
//     the increment, then per Gauss point the masked strain, the radial
//     return and sigma', eps_p', n, alpha', beta, gamma, exactly as the plain
//     version computes them at every origin;
//  2. every node n: r[j, n] = sum_{a=0..7} F[a, j] of the cell at n - off_a,
//     in the order of the plain version's shifted adds, each corner force
//     formed from the cell's new stress, which phase 1 has just written. A
//     block takes 256 consecutive nodes at a time; their cells lie in two
//     windows (one x-plane apart) of at most 2 x 257 cells, whose 12 needed
//     corner forces each are formed once into shared memory (at most 98.7
//     KB in float64, whatever the box).
// The return map runs once per cell, no [24, M] corner forces reach device
// memory, and no atomics are used: two launches are bit-equal.
//
// What bounds it on the H100: bytes, and how they are laid out. It reads du
// [3, M], the old stress and plastic strain ([48, M] each), alpha [8, M] and
// the mask, and writes r [3, M], sigma', eps_p', n ([48, M] each) and
// alpha', beta, gamma ([8, M] each): 279 M values per call; phase 2 reads
// sigma' again, each cell in both windows and the s1 + 1 cells where two
// steps' windows overlap (2.4 x 48 M values at 50^3; the share served by
// L2 is not measured).
// 276 rows of M values are in flight at once: on an NVIDIA H100 80GB HBM3
// (700 W) a plain copy kernel that reads the 108 input rows and writes the
// 168 output rows at each n in flat order takes 0.085 ms at 50^3 in float32,
// 1.6x a contiguous copy of the same bytes, and twice that when blocks own
// 8 x 4 x 17 node bricks (scripts/k2_store_floor.py). So phase 1 walks the
// cells in flat order with short, coalesced rows, and the node sums are
// taken after the barrier instead of from a brick of recomputed halo cells
// as matvec.cu does (on that card that design took 0.133 ms at its best
// brick against this kernel's 0.099 ms; PERF.md §6).
// The products with KEPS_c and KDIV_c use their structure (common.cuh:
// strain_at, add_divergence).
//
// The local Newton: the TPU ran a fixed trip count with a per-lane active
// mask because its lanes are SIMD; here a thread whose point has converged
// leaves the loop. A converged point never changes again, so the result is
// the same; trip cap and tolerances are those of models/packed_models.py.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fct;

constexpr int kThreadsEval = 256;
// blocks per SM the register budget is set for: 4 in float32 (64 registers,
// one wave at 50^3), 2 in float64
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 4 : 2;
constexpr double kSq23 = 0.816496580927726;  // sqrt(2/3)

// Model constants, folded on the host in double exactly as the plain
// PyTorch version folds its Python-float scalars.
template <typename T>
struct Consts {
  T ka, two_mu, neg_two_mu, y0, dy, neg_w, dfk, four_mu2;
  T tol, rtol, eight_eps, c;
  int max_it;
};

// the kernel's fields in device memory (no two alias)
template <typename T>
struct Fields {
  const T* __restrict__ du;
  const T* __restrict__ sig;
  const T* __restrict__ epsn;
  const T* __restrict__ alpha;
  const T* __restrict__ mask;
  T* __restrict__ sig_out;
  T* __restrict__ epsn_out;
  T* __restrict__ alpha_out;
  T* __restrict__ beta_out;
  T* __restrict__ gamma_out;
  T* __restrict__ n_out;
};

// Gauss point q of the cell at origin n with strain e: the radial return
// from the old state, its new state written if ``own``; returns the new
// stress in s_new.
template <typename T>
__device__ __forceinline__ void return_map(const Fields<T>& f, const Consts<T>& p,
                                           const T (&e)[kS], int q, int n, int M, bool own,
                                           T (&s_new)[kS]) {
  const T sq23 = T(kSq23), third = T(1) / T(3);
  T sq[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) sq[s] = f.sig[(s * kQ + q) * M + n];
  const T al = f.alpha[q * M + n];

  // deviatoric split of the strain increment and the old stress
  const T tr_e = e[0] + e[1] + e[2];
  const T tr_s = sq[0] + sq[1] + sq[2];
  T ed[kS], sigtr[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    ed[s] = s < 3 ? e[s] - tr_e * third : e[s];
    const T sd_s = s < 3 ? sq[s] - tr_s * third : sq[s];
    sigtr[s] = sd_s + p.two_mu * ed[s];
  }
  T n2 = sigtr[0] * sigtr[0];
#pragma unroll
  for (int s = 1; s < kS; ++s) n2 += sigtr[s] * sigtr[s];
  const T sigtrn = dsqrt(n2);

  const T phitr = sigtrn - sq23 * (p.y0 + p.dy * (T(1) - dexp(p.neg_w * al)));
  const bool plastic = phitr > T(0);
  const T inv = plastic ? T(1) / sigtrn : T(0);  // 1/|s_tr| where the flow uses it
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
  const T two_mu_g = p.two_mu * gam;

#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const T xn = sigtr[s] * inv;
    const T v = s < 3 ? sq[s] + p.ka * tr_e : sq[s];
    s_new[s] = v + p.two_mu * ed[s] - two_mu_g * xn;
    if (own) {
      const int o = (s * kQ + q) * M + n;
      f.sig_out[o] = s_new[s];
      f.epsn_out[o] = f.epsn[o] + gam * xn;
      f.n_out[o] = xn;
    }
  }
  if (own) {
    const T exg = dexp(p.neg_w * (al + sq23 * gam));
    const T xg = p.neg_two_mu - p.dfk * exg;
    const T xc1 = plastic ? T(-1) / xg : T(0);
    const T xc2 = gam * inv;
    f.alpha_out[q * M + n] = al + sq23 * gam;
    f.beta_out[q * M + n] = p.two_mu * (T(1) - p.two_mu * xc2);
    f.gamma_out[q * M + n] = p.four_mu2 * (xc2 - xc1);
  }
}

// Phase 2, the forces the node sums take from the cell at origin ``cell``:
// the 12 components of its 4 corners a with a & 1 == ``odd``, formed from
// its new stress (written by phase 1) as add_divergence forms them; zero
// for a cell outside the grid or with mask 0 (the plain version adds its
// zero).
template <typename T>
__device__ __forceinline__ void half_corner_forces(const Fields<T>& f, const T* dq, const T* wq,
                                                   T c, int cell, int M, int odd, T (&Fh)[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) Fh[k] = T(0);
  if (cell < 0 || cell >= M) return;
  const T m = f.mask[cell];
  if (m == T(0)) return;
#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    const T w = wq[q], wc = w * c;
    T sg[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) sg[s] = f.sig_out[(s * kQ + q) * M + cell] * m;
    const T Tm[3][3] = {{w * sg[0], wc * sg[3], wc * sg[4]},
                        {wc * sg[3], w * sg[1], wc * sg[5]},
                        {wc * sg[4], wc * sg[5], w * sg[2]}};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const T* d = dq + (q * kNodes + 2 * h + odd) * 3;
#pragma unroll
      for (int j = 0; j < kVs; ++j) {
        T v = Fh[h * kVs + j];
#pragma unroll
        for (int i = 0; i < 3; ++i) v += d[i] * Tm[i][j];
        Fh[h * kVs + j] = v;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreadsEval, kMinBlocks<T>)
eval_kernel(Fields<T> f, const T* __restrict__ dn, const T* __restrict__ w,
            T* __restrict__ r, Consts<T> p, int n0, int n1, int n2) {
  __shared__ T dq[kTab];
  __shared__ T wq[kQ];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  load_tables(dn, w, dq, wq);
  const int M = n0 * n1 * n2, s1 = n2, s0 = n1 * n2;
  const int stride = gridDim.x * blockDim.x;
  // phase 1: the state of every cell origin, one point at a time
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < M; n += stride) {
    T U[kCorner];
    load_corners(f.du, n, M, s0, s1, U);
    const T m = f.mask[n];
#pragma unroll 1
    for (int q = 0; q < kQ; ++q) {
      T e[kS], s_new[kS];
      strain_at(dq + q * kNodes * 3, U, p.c, m, e);
      return_map(f, p, e, q, n, M, true, s_new);
    }
  }
  cg::this_grid().sync();

  // phase 2: the node sums of C = blockDim.x nodes [base, base + C) at a
  // time. Their cells lie in two windows: B = [base - s1 - 1, ...) gives the
  // even corners (dx = 0), A = B - s0 the odd ones. A window needs the cells
  // at offsets [0, C] (dy = 1) and [s1, s1 + C] (dy = 0); past s1 = C + 1
  // the two runs part, and the gap between them is skipped, so a window
  // holds W = C + 1 + min(s1, C + 1) cells, offset h > C in slot h - gap.
  // Each window cell's 12 needed forces are formed once, in shared memory
  // [12][W] each, and each node sums its 8 in the order a = 0..7.
  const int C = blockDim.x, gap = s1 > C + 1 ? s1 - C - 1 : 0, W = s1 + C + 1 - gap;
  T* FA = reinterpret_cast<T*>(smem_raw);
  T* FB = FA + 12 * W;
  for (int base = blockIdx.x * C; base < M; base += stride) {
    for (int i = threadIdx.x; i < 2 * W; i += C) {
      const int odd = i < W, slot = odd ? i : i - W, h = slot > C ? slot + gap : slot;
      T Fh[12];
      half_corner_forces(f, dq, wq, p.c, base - s1 - 1 + h - odd * s0, M, odd, Fh);
      T* dst = odd ? FA : FB;
#pragma unroll
      for (int k = 0; k < 12; ++k) dst[k * W + slot] = Fh[k];
    }
    __syncthreads();
    const int n = base + threadIdx.x;
    if (n < M) {
#pragma unroll
      for (int j = 0; j < kVs; ++j) {
        T acc = T(0);
#pragma unroll
        for (int a = 0; a < kNodes; ++a) {
          // corner a of the cell at n - (dx s0 + dy s1 + dz) sits at offset
          // (n - base) + (1 - dy) s1 + (1 - dz) of its window
          const int h = threadIdx.x + (1 - ((a >> 1) & 1)) * s1 + (1 - ((a >> 2) & 1));
          acc += ((a & 1) ? FA : FB)[((a >> 1) * kVs + j) * W + (h > C ? h - gap : h)];
        }
        r[j * M + n] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* du, const void* sig, const void* epsn, const void* alpha,
           const void* mask, const void* dn, const void* w, void* r, void* sig_out,
           void* epsn_out, void* alpha_out, void* beta_out, void* gamma_out, void* n_out,
           double ka, double mu, double y0, double y00, double wh, double tol, double rtol,
           int max_it, double eps, double c, int n0, int n1, int n2, void* stream) {
  Consts<T> p;
  p.ka = static_cast<T>(ka);
  p.two_mu = static_cast<T>(2.0 * mu);
  p.neg_two_mu = static_cast<T>(-2.0 * mu);
  p.y0 = static_cast<T>(y0);
  p.dy = static_cast<T>(y00 - y0);
  p.neg_w = static_cast<T>(-wh);
  p.dfk = static_cast<T>((2.0 / 3.0) * (y00 - y0) * wh);
  p.four_mu2 = static_cast<T>(4.0 * mu * mu);
  p.tol = static_cast<T>(tol);
  p.rtol = static_cast<T>(rtol);
  p.eight_eps = static_cast<T>(8.0 * eps);
  p.c = static_cast<T>(c);
  p.max_it = max_it;
  Fields<T> f = {static_cast<const T*>(du),    static_cast<const T*>(sig),
                 static_cast<const T*>(epsn),  static_cast<const T*>(alpha),
                 static_cast<const T*>(mask),  static_cast<T*>(sig_out),
                 static_cast<T*>(epsn_out),    static_cast<T*>(alpha_out),
                 static_cast<T*>(beta_out),    static_cast<T*>(gamma_out),
                 static_cast<T*>(n_out)};
  const T* dnp = static_cast<const T*>(dn);
  const T* wp = static_cast<const T*>(w);
  T* rp = static_cast<T*>(r);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);

  // phase 2's two windows of corner forces (W = C + 1 + min(s1, C + 1)
  // cells each, at most 98.7 KB in float64), opted in once per device; the
  // persistent grid: as many blocks as the SMs hold at once with them
  const int W = kThreadsEval + 1 + (n2 < kThreadsEval + 1 ? n2 : kThreadsEval + 1);
  const size_t bytes = 24 * static_cast<size_t>(W) * sizeof(T);
  static size_t opted[kMaxDevices] = {};
  e = opt_in_smem(eval_kernel<T>, bytes, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int cap[kMaxDevices] = {};
  static size_t cap_bytes[kMaxDevices] = {};
  if (cap_bytes[dev] != bytes) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eval_kernel<T>, kThreadsEval,
                                                      bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    cap[dev] = per_sm * sms;
    cap_bytes[dev] = bytes;
  }
  const int M = n0 * n1 * n2;
  int blocks = (M + kThreadsEval - 1) / kThreadsEval;
  if (blocks > cap[dev]) blocks = cap[dev];
  void* params[] = {&f, &dnp, &wp, &rp, &p, &n0, &n1, &n2};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(eval_kernel<T>), dim3(blocks),
                                  dim3(kThreadsEval), params, bytes, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t.
// On the node grid n0 x n1 x n2 (M = n0 n1 n2, z fastest): inputs du [3, M],
// sig/epsn [6, 8, M], alpha [8, M], mask [M]; ``dn`` is the gradient table
// [8 q][8 a][3 i] of the cells and ``w`` the 8 quadrature weights; outputs r
// [3, M], sig_out/epsn_out/n_out [6, 8, M], alpha_out/beta_out/gamma_out
// [8, M]. (ka, mu, y0, y00, w) are the model parameters; tol/rtol/max_it the
// local Newton controls; eps the working type's machine epsilon; c the
// Mandel shear factor 1/sqrt(2). Returns cudaGetLastError() (or the
// launch's, the occupancy query's or the opt-in's error) after the one
// launch.
#define FCT_EVAL_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* du, const void* sig, const void* epsn,                 \
                      const void* alpha, const void* mask, const void* dn, const void* w, \
                      void* r, void* sig_out, void* epsn_out, void* alpha_out,           \
                      void* beta_out, void* gamma_out, void* n_out, double ka, double mu, \
                      double y0, double y00, double wh, double tol, double rtol,          \
                      int max_it, double eps, double c, int n0, int n1, int n2,          \
                      void* stream) {                                                    \
    return launch<T>(du, sig, epsn, alpha, mask, dn, w, r, sig_out, epsn_out, alpha_out, \
                     beta_out, gamma_out, n_out, ka, mu, y0, y00, wh, tol, rtol, max_it,  \
                     eps, c, n0, n1, n2, stream);                                        \
  }

FCT_EVAL_ENTRY(fct_eval_f32, float)
FCT_EVAL_ENTRY(fct_eval_f64, double)
