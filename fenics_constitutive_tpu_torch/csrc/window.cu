// The windowed exchange and the BSR SpMV of the general-mesh path.
//
// Replaces the three TPU kernels of fenics_constitutive_tpu/ops/pallas_window.py:
//   K4 windowed_gather      -> gather_kernel
//   K5 windowed_scatter     -> scatter_kernel
//   K6 windowed_bsr_matvec  -> bsr_rows_kernel
// and adds K7 cell_apply_kernel, the affine P1 tet operator's cell part.
//
// Layouts (row-major, the flat minor axis last):
//   node rows u       [K, M_pad]         u[k*M_pad + m]
//   cell-local rows f [B, K, Rn]         f[(b*K + k)*Rn + r], Rn % 4 == 0
//   loc               [B, Rn] int32      window-local node of row r of block b
//                                        (node b*T + loc), -1 for a pad row
//   node_ptr/rows     CSR [M_pad]        flat rows b*Rn + r feeding node m,
//                                        ascending (pad rows in no list)
//   BSR row_ptr       [NR_pad + 1] int32 the blocks of row node r (pad rows empty)
//   BSR col           [nnzb] int32       column node of each block
//   BSR blk           [nnzb, br*bc]      block entries, (jr, jc) row-major
//   x / y             [bc, NC_pad] / [br, NR_pad]
//   dN                [4, 3, C_pad]      affine P1 gradients, C_pad = B*C_B slots
//   QP fields w, beta, gamma [N], n [6, N]   q-major, w[q*C_pad + s]
//
// What bounds them on the H100: bytes (K4, K5, and K6 on the fine-level
// operators A0, P0, R0), and for K6 below the fine level the latency of a
// few warps per operator. The TPU, which has no fast arbitrary gather,
// turned each index op into a one-hot MXU contraction with an exact 3-term
// bf16 split of the values, and laid the AMG operators out in windowed row
// tiles [B, k, T_r] for it. On the GPU a direct indexed load does the same work.
// K4 gives each thread 4 consecutive rows: loc comes in as one int4 and each
// component goes out as one 16-byte store, so loc and the output move in
// full sectors; u comes through the read-only path, mostly from L2, as the
// window of a block is a narrow band of nodes. K5 is the transpose without
// float atomics: one thread per (component, node) sums its rows in the
// plan's fixed order, so a launch repeats bit for bit. K6 drops the windowed
// tiles, whose coarse levels gave 35-363 live rows to 1,024 threads that each
// walked up to 333 slots: it reads the operator as a compact BSR list in row
// order and spreads each row's blocks over `lanes` consecutive threads (a
// power of two up to a warp, from the plan's mean blocks per row), whose
// partial sums meet in a fixed shuffle tree. No atomics, no padded slots, a
// fixed order (two launches agree bit for bit), and every real row gets up
// to 32 threads; the rows of a warp read one contiguous stretch of blocks.
//
// K7 cell_apply_kernel has no TPU counterpart: it is the middle of the CG
// operator on affine P1 tets (WindowedGeometry.matvec), which the JAX
// package runs as XLA-fused array ops between K4 and K5 and the port ran as
// some 20 PyTorch ops, each reading and writing [.., C_pad] or [.., N]
// fields. Its input is the node rows u [3, M_pad], its output K5's input f
// [B, 3, Rn]; in between nothing leaves the registers. One thread per cell
// slot s = b*C_B + r (a 128-thread block lies in one window block, as C_B is
// a multiple of 128), consecutive threads on consecutive r, so every
// per-slot read (loc, dN [4, 3, C_pad], the QP fields at q*C_pad + s) and
// every store of f is coalesced. The thread
//   1. gathers its 4 nodes' 3 components, u[j, b*T + loc[b, a*C_B + r]]
//      (K4's work folded in; a pad slot, loc -1, reads 0), mostly from L2;
//   2. forms grad[i][j] = sum_a dN[a][i] u[a][j] (a ascending) and the 6
//      Mandel strains of the FULL map (its shear factor c read from the
//      geometry's own map, mandel_T[3][0][1]);
//   3. for each QP q ascending, applies the factored tangent, sigma = beta e
//      + gamma (n.e) n + (kappa - beta/3) tr(e) on the diagonal slots, and
//      sums w_q sigma_q (the map T^T and the sum over q commute, so T^T is
//      applied once to the sum);
//   4. stores f[a][j] = sum_i dN[a][i] S[i][j], S = T^T sum_q w_q sigma_q.
// Every sum runs in a fixed order and no atomic is used, so two launches
// agree bit for bit. A uniform beta, gamma or n is read with a zero stride.
// The sum over the cells of each node stays with K5, whose node-major lists
// fix its order: summing there rather than with atomics in K7 keeps the
// operator repeatable, and K5's per-node reads are a small part of the bytes.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using fct::kThreads;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
__device__ __forceinline__ T take(const T* __restrict__ src, int l) {
  return l < 0 ? T(0) : __ldg(src + l);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// K4: out[b, k, r] = u[k, b*T + loc[b, r]], 0 where loc = -1; thread i owns
// the rows 4q..4q+3 of block b, i = b*(Rn/4) + q
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ u, const int4* __restrict__ loc4, T* __restrict__ out,
              int K, int Rn4, int tile, int M_pad, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int b = i / Rn4;
  const int4 l = __ldg(loc4 + i);
  const T* src = u + b * tile;
  T* dst = out + (b * K * Rn4 + (i - b * Rn4)) * 4;
  for (int k = 0; k < K; ++k) {
    const T* s = src + k * M_pad;
    store4(dst + k * Rn4 * 4, take(s, l.x), take(s, l.y), take(s, l.z), take(s, l.w));
  }
}

// K5: out[k, m] = sum over the rows (b, r) of node m, ascending, of f[b, k, r]
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const T* __restrict__ f, const int* __restrict__ node_ptr,
               const int* __restrict__ node_rows, T* __restrict__ out, int K, int Rn,
               int M_pad) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (m >= M_pad) return;
  T acc = T(0);
  const int e1 = node_ptr[m + 1];
  for (int e = node_ptr[m]; e < e1; ++e) {
    const int row = node_rows[e];
    const int b = row / Rn;
    acc += f[(b * K + k) * Rn + (row - b * Rn)];
  }
  out[k * M_pad + m] = acc;
}

// the column select of K6: float32 may be rounded to bfloat16 (round to
// nearest even, the first term of the JAX package's exact 3-term split)
__device__ __forceinline__ float select_value(float v, int round_bf16) {
  return round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
__device__ __forceinline__ double select_value(double v, int) { return v; }

// K6: y[jr, r] = sum over the blocks e of row r of
//     sum_jc blk[e, jr, jc] * x[jc, col[e]]
// Thread g serves row r = g >> log2_lanes as lane j = g & (lanes - 1) and
// takes the blocks row_ptr[r] + j, + lanes, ...; the lanes of a row (aligned
// within a warp) combine their partial sums by a fixed xor tree and lane 0
// writes. Threads past NR_pad have no blocks but join the shuffles.
template <typename T, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
bsr_rows_kernel(const T* __restrict__ x, const int* __restrict__ row_ptr,
                const int* __restrict__ col, const T* __restrict__ blk, T* __restrict__ y,
                int NR_pad, int NC_pad, int log2_lanes, int round_bf16) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = g >> log2_lanes;
  const int lanes = 1 << log2_lanes;
  const int lane = g & (lanes - 1);
  int e = 0, e1 = 0;
  if (r < NR_pad) {
    e = __ldg(row_ptr + r) + lane;
    e1 = __ldg(row_ptr + r + 1);
  }
  T acc[BR];
#pragma unroll
  for (int jr = 0; jr < BR; ++jr) acc[jr] = T(0);

  for (; e < e1; e += lanes) {
    const int c = __ldg(col + e);
    T xs[BC];
#pragma unroll
    for (int jc = 0; jc < BC; ++jc) {
      xs[jc] = select_value(__ldg(x + jc * NC_pad + c), round_bf16);
    }
    const T* v = blk + e * (BR * BC);
#pragma unroll
    for (int jr = 0; jr < BR; ++jr) {
      T s = T(0);
#pragma unroll
      for (int jc = 0; jc < BC; ++jc) s += __ldg(v + jr * BC + jc) * xs[jc];
      acc[jr] += s;
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int jr = 0; jr < BR; ++jr) acc[jr] += __shfl_xor_sync(0xffffffffu, acc[jr], off);
  }
  if (r < NR_pad && lane == 0) {
#pragma unroll
    for (int jr = 0; jr < BR; ++jr) y[jr * NR_pad + r] = acc[jr];
  }
}

// K7: f[b, j, a*C_B + r] = sum_i dN[a, i, s] S[i, j] for the cell slot
// s = b*C_B + r (design at the head of this file). kappa is coef[0], the
// shear factor c of the FULL Mandel map [6][3][3] is mandel[3][0][1]; beta,
// gamma and n[k] of QP p = q*C_pad + s are beta[p*beta_stride],
// gamma[p*gamma_stride] and nf[k*n_comp_stride + p*n_qp_stride], a stride 0
// for a uniform value. At least half occupancy: at most 64 registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
cell_apply_kernel(const T* __restrict__ u, const int* __restrict__ loc,
                  const T* __restrict__ dN, const T* __restrict__ w,
                  const T* __restrict__ beta, const T* __restrict__ gamma,
                  const T* __restrict__ nf, const T* __restrict__ coef,
                  const T* __restrict__ mandel, T* __restrict__ f, int C_B, int tile,
                  int M_pad, int C_pad, int n_qp, int beta_stride,
                  int gamma_stride, int n_comp_stride, int n_qp_stride) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= C_pad) return;
  const int b = s / C_B;
  const int r = s - b * C_B;
  const int Rn = 4 * C_B;
  const int* lrow = loc + b * Rn + r;
  const T* ub = u + b * tile;

  T H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = T(0);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int l = __ldg(lrow + a * C_B);
    T ua[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) ua[j] = take(ub + j * M_pad, l);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T d = __ldg(dN + (a * 3 + i) * C_pad + s);
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i][j] += d * ua[j];
    }
  }
  const T c = __ldg(mandel + 28);
  const T e[6] = {H[0][0], H[1][1], H[2][2], c * (H[0][1] + H[1][0]),
                  c * (H[0][2] + H[2][0]), c * (H[1][2] + H[2][1])};
  const T tr = e[0] + e[1] + e[2];
  const T kappa = __ldg(coef);

  T sg[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) sg[k] = T(0);
  for (int q = 0; q < n_qp; ++q) {
    const int p = q * C_pad + s;
    const T bq = __ldg(beta + p * beta_stride);
    const T gq = __ldg(gamma + p * gamma_stride);
    const T wq = __ldg(w + p);
    const T* np = nf + p * n_qp_stride;
    T nde = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) nde += __ldg(np + k * n_comp_stride) * e[k];
    const T gn = gq * nde;
    const T corr = (kappa - bq / T(3)) * tr;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T sig = bq * e[k] + gn * __ldg(np + k * n_comp_stride);
      if (k < 3) sig += corr;
      sg[k] += wq * sig;
    }
  }
  // S = T^T sg (symmetric), then the divergence into the 4 nodes
  const T S[3][3] = {{sg[0], c * sg[3], c * sg[4]},
                     {c * sg[3], sg[1], c * sg[5]},
                     {c * sg[4], c * sg[5], sg[2]}};
  T* fb = f + b * 3 * Rn + r;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    T d[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = __ldg(dN + (a * 3 + i) * C_pad + s);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < 3; ++i) acc += d[i] * S[i][j];
      fb[j * Rn + a * C_B] = acc;
    }
  }
}

template <typename T>
int launch_cell_apply(const void* u, const void* loc, const void* dN, const void* w,
                      const void* beta, const void* gamma, const void* nf, const void* coef,
                      const void* mandel, void* f, int C_B, int B, int tile, int M_pad, int n_qp,
                      int beta_stride, int gamma_stride, int n_comp_stride, int n_qp_stride,
                      void* stream) {
  const int C_pad = B * C_B;
  cell_apply_kernel<T><<<cdiv(C_pad, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(loc), static_cast<const T*>(dN),
      static_cast<const T*>(w), static_cast<const T*>(beta), static_cast<const T*>(gamma),
      static_cast<const T*>(nf), static_cast<const T*>(coef), static_cast<const T*>(mandel),
      static_cast<T*>(f), C_B, tile, M_pad, C_pad, n_qp, beta_stride, gamma_stride,
      n_comp_stride, n_qp_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather(const void* u, const void* loc, void* out, int K, int B, int Rn,
                  int tile, int M_pad, void* stream) {
  const int n4 = B * (Rn / 4);
  gather_kernel<T><<<cdiv(n4, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int4*>(loc), static_cast<T*>(out), K,
      Rn / 4, tile, M_pad, n4);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const void* f, const void* node_ptr, const void* node_rows, void* out,
                   int K, int Rn, int M_pad, void* stream) {
  const dim3 grid(cdiv(M_pad, kThreads), K);
  scatter_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const int*>(node_ptr),
      static_cast<const int*>(node_rows), static_cast<T*>(out), K, Rn, M_pad);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BR, int BC>
void launch_bsr_shape(const void* x, const void* row_ptr, const void* col, const void* blk,
                      void* y, int NR_pad, int NC_pad, int log2_lanes, int round_bf16,
                      cudaStream_t stream) {
  const int grid = cdiv(NR_pad << log2_lanes, kThreads);
  bsr_rows_kernel<T, BR, BC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col), static_cast<const T*>(blk), static_cast<T*>(y), NR_pad,
      NC_pad, log2_lanes, round_bf16);
}

template <typename T>
int launch_bsr(const void* x, const void* row_ptr, const void* col, const void* blk,
               void* y, int br, int bc, int NR_pad, int NC_pad, int log2_lanes,
               int round_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (log2_lanes < 0 || log2_lanes > 5) return static_cast<int>(cudaErrorInvalidValue);
  if (br == 3 && bc == 3) {
    launch_bsr_shape<T, 3, 3>(x, row_ptr, col, blk, y, NR_pad, NC_pad, log2_lanes, round_bf16, s);
  } else if (br == 3 && bc == 6) {
    launch_bsr_shape<T, 3, 6>(x, row_ptr, col, blk, y, NR_pad, NC_pad, log2_lanes, round_bf16, s);
  } else if (br == 6 && bc == 3) {
    launch_bsr_shape<T, 6, 3>(x, row_ptr, col, blk, y, NR_pad, NC_pad, log2_lanes, round_bf16, s);
  } else if (br == 6 && bc == 6) {
    launch_bsr_shape<T, 6, 6>(x, row_ptr, col, blk, y, NR_pad, NC_pad, log2_lanes, round_bf16, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t.
// Each returns cudaGetLastError() after its launch.
extern "C" int fct_window_gather_f32(const void* u, const void* loc, void* out, int K,
                                     int B, int Rn, int tile, int M_pad, void* stream) {
  return launch_gather<float>(u, loc, out, K, B, Rn, tile, M_pad, stream);
}

extern "C" int fct_window_gather_f64(const void* u, const void* loc, void* out, int K,
                                     int B, int Rn, int tile, int M_pad, void* stream) {
  return launch_gather<double>(u, loc, out, K, B, Rn, tile, M_pad, stream);
}

extern "C" int fct_window_scatter_f32(const void* f, const void* node_ptr,
                                      const void* node_rows, void* out, int K, int Rn,
                                      int M_pad, void* stream) {
  return launch_scatter<float>(f, node_ptr, node_rows, out, K, Rn, M_pad, stream);
}

extern "C" int fct_window_scatter_f64(const void* f, const void* node_ptr,
                                      const void* node_rows, void* out, int K, int Rn,
                                      int M_pad, void* stream) {
  return launch_scatter<double>(f, node_ptr, node_rows, out, K, Rn, M_pad, stream);
}

// K7 on C_pad = B*C_B cell slots; mandel is the FULL Mandel map [6, 3, 3].
extern "C" int fct_window_cell_apply_f32(const void* u, const void* loc, const void* dN,
                                         const void* w, const void* beta, const void* gamma,
                                         const void* nf, const void* coef, const void* mandel,
                                         void* f, int C_B, int B, int tile, int M_pad, int n_qp,
                                         int beta_stride, int gamma_stride, int n_comp_stride,
                                         int n_qp_stride, void* stream) {
  return launch_cell_apply<float>(u, loc, dN, w, beta, gamma, nf, coef, mandel, f, C_B, B, tile,
                                  M_pad, n_qp, beta_stride, gamma_stride, n_comp_stride,
                                  n_qp_stride, stream);
}

extern "C" int fct_window_cell_apply_f64(const void* u, const void* loc, const void* dN,
                                         const void* w, const void* beta, const void* gamma,
                                         const void* nf, const void* coef, const void* mandel,
                                         void* f, int C_B, int B, int tile, int M_pad, int n_qp,
                                         int beta_stride, int gamma_stride, int n_comp_stride,
                                         int n_qp_stride, void* stream) {
  return launch_cell_apply<double>(u, loc, dN, w, beta, gamma, nf, coef, mandel, f, C_B, B,
                                   tile, M_pad, n_qp, beta_stride, gamma_stride, n_comp_stride,
                                   n_qp_stride, stream);
}

// (br, bc) must be one of (3, 3), (3, 6), (6, 3), (6, 6) and lanes =
// 2^log2_lanes at most 32; otherwise cudaErrorInvalidValue is returned and
// nothing is launched. ``round_bf16`` is read by the float32 entry point only.
extern "C" int fct_window_bsr_f32(const void* x, const void* row_ptr, const void* col,
                                  const void* blk, void* y, int br, int bc, int NR_pad,
                                  int NC_pad, int log2_lanes, int round_bf16, void* stream) {
  return launch_bsr<float>(x, row_ptr, col, blk, y, br, bc, NR_pad, NC_pad, log2_lanes,
                           round_bf16, stream);
}

extern "C" int fct_window_bsr_f64(const void* x, const void* row_ptr, const void* col,
                                  const void* blk, void* y, int br, int bc, int NR_pad,
                                  int NC_pad, int log2_lanes, int round_bf16, void* stream) {
  return launch_bsr<double>(x, row_ptr, col, blk, y, br, bc, NR_pad, NC_pad, log2_lanes,
                            round_bf16, stream);
}
