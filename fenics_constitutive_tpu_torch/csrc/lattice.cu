// K8: the CG operator of the degree-2 lattice engine (27-node hexes, 3 x 3 x
// 3 Gauss points, the FULL constraint) in one cooperative launch:
// r = A u, the element gather, the strain at the 27 Gauss points, the
// factored tangent sigma = (kappa - beta/3) tr(e) I + beta e + gamma (n.e) n,
// the weighted divergence and the node sums.
//
// Replaces no TPU kernel: it is LatticeGeometry.matvec_gm, which the JAX
// package runs as XLA-fused array ops (strided slices, two products with
// KEPS_c and KDIV_c, the tangent's elementwise ops, the slice adds) and the
// port ran as some 40 PyTorch ops that wrote [81, C], [162, C] and [6, 27, C]
// intermediates. Its plain twin is ops/cuda_lattice.py::lattice_apply_plain.
//
// Layouts (row-major, the flat minor axis last):
//   u, r              [3, L0, L1, L2]   grid-major dof vectors, Lk = 2 gk + 1
//   QP field of k     [k, 27, C]        f[(s*27 + q)*C + cell], q = 9 p0 + 3 p1 + p2,
//                                       cell = (c0 g1 + c1) g2 + c2
//   a uniform entry   k values, QP stride 0 (beta, gamma: a slot of coef)
//   coef              [3]               kappa, and beta, gamma where uniform
// Local node a = o0 + 3 o1 + 9 o2 of cell c sits at lattice (2 c0 + o0,
// 2 c1 + o1, 2 c2 + o2).
//
// What bounds it on the H100: bytes. An apply reads u (3 M values), n, beta
// and gamma (8 x 27 values a cell) and writes r (3 M): ~70 MB in float64
// on the 32^3 box, 20.8 us at 3.35 TB/s; 80% of it is the tangent, so each
// Gauss point's tangent is read once, by one thread, with neighbouring
// threads on neighbouring cells.
//
// Design. The gradients of the uniform box factor into 1-D tables at the 3
// Gauss points, B[p][o] = phi_o(xi_p) and D_k[p][o] = phi_o'(xi_p) / h_k,
// so the strain and the divergence are sum-factorised: three contractions
// of 3 x 3 each way instead of the 27 x 27 products (~5k multiply-adds a
// cell, ~10 us of the f64 pipe, under the byte bound; the dense form is
// ~13k). A block owns a brick of cells (b0 x b1 x b2, b2 <= 32) and takes
// one row of it at a time: 32 consecutive cells along axis 2, one a lane,
// and 9 warps, each warp in one role a stage:
//   A  (o0, o1): u[o0][o1][o2] -> TB, TD = sum_o2 B|D2[p2][o2] u   (in a row,
//                each node is read by the cells around it, from L1/L2)
//   B  (o0, p2): -> BB, DB, BD = sum_o1 B|D1|B[p1][o1] TB|TB|TD
//   C  (p1, p2): per p0, H[i][j] = sum_o0 D0|B|B[p0][o0] BB|DB|BD, the
//                Mandel strain, the tangent (8 values of the Gauss point,
//                loaded before stage A), G = w M^T sigma; then
//                S0|S1|S2 = sum_p0 D0|B|B[p0][o0] G[0|1|2][j]
//   BT (o0, p2): Ra = sum_p1 B[p1][o1] S0 + D1[p1][o1] S1, Rb = sum B S2
//   AT (o0, o1): f[o0][o1][o2] = sum_p2 B[p2][o2] Ra + D2[p2][o2] Rb.
// Each stage's values lie in shared memory in 9 columns (o0, p2) of 27
// slots a cell, [slot][lane], and each stage writes in place what only it
// reads next: 243 values a cell, no [81, C] or [6, 27, C] array in device
// memory. The 27 node forces of each cell are added into the brick's node
// lattice in shared memory, o2 = 0, 1 first and o2 = 2 after a barrier, so
// the two cells of a row that share a node never add at once, rows in a
// fixed order.
// Node sums across bricks: a node on a plane that two bricks share goes to
// a face buffer [brick][3][brick lattice] instead of r; after a grid-wide
// barrier each such node sums its 2, 4 or 8 bricks' values in brick order
// into r. That costs a write and a read of the bricks' face nodes, 53% of
// their lattices at 4 x 2 x 32 (float64: 3.7 MB each way at 32^3) and 64%
// at 2 x 2 x 32 (float32: 3.2 MB), mostly from L2; the barrier and the sums
// took ~8 us of the float64 apply at 2 x 2 (H100). No atomics: two launches
// are bit-equal.
// Bricks (ops/cuda_lattice.py::lattice_brick): in float64 one block an SM
// (168 registers a thread, 116 bytes of spill stores) on 4 x 2
// bricks, whose node lattice shares fewer planes; in float32 three blocks an
// SM on 2 x 2. On the H100 at 32^3 these took 0.073 ms (float64, against
// 0.094 for two blocks an SM on 2 x 2) and 0.043 ms (float32). Loading the
// next row a row ahead did not help, into registers (float64 0.085-0.110
// ms, float32 0.049-0.052: the registers spill) or into shared memory by
// cp.async (0.087-0.089, 0.057-0.064: a barrier more a row): the rows'
// stages and barriers, not the loads' latency, hold the kernel.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fct;

constexpr int kLanes = 32;                       // cells of a row segment
constexpr int kRoles = 9;                        // warps: one role a stage
constexpr int kThreadsLattice = kLanes * kRoles;  // 288
constexpr int kCol = 27;                         // slots of a column
constexpr int kSlots = kRoles * kCol;            // 243 values a cell
constexpr int kTabValues = 64;                   // B 9, D 27, w 27, c 1
// blocks per SM the register budget is set for: in float64 one, 168
// registers a thread (two give 96 and spill 368 bytes a thread), in float32
// three (72 registers)
template <typename T>
constexpr int kMinBlocksLattice = sizeof(T) == 4 ? 3 : 1;

template <typename T>
struct Tab {
  T B[3][3];     // B[p][o] = phi_o(xi_p)
  T D[3][3][3];  // D[k][p][o] = phi_o'(xi_p) / h_k
  T w[27];       // quadrature weight x |det J| at q = 9 p0 + 3 p1 + p2
  T c;           // Mandel shear factor
};

struct Dims {
  int g0, g1, g2;     // cells along each axis
  int L1, L2, M, C;   // lattice nodes along axes 1, 2; nodes; cells
  int b0, b1, b2;     // cells of a brick
  int nb0, nb1, nb2;  // bricks along each axis
  int beta_qs, gamma_qs, n_ks, n_qs;  // tangent strides: QP and component
};

// value of column col, slot s, lane of a row in the stage buffer
template <typename T>
__device__ __forceinline__ T& at(T* Y, int col, int s, int lane) {
  return Y[(col * kCol + s) * kLanes + lane];
}

// Along one axis, the bricks that hold lattice node n: one, or two where n
// lies on a plane two bricks share (lower brick first), with the node's
// local index in each.
__device__ __forceinline__ int bricks_of(int n, int b, int nb, int (&bk)[2], int (&lk)[2]) {
  int k = n / (2 * b);
  if (k >= nb) k = nb - 1;
  const int l = n - 2 * b * k;
  if (l == 0 && k > 0) {
    bk[0] = k - 1;
    lk[0] = 2 * b;
    bk[1] = k;
    lk[1] = 0;
    return 2;
  }
  bk[0] = k;
  lk[0] = l;
  return 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsLattice, kMinBlocksLattice<T>)
lattice_apply_kernel(const T* __restrict__ u, const T* __restrict__ beta,
                     const T* __restrict__ gamma, const T* __restrict__ nf,
                     const T* __restrict__ coef, T* __restrict__ r, T* __restrict__ face,
                     const Tab<T> tab, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Y = reinterpret_cast<T*>(smem_raw);  // [kSlots][kLanes]
  T* F = Y + kSlots * kLanes;             // [3][F0][F1][F2], the brick's nodes
  const int F0 = 2 * d.b0 + 1, F1 = 2 * d.b1 + 1, F2 = 2 * d.b2 + 1;
  const int FL = F0 * F1 * F2;
  const int role = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int ra = role / 3, rb = role % 3;  // the role's two indices
  const int plane = d.L1 * d.L2;
  const T kappa = coef[0];
  const int n_bricks = d.nb0 * d.nb1 * d.nb2;
  // the weights of the stage-C Gauss points q = 9 p0 + role, picked with
  // constant indices (a parameter indexed at run time would go to the stack)
  T wq[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int t = 0; t < kRoles; ++t) {
    if (role == t) {
#pragma unroll
      for (int p0 = 0; p0 < 3; ++p0) wq[p0] = tab.w[p0 * 9 + t];
    }
  }

  for (int b = blockIdx.x; b < n_bricks; b += gridDim.x) {
    const int bz = b % d.nb2, by = (b / d.nb2) % d.nb1, bx = b / (d.nb2 * d.nb1);
    const int x0 = bx * d.b0, y0 = by * d.b1, z0 = bz * d.b2;
    const int nx = min(d.b0, d.g0 - x0), ny = min(d.b1, d.g1 - y0), nz = min(d.b2, d.g2 - z0);
    for (int i = threadIdx.x; i < 3 * FL; i += blockDim.x) F[i] = T(0);
    __syncthreads();

    for (int row = 0; row < nx * ny; ++row) {
      const int cx = x0 + row / ny, cy = y0 + row % ny, cz = z0 + lane;
      const bool active = lane < nz;
      const int cell = (cx * d.g1 + cy) * d.g2 + cz;

      // the tangent of this thread's stage-C Gauss points (p1, p2) = (ra,
      // rb), p0 = 0..2, loaded first so that its latency hides behind A, B
      T tn[3][6], tb[3], tg[3];
      if (active) {
#pragma unroll
        for (int p0 = 0; p0 < 3; ++p0) {
          const int idx = (p0 * 9 + ra * 3 + rb) * d.C + cell;
          tb[p0] = __ldg(beta + idx * d.beta_qs);
          tg[p0] = __ldg(gamma + idx * d.gamma_qs);
#pragma unroll
          for (int k = 0; k < 6; ++k) tn[p0][k] = __ldg(nf + k * d.n_ks + idx * d.n_qs);
        }
      }

      // A (o0, o1) = (ra, rb): contract o2; TB, TD to columns (o0, p2)
      if (active) {
        const T* up = u + (2 * cx + ra) * plane + (2 * cy + rb) * d.L2 + 2 * cz;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T u0 = __ldg(up + j * d.M), u1 = __ldg(up + j * d.M + 1),
                  u2 = __ldg(up + j * d.M + 2);
#pragma unroll
          for (int p2 = 0; p2 < 3; ++p2) {
            at(Y, ra * 3 + p2, (rb * 3 + j) * 2, lane) =
                tab.B[p2][0] * u0 + tab.B[p2][1] * u1 + tab.B[p2][2] * u2;
            at(Y, ra * 3 + p2, (rb * 3 + j) * 2 + 1, lane) =
                tab.D[2][p2][0] * u0 + tab.D[2][p2][1] * u1 + tab.D[2][p2][2] * u2;
          }
        }
      }
      __syncthreads();

      // B (o0, p2) = (ra, rb), column `role`: contract o1
      if (active) {
        T X[3][3][2];
#pragma unroll
        for (int o1 = 0; o1 < 3; ++o1) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            X[o1][j][0] = at(Y, role, (o1 * 3 + j) * 2, lane);
            X[o1][j][1] = at(Y, role, (o1 * 3 + j) * 2 + 1, lane);
          }
        }
#pragma unroll
        for (int p1 = 0; p1 < 3; ++p1) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            T bb = T(0), db = T(0), bd = T(0);
#pragma unroll
            for (int o1 = 0; o1 < 3; ++o1) {
              bb += tab.B[p1][o1] * X[o1][j][0];
              db += tab.D[1][p1][o1] * X[o1][j][0];
              bd += tab.B[p1][o1] * X[o1][j][1];
            }
            at(Y, role, p1 * 9 + j * 3, lane) = bb;
            at(Y, role, p1 * 9 + j * 3 + 1, lane) = db;
            at(Y, role, p1 * 9 + j * 3 + 2, lane) = bd;
          }
        }
      }
      __syncthreads();

      // C (p1, p2) = (ra, rb): contract o0 per Gauss point, the tangent,
      // then the transposed contraction over p0, in place
      if (active) {
        const T c = tab.c;
        T G[3][6];
#pragma unroll
        for (int p0 = 0; p0 < 3; ++p0) {
          T H[3][3];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            T h0 = T(0), h1 = T(0), h2 = T(0);
#pragma unroll
            for (int o0 = 0; o0 < 3; ++o0) {
              const int col = o0 * 3 + rb, s = ra * 9 + j * 3;
              h0 += tab.D[0][p0][o0] * at(Y, col, s, lane);
              h1 += tab.B[p0][o0] * at(Y, col, s + 1, lane);
              h2 += tab.B[p0][o0] * at(Y, col, s + 2, lane);
            }
            H[0][j] = h0;
            H[1][j] = h1;
            H[2][j] = h2;
          }
          const T e[6] = {H[0][0], H[1][1], H[2][2], c * (H[0][1] + H[1][0]),
                          c * (H[0][2] + H[2][0]), c * (H[1][2] + H[2][1])};
          T nde = T(0);
#pragma unroll
          for (int k = 0; k < 6; ++k) nde += tn[p0][k] * e[k];
          const T bt = tb[p0], gn = tg[p0] * nde;
          const T corr = (kappa - bt / T(3)) * (e[0] + e[1] + e[2]);
          T sig[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) sig[k] = bt * e[k] + gn * tn[p0][k];
          sig[0] += corr;
          sig[1] += corr;
          sig[2] += corr;
          const T w = wq[p0], wc = w * c;
          G[p0][0] = w * sig[0];   // G00
          G[p0][1] = w * sig[1];   // G11
          G[p0][2] = w * sig[2];   // G22
          G[p0][3] = wc * sig[3];  // G01
          G[p0][4] = wc * sig[4];  // G02
          G[p0][5] = wc * sig[5];  // G12
        }
#pragma unroll
        for (int o0 = 0; o0 < 3; ++o0) {
          const int col = o0 * 3 + rb;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            // G[i][j] from the 6 symmetric values: row 0 (00 01 02),
            // row 1 (01 11 12), row 2 (02 12 22)
            const int g0 = j == 0 ? 0 : (j == 1 ? 3 : 4);
            const int g1 = j == 0 ? 3 : (j == 1 ? 1 : 5);
            const int g2 = j == 0 ? 4 : (j == 1 ? 5 : 2);
            T s0 = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
            for (int p0 = 0; p0 < 3; ++p0) {
              s0 += tab.D[0][p0][o0] * G[p0][g0];
              s1 += tab.B[p0][o0] * G[p0][g1];
              s2 += tab.B[p0][o0] * G[p0][g2];
            }
            const int s = ra * 9 + j * 3;
            at(Y, col, s, lane) = s0;
            at(Y, col, s + 1, lane) = s1;
            at(Y, col, s + 2, lane) = s2;
          }
        }
      }
      __syncthreads();

      // BT (o0, p2) = (ra, rb), column `role`: contract p1 into o1, in place
      // per component
      if (active) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T S[3][3];
#pragma unroll
          for (int p1 = 0; p1 < 3; ++p1) {
#pragma unroll
            for (int k = 0; k < 3; ++k) S[p1][k] = at(Y, role, p1 * 9 + j * 3 + k, lane);
          }
#pragma unroll
          for (int o1 = 0; o1 < 3; ++o1) {
            T ra_ = T(0), rb_ = T(0);
#pragma unroll
            for (int p1 = 0; p1 < 3; ++p1) {
              ra_ += tab.B[p1][o1] * S[p1][0] + tab.D[1][p1][o1] * S[p1][1];
              rb_ += tab.B[p1][o1] * S[p1][2];
            }
            at(Y, role, o1 * 9 + j * 3, lane) = ra_;
            at(Y, role, o1 * 9 + j * 3 + 1, lane) = rb_;
          }
        }
      }
      __syncthreads();

      // AT (o0, o1) = (ra, rb): contract p2 into o2; the cell's 9 forces of
      // this thread's (o0, o1) line
      T f[3][3];
      if (active) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          T Ra[3], Rb[3];
#pragma unroll
          for (int p2 = 0; p2 < 3; ++p2) {
            Ra[p2] = at(Y, ra * 3 + p2, rb * 9 + j * 3, lane);
            Rb[p2] = at(Y, ra * 3 + p2, rb * 9 + j * 3 + 1, lane);
          }
#pragma unroll
          for (int o2 = 0; o2 < 3; ++o2) {
            T acc = T(0);
#pragma unroll
            for (int p2 = 0; p2 < 3; ++p2) {
              acc += tab.B[p2][o2] * Ra[p2] + tab.D[2][p2][o2] * Rb[p2];
            }
            f[o2][j] = acc;
          }
        }
      }
      // into the brick's lattice: o2 = 0, 1 (no two cells share them), then
      // o2 = 2 (the next cell's o2 = 0), rows in order
      const int base = ((2 * (cx - x0) + ra) * F1 + 2 * (cy - y0) + rb) * F2 + 2 * lane;
      if (active) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          F[j * FL + base] += f[0][j];
          F[j * FL + base + 1] += f[1][j];
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int j = 0; j < 3; ++j) F[j * FL + base + 2] += f[2][j];
      }
      // the next row writes the stage buffer only after every thread has
      // passed the barrier above, its reads done; F again after four more
    }
    __syncthreads();

    // the brick's nodes: those no other brick holds go to r, the others to
    // the face buffer
    for (int i = threadIdx.x; i < 3 * FL; i += blockDim.x) {
      const int l2 = i % F2, l1 = (i / F2) % F1, l0 = (i / (F2 * F1)) % F0, j = i / FL;
      if (l0 > 2 * nx || l1 > 2 * ny || l2 > 2 * nz) continue;
      const bool shared = (l0 == 0 && bx > 0) || (l0 == 2 * nx && bx < d.nb0 - 1) ||
                          (l1 == 0 && by > 0) || (l1 == 2 * ny && by < d.nb1 - 1) ||
                          (l2 == 0 && bz > 0) || (l2 == 2 * nz && bz < d.nb2 - 1);
      if (shared) {
        face[b * 3 * FL + i] = F[i];
      } else {
        r[j * d.M + (2 * x0 + l0) * plane + (2 * y0 + l1) * d.L2 + 2 * z0 + l2] = F[i];
      }
    }
    __syncthreads();  // F is zeroed for the next brick
  }

  cg::this_grid().sync();

  // the shared nodes: each sums its bricks' values in brick order
  for (int n = blockIdx.x * blockDim.x + threadIdx.x; n < d.M; n += gridDim.x * blockDim.x) {
    const int n2 = n % d.L2, n1 = (n / d.L2) % d.L1, n0 = n / plane;
    int b0[2], l0[2], b1[2], l1[2], b2[2], l2[2];
    const int k0 = bricks_of(n0, d.b0, d.nb0, b0, l0);
    const int k1 = bricks_of(n1, d.b1, d.nb1, b1, l1);
    const int k2 = bricks_of(n2, d.b2, d.nb2, b2, l2);
    if (k0 * k1 * k2 == 1) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = T(0);
      for (int i0 = 0; i0 < k0; ++i0) {
        for (int i1 = 0; i1 < k1; ++i1) {
          for (int i2 = 0; i2 < k2; ++i2) {
            const int bi = (b0[i0] * d.nb1 + b1[i1]) * d.nb2 + b2[i2];
            acc += face[(bi * 3 + j) * FL + (l0[i0] * F1 + l1[i1]) * F2 + l2[i2]];
          }
        }
      }
      r[j * d.M + n] = acc;
    }
  }
}

template <typename T>
int launch(const void* u, const void* beta, const void* gamma, const void* nf, const void* coef,
           void* r, void* face, const double* tab_host, int g0, int g1, int g2, int b0, int b1,
           int b2, int beta_qs, int gamma_qs, int n_ks, int n_qs, void* stream) {
  if (g0 < 1 || g1 < 1 || g2 < 1 || b0 < 1 || b1 < 1 || b2 < 1 || b2 > kLanes || b0 > g0 ||
      b1 > g1 || b2 > g2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tab<T> tab;
  const double* t = tab_host;
  for (int p = 0; p < 3; ++p) {
    for (int o = 0; o < 3; ++o) tab.B[p][o] = static_cast<T>(t[p * 3 + o]);
  }
  for (int k = 0; k < 3; ++k) {
    for (int p = 0; p < 3; ++p) {
      for (int o = 0; o < 3; ++o) tab.D[k][p][o] = static_cast<T>(t[9 + (k * 3 + p) * 3 + o]);
    }
  }
  for (int q = 0; q < 27; ++q) tab.w[q] = static_cast<T>(t[36 + q]);
  tab.c = static_cast<T>(t[kTabValues - 1]);

  Dims d;
  d.g0 = g0;
  d.g1 = g1;
  d.g2 = g2;
  d.L1 = 2 * g1 + 1;
  d.L2 = 2 * g2 + 1;
  d.M = (2 * g0 + 1) * d.L1 * d.L2;
  d.C = g0 * g1 * g2;
  d.b0 = b0;
  d.b1 = b1;
  d.b2 = b2;
  d.nb0 = (g0 + b0 - 1) / b0;
  d.nb1 = (g1 + b1 - 1) / b1;
  d.nb2 = (g2 + b2 - 1) / b2;
  d.beta_qs = beta_qs;
  d.gamma_qs = gamma_qs;
  d.n_ks = n_ks;
  d.n_qs = n_qs;

  // the stage buffer and the brick's node lattice: 132.3 KB in float64 at
  // 4 x 2 x 32, 50.6 KB in float32 at 2 x 2 x 32
  const size_t bytes =
      (static_cast<size_t>(kSlots) * kLanes + 3 * static_cast<size_t>(2 * b0 + 1) * (2 * b1 + 1) *
                                                   (2 * b2 + 1)) * sizeof(T);
  static size_t opted[kMaxDevices] = {};
  cudaError_t e = opt_in_smem(lattice_apply_kernel<T>, bytes, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int cap[kMaxDevices] = {};
  static size_t cap_bytes[kMaxDevices] = {};
  if (cap_bytes[dev] != bytes) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lattice_apply_kernel<T>,
                                                      kThreadsLattice, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    cap[dev] = per_sm * sms;
    cap_bytes[dev] = bytes;
  }
  int blocks = d.nb0 * d.nb1 * d.nb2;
  if (blocks > cap[dev]) blocks = cap[dev];
  const T* up = static_cast<const T*>(u);
  const T* bp = static_cast<const T*>(beta);
  const T* gp = static_cast<const T*>(gamma);
  const T* np = static_cast<const T*>(nf);
  const T* cp = static_cast<const T*>(coef);
  T* rp = static_cast<T*>(r);
  T* fp = static_cast<T*>(face);
  void* params[] = {&up, &bp, &gp, &np, &cp, &rp, &fp, &tab, &d};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lattice_apply_kernel<T>),
                                  dim3(blocks), dim3(kThreadsLattice), params, bytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer but ``tab`` is a device pointer, ``stream`` a
// cudaStream_t. On the box of g0 x g1 x g2 cells: u, r [3, M] grid-major
// (M = (2 g0 + 1)(2 g1 + 1)(2 g2 + 1)); the tangent's n, beta, gamma read as
// x[k * ks + (q * C + cell) * qs] (a field: ks = 27 C, qs = 1; a uniform
// entry: ks = 1, qs = 0); coef = (kappa, beta, gamma); face the buffer of
// the bricks' shared nodes, 3 (2 b0 + 1)(2 b1 + 1)(2 b2 + 1) values a brick of
// b0 x b1 x b2 cells (b2 <= 32); ``tab`` 64 host doubles: B [3][3], D
// [3][3][3], w [27], c. Returns cudaGetLastError() (or the launch's, the
// occupancy query's or the opt-in's error) after the one launch.
#define FCT_LATTICE_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* u, const void* beta, const void* gamma, const void* nf,  \
                      const void* coef, void* r, void* face, const double* tab, int g0,     \
                      int g1, int g2, int b0, int b1, int b2, int beta_qs, int gamma_qs,    \
                      int n_ks, int n_qs, void* stream) {                                   \
    return launch<T>(u, beta, gamma, nf, coef, r, face, tab, g0, g1, g2, b0, b1, b2,        \
                     beta_qs, gamma_qs, n_ks, n_qs, stream);                                \
  }

FCT_LATTICE_ENTRY(fct_lattice_apply_f32, float)
FCT_LATTICE_ENTRY(fct_lattice_apply_f64, double)
