// Damped-Jacobi smoothing chains of the multigrid levels (structured hex and
// quad grids), with the V-cycle's transfers fused in.
//
// Replaces the TPU kernel fenics_constitutive_tpu/ops/pallas_smoother.py::
// build_fused_smoother. A level's chain is nu sweeps
//   x <- x + inv_d * (b - A x)
// of the constant-coefficient elastic operator A, optionally followed by the
// free-masked residual r = [inv_d != 0] * (b - A x). A is applied per cell
// origin c with the constant element matrix Ke [24, 24] (3D: 8 corners, 3
// components; 2D: [8, 8], 4 corners, 2 components) on the masked corner dofs
// and summed onto the nodes:
//   (A x)[j, n] = sum_a sum_{col} Ke[a*vs+j, col] * mask[c] * x[col @ c],
//   c = n - off_a, cells outside the cell grid contributing nothing.
// Every kernel is a template on the dimension D (3: hex levels, 2: quad
// levels); the 2D instances are the same code on a 9-point stencil of 2 x 2
// blocks and 3^2 transfer weights, entered through the *_2d_* symbols.
// b is read masked, [inv_d != 0] * b (inv_d is zero exactly at the Dirichlet
// dofs), so no caller masks it first.
//
// Design. The TPU kept a level's whole iterate in VMEM and ran a chain in one
// kernel, and XLA fused the transfers between the chains. On the H100 one
// fused V-cycle takes a handful of launches:
//
// * chain_kernel, one COOPERATIVE launch per chain on the fine levels
//   (cudaLaunchCooperativeKernel, a persistent grid of at most the blocks the
//   SMs hold at once, from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
//   every phase loops over the nodes). A sweep must see the whole previous
//   iterate, so the phases are separated by cg::this_grid().sync(), with two
//   ping-pong buffers in global memory (L2-resident: 1.6 MB at 51^3 in
//   float32). The same launch starts a post-chain with the prolongation of
//   the coarse correction, masked and added (x0 = x + [free] P xc), and ends
//   a pre-chain with the residual and its restriction R = P^T to the next
//   level's right-hand side. A grid that the card cannot hold at once is
//   refused by the launch (cudaErrorCooperativeLaunchTooLarge), never split.
// * tail_kernel, ONE BLOCK of 512 threads for the coarse levels from the
//   tail's first level down, as the TPU did with VMEM: the pre-chains and
//   restrictions, the dense coarse solve (coarse_inv from L2, one warp per
//   row, four rows at a time, a fixed xor-shuffle sum) or the coarse chain,
//   the prolongations and the post-chains, with __syncthreads() between the
//   phases. Every tail level's stencils (27 x 252 values on a box) and its x,
//   b and a scratch vector (3 x 3 M_l values) sit in dynamic shared memory;
//   inv_d and the masks are read from global memory (L1). On the 50^3
//   hierarchy (node grids 51/26/13/7/4) the levels 13^3, 7^3 and 4^3 take
//   3 x 27 x 252 + 9 x (2197 + 343 + 64) values: 171.3 KB in float32, under
//   the 227 KB a block may hold, so the tail starts at level 2 (5 launches per
//   V-cycle); in float64 that is 342.6 KB, so the tail starts at level 3
//   (134.9 KB; 7 launches). The level where the tail starts is computed by
//   the wrapper from the level sizes, the patterns, the type and
//   fct_smem_optin(); a tail that does not fit raises there. The level table
//   (views and places in shared memory) is one copy per block in shared
//   memory: per-thread arrays indexed by level spilled to local memory.
//
// Sweeps. Each node applies A as the 27-point stencil of 3 x 3 blocks of its
// pattern, the set of its 8 cells that exist with mask 1: a box has 27
// patterns (interior, faces, edges, corners), assembled from Ke on the host
// in float64, so every node runs the same code, 81 loads and 243
// multiply-adds, against 192 and 576 for the 8-cell gather. (2D: the
// 9-point stencil of 2 x 2 blocks of its 4 cells, 9 patterns on a box, 18
// loads and 36 multiply-adds.) (The wrapper
// takes cell masks of 0 and 1 only, the validity masks the engine builds.)
// Every sum is taken in a fixed order by the thread that owns the node: no
// atomics, and two launches are bit-equal. A stencil phase (a sweep or the
// residual) runs one of two ways, chosen on the host per level
// (ops/cuda_smoother.py::brick_plan) and passed as FctChain::run, p1, p2:
//
// * one node a thread (chain_kernel<T, D, 0>, every 2D level and the small
//   3D ones): the node's 27 neighbours a component are loaded from global
//   memory together, the coefficients read from the stencils in shared
//   memory 16 bytes at a time;
// * on bricks (chain_kernel<T, 3, kBrickRun>, a 3D level that gives every SM
//   at least 4 warps of runs: the 51^3 and 65^3 fine levels): runs of 4
//   nodes along axis 0 over the planes 1 .. n0 - 2 and of one node on the
//   planes 0 and n0 - 1 (so that the nodes of a run share their pattern on a
//   box), over tiles of columns; a block walks over its bricks, stages the
//   brick's x with its one-node halo and its b and inv_d into shared memory
//   (cp.async, 8 or 4 bytes a copy: a row of 51 or 65 values is not 16-byte
//   aligned, so neither 16-byte copies nor a TMA tensor map line up with
//   it), and each thread slides down its run: each component's 3 x 3
//   neighbour columns of 6 planes are read once for the 4 nodes, and each
//   coefficient (read through L1) once for the 4 nodes; a node of another
//   pattern than its run's middle node (a level with masked cells) is
//   applied again by its own stencil. The sums run k, d1, d2, d0 per node,
//   another order than one node a thread's (within the tolerances of the
//   plain twin).
//
// What bounds it on the H100: a chain moves ~13 values per node (~7 MB at
// 51^3 in float32) and does 243 multiply-adds per node per apply, so its
// bound is arithmetic (67 TFLOP/s float32, 34 float64): 1.9 us for an apply
// at 51^3 in float64, 4.0 us at 65^3. What binds it is latency. One node a
// thread holds 64 registers (4 blocks of 256 an SM) and spills in both
// types (float64: 476 bytes stored, 572 loaded a thread); an apply (a sweep
// and its grid sync) takes ~19-21 us at 51^3 in float64, ~49-50 at 65^3. On
// bricks (128 registers, no spill) ~12.5-13.5 us and ~28-29 us: a 51^3
// brick spends ~2.5 us staging, ~5.4 us in the stencil (at ~40% of the
// float64 pipe, 2 bricks an SM), ~1.1 us writing back, and the phase ~1.3
// us in its grid sync; at 65^3 the runs fill the SMs twice at 128
// registers, so the bricks go in two rounds. Each level below runs at ~4-7
// us a phase whether it holds 2 or 519 blocks (a grid sync and one node's
// latency), and the tail on one SM. The tensor cores (DMMA, wgmma) are
// later work.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// one multigrid level's constant data (device pointers)
struct FctLevel {
  const void* invd;  // [vs, M] damped inverse diagonal, 0 at Dirichlet dofs
  const void* pid;   // [M] uint8: the node's pattern of cells
  const void* st;    // [patterns][vs][stencil] stencils ([k][d][j], padded)
  int n0, n1, n2;    // node grid, n = (i0 * n1 + i1) * n2 + i2 (2D: n2 = 1)
  int nu;            // sweeps of the level's chains
  int n_pat;         // patterns in st
};

// one chain launch on a fine level
struct FctChain {
  FctLevel lv;
  const void* x;   // [vs, M] start iterate (not read with zero_start)
  const void* b;   // [vs, M] right-hand side
  const void* xc;  // [vs, Mc] coarse correction (with prolong)
  void* xout;      // [vs, M] the chain's result
  void* tmp;       // [vs, M] ping-pong scratch (with 2 or more writes)
  void* r;         // [vs, M] the residual (with residual)
  void* bc;        // [vs, Mc] its restriction (with restrict_to)
  int c0, c1, c2;  // coarse node grid (2D: c2 = 1)
  int zero_start, residual, prolong, restrict_to;
  int run;         // stencil phases on bricks with runs of `run` nodes a thread, or 0
  int p1, p2;      // the bricks' tiles along axes 1 and 2 (with run)
};

constexpr int kMaxTail = 8;

// the one-block tail: levels lv[0] (its first level) .. lv[n_levels - 1]
struct FctTail {
  FctLevel lv[kMaxTail];
  int n_levels;
  const void* coarse_inv;  // [N, N], N = vs M of the coarsest level, or null
  const void* b;           // [vs, M] right-hand side of the first level
  void* xout;              // [vs, M] its V-cycle result
};

namespace {

// the sizes of a level of dimension D
template <int D>
struct Dim;
template <>
struct Dim<3> {
  static constexpr int kVs = fct::kVs;  // components
  static constexpr int kNb = 27;        // stencil neighbours
  static constexpr int kStencilK = 84;  // one component's [27][3] values, padded
};
template <>
struct Dim<2> {
  static constexpr int kVs = 2;
  static constexpr int kNb = 9;
  static constexpr int kStencilK = 20;  // one component's [9][2] values, padded
};
// one pattern's stencil (a multiple of 16 bytes in either type)
template <int D>
constexpr int kStencilValues = Dim<D>::kVs * Dim<D>::kStencilK;

// 16-byte vectors of the working type, for the stencils' coefficients
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

constexpr int kChainThreads = 256;
constexpr int kTailThreads = 512;
// a chain on bricks: at most this many threads a block, and the blocks an SM
// must hold at once by registers (so at most 128 registers a thread)
constexpr int kBrickThreads = 256;
constexpr int kBrickBlocks = 2;
constexpr int kBrickRun = 4;  // nodes a thread takes along axis 0 on bricks

template <typename T>
struct Lv {
  const T* invd;
  const unsigned char* pid;
  int n0, n1, n2, M, nu;
};

template <typename T>
__device__ __forceinline__ Lv<T> view(const FctLevel& l) {
  return {static_cast<const T*>(l.invd), static_cast<const unsigned char*>(l.pid), l.n0, l.n1,
          l.n2, l.n0 * l.n1 * l.n2, l.nu};
}

// node n -> its grid coordinates (i0, i1, i2), the last axis fastest (2D:
// (i0, i1) on the grid n0 x n1, i2 = 0)
template <int D>
__device__ __forceinline__ void coords(int n, int n1, int n2, int& i0, int& i1, int& i2) {
  if constexpr (D == 3) {
    const int s0 = n1 * n2;
    i0 = n / s0;
    const int rem = n - i0 * s0;
    i1 = rem / n2;
    i2 = rem - i1 * n2;
  } else {
    i0 = n / n1;
    i1 = n - i0 * n1;
    i2 = 0;
  }
}

// acc[j] += sum_d c[k][d][j] v[d] for one component k: the coefficients
// q = d * vs + j of c (st[p] + k * kStencilK, 16-byte aligned) are read 16
// bytes at a time
template <typename T, int D>
__device__ __forceinline__ void stencil_madd(const T* ck_, const T (&v)[Dim<D>::kNb],
                                             T (&acc)[Dim<D>::kVs]) {
  constexpr int kVs = Dim<D>::kVs, kNb = Dim<D>::kNb;
  using V = typename Vec16<T>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
  const V* ck = reinterpret_cast<const V*>(ck_);
#pragma unroll
  for (int q = 0; q < (kNb * kVs + kPer - 1) / kPer; ++q) {
    const V cv = ck[q];
    const T* e = reinterpret_cast<const T*>(&cv);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = q * kPer + t;
      if (i < kNb * kVs) acc[i % kVs] += e[t] * v[i / kVs];
    }
  }
}

// (A x) at the vs dofs of node n = (i0, i1, i2), x in shared or global
// memory, st (the stencils) in shared memory. A node of pattern p applies its
// 3^D-point stencil st[p] [k][d][j]: one component k at a time, its
// neighbour values are loaded together first (neighbours outside the grid
// read 0), so the node waits for memory vs times, not once per neighbour.
template <typename T, int D>
__device__ __forceinline__ void apply_node(const Lv<T>& L, const T* st, const T* x, int n,
                                           int i0, int i1, int i2, T (&acc)[Dim<D>::kVs]) {
  constexpr int kVs = Dim<D>::kVs, kNb = Dim<D>::kNb;
  const int M = L.M;
#pragma unroll
  for (int j = 0; j < kVs; ++j) acc[j] = T(0);
  const T* c = st + __ldg(L.pid + n) * kStencilValues<D>;
  if constexpr (D == 3) {
    const int s1 = L.n2, s0 = L.n1 * L.n2;
    const bool lo0 = i0 > 0, lo1 = i1 > 0, lo2 = i2 > 0;
    const bool hi0 = i0 < L.n0 - 1, hi1 = i1 < L.n1 - 1, hi2 = i2 < L.n2 - 1;
#pragma unroll
    for (int k = 0; k < kVs; ++k) {
      T v[kNb];
#pragma unroll
      for (int d = 0; d < kNb; ++d) {
        const int d0 = d / 9 - 1, d1 = (d / 3) % 3 - 1, d2 = d % 3 - 1;
        const bool in = (d0 >= 0 || lo0) && (d0 <= 0 || hi0) && (d1 >= 0 || lo1) &&
                        (d1 <= 0 || hi1) && (d2 >= 0 || lo2) && (d2 <= 0 || hi2);
        v[d] = in ? x[k * M + n + d0 * s0 + d1 * s1 + d2] : T(0);
      }
      stencil_madd<T, D>(c + k * Dim<D>::kStencilK, v, acc);
    }
  } else {
    const int s0 = L.n1;
    const bool lo0 = i0 > 0, lo1 = i1 > 0;
    const bool hi0 = i0 < L.n0 - 1, hi1 = i1 < L.n1 - 1;
#pragma unroll
    for (int k = 0; k < kVs; ++k) {
      T v[kNb];
#pragma unroll
      for (int d = 0; d < kNb; ++d) {
        const int d0 = d / 3 - 1, d1 = d % 3 - 1;
        const bool in = (d0 >= 0 || lo0) && (d0 <= 0 || hi0) && (d1 >= 0 || lo1) &&
                        (d1 <= 0 || hi1);
        v[d] = in ? x[k * M + n + d0 * s0 + d1] : T(0);
      }
      stencil_madd<T, D>(c + k * Dim<D>::kStencilK, v, acc);
    }
  }
}

// kResid = false: out = x + inv_d * (bm - A x)
// kResid = true:  out = [inv_d != 0] * (bm - A x)
template <typename T, int D, bool kResid>
__device__ void sweep(const Lv<T>& L, const T* st, const T* x, const T* b,
                      T* out, int start, int stride) {
  constexpr int kVs = Dim<D>::kVs;
  for (int n = start; n < L.M; n += stride) {
    int i0, i1, i2;
    coords<D>(n, L.n1, L.n2, i0, i1, i2);
    T acc[kVs];
    apply_node<T, D>(L, st, x, n, i0, i1, i2, acc);
#pragma unroll
    for (int j = 0; j < kVs; ++j) {
      const int i = j * L.M + n;
      const T d = __ldg(L.invd + i);
      const T rj = (d != T(0) ? b[i] : T(0)) - acc[j];
      if constexpr (kResid) {
        out[i] = d != T(0) ? rj : T(0);
      } else {
        out[i] = x[i] + d * rj;
      }
    }
  }
}

// The bricks of a 3D level: along axis 0 the plane 0, the planes 1 .. n0 - 2
// cut into runs of kRun nodes (the last run shorter), and the plane n0 - 1,
// so that the nodes of a run share their pattern of cells on a box; the
// (axis 1, axis 2) plane cut into p1 x p2 tiles of e1 x e2 columns as even
// as the grid allows, one thread a column. A brick's x and its one-node
// halo are staged as [3][w1][w2][kPitch] values (w1, w2: the largest e1 + 2
// and e2 + 2), a column's kRun + 2 planes together, at an odd pitch so that
// neighbouring threads' columns fall in different banks; its b and inv_d
// as [3][w1 - 2][w2 - 2][kPitchB] each.
template <int kRun>
constexpr int kPitch = (kRun + 2) | 1;
template <int kRun>
constexpr int kPitchB = kRun | 1;

struct Bricks {
  int p0, p1, p2;
  int w1, w2;
};

template <int kRun>
__device__ __forceinline__ Bricks bricks(int n0, int n1, int n2, int p1, int p2) {
  return {2 + (n0 - 2 + kRun - 1) / kRun, p1, p2, (n1 + p1 - 1) / p1 + 2, (n2 + p2 - 1) / p2 + 2};
}

// cp.async of one value into shared memory, or a zero where `in` is false
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)), "r"(in ? static_cast<int>(sizeof(T)) : 0));
}

// acc[r][j] += (A x)[j] at the run's node r by the stencil c (global
// memory, read through L1), from the staged brick: col is the staged column
// (component 0, row t1, column t2), the run's lower corner of its halo. Per
// component k and neighbour column (d1, d2) the kRun + 2 planes are loaded
// once and feed every node of the run, and each coefficient is read once
// for the kRun nodes. Each node sums k, d1, d2, d0 in this order.
template <typename T, int kRun>
__device__ __forceinline__ void run_stencil(const T* col, const Bricks& B, const T* __restrict__ c,
                                            T (&acc)[kRun][3]) {
  constexpr int kK = Dim<3>::kStencilK, kP = kPitch<kRun>;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const T* vk = col + k * B.w1 * B.w2 * kP;
#pragma unroll
    for (int d12 = 0; d12 < 9; ++d12) {
      T v[kRun + 2];
#pragma unroll
      for (int p = 0; p < kRun + 2; ++p) v[p] = vk[((d12 / 3) * B.w2 + d12 % 3) * kP + p];
#pragma unroll
      for (int d0 = 0; d0 < 3; ++d0) {
        const T* ck = c + k * kK + (d0 * 9 + d12) * 3;
        const T c0 = __ldg(ck), c1 = __ldg(ck + 1), c2 = __ldg(ck + 2);
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          acc[r][0] += c0 * v[r + d0];
          acc[r][1] += c1 * v[r + d0];
          acc[r][2] += c2 * v[r + d0];
        }
      }
    }
  }
}

// acc[j] = (A x)[j] at one node of a run by its own stencil c, in
// run_stencil's order: col + r is the node's staged column
template <typename T, int kRun>
__device__ __noinline__ void node_stencil(const T* col, const Bricks& B, const T* __restrict__ c,
                                          T (&acc)[3]) {
  constexpr int kK = Dim<3>::kStencilK, kP = kPitch<kRun>;
#pragma unroll
  for (int j = 0; j < 3; ++j) acc[j] = T(0);
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const T* vk = col + k * B.w1 * B.w2 * kP;
#pragma unroll
    for (int d12 = 0; d12 < 9; ++d12) {
#pragma unroll
      for (int d0 = 0; d0 < 3; ++d0) {
        const T v = vk[((d12 / 3) * B.w2 + d12 % 3) * kP + d0];
        const T* ck = c + k * kK + (d0 * 9 + d12) * 3;
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[j] += __ldg(ck + j) * v;
      }
    }
  }
}

// sweep (kResid false) or residual (true) of a 3D level on bricks, the
// same arithmetic per node as sweep() but the order of its sums: each block
// walks over its bricks, stages x's brick and halo (zeros outside the grid)
// and the brick's b and inv_d into shared memory (cp.async), then each
// thread applies the stencil to its run of nodes along axis 0.
template <typename T, int kRun, bool kResid>
__device__ void sweep_bricks(const Lv<T>& L, const T* st, const Bricks& B, T* sx, const T* x,
                             const T* b, T* out) {
  constexpr int kP = kPitch<kRun>, kQ = kPitchB<kRun>;
  const int n0 = L.n0, n1 = L.n1, n2 = L.n2, M = L.M, s0 = n1 * n2;
  const int nb = B.p0 * B.p1 * B.p2, sk = B.w1 * B.w2 * kP, sq = (B.w1 - 2) * (B.w2 - 2) * kQ;
  T* sb = sx + 3 * sk;
  T* sd = sb + 3 * sq;
  // block b takes bricks [b nb / G, (b + 1) nb / G) (rounded up): with more
  // blocks than bricks, the busy ones spread evenly over the block indices
  const int g = gridDim.x;
  const int q_begin = (blockIdx.x * nb + g - 1) / g;
  const int q_end = ((blockIdx.x + 1) * nb + g - 1) / g;
  for (int q = q_begin; q < q_end; ++q) {
    const int q2 = q % B.p2, q1 = (q / B.p2) % B.p1, q0 = q / (B.p1 * B.p2);
    // the planes 0 and n0 - 1 are runs of one node
    const int b0 = q0 == 0 ? 0 : q0 == B.p0 - 1 ? n0 - 1 : 1 + (q0 - 1) * kRun;
    const int e0 = q0 == 0 || q0 == B.p0 - 1 ? 1 : min(kRun, n0 - 1 - b0);
    const int b1 = q1 * n1 / B.p1, e1 = (q1 + 1) * n1 / B.p1 - b1;
    const int b2 = q2 * n2 / B.p2, e2 = (q2 + 1) * n2 / B.p2 - b2;
    __syncthreads();  // every read of the previous brick is done
    for (int j = threadIdx.x; j < (e1 + 2) * (e2 + 2); j += blockDim.x) {
      const int h1 = j / (e2 + 2), h2 = j - h1 * (e2 + 2);
      const int i1 = b1 - 1 + h1, i2 = b2 - 1 + h2;
      const bool in12 = i1 >= 0 && i1 < n1 && i2 >= 0 && i2 < n2;
      T* dst = sx + (h1 * B.w2 + h2) * kP;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int p = 0; p < kRun + 2; ++p) {
          const int i0 = b0 - 1 + p;
          const bool in = in12 && i0 >= 0 && i0 < n0;
          copy_async(dst + k * sk + p, in ? x + k * M + i0 * s0 + i1 * n2 + i2 : x, in);
        }
      }
    }
    for (int j = threadIdx.x; j < e1 * e2; j += blockDim.x) {
      const int h1 = j / e2, h2 = j - h1 * e2;
      const int i = b0 * s0 + (b1 + h1) * n2 + b2 + h2;
      const int s = (h1 * (B.w2 - 2) + h2) * kQ;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int r = 0; r < kRun; ++r) {
          const bool in = r < e0;
          copy_async(sb + k * sq + s + r, in ? b + k * M + i + r * s0 : b, in);
          copy_async(sd + k * sq + s + r, in ? L.invd + k * M + i + r * s0 : L.invd, in);
        }
      }
    }
    const int t1 = threadIdx.x / e2, t2 = threadIdx.x - t1 * e2;
    const int n = b0 * s0 + (b1 + t1) * n2 + b2 + t2;
    const bool active = threadIdx.x < e1 * e2;
    // the whole run by the stencil of its middle node, then each node of
    // another pattern again by its own
    int pat[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) pat[r] = active ? __ldg(L.pid + n + min(r, e0 - 1) * s0) : 0;
    const int mid = active ? __ldg(L.pid + n + (e0 - 1) / 2 * s0) : 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (!active) continue;
    T acc[kRun][3];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) acc[r][j] = T(0);
    }
    const T* col = sx + (t1 * B.w2 + t2) * kP;
    run_stencil<T, kRun>(col, B, st + mid * kStencilValues<3>, acc);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (r < e0 && pat[r] != mid) {
        node_stencil<T, kRun>(col + r, B, st + pat[r] * kStencilValues<3>, acc[r]);
      }
    }
    const T* xc = col + (B.w2 + 1) * kP + 1;  // the run's own staged values
    const int s = (t1 * (B.w2 - 2) + t2) * kQ;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r >= e0) break;
        const int i = j * M + n + r * s0;
        const T d = sd[j * sq + s + r];
        const T rj = (d != T(0) ? sb[j * sq + s + r] : T(0)) - acc[r][j];
        if constexpr (kResid) {
          out[i] = d != T(0) ? rj : T(0);
        } else {
          out[i] = xc[j * sk + r] + d * rj;
        }
      }
    }
  }
}

// a stencil phase of a chain: on bricks (kRun > 0, 3D) or one node a thread
template <typename T, int D, int kRun, bool kResid>
__device__ __forceinline__ void stencil_phase(const Lv<T>& L, const T* st, const Bricks& B, T* sx,
                                              const T* x, const T* b, T* out, int first,
                                              int stride) {
  if constexpr (kRun > 0) {
    static_assert(D == 3, "bricks are 3D");
    sweep_bricks<T, kRun, kResid>(L, st, B, sx, x, b, out);
  } else {
    sweep<T, D, kResid>(L, st, x, b, out, first, stride);
  }
}

// trilinear (2D: bilinear) prolongation of xc (coarse grid c0 x c1 x c2;
// 2D: c0 x c1) at fine node (i0, i1, i2), component k: fine 2i reads coarse
// i, fine 2i+1 reads (i + (i+1)) / 2 with coarse nodes past the end read as 0
template <typename T, int D>
__device__ __forceinline__ T prolong_at(const T* xc, int c0, int c1, int c2, int i0, int i1,
                                        int i2, int k) {
  const int ci[3] = {i0 >> 1, i1 >> 1, i2 >> 1};
  const int odd[3] = {i0 & 1, i1 & 1, i2 & 1};
  const int cn[3] = {c0, c1, c2};
  const T* base = xc + k * c0 * c1 * c2;
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < (1 << D); ++t) {
    int I[3];
    T w = T(1);
    bool ok = true;
#pragma unroll
    for (int ax = 0; ax < D; ++ax) {
      const int hi = (t >> ax) & 1;
      if (hi && !odd[ax]) ok = false;
      I[ax] = ci[ax] + hi;
      if (I[ax] >= cn[ax]) ok = false;
      if (odd[ax]) w *= T(0.5);
    }
    if constexpr (D == 3) {
      if (ok) acc += w * base[(I[0] * c1 + I[1]) * c2 + I[2]];
    } else {
      if (ok) acc += w * base[I[0] * c1 + I[1]];
    }
  }
  return acc;
}

// restriction R = P^T of r (fine grid f0 x f1 x f2; 2D: f0 x f1) at coarse
// node (I0, I1, I2), component k: weights 1 at fine 2I and 1/2 at 2I -+ 1
template <typename T, int D>
__device__ __forceinline__ T restrict_at(const T* r, int f0, int f1, int f2, int I0, int I1,
                                         int I2, int k) {
  const T* base = r + k * f0 * f1 * f2;
  T acc = T(0);
  if constexpr (D == 3) {
#pragma unroll
    for (int d = 0; d < 27; ++d) {
      const int d0 = d / 9 - 1, d1 = (d / 3) % 3 - 1, d2 = d % 3 - 1;
      const int a = 2 * I0 + d0, b = 2 * I1 + d1, c = 2 * I2 + d2;
      if (a < 0 || b < 0 || c < 0 || a >= f0 || b >= f1 || c >= f2) continue;
      const T w = (d0 ? T(0.5) : T(1)) * (d1 ? T(0.5) : T(1)) * (d2 ? T(0.5) : T(1));
      acc += w * base[(a * f1 + b) * f2 + c];
    }
  } else {
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      const int d0 = d / 3 - 1, d1 = d % 3 - 1;
      const int a = 2 * I0 + d0, b = 2 * I1 + d1;
      if (a < 0 || b < 0 || a >= f0 || b >= f1) continue;
      const T w = (d0 ? T(0.5) : T(1)) * (d1 ? T(0.5) : T(1));
      acc += w * base[a * f1 + b];
    }
  }
  return acc;
}

// first write of a chain: zero start: inv_d * bm (nu >= 1) or 0; else
// x + [inv_d != 0] * P xc (with xc) or x
template <typename T, int D>
__device__ void start(const Lv<T>& L, const T* x, const T* b, const T* xc, int c0, int c1,
                      int c2, bool zero_start, T* out, int first, int stride) {
  constexpr int kVs = Dim<D>::kVs;
  for (int n = first; n < L.M; n += stride) {
    int i0 = 0, i1 = 0, i2 = 0;
    if (xc != nullptr) coords<D>(n, L.n1, L.n2, i0, i1, i2);
#pragma unroll
    for (int j = 0; j < kVs; ++j) {
      const int i = j * L.M + n;
      const T d = __ldg(L.invd + i);
      T v;
      if (zero_start) {
        v = L.nu >= 1 && d != T(0) ? d * b[i] : T(0);
      } else {
        v = x[i];
        if (xc != nullptr && d != T(0)) v += prolong_at<T, D>(xc, c0, c1, c2, i0, i1, i2, j);
      }
      out[i] = v;
    }
  }
}

template <typename T, int D>
__device__ void restrict_all(const T* r, int f0, int f1, int f2, T* bc, int c0, int c1, int c2,
                             int first, int stride) {
  const int Mc = c0 * c1 * c2;
  for (int nc = first; nc < Mc; nc += stride) {
    int I0, I1, I2;
    coords<D>(nc, c1, c2, I0, I1, I2);
#pragma unroll
    for (int k = 0; k < Dim<D>::kVs; ++k) {
      bc[k * Mc + nc] = restrict_at<T, D>(r, f0, f1, f2, I0, I1, I2, k);
    }
  }
}

// A chain: the first write, then the sweeps (sweep_to(x, out)), each phase
// behind sync(). The writes alternate between tmp and xout so that the last
// one lands in xout.
template <typename T, int D, typename Sync, typename Sweep>
__device__ void run_chain(const Lv<T>& L, const T* x, const T* b, const T* xc, int c0, int c1,
                          int c2, bool zero_start, T* xout, T* tmp, int first, int stride,
                          Sync sync, Sweep sweep_to) {
  const int sweeps = zero_start ? (L.nu > 1 ? L.nu - 1 : 0) : L.nu;
  T* cur = (sweeps & 1) ? tmp : xout;
  start<T, D>(L, x, b, xc, c0, c1, c2, zero_start, cur, first, stride);
  for (int s = 1; s <= sweeps; ++s) {
    sync();
    T* nxt = ((sweeps - s) & 1) ? tmp : xout;
    sweep_to(cur, nxt);
    cur = nxt;
  }
}

// kRun = 0: every phase one node a thread (kChainThreads a block), the
// stencils in shared memory; kRun > 0: the stencil phases on bricks (a.p1,
// a.p2; at most kBrickThreads a block), the brick in shared memory and the
// stencils read from global memory through L1, which the SM's blocks share
template <typename T, int D, int kRun>
__global__ void __launch_bounds__(kRun ? kBrickThreads : kChainThreads, kRun ? kBrickBlocks : 4)
    chain_kernel(FctChain a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  const T* st = static_cast<const T*>(a.lv.st);
  const Lv<T> L = view<T>(a.lv);
  if constexpr (kRun == 0) {
    for (int i = threadIdx.x; i < a.lv.n_pat * kStencilValues<D>; i += blockDim.x) sx[i] = st[i];
    st = sx;
    __syncthreads();
  }
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const T* b = static_cast<const T*>(a.b);
  T* xout = static_cast<T*>(a.xout);
  Bricks B{};
  if constexpr (kRun > 0) B = bricks<kRun>(L.n0, L.n1, L.n2, a.p1, a.p2);
  run_chain<T, D>(L, static_cast<const T*>(a.x), b,
                  a.prolong ? static_cast<const T*>(a.xc) : nullptr, a.c0, a.c1, a.c2,
                  a.zero_start != 0, xout, static_cast<T*>(a.tmp), first, stride,
                  [&] { grid.sync(); },
                  [&](const T* x, T* out) {
                    stencil_phase<T, D, kRun, false>(L, st, B, sx, x, b, out, first, stride);
                  });
  if (!a.residual) return;
  grid.sync();
  T* r = static_cast<T*>(a.r);
  stencil_phase<T, D, kRun, true>(L, st, B, sx, xout, b, r, first, stride);
  if (!a.restrict_to) return;
  grid.sync();
  restrict_all<T, D>(r, L.n0, L.n1, L.n2, static_cast<T*>(a.bc), a.c0, a.c1, a.c2, first,
                     stride);
}

// shared memory of one tail level: its stencils, and x, b and a scratch
// vector of vs M values
template <int D>
__host__ __device__ constexpr int tail_level_values(int M, int n_pat) {
  return 3 * Dim<D>::kVs * M + n_pat * kStencilValues<D>;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTailThreads) tail_kernel(FctTail a) {
  constexpr int kVs = Dim<D>::kVs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the levels' views and their place in shared memory, one copy per block
  __shared__ Lv<T> sL[kMaxTail];
  __shared__ T* sX[kMaxTail];
  __shared__ T* sB[kMaxTail];
  __shared__ T* sS[kMaxTail];
  __shared__ T* sSt[kMaxTail];
  const int nt = a.n_levels;
  if (threadIdx.x == 0) {
    // the stencils first (each a multiple of 16 bytes, so every table stays
    // aligned for the 16-byte reads), then the vectors
    T* p = reinterpret_cast<T*>(smem_raw);
#pragma unroll
    for (int t = 0; t < kMaxTail; ++t) {
      if (t >= nt) break;
      sL[t] = view<T>(a.lv[t]);
      sSt[t] = p;
      p += a.lv[t].n_pat * kStencilValues<D>;
    }
#pragma unroll
    for (int t = 0; t < kMaxTail; ++t) {
      if (t >= nt) break;
      const int n = kVs * sL[t].M;
      sX[t] = p;
      sB[t] = p + n;
      sS[t] = p + 2 * n;
      p += 3 * n;
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kMaxTail; ++t) {
    if (t >= nt) break;
    const T* g = static_cast<const T*>(a.lv[t].st);
    T* st = sSt[t];
    for (int i = threadIdx.x; i < a.lv[t].n_pat * kStencilValues<D>; i += blockDim.x) {
      st[i] = g[i];
    }
  }
  const int first = threadIdx.x, stride = blockDim.x;
  auto sync = [] { __syncthreads(); };
  auto sweep_in = [=](const Lv<T>& L, const T* st, const T* B) {
    return [=](const T* x, T* out) { sweep<T, D, false>(L, st, x, B, out, first, stride); };
  };

  {
    const T* b = static_cast<const T*>(a.b);
    T* B0 = sB[0];
    for (int i = first; i < kVs * sL[0].M; i += stride) B0[i] = b[i];
  }
  __syncthreads();

  // down: pre-chain, residual, restriction
  for (int t = 0; t + 1 < nt; ++t) {
    const Lv<T> L = sL[t];
    T* X = sX[t];
    T* B = sB[t];
    T* S = sS[t];
    run_chain<T, D>(L, (const T*)nullptr, B, (const T*)nullptr, 0, 0, 0, true, X, S, first,
                    stride, sync, sweep_in(L, sSt[t], B));
    __syncthreads();
    sweep<T, D, true>(L, sSt[t], X, B, S, first, stride);
    __syncthreads();
    const Lv<T> Lc = sL[t + 1];
    restrict_all<T, D>(S, L.n0, L.n1, L.n2, sB[t + 1], Lc.n0, Lc.n1, Lc.n2, first, stride);
    __syncthreads();
  }

  // the coarsest level: dense solve or the coarse chain
  {
    const int c = nt - 1;
    const Lv<T> L = sL[c];
    T* X = sX[c];
    const T* B = sB[c];
    if (a.coarse_inv != nullptr) {
      const T* C = static_cast<const T*>(a.coarse_inv);
      const int N = kVs * L.M;
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
      // rows i0 + r nwarps (r < 4) at once, so that their loads overlap
      for (int i0 = warp; i0 < N; i0 += 4 * nwarps) {
        T s[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 2
        for (int k = lane; k < N; k += 32) {
          const T bk = __ldg(L.invd + k) != T(0) ? B[k] : T(0);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r * nwarps;
            if (i < N) s[r] += __ldg(C + static_cast<size_t>(i) * N + k) * bk;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
          const int i = i0 + r * nwarps;
          if (lane == 0 && i < N) X[i] = __ldg(L.invd + i) != T(0) ? s[r] : T(0);
        }
      }
    } else {
      run_chain<T, D>(L, (const T*)nullptr, B, (const T*)nullptr, 0, 0, 0, true, X, sS[c],
                      first, stride, sync, sweep_in(L, sSt[c], B));
    }
  }
  __syncthreads();

  // up: prolongation, mask and add, post-chain
  for (int t = nt - 2; t >= 0; --t) {
    const Lv<T> L = sL[t];
    const Lv<T> Lc = sL[t + 1];
    run_chain<T, D>(L, sX[t], sB[t], sX[t + 1], Lc.n0, Lc.n1, Lc.n2, false, sX[t], sS[t], first,
                    stride, sync, sweep_in(L, sSt[t], sB[t]));
    __syncthreads();
  }
  T* xout = static_cast<T*>(a.xout);
  const T* X0 = sX[0];
  for (int i = first; i < kVs * sL[0].M; i += stride) xout[i] = X0[i];
}

// the blocks of a persistent grid the card holds at once (kernel, block size
// and shared memory), once per device and kernel shape
cudaError_t grid_cap(const void* kernel, int threads, size_t bytes, int& cap) {
  struct Seen {
    const void* kernel;
    int dev, threads;
    size_t bytes;
    int cap;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < n_seen; ++i) {
    const Seen& s = seen[i];
    if (s.kernel == kernel && s.dev == dev && s.threads == threads && s.bytes == bytes) {
      cap = s.cap;
      return cudaSuccess;
    }
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
  cap = per_sm * sms;
  if (n_seen < 64) seen[n_seen++] = {kernel, dev, threads, bytes, cap};
  return cudaSuccess;
}

// One cooperative launch of chain_kernel<T, D, kRun>: the persistent grid is
// as many blocks as the SMs hold at once, and no more than the nodes need;
// the shared-memory opt-in once per device.
template <typename T, int D, int kRun>
int launch_chain_as(const FctChain* args, void* stream, int threads, size_t bytes) {
  static size_t opted[fct::kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(chain_kernel<T, D, kRun>);
  cudaError_t e = fct::opt_in_smem(chain_kernel<T, D, kRun>, bytes, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  int cap = 0;
  e = grid_cap(kernel, threads, bytes, cap);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int M = args->lv.n0 * args->lv.n1 * args->lv.n2;
  int blocks = (M + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  FctChain a = *args;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), params, bytes,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// in shared memory the stencils, or with bricks (run, p1, p2) the staged
// brick; a block of kChainThreads, or on bricks the warps that cover the
// largest tile of columns
template <typename T, int D>
int launch_chain(const FctChain* args, void* stream) {
  const FctLevel& l = args->lv;
  if (l.n_pat < 1 || l.n_pat > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (args->run == 0) {
    const size_t bytes = static_cast<size_t>(l.n_pat) * kStencilValues<D> * sizeof(T);
    return launch_chain_as<T, D, 0>(args, stream, kChainThreads, bytes);
  }
  if (D != 3 || args->run != kBrickRun || l.n0 < 3 || args->p1 < 1 || args->p2 < 1 ||
      args->p1 > l.n1 || args->p2 > l.n2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e1 = (l.n1 + args->p1 - 1) / args->p1, e2 = (l.n2 + args->p2 - 1) / args->p2;
  const int threads = (e1 * e2 + 31) / 32 * 32;
  if (threads > kBrickThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (static_cast<size_t>(3) * (e1 + 2) * (e2 + 2) * kPitch<kBrickRun> +
                        static_cast<size_t>(6) * e1 * e2 * kPitchB<kBrickRun>) * sizeof(T);
  if constexpr (D == 3) return launch_chain_as<T, 3, kBrickRun>(args, stream, threads, bytes);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int launch_tail(const FctTail* args, void* stream) {
  if (args->n_levels < 1 || args->n_levels > kMaxTail) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t bytes = 0;
  for (int t = 0; t < args->n_levels; ++t) {
    const FctLevel& l = args->lv[t];
    bytes += static_cast<size_t>(tail_level_values<D>(l.n0 * l.n1 * l.n2, l.n_pat)) * sizeof(T);
  }
  cudaError_t e = cudaFuncSetAttribute(tail_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  tail_kernel<T, D><<<1, kTailThreads, bytes, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points: every pointer is a device pointer, ``stream`` a cudaStream_t;
// the argument structs are read on the host and passed to the kernel by
// value. Each returns cudaGetLastError() (or the launch's error) after its
// one launch. fct_chain_* and fct_tail_* take 3D hex levels, fct_chain_2d_*
// and fct_tail_2d_* 2D quad levels (n2 = c2 = 1).
extern "C" int fct_chain_f32(const FctChain* args, void* stream) {
  return launch_chain<float, 3>(args, stream);
}

extern "C" int fct_chain_f64(const FctChain* args, void* stream) {
  return launch_chain<double, 3>(args, stream);
}

extern "C" int fct_tail_f32(const FctTail* args, void* stream) {
  return launch_tail<float, 3>(args, stream);
}

extern "C" int fct_tail_f64(const FctTail* args, void* stream) {
  return launch_tail<double, 3>(args, stream);
}

extern "C" int fct_chain_2d_f32(const FctChain* args, void* stream) {
  return launch_chain<float, 2>(args, stream);
}

extern "C" int fct_chain_2d_f64(const FctChain* args, void* stream) {
  return launch_chain<double, 2>(args, stream);
}

extern "C" int fct_tail_2d_f32(const FctTail* args, void* stream) {
  return launch_tail<float, 2>(args, stream);
}

extern "C" int fct_tail_2d_f64(const FctTail* args, void* stream) {
  return launch_tail<double, 2>(args, stream);
}

// the shared memory one block may hold on device ``dev`` (bytes), or -1
extern "C" int fct_smem_optin(int dev) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  return v;
}
