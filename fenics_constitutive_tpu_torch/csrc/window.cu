// The windowed exchange and the BSR SpMV of the general-mesh path.
//
// Replaces the three TPU kernels of fenics_constitutive_tpu/ops/pallas_window.py:
//   K4 windowed_gather      -> gather_kernel
//   K5 windowed_scatter     -> scatter_kernel
//   K6 windowed_bsr_matvec  -> bsr_rows_kernel
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
