// The windowed exchange and the windowed BSR SpMV of the general-mesh path.
//
// Replaces the three TPU kernels of fenics_constitutive_tpu/ops/pallas_window.py:
//   K4 windowed_gather      -> gather_kernel
//   K5 windowed_scatter     -> scatter_kernel
//   K6 windowed_bsr_matvec  -> bsr_kernel
//
// Layouts (row-major, the flat minor axis last):
//   node rows u       [K, M_pad]         u[k*M_pad + m]
//   cell-local rows f [B, K, Rn]         f[(b*K + k)*Rn + r]
//   loc               [B, Rn] int32      window-local node of row r of block b
//                                        (node b*T + loc), -1 for a pad row
//   node_ptr/rows     CSR [M_pad]        flat rows b*Rn + r feeding node m,
//                                        ascending (pad rows in no list)
//   BSR loc           [B, k, T_r] int32  window-local column node per slot
//   BSR vals          [B, k*br*bc, T_r]  block entries, slot then (jr, jc)
//   BSR jb            [B] int32          window start in kGran column nodes
//   x / y             [bc, NC_pad] / [br, NR_pad]
//
// What bounds them on the H100: bytes and, for the small AMG levels, latency.
// The TPU, which has no fast arbitrary gather, turned each index op into a
// one-hot MXU contraction with an exact 3-term bf16 split of the values. On
// the GPU a direct indexed load does the same work: K4 reads loc once per row
// and copies K values (neighbouring threads on neighbouring rows, so loc and
// the output are read and written coalesced; u comes mostly from L2, as the
// window of a block is a narrow band of nodes). K5 is the transpose without
// float atomics: one thread per (component, node) sums its rows in the
// plan's fixed order, so a launch repeats bit for bit. K6 gives one thread
// per row node; loc and vals are read coalesced along the row axis, and each
// thread owns its br outputs, so there is no scatter. The coarse AMG levels
// have only 1-3 row tiles (1,024-3,072 threads) and are latency-bound.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using fct::kThreads;

constexpr int kGran = 1024;  // BSR column window granule (ops/windowed_bsr._GRAN)

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// K4: out[b, k, r] = u[k, b*T + loc[b, r]], 0 where loc = -1
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ u, const int* __restrict__ loc, T* __restrict__ out,
              int K, int Rn, int tile, int M_pad) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= Rn) return;
  const int l = loc[b * Rn + r];
  T* dst = out + b * K * Rn + r;
  if (l < 0) {
    for (int k = 0; k < K; ++k) dst[k * Rn] = T(0);
    return;
  }
  const T* src = u + b * tile + l;
  for (int k = 0; k < K; ++k) dst[k * Rn] = src[k * M_pad];
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

// K6: y[jr, b*T_r + t] = sum over slots a (in order) of
//     sum_jc vals[b, a, jr, jc, t] * x[jc, jb[b]*kGran + loc[b, a, t]]
template <typename T, int BR, int BC>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const T* __restrict__ x, const int* __restrict__ loc,
           const T* __restrict__ vals, const int* __restrict__ jb, T* __restrict__ y,
           int k, int T_r, int NC_pad, int NR_pad, int round_bf16) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (t >= T_r) return;
  const int base = jb[b] * kGran;
  T acc[BR];
#pragma unroll
  for (int jr = 0; jr < BR; ++jr) acc[jr] = T(0);

  for (int a = 0; a < k; ++a) {
    const int slot = b * k + a;
    const int l = loc[slot * T_r + t];
    if (l < 0) continue;
    T xs[BC];
#pragma unroll
    for (int jc = 0; jc < BC; ++jc) {
      xs[jc] = select_value(x[jc * NC_pad + base + l], round_bf16);
    }
    const T* v = vals + slot * (BR * BC) * T_r + t;
#pragma unroll
    for (int jr = 0; jr < BR; ++jr) {
      T c = T(0);
#pragma unroll
      for (int jc = 0; jc < BC; ++jc) c += v[(jr * BC + jc) * T_r] * xs[jc];
      acc[jr] += c;
    }
  }
#pragma unroll
  for (int jr = 0; jr < BR; ++jr) y[jr * NR_pad + b * T_r + t] = acc[jr];
}

template <typename T>
int launch_gather(const void* u, const void* loc, void* out, int K, int B, int Rn,
                  int tile, int M_pad, void* stream) {
  const dim3 grid(cdiv(Rn, kThreads), B);
  gather_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const int*>(loc), static_cast<T*>(out), K,
      Rn, tile, M_pad);
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
void launch_bsr_shape(const void* x, const void* loc, const void* vals, const void* jb,
                      void* y, int k, int T_r, int B, int NC_pad, int NR_pad,
                      int round_bf16, cudaStream_t stream) {
  const dim3 grid(cdiv(T_r, kThreads), B);
  bsr_kernel<T, BR, BC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(loc),
      static_cast<const T*>(vals), static_cast<const int*>(jb), static_cast<T*>(y), k,
      T_r, NC_pad, NR_pad, round_bf16);
}

template <typename T>
int launch_bsr(const void* x, const void* loc, const void* vals, const void* jb, void* y,
               int br, int bc, int k, int T_r, int B, int NC_pad, int NR_pad,
               int round_bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (br == 3 && bc == 3) {
    launch_bsr_shape<T, 3, 3>(x, loc, vals, jb, y, k, T_r, B, NC_pad, NR_pad, round_bf16, s);
  } else if (br == 3 && bc == 6) {
    launch_bsr_shape<T, 3, 6>(x, loc, vals, jb, y, k, T_r, B, NC_pad, NR_pad, round_bf16, s);
  } else if (br == 6 && bc == 3) {
    launch_bsr_shape<T, 6, 3>(x, loc, vals, jb, y, k, T_r, B, NC_pad, NR_pad, round_bf16, s);
  } else if (br == 6 && bc == 6) {
    launch_bsr_shape<T, 6, 6>(x, loc, vals, jb, y, k, T_r, B, NC_pad, NR_pad, round_bf16, s);
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

// (br, bc) must be one of (3, 3), (3, 6), (6, 3), (6, 6); otherwise
// cudaErrorInvalidValue is returned and nothing is launched. ``round_bf16``
// is read by the float32 entry point only.
extern "C" int fct_window_bsr_f32(const void* x, const void* loc, const void* vals,
                                  const void* jb, void* y, int br, int bc, int k, int T_r,
                                  int B, int NC_pad, int NR_pad, int round_bf16,
                                  void* stream) {
  return launch_bsr<float>(x, loc, vals, jb, y, br, bc, k, T_r, B, NC_pad, NR_pad,
                           round_bf16, stream);
}

extern "C" int fct_window_bsr_f64(const void* x, const void* loc, const void* vals,
                                  const void* jb, void* y, int br, int bc, int k, int T_r,
                                  int B, int NC_pad, int NR_pad, int round_bf16,
                                  void* stream) {
  return launch_bsr<double>(x, loc, vals, jb, y, br, bc, k, T_r, B, NC_pad, NR_pad,
                            round_bf16, stream);
}
