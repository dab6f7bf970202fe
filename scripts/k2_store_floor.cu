// Copy kernels with K2's traffic (scripts/k2_store_floor.py): at each flat
// node, read R rows of an [R, M] field and write W rows of a [W, M] one.
#include "common.cuh"

template <int R, int W>
__global__ void __launch_bounds__(256) copy_flat(const float* __restrict__ in,
                                                 float* __restrict__ out, int M) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= M) return;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) acc += in[(size_t)r * M + n];
#pragma unroll
  for (int w = 0; w < W; ++w) out[(size_t)w * M + n] = acc + w;
}

// blocks own b0 x b1 x b2 bricks (z fastest) and walk their nodes in order
template <int R, int W>
__global__ void __launch_bounds__(256) copy_brick(const float* __restrict__ in,
                                                  float* __restrict__ out, int n0, int n1,
                                                  int n2, int b0, int b1, int b2) {
  const int M = n0 * n1 * n2;
  const int o0 = blockIdx.z * b0, o1 = blockIdx.y * b1, o2 = blockIdx.x * b2;
  for (int ln = threadIdx.x; ln < b0 * b1 * b2; ln += blockDim.x) {
    const int l0 = ln / (b1 * b2), rem = ln - l0 * (b1 * b2);
    const int l1 = rem / b2, l2 = rem - l1 * b2;
    const int g0 = o0 + l0, g1 = o1 + l1, g2 = o2 + l2;
    if (g0 >= n0 || g1 >= n1 || g2 >= n2) continue;
    const int n = (g0 * n1 + g1) * n2 + g2;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc += in[(size_t)r * M + n];
#pragma unroll
    for (int w = 0; w < W; ++w) out[(size_t)w * M + n] = acc + w;
  }
}

// brick != 0: blocks own b0 x b1 x b2 bricks; else one thread a flat node
extern "C" int fct_store_floor(int brick, const float* in, float* out, int n0, int n1, int n2,
                               int b0, int b1, int b2) {
  const int M = n0 * n1 * n2;
  if (brick) {
    const dim3 g((n2 + b2 - 1) / b2, (n1 + b1 - 1) / b1, (n0 + b0 - 1) / b0);
    copy_brick<108, 168><<<g, 256>>>(in, out, n0, n1, n2, b0, b1, b2);
  } else {
    copy_flat<108, 168><<<(M + 255) / 256, 256>>>(in, out, M);
  }
  return (int)cudaGetLastError();
}
