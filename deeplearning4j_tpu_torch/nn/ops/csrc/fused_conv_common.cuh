// What the fused conv+BN+ReLU kernels share (fused_conv.cu: forward,
// fused_conv_bwd.cu: backward): the fixed-order sum of their per-block
// column partials. Each .cu file is its own shared library, so everything
// here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// partial (tiles, cols) -> out (cols): a fixed summation order, so the
// column sums are the same on every run
__global__ void __launch_bounds__(1024)
stats_reduce_kernel(const float* __restrict__ partial, int tiles, int cols,
                    float* __restrict__ out) {
  __shared__ float buf[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < cols) {
    for (int t = threadIdx.y; t < tiles; t += 32) s += partial[(long long)t * cols + c];
  }
  buf[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float total = 0.f;
    for (int g = 0; g < 32; ++g) total += buf[g][threadIdx.x];
    out[c] = total;
  }
}

inline cudaError_t launch_stats_reduce(const float* partial, int tiles, int cols,
                                       float* out, cudaStream_t s) {
  stats_reduce_kernel<<<dim3((cols + 31) / 32), dim3(32, 32), 0, s>>>(partial, tiles,
                                                                      cols, out);
  return cudaGetLastError();
}

}  // namespace
