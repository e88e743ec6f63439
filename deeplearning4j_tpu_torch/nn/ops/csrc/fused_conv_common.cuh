// Pieces shared by the fused conv+BN+ReLU kernels (fused_conv.cu: forward,
// fused_conv_bwd.cu: backward). Each .cu file is its own shared library, so
// everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // depth per pipeline step
constexpr int THREADS = 128;    // four warps, 2x2 over the 64x64 tile

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n_valid) {
  // 8 consecutive bf16 values; entries past n_valid read as 0
  if (n_valid >= 8 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  unsigned short* dst = reinterpret_cast<unsigned short*>(&v);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < n_valid) dst[j] = src[j];
  }
  return v;
}

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
