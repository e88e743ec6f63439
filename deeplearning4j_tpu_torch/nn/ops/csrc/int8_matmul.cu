// Int8 weight-only matmul for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../build.py and ../int8_matmul.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   deeplearning4j_tpu/nn/ops/int8_matmul.py _int8_kernel (pallas_call in int8_matmul)
//
// It computes   y = (x @ float(q)) * scale
//   x (B, K) f32 or bf16, q (K, N) int8, scale (N,) per output channel, f32;
//   the products and sums are f32 FMAs on the CUDA cores (no TF32, no tensor
//   cores: f32 means f32), the scale is applied once, after the whole sum,
//   and y is stored once in x's type (for bf16 x: one rounding of the f32
//   result). The int8 -> f32 widening is exact.
//
// Bound on an H100: the serving heads run at batch buckets of 1..32 rows.
// At one row the kernel is bound by the bytes of q (a quarter of the f32
// weight's); at 32 rows by the f32 FMAs (2*B*K*N operations at the 67 TFLOP/s
// of the CUDA cores). PERF.md has both.
//
// Design. A block of four warps covers 512 output columns: each thread owns
// 4 consecutive columns and reads them as one char4 per row of q, so a warp
// reads 128 contiguous bytes of a q row. The block's rows of x (RB of them,
// RB the smallest power of two >= B, at most 32) are staged in shared memory
// in steps of 128 depths, widened to f32, and read as float4 broadcasts (4
// depths of one row: 16 FMAs per shared-memory load). Each thread keeps an
// RB x 4 f32 accumulator in registers.
//
// Grid fill. A grid over the column tiles alone would launch 1..8 blocks for
// N = 10..4096 on 132 SMs. So the depth K is split into chunks (one grid row
// per chunk, sized by the wrapper from K, N and the SM count only, never from
// B: a row's summation order does not depend on the bucket it was padded
// to). Each block writes its f32 partial tile; a second kernel sums the
// partials of a column over the chunks in a fixed order, multiplies by the
// scale and rounds to y's type. No float atomics: the same input gives the
// same bits on every run.
//
// Ragged shapes are masked, not padded: any B, K and N. When N is not a
// multiple of 4 (or q is not 4-byte aligned) the q row is read byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;     // four warps
constexpr int COLS = 4;          // output columns per thread (one char4 of q)
constexpr int BN = THREADS * COLS;   // 512 output columns per block
constexpr int KS = 128;          // depths of x staged per step
constexpr int MAX_RB = 32;       // rows of x per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// q[k, n..n+3] as f32; columns >= N read as 0
template <bool VEC>
__device__ __forceinline__ void load_q4(const int8_t* __restrict__ row, int n, int N,
                                        float (&w)[COLS]) {
  if (VEC) {
    // N % 4 == 0 and n % 4 == 0: the four columns are all valid or all not
    if (n < N) {
      const char4 c = __ldg(reinterpret_cast<const char4*>(row + n));
      w[0] = static_cast<float>(c.x);
      w[1] = static_cast<float>(c.y);
      w[2] = static_cast<float>(c.z);
      w[3] = static_cast<float>(c.w);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) w[c] = 0.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      w[c] = (n + c < N) ? static_cast<float>(__ldg(row + n + c)) : 0.f;
    }
  }
}

// partial[s, r, n] = sum over k in chunk s of x[r, k] * q[k, n]
template <int RB, typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_partial_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    float* __restrict__ partial, int B, int K, int N, int chunk) {
  __shared__ __align__(16) float xs[RB][KS];

  const int tid = threadIdx.x;
  const int n = blockIdx.x * BN + tid * COLS;
  const int s = blockIdx.y;
  const int r0 = blockIdx.z * RB;
  const int k_begin = s * chunk;
  const int k_end = min(K, k_begin + chunk);

  float acc[RB][COLS];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.f;
  }

  for (int kb = k_begin; kb < k_end; kb += KS) {
    const int nk = min(KS, k_end - kb);
    __syncthreads();  // every thread is done reading the previous step's xs
    for (int i = tid; i < RB * KS; i += THREADS) {
      const int r = i / KS;
      const int kk = i % KS;
      float v = 0.f;
      if (r0 + r < B && kk < nk) v = to_f32(x[(long long)(r0 + r) * K + kb + kk]);
      xs[r][kk] = v;
    }
    __syncthreads();

    const int8_t* qk = q + (long long)kb * N;
#pragma unroll 2
    for (int kk = 0; kk < nk; kk += 4) {
      float w[4][COLS];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kk + j < nk) {
          load_q4<VEC>(qk + (long long)(kk + j) * N, n, N, w[j]);
        } else {
#pragma unroll
          for (int c = 0; c < COLS; ++c) w[j][c] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[r][kk]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          float a = acc[r][c];
          a = fmaf(xv.x, w[0][c], a);
          a = fmaf(xv.y, w[1][c], a);
          a = fmaf(xv.z, w[2][c], a);
          a = fmaf(xv.w, w[3][c], a);
          acc[r][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r0 + r >= B) break;
    float* out = partial + ((long long)s * B + r0 + r) * N + n;
    if (VEC) {
      if (n < N) *reinterpret_cast<float4*>(out) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        if (n + c < N) out[c] = acc[r][c];
      }
    }
  }
}

// y[r, n] = (sum over the chunks s, in order, of partial[s, r, n]) * scale[n]
template <typename T>
__global__ void __launch_bounds__(256)
int8_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                   T* __restrict__ y, int splits, int B, int N) {
  const long long total = (long long)B * N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(long long)s * total + i];
  store(y + i, sum * scale[i % N]);
}

template <int RB, typename T>
void launch_partial(bool vec, dim3 grid, const T* x, const int8_t* q, float* partial, int B,
                    int K, int N, int chunk, cudaStream_t s) {
  if (vec) {
    int8_partial_kernel<RB, T, true><<<grid, THREADS, 0, s>>>(x, q, partial, B, K, N, chunk);
  } else {
    int8_partial_kernel<RB, T, false><<<grid, THREADS, 0, s>>>(x, q, partial, B, K, N, chunk);
  }
}

template <typename T>
int launch(const void* x, const void* q, const void* scale, void* partial, void* y, int B,
           int K, int N, int chunk, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xb = static_cast<const T*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  float* pp = static_cast<float*>(partial);
  int rb = 1;
  while (rb < B && rb < MAX_RB) rb *= 2;
  dim3 grid((N + BN - 1) / BN, splits, (B + rb - 1) / rb);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  switch (rb) {
    case 1: launch_partial<1, T>(vec, grid, xb, qb, pp, B, K, N, chunk, s); break;
    case 2: launch_partial<2, T>(vec, grid, xb, qb, pp, B, K, N, chunk, s); break;
    case 4: launch_partial<4, T>(vec, grid, xb, qb, pp, B, K, N, chunk, s); break;
    case 8: launch_partial<8, T>(vec, grid, xb, qb, pp, B, K, N, chunk, s); break;
    case 16: launch_partial<16, T>(vec, grid, xb, qb, pp, B, K, N, chunk, s); break;
    default: launch_partial<32, T>(vec, grid, xb, qb, pp, B, K, N, chunk, s); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)B * N;
  int8_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      pp, static_cast<const float*>(scale), static_cast<T*>(y), splits, B, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tile sizes: 0 -> most rows of x per block, 1 -> output columns per block,
// 2 -> depths of x staged per step
int dl4j_int8_matmul_tile(int which) { return which == 0 ? MAX_RB : which == 1 ? BN : KS; }

// x (b, k) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), q (k, n) int8 row-major,
// scale (n,) f32 -> y (b, n) in x's type. partial is (splits, b, n) f32
// scratch; the depth splits into `splits` chunks of `chunk` (chunk * splits >= k).
int dl4j_int8_matmul(const void* x, const void* q, const void* scale, void* partial, void* y,
                     int b, int k, int n, int chunk, int splits, int x_bf16, void* stream) {
  if (b <= 0 || k <= 0 || n <= 0 || chunk <= 0 || splits <= 0 || splits > 65535 ||
      (long long)chunk * splits < k || (long long)chunk * (splits - 1) >= k) {
    return (int)cudaErrorInvalidValue;
  }
  if (x_bf16) {
    return launch<__nv_bfloat16>(x, q, scale, partial, y, b, k, n, chunk, splits, stream);
  }
  return launch<float>(x, q, scale, partial, y, b, k, n, chunk, splits, stream);
}

}  // extern "C"
