// Fused conv+BN+ReLU forward kernels for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ../build.py and ../fused_conv.py).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   pw_conv forward  <- deeplearning4j_tpu/nn/ops/fused_conv.py _pw_fwd_kernel
//   conv3x3 forward  <- deeplearning4j_tpu/nn/ops/fused_conv.py _c3_fwd_kernel
//
// Both compute   y, stats = conv(act(x * scale + shift), W)
//   - the upstream BatchNormalization's folded affine (scale, shift, f32) and
//     an optional ReLU are applied to the input tile as it is read, in f32,
//     then rounded to bf16 for the tensor cores;
//   - y is accumulated in f32 and stored as bf16;
//   - stats = [colsum(y); colsum(y*y)] over the valid output rows, taken from
//     the f32 accumulator.
//
// Design. One kernel template serves both ops as an implicit GEMM:
//   rows M = output pixels, columns = Cout, depth K = TAPS * Cin
// (TAPS = 1 for the pointwise conv, 9 for the 3x3 SAME stride-1 conv). A block
// computes a 64x64 output tile with four warps, each a 32x32 sub-tile of
// 16x16x16 bf16 WMMA products with f32 accumulators. K advances in steps of
// 32 through two shared-memory buffers: the next step's global loads are in
// registers while the tensor cores work on the current step, and the input
// fold happens on the way from registers into shared memory.
//
// What the TPU layout forced and this kernel does not: the Pallas kernels pad
// channels to 128 lanes and M to the block. Here ragged edges (M = 49 at
// batch 1 and 7x7, Cin or Cout not a multiple of the tile) are masked in the
// kernel. The 3x3 halo is zero AFTER the fold: an out-of-image tap contributes
// 0, not relu(shift).
//
// Statistics across blocks: Pallas sums them over sequential grid steps. Here
// blocks run in parallel, so each block writes its column partials for its 64
// rows, and a second kernel reduces them over the M tiles in a fixed order.
// No float atomics: the result is deterministic.
//
// Bound on an H100: at the ResNet-50 shapes these are GEMMs of depth 64..4608,
// above the card's ~295 FLOP/byte ridge for the deep ones (bound by tensor-core
// operations) and below it for the 64-channel stage-1 convs (bound by bytes).
// This first kernel is simple (WMMA + register-staged double buffering); wgmma
// and TMA are later work. Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;          // output rows (pixels) per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // depth per pipeline step
constexpr int THREADS = 128;    // four warps, 2x2 over the 64x64 tile
constexpr int LDA = BK + 8;     // padded leading dims (bank conflicts)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BK * LDB;
constexpr int AB_BYTES = 2 * (A_ELEMS + B_ELEMS) * 2;   // two stages, bf16
constexpr int C_BYTES = BM * LDC * 4;                   // f32 epilogue tile
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

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

template <int TAPS>
__global__ void __launch_bounds__(THREADS)
fused_conv_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ partial,
                      int M, int H, int W, int Cin, int Cout, int relu_in) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red[2][2][BN];

  __nv_bfloat16* As[2];
  __nv_bfloat16* Bs[2];
  As[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  Bs[0] = As[0] + A_ELEMS;
  As[1] = Bs[0] + B_ELEMS;
  Bs[1] = As[1] + A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A tile: each thread stages one 8-channel chunk of two rows (r, r + 32)
  const int a_row = tid >> 2;
  const int a_kc = (tid & 3) * 8;
  long long a_pix[2];   // TAPS == 1: pixel index; else image index n
  int a_h[2], a_w[2];
  bool a_valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + 32 * i;
    a_valid[i] = m < M;
    if (TAPS == 1) {
      a_pix[i] = m;
      a_h[i] = a_w[i] = 0;
    } else {
      const int hw = H * W;
      const int n = m / hw;
      const int r = m - n * hw;
      a_pix[i] = n;
      a_h[i] = r / W;
      a_w[i] = r - a_h[i] * W;
    }
  }
  // B tile: each thread stages one 8-column chunk of two depth rows (k, k + 16)
  const int b_k = tid >> 3;
  const int b_nc = (tid & 7) * 8;

  const int CK = (Cin + BK - 1) / BK;
  const int KT = TAPS * CK;

  uint4 ra[2], rb[2];
  int na[2];

  auto load = [&](int kt) {
    const int tap = (TAPS == 1) ? 0 : kt / CK;
    const int c0 = (kt - tap * CK) * BK;
    const int c = c0 + a_kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      long long pix = -1;
      if (a_valid[i]) {
        if (TAPS == 1) {
          pix = a_pix[i];
        } else {
          const int hs = a_h[i] + tap / 3 - 1;
          const int ws = a_w[i] + tap % 3 - 1;
          if (hs >= 0 && hs < H && ws >= 0 && ws < W) {
            pix = (a_pix[i] * H + hs) * W + ws;
          }
        }
      }
      const int nv = pix >= 0 ? min(8, Cin - c) : 0;
      na[i] = nv;
      ra[i] = nv > 0 ? load8(x + pix * Cin + c, nv) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = c0 + b_k + 16 * j;
      const int col = n0 + b_nc;
      const int nv = k < Cin ? min(8, Cout - col) : 0;
      rb[j] = nv > 0 ? load8(w + ((long long)tap * Cin + k) * Cout + col, nv)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store = [&](int kt, int buf) {
    const int tap = (TAPS == 1) ? 0 : kt / CK;
    const int c = (kt - tap * CK) * BK + a_kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&ra[i]);
      uint4 out;
      __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float u = 0.f;
        if (j < na[i]) {
          // no FMA contraction: the plain version rounds the product first
          u = __fadd_rn(__fmul_rn(__bfloat162float(xb[j]), __ldg(scale + c + j)),
                        __ldg(shift + c + j));
          if (relu_in && u < 0.f) u = 0.f;
        }
        ob[j] = __float2bfloat16_rn(u);
      }
      *reinterpret_cast<uint4*>(As[buf] + (a_row + 32 * i) * LDA + a_kc) = out;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<uint4*>(Bs[buf] + (b_k + 16 * j) * LDB + b_nc) = rb[j];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  store(0, 0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As[cur] + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs[cur] + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < KT) store(kt + 1, cur ^ 1);
    __syncthreads();
  }

  // epilogue: the f32 tile goes through shared memory (aliases the stages,
  // all of whose reads finished at the last barrier)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    const int m = m0 + r;
    const int col = n0 + c;
    if (m < M && col < Cout) {
      y[(long long)m * Cout + col] = __float2bfloat16_rn(Cs[r * LDC + c]);
    }
  }

  // column partials over this block's valid rows, from the f32 accumulator
  {
    const int c = tid & (BN - 1);
    const int half = tid / BN;
    float s1 = 0.f, s2 = 0.f;
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
      if (m0 + r < M) {
        const float v = Cs[r * LDC + c];
        s1 += v;
        s2 += v * v;
      }
    }
    red[0][half][c] = s1;
    red[1][half][c] = s2;
  }
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    const long long base = (long long)blockIdx.x * 2 * Cout + n0 + tid;
    partial[base] = red[0][0][tid] + red[0][1][tid];
    partial[base + Cout] = red[1][0][tid] + red[1][1][tid];
  }
}

// partial (tiles, cols) -> out (cols): a fixed summation order, so the
// statistics are the same on every run
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

int launch(int taps, const void* x, const void* scale, const void* shift,
           const void* w, void* y, void* partial, void* stats, int m, int h,
           int wd, int cin, int cout, int relu_in, void* stream) {
  if (m <= 0 || cin <= 0 || cout <= 0 || (cout + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((m + BM - 1) / BM, (cout + BN - 1) / BN);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  if (taps == 1) {
    fused_conv_fwd_kernel<1><<<grid, THREADS, 0, s>>>(xb, sc, sh, wb, yb, pp, m, h, wd,
                                                      cin, cout, relu_in);
  } else {
    fused_conv_fwd_kernel<9><<<grid, THREADS, 0, s>>>(xb, sc, sh, wb, yb, pp, m, h, wd,
                                                      cin, cout, relu_in);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int cols = 2 * cout;
  stats_reduce_kernel<<<dim3((cols + 31) / 32), dim3(32, 32), 0, s>>>(
      pp, (int)grid.x, cols, static_cast<float*>(stats));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows per block: the wrapper sizes the (tiles, 2, Cout) partials buffer by it
int dl4j_fused_conv_block_m(void) { return BM; }

// x (m, cin) bf16, scale/shift (cin,) f32, w (cin, cout) bf16
// -> y (m, cout) bf16, stats (2, cout) f32; partial is (ceil(m/BM), 2, cout) f32
int dl4j_pw_conv_fwd(const void* x, const void* scale, const void* shift,
                     const void* w, void* y, void* partial, void* stats, int m,
                     int cin, int cout, int relu_in, void* stream) {
  return launch(1, x, scale, shift, w, y, partial, stats, m, 1, 1, cin, cout,
                relu_in, stream);
}

// x (n, h, wd, cin) bf16 NHWC, w (3, 3, cin, cout) bf16 HWIO -> y (n, h, wd, cout)
int dl4j_conv3x3_fwd(const void* x, const void* scale, const void* shift,
                     const void* w, void* y, void* partial, void* stats, int n,
                     int h, int wd, int cin, int cout, int relu_in, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  return launch(9, x, scale, shift, w, y, partial, stats, n * h * wd, h, wd, cin,
                cout, relu_in, stream);
}

}  // extern "C"
