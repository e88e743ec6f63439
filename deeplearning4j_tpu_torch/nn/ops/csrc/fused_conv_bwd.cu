// Fused conv+BN+ReLU backward kernels for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ../build.py and ../fused_conv.py).
//
// Replaces the Pallas TPU kernels of the JAX package
// (deeplearning4j_tpu/nn/ops/fused_conv.py):
//   pw_conv dx   <- _pw_bwd_dx_kernel      pw_conv dW   <- _pw_bwd_dw_kernel
//   conv3x3 dx   <- _c3_bwd_dx_kernel      conv3x3 dW   <- _c3_bwd_dw_kernel
//
// The forward op is  y, stats = conv(xn, W),  xn = act(x * scale + shift).
// Its backward takes the cotangents (dz of y, dst of stats) and the saved
// (x, scale, shift, W, z = y in bf16):
//   dz_eff = dz + dst[0] + 2 * z * dst[1]           f32, rounded to bf16
//   dxn    = dz_eff (*) W^T                         transposed conv, f32 sum
//   du     = relu_in ? (u > 0 ? dxn : 0) : dxn,     u = x * scale + shift
//   dx     = bf16(du * scale);  dscale = sum du*x;  dshift = sum du
//   dW     = xn(bf16)^T (*) dz_eff(bf16)            f32 sum, rounded to bf16
// The f32 products and sums are written with __fmul_rn/__fadd_rn where the
// plain version rounds each step, so the two round alike.
//
// Design. Two kernel templates, each an implicit GEMM with 64x64 output
// tiles, four warps of 16x16x16 bf16 WMMA into f32 accumulators, depth in
// steps of 32 through two shared-memory stages (the next step's global loads
// wait in registers while the tensor cores work), as in fused_conv.cu.
//
// dx: rows = pixels, columns = Cin, depth = TAPS * Cout. The A tile is
//   dz_eff, formed from dz, z and dst as it is read. For the 3x3 conv the
//   tap (dy, dx) of output pixel (h, w) reads dz_eff at (h+1-dy, w+1-dx):
//   the transposed conv with the taps flipped. An out-of-image tap loads 0,
//   NOT dz_eff of a zero pixel (which would add dst[0]): the Pallas kernel
//   forms dz_eff over the valid pixels only and scatters into a zero halo.
//   The epilogue recomputes u from x, applies the ReLU mask and the scale,
//   stores dx, and writes per-block column partials of du*x and du that a
//   second kernel sums over the row tiles in a fixed order.
// dW: rows = Cin, columns = Cout, depth = pixels, one GEMM per tap. The
//   output is small and the depth huge (stage 1 at batch 32: one 64x64 tile
//   over 100352 pixels). The TPU accumulated over a sequential grid
//   (dw_ref +=); here the pixels are split into chunks across blocks (grid z
//   = tap x chunk), each writes an f32 partial tile, and a second kernel sums
//   the partials in a fixed order and rounds to bf16 only after the sum. No
//   float atomics: the result is the same on every run. The 3x3 input halo
//   is zero AFTER the fold, as in the forward.
//
// Bound on an H100: the deep GEMMs are bound by tensor-core operations, the
// 64-channel stage-1 ones by bytes (see chip_smoke.py phase 2b). Simple first
// kernels; wgmma and TMA are later work. Times are in PERF.md.

#include <mma.h>

#include "fused_conv_common.cuh"

namespace {

using namespace nvcuda;

// dx kernel: A tile [row][k] (pixels x Cout-depth), B tile [n][k] (Cin x
// Cout-depth, read as col-major K x N)
constexpr int LDK = BK + 8;
constexpr int LDC = BN + 4;
constexpr int DX_STAGE = BM * LDK + BN * LDK;                  // bf16 elements
constexpr int DX_AB_BYTES = 2 * DX_STAGE * 2;
// dW kernel: A tile [k][i] (pixel-depth x Cin, read as col-major M x K),
// B tile [k][n] (pixel-depth x Cout)
constexpr int LDT = BM + 8;
constexpr int DW_STAGE = BK * LDT + BK * LDT;
constexpr int DW_AB_BYTES = 2 * DW_STAGE * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int DX_SMEM = DX_AB_BYTES > C_BYTES ? DX_AB_BYTES : C_BYTES;
constexpr int DW_SMEM = DW_AB_BYTES > C_BYTES ? DW_AB_BYTES : C_BYTES;

__device__ __forceinline__ float dz_eff(float dz, float z, float d0, float d1) {
  // (dz + dst0) + (2z) * dst1, each step rounded, as the plain version
  return __fadd_rn(__fadd_rn(dz, d0), __fmul_rn(2.f * z, d1));
}

// 8 channels of dz_eff from raw dz/z registers; channels past n_valid are 0
__device__ __forceinline__ uint4 dz_eff8(uint4 rdz, uint4 rz, const float* dst,
                                         int cout, int c, int n_valid) {
  const __nv_bfloat16* d = reinterpret_cast<const __nv_bfloat16*>(&rdz);
  const __nv_bfloat16* zz = reinterpret_cast<const __nv_bfloat16*>(&rz);
  uint4 out;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float e = 0.f;
    if (j < n_valid) {
      e = dz_eff(__bfloat162float(d[j]), __bfloat162float(zz[j]),
                 __ldg(dst + c + j), __ldg(dst + cout + c + j));
    }
    ob[j] = __float2bfloat16_rn(e);
  }
  return out;
}

// 8 channels of the folded input xn = act(x * scale + shift) in bf16
__device__ __forceinline__ uint4 fold8(uint4 rx, const float* scale, const float* shift,
                                       int c, int n_valid, int relu_in) {
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&rx);
  uint4 out;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float u = 0.f;
    if (j < n_valid) {
      u = __fadd_rn(__fmul_rn(__bfloat162float(xb[j]), __ldg(scale + c + j)),
                    __ldg(shift + c + j));
      if (relu_in && u < 0.f) u = 0.f;
    }
    ob[j] = __float2bfloat16_rn(u);
  }
  return out;
}

// pixel m -> (image, row, col) of an H x W image
struct Pixel {
  long long n;
  int h, w;
};

__device__ __forceinline__ Pixel pixel_of(int m, int H, int W) {
  const int hw = H * W;
  const int n = m / hw;
  const int r = m - n * hw;
  Pixel p;
  p.n = n;
  p.h = r / W;
  p.w = r - p.h * W;
  return p;
}

// ---------------------------------------------------------------------------
// dx, dscale, dshift
// ---------------------------------------------------------------------------

template <int TAPS>
__global__ void __launch_bounds__(THREADS)
conv_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ z,
                   const __nv_bfloat16* __restrict__ dz,
                   const float* __restrict__ dst,
                   __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ partial,
                   int M, int H, int W, int Cin, int Cout, int relu_in) {
  __shared__ __align__(128) unsigned char smem[DX_SMEM];
  __shared__ float red[2][2][BN];

  __nv_bfloat16* As[2];
  __nv_bfloat16* Bs[2];
  As[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  Bs[0] = As[0] + BM * LDK;
  As[1] = Bs[0] + BN * LDK;
  Bs[1] = As[1] + BM * LDK;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;   // first input channel of the tile

  // A tile: each thread stages one 8-channel chunk of rows r and r + 32
  const int a_row = tid >> 2;
  const int a_kc = (tid & 3) * 8;
  bool a_valid[2];
  Pixel a_px[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + a_row + 32 * i;
    a_valid[i] = m < M;
    if (TAPS == 1) {
      a_px[i].n = m;
      a_px[i].h = a_px[i].w = 0;
    } else {
      a_px[i] = pixel_of(a_valid[i] ? m : 0, H, W);
    }
  }
  // B tile: each thread stages one 8-channel (Cout) chunk of Cin rows r, r + 32
  const int b_row = tid >> 2;
  const int b_kc = (tid & 3) * 8;

  const int CK = (Cout + BK - 1) / BK;
  const int KT = TAPS * CK;

  uint4 rdz[2], rz[2], rb[2];
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
          pix = a_px[i].n;
        } else {
          // flipped tap: the transposed conv
          const int hs = a_px[i].h + 1 - tap / 3;
          const int ws = a_px[i].w + 1 - tap % 3;
          if (hs >= 0 && hs < H && ws >= 0 && ws < W) {
            pix = (a_px[i].n * H + hs) * W + ws;
          }
        }
      }
      const int nv = pix >= 0 ? min(8, Cout - c) : 0;
      na[i] = nv;
      rdz[i] = nv > 0 ? load8(dz + pix * Cout + c, nv) : make_uint4(0u, 0u, 0u, 0u);
      rz[i] = nv > 0 ? load8(z + pix * Cout + c, nv) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ci = n0 + b_row + 32 * j;
      const int co = c0 + b_kc;
      const int nv = ci < Cin ? min(8, Cout - co) : 0;
      rb[j] = nv > 0 ? load8(w + ((long long)tap * Cin + ci) * Cout + co, nv)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store = [&](int kt, int buf) {
    const int tap = (TAPS == 1) ? 0 : kt / CK;
    const int c = (kt - tap * CK) * BK + a_kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<uint4*>(As[buf] + (a_row + 32 * i) * LDK + a_kc) =
          dz_eff8(rdz[i], rz[i], dst, Cout, c, na[i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<uint4*>(Bs[buf] + (b_row + 32 * j) * LDK + b_kc) = rb[j];
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As[cur] + (wm * 32 + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs[cur] + (wn * 32 + j * 16) * LDK + kk, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < KT) store(kt + 1, cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // epilogue: thread (c, half) walks 32 rows of column c; neighbouring
  // threads touch neighbouring channels of one row (coalesced)
  const int c = tid & (BN - 1);
  const int half = tid / BN;
  const int ci = n0 + c;
  float s_dux = 0.f, s_du = 0.f;
  if (ci < Cin) {
    const float sc = __ldg(scale + ci);
    const float sh = __ldg(shift + ci);
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
      const int m = m0 + r;
      if (m >= M) break;
      const long long off = (long long)m * Cin + ci;
      const float xv = __bfloat162float(x[off]);
      float du = Cs[r * LDC + c];
      if (relu_in && !(__fadd_rn(__fmul_rn(xv, sc), sh) > 0.f)) du = 0.f;
      dx[off] = __float2bfloat16_rn(__fmul_rn(du, sc));
      s_dux += du * xv;
      s_du += du;
    }
  }
  red[0][half][c] = s_dux;
  red[1][half][c] = s_du;
  __syncthreads();
  if (tid < BN && n0 + tid < Cin) {
    const long long base = (long long)blockIdx.x * 2 * Cin + n0 + tid;
    partial[base] = red[0][0][tid] + red[0][1][tid];
    partial[base + Cin] = red[1][0][tid] + red[1][1][tid];
  }
}

// ---------------------------------------------------------------------------
// dW, split over pixel chunks
// ---------------------------------------------------------------------------

template <int TAPS>
__global__ void __launch_bounds__(THREADS)
conv_bwd_dw_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const __nv_bfloat16* __restrict__ z,
                   const __nv_bfloat16* __restrict__ dz,
                   const float* __restrict__ dst,
                   float* __restrict__ partial,
                   int M, int H, int W, int Cin, int Cout, int relu_in, int chunk) {
  __shared__ __align__(128) unsigned char smem[DW_SMEM];

  __nv_bfloat16* As[2];
  __nv_bfloat16* Bs[2];
  As[0] = reinterpret_cast<__nv_bfloat16*>(smem);
  Bs[0] = As[0] + BK * LDT;
  As[1] = Bs[0] + BK * LDT;
  Bs[1] = As[1] + BK * LDT;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int i0 = blockIdx.x * BM;   // first input channel of the tile
  const int n0 = blockIdx.y * BN;   // first output channel of the tile
  const int tap = (TAPS == 1) ? 0 : blockIdx.z % TAPS;
  const int split = blockIdx.z / TAPS;
  const int p_begin = split * chunk;
  const int p_end = min(M, p_begin + chunk);
  const int dy = tap / 3 - 1;
  const int dxo = tap % 3 - 1;

  // both tiles: each thread stages one 8-channel chunk of depth rows k, k + 16
  const int t_k = tid >> 3;
  const int t_c = (tid & 7) * 8;

  const int KT = (p_end - p_begin + BK - 1) / BK;

  uint4 ra[2], rdz[2], rz[2];
  int na[2], nb[2];

  auto load = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = p_begin + kt * BK + t_k + 16 * j;
      long long src = -1;
      if (p < p_end) {
        if (TAPS == 1) {
          src = p;
        } else {
          const Pixel px = pixel_of(p, H, W);
          const int hs = px.h + dy;
          const int ws = px.w + dxo;
          if (hs >= 0 && hs < H && ws >= 0 && ws < W) src = (px.n * H + hs) * W + ws;
        }
      }
      // the zero halo: an out-of-image tap contributes 0, not act(shift)
      const int nva = src >= 0 ? min(8, Cin - (i0 + t_c)) : 0;
      na[j] = nva;
      ra[j] = nva > 0 ? load8(x + src * Cin + i0 + t_c, nva) : make_uint4(0u, 0u, 0u, 0u);
      const int nvb = p < p_end ? min(8, Cout - (n0 + t_c)) : 0;
      nb[j] = nvb;
      const long long off = (long long)p * Cout + n0 + t_c;
      rdz[j] = nvb > 0 ? load8(dz + off, nvb) : make_uint4(0u, 0u, 0u, 0u);
      rz[j] = nvb > 0 ? load8(z + off, nvb) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = t_k + 16 * j;
      *reinterpret_cast<uint4*>(As[buf] + k * LDT + t_c) =
          fold8(ra[j], scale, shift, i0 + t_c, na[j], relu_in);
      *reinterpret_cast<uint4*>(Bs[buf] + k * LDT + t_c) =
          dz_eff8(rdz[j], rz[j], dst, Cout, n0 + t_c, nb[j]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (KT > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As[cur] + kk * LDT + wm * 32 + i * 16, LDT);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs[cur] + kk * LDT + wn * 32 + j * 16, LDT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  float* out = partial + ((long long)split * TAPS + tap) * Cin * Cout;
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    if (i0 + r < Cin && n0 + c < Cout) {
      out[(long long)(i0 + r) * Cout + n0 + c] = Cs[r * LDC + c];
    }
  }
}

// partial (splits, n) f32 -> out (n) bf16, summed over the splits in order
__global__ void dw_reduce_kernel(const float* __restrict__ partial, int splits,
                                 long long n, __nv_bfloat16* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(long long)k * n + i];
  out[i] = __float2bfloat16_rn(s);
}

int launch_dx(int taps, const void* x, const void* scale, const void* shift,
              const void* w, const void* z, const void* dz, const void* dst, void* dx,
              void* partial, void* gst, int m, int h, int wd, int cin, int cout,
              int relu_in, void* stream) {
  if (m <= 0 || cin <= 0 || cout <= 0 || (cin + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((m + BM - 1) / BM, (cin + BN - 1) / BN);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  const auto* dzb = static_cast<const __nv_bfloat16*>(dz);
  const auto* ds = static_cast<const float*>(dst);
  auto* dxb = static_cast<__nv_bfloat16*>(dx);
  auto* pp = static_cast<float*>(partial);
  if (taps == 1) {
    conv_bwd_dx_kernel<1><<<grid, THREADS, 0, s>>>(xb, sc, sh, wb, zb, dzb, ds, dxb, pp,
                                                   m, h, wd, cin, cout, relu_in);
  } else {
    conv_bwd_dx_kernel<9><<<grid, THREADS, 0, s>>>(xb, sc, sh, wb, zb, dzb, ds, dxb, pp,
                                                   m, h, wd, cin, cout, relu_in);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_stats_reduce(pp, (int)grid.x, 2 * cin, static_cast<float*>(gst), s);
}

int launch_dw(int taps, const void* x, const void* scale, const void* shift,
              const void* z, const void* dz, const void* dst, void* partial, void* dw,
              int m, int h, int wd, int cin, int cout, int relu_in, int chunk,
              void* stream) {
  if (m <= 0 || cin <= 0 || cout <= 0 || chunk <= 0 || chunk % BK != 0 ||
      (cout + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int splits = (m + chunk - 1) / chunk;
  if ((long long)splits * taps > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((cin + BM - 1) / BM, (cout + BN - 1) / BN, splits * taps);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  const auto* dzb = static_cast<const __nv_bfloat16*>(dz);
  const auto* ds = static_cast<const float*>(dst);
  auto* pp = static_cast<float*>(partial);
  if (taps == 1) {
    conv_bwd_dw_kernel<1><<<grid, THREADS, 0, s>>>(xb, sc, sh, zb, dzb, ds, pp, m, h, wd,
                                                   cin, cout, relu_in, chunk);
  } else {
    conv_bwd_dw_kernel<9><<<grid, THREADS, 0, s>>>(xb, sc, sh, zb, dzb, ds, pp, m, h, wd,
                                                   cin, cout, relu_in, chunk);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)taps * cin * cout;
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      pp, splits, n, static_cast<__nv_bfloat16*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tile sizes: 0 -> rows per dx block (sizes the (tiles, 2, Cin) partials),
// 1 -> columns per block, 2 -> depth step (the dW pixel chunk is a multiple)
int dl4j_fused_conv_bwd_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : BK;
}

// x (m, cin) bf16, scale/shift (cin,) f32, w (cin, cout) bf16, z/dz (m, cout)
// bf16, dst (2, cout) f32 -> dx (m, cin) bf16, gst (2, cin) f32 = [dscale;
// dshift]; partial is (ceil(m/BM), 2, cin) f32
int dl4j_pw_conv_bwd_dx(const void* x, const void* scale, const void* shift,
                        const void* w, const void* z, const void* dz, const void* dst,
                        void* dx, void* partial, void* gst, int m, int cin, int cout,
                        int relu_in, void* stream) {
  return launch_dx(1, x, scale, shift, w, z, dz, dst, dx, partial, gst, m, 1, 1, cin,
                   cout, relu_in, stream);
}

// NHWC x (n, h, wd, cin), HWIO w (3, 3, cin, cout), z/dz (n, h, wd, cout)
int dl4j_conv3x3_bwd_dx(const void* x, const void* scale, const void* shift,
                        const void* w, const void* z, const void* dz, const void* dst,
                        void* dx, void* partial, void* gst, int n, int h, int wd,
                        int cin, int cout, int relu_in, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  return launch_dx(9, x, scale, shift, w, z, dz, dst, dx, partial, gst, n * h * wd, h,
                   wd, cin, cout, relu_in, stream);
}

// -> dw (cin, cout) bf16; partial is (ceil(m/chunk), cin, cout) f32
int dl4j_pw_conv_bwd_dw(const void* x, const void* scale, const void* shift,
                        const void* z, const void* dz, const void* dst, void* partial,
                        void* dw, int m, int cin, int cout, int relu_in, int chunk,
                        void* stream) {
  return launch_dw(1, x, scale, shift, z, dz, dst, partial, dw, m, 1, 1, cin, cout,
                   relu_in, chunk, stream);
}

// -> dw (3, 3, cin, cout) bf16; partial is (ceil(m/chunk), 9, cin, cout) f32
int dl4j_conv3x3_bwd_dw(const void* x, const void* scale, const void* shift,
                        const void* z, const void* dz, const void* dst, void* partial,
                        void* dw, int n, int h, int wd, int cin, int cout, int relu_in,
                        int chunk, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  return launch_dw(9, x, scale, shift, z, dz, dst, partial, dw, n * h * wd, h, wd, cin,
                   cout, relu_in, chunk, stream);
}

}  // extern "C"
