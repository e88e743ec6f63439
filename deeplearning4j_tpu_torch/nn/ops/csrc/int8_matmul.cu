// Int8 weight-only matmul for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../build.py and ../int8_matmul.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   deeplearning4j_tpu/nn/ops/int8_matmul.py _int8_kernel (pallas_call in int8_matmul)
//
// It computes   y = (x @ float(q)) * scale
//   x (B, K) f32 or bf16, q (K, N) int8, scale (N,) per output channel, f32;
//   the scale is applied once, after the whole sum, and y is stored once in
//   x's type (for bf16 x: one rounding of the f32 result).
//
// f32 stays f32 on the tensor cores. Every q (|q| <= 127) is exact in bf16,
// and a bf16 x int8 product is exact in f32. An f32 x splits exactly into
// three bf16 planes, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid) (the subtractions are exact; the planes sum back to x within
// 2^-24 |x|). So three bf16 wgmma passes over the same q registers give
// every product of x and q at f32 accuracy, summed in f32. A bf16 x is one
// plane. Not TF32, not one bf16 pass: both round x.
//
// Bound on an H100: the bytes of q at every serving bucket (1..32 rows):
// the three passes at bucket 32 take less time at 989 TFLOP/s than q's
// bytes at 3.35 TB/s. PERF.md has both.
//
// Three kernels, one C entry (dl4j_int8_matmul):
// 1. int8_planes_kernel: x -> planes (P, B, K8) bf16, P = 3 for f32 x (hi,
//    mid, lo) and 1 for bf16 x; K8 is K rounded up to 8 (rows 16-byte
//    aligned for TMA), the padding 0. Rows are not padded: TMA's zero fill
//    gives the rows past B.
// 2. int8_matmul_kernel_sm90<P>, swap-AB: y^T = q^T x^T. wgmma's M (64) runs
//    over output columns and its N over the rows of x: always m64n32k16,
//    whatever the bucket, so a row's bits do not depend on the bucket. A
//    block owns 256 output columns (four m-tiles) by 32 rows of x over a
//    chunk of the depth (a whole number of 64-deep stages):
//    - a producer streams, per stage, the q tile (64 depths x 256
//      columns: two 128-byte boxes, 128-byte swizzle) and the P plane tiles
//      (32 rows x 64 depths of bf16 each) into a ring on full/empty
//      mbarriers. q comes by TMA where its row stride allows (N % 16 == 0);
//      else the producer warpgroup's four warps write the same swizzled
//      stage with 4-byte cp.async (N % 4 == 0) or byte by byte. Zero fill
//      past K, N and B is right here: a zero q or x adds nothing, and
//      columns past N are never stored.
//    - two consumer warpgroups take the stages in turn (warpgroup w the
//      stages j with j % 2 == w). A = q^T is formed from the int8 stage
//      straight into wgmma's register layout: fragment row r of m-tile j
//      stands for column 4r + j of the block, so one 32-bit shared load gives
//      a thread the bytes of all four m-tiles at one depth, and a byte_perm
//      pairs depth k with k + 1. The widening needs no I2F: the bits
//      0x4B000000 | (q ^ 0x80) read as f32 are 2^23 + 128 + q, one subtract
//      leaves q exactly, and its upper half is bf16(q) exactly. The same A
//      registers feed P wgmmas per k-step and m-tile (B = the plane tiles,
//      K-major).
//    - the tensor cores sum one stage (4 k-steps x P planes) into `part`;
//      the CUDA cores add each stage's `part` into the f32 accumulator
//      (round to nearest), so the tensor cores' own accumulation (which
//      truncates) spans 64 depths, not the whole chunk. The second
//      warpgroup's sum is added to the first's through shared memory (the
//      first's stages, then the second's), and the first warpgroup writes
//      the block's f32 tile into its chunk's slice of the partials, undoing
//      the column permutation with float4 stores (no column >= N, no row
//      >= B).
// 3. int8_reduce_kernel: y = (the chunks' partials summed in order) * scale,
//    rounded once to y's type. No float atomics: reruns give the same bits.
// The chunking comes from K, N and the SM count (int8_matmul.py int8_split),
// never from B, so a row's summation order is the same in every bucket.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 256;                  // output columns per block (four m-tiles)
constexpr int BK = 64;                   // depths per stage
constexpr int BR = 32;                   // rows of x per block (wgmma's N)
constexpr int KSTEPS = BK / 16;          // wgmma k-steps per stage
constexpr int Q_BOX = BK * 128;          // one 128-column box of q in a stage
constexpr int Q_TILE = 2 * Q_BOX;        // a stage's q tile (64 x 256 bytes)
constexpr int PLANE_TILE = BR * 128;     // a stage's tile of one x plane (32 x 64 bf16)
constexpr int STAGES = 6;                // even: a warpgroup keeps its own ring slots
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and a producer warpgroup
constexpr int ACC = 4 * 16;              // f32 accumulators a consumer thread holds
static_assert(KSTEPS == 4, "the consumer loop is written out for four k-steps a stage");

// how the producer brings q into a stage (int8_matmul.py q_route)
constexpr int ROUTE_TMA = 0;    // N % 16 == 0 and q 16-byte aligned
constexpr int ROUTE_WORDS = 1;  // N % 4 == 0 and q 4-byte aligned: 4-byte cp.async
constexpr int ROUTE_BYTES = 2;  // anything else: byte loads and shared stores

template <int P>
struct Geo {
  static constexpr int STAGE_BYTES = Q_TILE + P * PLANE_TILE;  // 1024-aligned
  static constexpr int XCH = STAGES * STAGE_BYTES;             // the second warpgroup's sums
  static constexpr int BAR = XCH + 128 * ACC * 4;              // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;    // + the alignment slack
};

struct Args {
  const int8_t* q;   // (K, N) row-major
  float* partial;    // (splits, B, N)
  int B, K, N, chunk, route;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// 1. the x planes
// ---------------------------------------------------------------------------
// planes[p, r, k..k+7] for one row r and 8 depths; P = 3: hi, mid, lo (the
// subtractions exact, each plane rounded to nearest), P = 1: x as it is
template <typename T, int P>
__global__ void __launch_bounds__(256)
int8_planes_kernel(const T* __restrict__ x, __nv_bfloat16* __restrict__ planes, int B, int K,
                   int K8) {
  const int groups = K8 / 8;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<long long>(B) * groups) return;
  const long long r = i / groups;
  const int k = static_cast<int>(i - r * groups) * 8;
  const T* row = x + r * K;
  uint32_t out[P][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v0 = k + 2 * e < K ? to_f32(row[k + 2 * e]) : 0.f;
    const float v1 = k + 2 * e + 1 < K ? to_f32(row[k + 2 * e + 1]) : 0.f;
    if constexpr (P == 1) {
      out[0][e] = hopper::pack_bf16(v0, v1);
    } else {
      const float h0 = __bfloat162float(__float2bfloat16_rn(v0));
      const float h1 = __bfloat162float(__float2bfloat16_rn(v1));
      const float r0 = __fsub_rn(v0, h0), r1 = __fsub_rn(v1, h1);
      const float m0 = __bfloat162float(__float2bfloat16_rn(r0));
      const float m1 = __bfloat162float(__float2bfloat16_rn(r1));
      out[0][e] = hopper::pack_bf16(h0, h1);
      out[1][e] = hopper::pack_bf16(m0, m1);
      out[2][e] = hopper::pack_bf16(__fsub_rn(r0, m0), __fsub_rn(r1, m1));
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    *reinterpret_cast<uint4*>(planes + (static_cast<long long>(p) * B + r) * K8 + k) =
        make_uint4(out[p][0], out[p][1], out[p][2], out[p][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. the main kernel
// ---------------------------------------------------------------------------
// 4 bytes of global memory into shared memory, asynchronously (0 bytes read
// and 4 zeros written when !valid)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// q[k + kr, n0 + c] for 16 of the stage's 64 rows (kr = 16 pw ..) and its
// 256 columns c into the stage as TMA would write it (two 128-column boxes,
// 128-byte swizzle), 0 past K and N; by producer warp pw, each lane then
// arriving once on bar
__device__ __forceinline__ void fill_q(unsigned char* st, const Args& a, int n0, int k, int pw,
                                       int lane, uint64_t* bar) {
  if (a.route == ROUTE_WORDS) {
    // lane l: the 4 bytes of columns 4l.. of each box row (128 bytes a warp)
    for (int kr = 16 * pw; kr < 16 * pw + 16; ++kr) {
      const bool row_in = k + kr < a.K;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 128 * h + 4 * lane;
        const bool in = row_in && n < a.N;
        const int8_t* src = in ? a.q + static_cast<long long>(k + kr) * a.N + n : a.q;
        cp_async4(st + h * Q_BOX + kr * 128 + (((lane >> 2) ^ (kr & 7)) << 4) + 4 * (lane & 3),
                  src, in);
      }
    }
    cp_async_arrive(bar);
  } else {
    for (int kr = 16 * pw; kr < 16 * pw + 16; ++kr) {
      const bool row_in = k + kr < a.K;
      const int8_t* src = a.q + static_cast<long long>(k + kr) * a.N;
#pragma unroll
      for (int cb = 0; cb < 8; ++cb) {  // column 32 cb + lane of the stage
        const int nl = 32 * cb + lane;
        const int n = n0 + nl;
        const int8_t v = row_in && n < a.N ? __ldg(src + n) : static_cast<int8_t>(0);
        st[(nl >> 7) * Q_BOX + kr * 128 + ((((nl & 127) >> 4) ^ (kr & 7)) << 4) + (nl & 15)] =
            static_cast<unsigned char>(v);
      }
    }
    hopper::mbar_arrive(bar);
  }
}

// two int8 (byte j of x and of y, each XOR 0x80) -> the bf16 pair (x's low):
// 0x4B000000 | u read as f32 is 2^23 + u, less 2^23 + 128 it is q exactly,
// and the upper half of an f32 integer |q| <= 128 is bf16(q) exactly
template <int J>
__device__ __forceinline__ uint32_t widen_pair(uint32_t x, uint32_t y) {
  const float fx = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | J)), 8388736.f);
  const float fy = __fsub_rn(__uint_as_float(__byte_perm(y, 0x4B000000u, 0x7650 | J)), 8388736.f);
  return __byte_perm(__float_as_uint(fx), __float_as_uint(fy), 0x7632);
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel_sm90(__grid_constant__ const CUtensorMap mq,
                        __grid_constant__ const CUtensorMap mx, const Args a) {
  using namespace hopper;
  using G = Geo<P>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* xch = reinterpret_cast<float*>(ring + G::XCH);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::BAR);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int r0 = blockIdx.z * BR;
  const int k0 = split * a.chunk;
  const int steps = (min(a.K - k0, a.chunk) + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // TMA: one arrival with the bytes; else also one per producer thread
      mbar_init(&full[s], a.route == ROUTE_TMA ? 1 : 129);
      mbar_init(&empty[s], 4);  // the four warps of the warpgroup that read the stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    // it hands its registers to the consumers (setmaxnreg 40 / 232: 168 a
    // thread would make the consumers spill); TMA needs one thread, the
    // other routes copy q with all four warps
    regs_dec<40>();
    const int pw = warp - CONSUMERS / 32;
    if (a.route == ROUTE_TMA && pw != 0) return;
    // the second q box lies wholly past N when the block's columns end in
    // the first: it is not loaded (its rows feed columns that are not stored)
    const bool box2 = n0 + 128 < a.N;
    const uint32_t q_bytes = a.route == ROUTE_TMA ? (box2 ? Q_TILE : Q_BOX) : 0;
    for (int j = 0; j < steps; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
      unsigned char* st = ring + s * G::STAGE_BYTES;
      const int k = k0 + j * BK;
      if (a.route != ROUTE_TMA) fill_q(st, a, n0, k, pw, lane, &full[s]);
      if (pw == 0 && lane == 0) {
        mbar_expect_tx(&full[s], q_bytes + P * PLANE_TILE);
        if (a.route == ROUTE_TMA) {
          tma_load_2d(st, &mq, &full[s], n0, k);
          if (box2) tma_load_2d(st + Q_BOX, &mq, &full[s], n0 + 128, k);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load_3d(st + Q_TILE + p * PLANE_TILE, &mx, &full[s], k, r0, p);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg takes stages wg, wg + 2, ...; thread (w, g, c)
  // holds fragment rows 16w + g and 16w + g + 8 of each m-tile, that is the
  // block's columns 4(16w + g) + j and 4(16w + g + 8) + j, j = 0..3
  regs_inc<232>();
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int w = warp % 4;
  const int g = lane / 4;
  const int c = lane % 4;
  // the byte offset in a stage of the 32-bit q word (4 columns) of fragment
  // row 16w + g + 8 rs at depth 2c + par (+ 16 kk + 8 h): box w / 2, row
  // chunk 4(w % 2) + g / 4 + 2 rs, swizzled by the depth % 8 = 2c + par
  int off[2][2];
#pragma unroll
  for (int rs = 0; rs < 2; ++rs) {
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const int kr = 2 * c + par;
      const int chunk = 4 * (w & 1) + (g >> 2) + 2 * rs;
      off[rs][par] = (w >> 1) * Q_BOX + kr * 128 + ((chunk ^ kr) << 4) + 4 * (g & 3);
    }
  }

  float acc[4][16], part[4][16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = 0.f;
  }

  // k-step kk of a stage's q tile in wgmma's register A layout, m-tile j:
  // av[j] = {(row 16w + g, depths 2c, 2c + 1), (row + 8, the same), (row,
  // depths 2c + 8, 2c + 9), (row + 8, the same)}
  const auto build = [&](uint32_t (&av)[4][4], const unsigned char* tq, int kk) {
    uint32_t wd[2][4];
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        wd[rs][d] = *reinterpret_cast<const uint32_t*>(tq + off[rs][d & 1] +
                                                       (16 * kk + 8 * (d >> 1)) * 128);
      }
    }
#pragma unroll
    for (int rs = 0; rs < 2; ++rs) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t x = wd[rs][2 * h] ^ 0x80808080u;
        const uint32_t y = wd[rs][2 * h + 1] ^ 0x80808080u;
        av[0][rs + 2 * h] = widen_pair<0>(x, y);
        av[1][rs + 2 * h] = widen_pair<1>(x, y);
        av[2][rs + 2 * h] = widen_pair<2>(x, y);
        av[3][rs + 2 * h] = widen_pair<3>(x, y);
      }
    }
  };
  // part[j] += A_j . plane_p for k-step kk, the planes in the order hi,
  // mid, lo (p = 0, 1, 2), each over the four m-tiles; the first k-step of a
  // stage starts part afresh (its hi wgmma does not read it)
  const auto mma = [&](const uint32_t (&av)[4][4], const unsigned char* tp, int kk) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint64_t db = desc_kmajor(
          reinterpret_cast<const __nv_bfloat16*>(tp + p * PLANE_TILE) + kk * 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<0>(part[j], av[j], db, kk > 0 || p > 0);
    }
    wgmma_commit();
  };

  const int mine = (steps - wg + 1) / 2;  // this warpgroup's stages
  int slot = wg;                          // its stage's ring slot and full-barrier parity
  uint32_t phase = 0;
  uint32_t a0[4][4], a1[4][4];
  if (mine > 0) {
    mbar_wait(&full[slot], phase);
    build(a0, ring + slot * G::STAGE_BYTES, 0);
  }
  for (int i = 0; i < mine; ++i) {
    const unsigned char* tq = ring + slot * G::STAGE_BYTES;
    const unsigned char* tp = tq + Q_TILE;
    mma(a0, tp, 0);
    build(a1, tq, 1);
    mma(a1, tp, 1);
    wgmma_wait<1>();  // k-step 0 done: a0 is free
    build(a0, tq, 2);
    mma(a0, tp, 2);
    wgmma_wait<1>();  // k-step 1 done: a1 is free
    build(a1, tq, 3);
    mma(a1, tp, 3);
    const int done = slot;
    slot += 2;
    if (slot >= STAGES) {
      slot -= STAGES;
      phase ^= 1;
    }
    wgmma_wait<1>();  // k-step 2 done: a0 is free for the next stage
    if (i + 1 < mine) {
      mbar_wait(&full[slot], phase);
      build(a0, ring + slot * G::STAGE_BYTES, 0);
    }
    wgmma_wait<0>();  // the stage is done: its slot and part are free
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_regs(part[j]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[done]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
    }
  }

  // the second warpgroup's sums after the first's
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 16; ++e) xch[(16 * j + e) * 128 + t] = acc[j][e];
    }
  }
  named_barrier(1, CONSUMERS);
  if (wg == 1) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[j][e] = __fadd_rn(acc[j][e], xch[(16 * j + e) * 128 + t]);
  }

  // fragment row r of m-tile j is column n0 + 4r + j: the four m-tiles'
  // values of one (row, x row) are four neighbouring columns
  float* out = a.partial + static_cast<long long>(split) * a.B * a.N;
  const bool vec = (a.N & 3) == 0;  // 16-byte aligned column quads
#pragma unroll
  for (int slot2 = 0; slot2 < 2; ++slot2) {
    const int n = n0 + 4 * (16 * w + g + 8 * slot2);
    if (n >= a.N) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int b = r0 + 8 * i + 2 * c + e;
        if (b >= a.B) continue;
        const int idx = 4 * i + 2 * slot2 + e;
        float* p = out + static_cast<long long>(b) * a.N + n;
        if (vec) {
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[0][idx], acc[1][idx], acc[2][idx], acc[3][idx]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (n + j < a.N) p[j] = acc[j][idx];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the reduce
// ---------------------------------------------------------------------------
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

template <typename T, int P>
int launch(const void* x, const void* q, const void* scale, void* planes, void* partial, void* y,
           int B, int K, int N, int chunk, int splits, int route, cudaStream_t s) {
  const int k8 = (K + 7) / 8 * 8;
  const long long groups = static_cast<long long>(B) * (k8 / 8);
  auto* pl = static_cast<__nv_bfloat16*>(planes);
  int8_planes_kernel<T, P><<<static_cast<unsigned>((groups + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(x), pl, B, K, k8);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  CUtensorMap mq{}, mx{};
  int err = hopper::encode_stack(&mx, pl, K, B, P, k8, BR);
  if (err != 0) return err;
  if (route == ROUTE_TMA) {
    err = hopper::encode_bytes(&mq, q, N, K, N, BK);
    if (err != 0) return err;
  }
  static bool done[64] = {};  // per P: each instantiation opts in for itself
  err = hopper::opt_in_smem(int8_matmul_kernel_sm90<P>, Geo<P>::BYTES, done);
  if (err != 0) return err;
  const Args a{static_cast<const int8_t*>(q), static_cast<float*>(partial), B, K, N, chunk,
               route};
  const dim3 grid((N + BN - 1) / BN, splits, (B + BR - 1) / BR);
  int8_matmul_kernel_sm90<P><<<grid, THREADS, Geo<P>::BYTES, s>>>(mq, mx, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long total = static_cast<long long>(B) * N;
  int8_reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale), static_cast<T*>(y),
      splits, B, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tile sizes: 0 -> rows of x per block, 1 -> output columns per block,
// 2 -> depths per stage (a chunk is a multiple of it)
int dl4j_int8_matmul_tile(int which) { return which == 0 ? BR : which == 1 ? BN : BK; }

// x (b, k) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), q (k, n) int8 row-major,
// scale (n,) f32 -> y (b, n) in x's type. planes is (P, b, k rounded up to
// 8) bf16 scratch (P = 3 for f32 x, 1 for bf16), partial (splits, b, n) f32
// scratch; the depth splits into `splits` chunks of `chunk` (a multiple of
// 64, chunk * splits >= k, no chunk empty). route: how q reaches the stages
// (0 TMA: n % 16 == 0 and q 16-byte aligned; 1 4-byte cp.async: n % 4 == 0
// and q 4-byte aligned; 2 bytes).
int dl4j_int8_matmul(const void* x, const void* q, const void* scale, void* planes,
                     void* partial, void* y, int b, int k, int n, int chunk, int splits,
                     int x_bf16, int route, void* stream) {
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  if (b <= 0 || k <= 0 || n <= 0 || chunk <= 0 || chunk % BK != 0 || splits <= 0 ||
      splits > 65535 || (b + BR - 1) / BR > 65535 || (long long)chunk * splits < k ||
      (long long)chunk * (splits - 1) >= k || reinterpret_cast<uintptr_t>(planes) % 16 != 0 ||
      (route == ROUTE_TMA && (n % 16 != 0 || qa % 16 != 0)) ||
      (route == ROUTE_WORDS && (n % 4 != 0 || qa % 4 != 0)) || route < 0 ||
      route > ROUTE_BYTES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch<__nv_bfloat16, 1>(x, q, scale, planes, partial, y, b, k, n, chunk, splits,
                                    route, s);
  }
  return launch<float, 3>(x, q, scale, planes, partial, y, b, k, n, chunk, splits, route, s);
}

}  // extern "C"
