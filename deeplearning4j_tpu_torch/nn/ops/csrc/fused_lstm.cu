// Fused (Graves)LSTM cell for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../build.py and ../fused_lstm.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   deeplearning4j_tpu/nn/ops/fused_lstm.py _cell_kernel (pallas_call in _cell_impl)
//
// One time step of an LSTM layer, gates packed [i, f, o, g] as in the
// reference:
//   z  = x @ Wx + h @ Wh + b                       (B, 4n)
//   i  = sig(z_i [+ pI*c]),  f = sig(z_f [+ pF*c]),  g = tanh(z_g)
//   c' = f*c + i*g
//   o  = sig(z_o [+ pO*c'])                        (peepholes: c feeds i and
//   h' = o*tanh(c')                                 f, c' feeds o)
// Only h' and c' leave the kernel: z stays in the block.
//
// Types. Each operand keeps the type it arrives in: x (TX), the weights
// Wx/Wh/b/pI/pF/pO (TW) and the carries h/c (TS) are each f32 or bf16
// (under compute_dtype="bfloat16" the reference feeds bf16 x and weights
// with f32 carries). bf16 widens exactly; every product and sum is an f32
// FMA on the CUDA cores (the reference pins f32 to full precision: no TF32,
// no tensor cores); the gate chain runs in f32 with expf/tanhf; h' and c'
// are rounded once, to bf16 when x, the weights and the carries are all
// bf16, else stored as f32 (the type JAX's promotion gives the reference's
// outputs).
//
// Bound on an H100: at the serving shapes (B = 1 per prefill step, B = the
// slot count per decode step; n_in = 77 or 256, n = 256) the cell reads the
// (n_in + n) x 4n weights (1.4 and 2.1 MB in f32) and does 4 B (n_in + n) n
// FMAs; counted once, the bytes bound it (about 1 us a cell), and launching
// a kernel costs more than that. So the design spreads the work over the
// SMs and keeps every load of the depth in flight at once.
//
// Design. One block owns U hidden units with all four gates (4U weight
// columns) and R rows of x: the whole gate chain stays in the block, one
// launch a cell. The grid is ceil(n / U) x ceil(B / R); fused_lstm.py
// lstm_tiles picks (U, R) for about one wave of blocks. The depth of
// [x | h] is streamed through a ring of STAGES stages in shared memory on
// full/empty mbarriers: stage j holds D depths of Wx (the first
// ceil(n_in / D) stages) or of Wh (the rest), gate strips of U units, and
// the same depths of the block's R rows of x or h.
// - A producer warpgroup fills the ring. The weights come by TMA through a
//   3-D map of Wx (and one of Wh) seen as (rows, 4, n): one box (U, 4, D)
//   brings a stage's four gate strips, laid out [D][4][U]. Where the strips
//   are not 16-byte aligned (n * elt % 16 != 0, or a base off 16 bytes) the
//   producers write the same layout by 4-byte cp.async, and where not even
//   4-byte aligned (bf16 and an odd n) element by element. The rows of x
//   or h come by 16-byte cp.async, 4-byte cp.async, or element by element,
//   by the same rule on their own row length and base (fused_lstm.py
//   lstm_route), into rows of D + 16 / elt elements (the pad puts
//   neighbouring rows on other banks). Depths past n_in or n and rows past
//   B arrive as zeros (TMA's zero fill, a zero-byte cp.async, a stored
//   zero): a zero weight times a zero input adds nothing. No operand is
//   padded or copied per call. The rows' copies cost more than the FMAs:
//   a warpgroup of producers shares them (PERF.md § 6, PR 17).
// - WARPS consumer warps split each stage's depths: warp w takes depths
//   [w DW, (w + 1) DW) of every stage and keeps its own f32 sums for all of
//   the block's (row, column) outputs, lane (rg, cg) the rows rg + (32 / U) i
//   and the four columns 4 cg .. 4 cg + 3 (a float4 of weights a depth,
//   one x value a row and depth, RL x 4 FMAs).
// - The warps' sums meet in shared memory and a thread per (row, unit) adds
//   them in warp order, then the bias, and runs the gate chain; its bias,
//   peepholes and c were loaded before the depth loop.
//
// Batch invariance. A row's sum over the depth runs in an order fixed by D,
// WARPS, n_in and n alone: each warp's FMAs over its depths, stage by stage,
// then the warps' sums in warp order, then the bias. Nothing depends on B,
// R, U or the route, and no float atomic is used. So a row's h' and c' are
// the same bits at B = 1 and at B = 32, and reruns are bit-identical (the
// generation engine's "a slot among others == the slot alone").

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int D = 128;                   // depths of [x | h] a stage
constexpr int WARPS = 8;                 // consumer warps, splitting each stage's depths
constexpr int DW = D / WARPS;            // depths of a stage one warp sums
constexpr int STAGES = 4;                // ring slots (a power of two)
constexpr int CONSUMERS = WARPS * 32;
constexpr int PRODUCERS = 128;           // a producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
static_assert(DW % 4 == 0, "a warp reads its depths four at a time");
static_assert((STAGES & (STAGES - 1)) == 0, "the ring's index is a mask");

// how an operand reaches the stages (fused_lstm.py lstm_route)
constexpr int ROUTE_WIDE = 0;      // 16-byte aligned: weights by TMA, rows by 16-byte cp.async
constexpr int ROUTE_WORDS = 1;     // 4-byte aligned: 4-byte cp.async
constexpr int ROUTE_ELEMENTS = 2;  // anything else: loads and shared stores

struct Args {
  const void* x;  // (B, n_in)
  const void* h;  // (B, n)
  const void* c;  // (B, n)
  const void* wx;  // (n_in, 4n)
  const void* wh;  // (n, 4n)
  const void* b;  // (4n,)
  const void* p_i;
  const void* p_f;
  const void* p_o;
  void* h_out;
  void* c_out;
  int B, n_in, n, peep, w_route, x_route, h_route;
};

// a staged row of D elements of T, padded by 16 bytes
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return D * static_cast<int>(sizeof(T)) + 16;
}

__host__ __device__ constexpr int round128(int v) { return (v + 127) / 128 * 128; }

// the block's shared memory: STAGES stages of (weights [D][4][U] of TW, then
// R rows of x or h), the warps' sums [WARPS][4][R][U] f32, the barriers
template <typename TX, typename TW, typename TS, int U, int RL>
struct Geo {
  static constexpr int G = 32 / U;        // row groups of a warp: lane = rg * U + cg
  static constexpr int R = RL * G;        // rows of x a block
  static constexpr int W_BYTES = D * 4 * U * static_cast<int>(sizeof(TW));
  static constexpr int ROW = row_bytes<TX>() > row_bytes<TS>() ? row_bytes<TX>() : row_bytes<TS>();
  static constexpr int STAGE = round128(W_BYTES + R * ROW);
  static constexpr int RED = STAGES * STAGE;
  static constexpr int BAR = RED + WARPS * 4 * R * U * 4;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + the alignment slack
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

// four neighbouring elements of shared memory, widened to f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

// 4 or 16 bytes of global memory into shared memory, asynchronously
// (nothing read and zeros written when !valid)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// The weight strips of one stage without TMA: w[k + d, g n + u0 + u] for the
// stage's D depths d, the four gates g and U units u into [D][4][U], zero
// past `rows` (the depth of Wx or Wh) and past n; by producer thread p.
template <typename TW, int U>
__device__ __forceinline__ void fill_weights(unsigned char* st, const TW* w, int rows, int n,
                                             int k, int u0, int route, int p) {
  const long long n4 = 4LL * n;
  if (route == ROUTE_WORDS) {
    constexpr int PER = 4 / sizeof(TW);              // elements a word
    constexpr int WPS = U * sizeof(TW) / 4;          // words a strip
#pragma unroll 4
    for (int i = p; i < D * 4 * WPS; i += PRODUCERS) {
      const int wd = i % WPS, g = (i / WPS) % 4, d = i / (4 * WPS);
      const int u = u0 + wd * PER;
      const bool in = k + d < rows && u < n;
      const TW* src = in ? w + (k + d) * n4 + g * n + u : w;
      cp_async4(st + 4 * i, src, in);
    }
  } else {
    TW* dst = reinterpret_cast<TW*>(st);
#pragma unroll 8
    for (int i = p; i < D * 4 * U; i += PRODUCERS) {
      const int u = i % U, g = (i / U) % 4, d = i / (4 * U);
      const bool in = k + d < rows && u0 + u < n;
      dst[i] = in ? w[(k + d) * n4 + g * n + u0 + u] : TW(0.f);
    }
  }
}

// The rows [r0, r0 + live) of src (rows of len elements) at depths [k, k +
// D) into rows of row_bytes<T>() bytes, zero past live and len; by producer
// thread p.
template <typename T, int R>
__device__ __forceinline__ void fill_rows(unsigned char* st, const T* src, int len, int live,
                                          int r0, int k, int route, int p) {
  constexpr int ROW = row_bytes<T>();
  if (route == ROUTE_WIDE) {
    constexpr int PER = 16 / sizeof(T);
    constexpr int CH = D / PER;  // 16-byte chunks a row
#pragma unroll 4
    for (int i = p; i < R * CH; i += PRODUCERS) {
      const int r = i / CH, e = k + (i % CH) * PER;
      const bool in = r < live && e < len;
      cp_async16(st + r * ROW + 16 * (i % CH),
                 in ? src + static_cast<long long>(r0 + r) * len + e : src, in);
    }
  } else if (route == ROUTE_WORDS) {
    constexpr int PER = 4 / sizeof(T);
    constexpr int WD = D / PER;  // words a row
#pragma unroll 4
    for (int i = p; i < R * WD; i += PRODUCERS) {
      const int r = i / WD, e = k + (i % WD) * PER;
      const bool in = r < live && e < len;
      cp_async4(st + r * ROW + 4 * (i % WD), in ? src + static_cast<long long>(r0 + r) * len + e : src,
                in);
    }
  } else {
#pragma unroll 8
    for (int i = p; i < R * D; i += PRODUCERS) {
      const int r = i / D, e = k + i % D;
      const bool in = r < live && e < len;
      reinterpret_cast<T*>(st + r * ROW)[i % D] =
          in ? src[static_cast<long long>(r0 + r) * len + e] : T(0.f);
    }
  }
}

// One stage into a consumer lane's sums: depths [warp DW, warp DW + DW) in
// order, rows rg + G i, columns 4 cg .. 4 cg + 3.
template <typename T, typename TW, int U, int RL>
__device__ __forceinline__ void mac(float (&acc)[RL][4], const unsigned char* st, int warp,
                                    int rg, int cg) {
  constexpr int G = 32 / U;
  constexpr int ROW = row_bytes<T>();
  const TW* wt = reinterpret_cast<const TW*>(st);
  const unsigned char* rt = st + D * 4 * U * static_cast<int>(sizeof(TW));
#pragma unroll
  for (int q = 0; q < DW / 4; ++q) {
    const int d = warp * DW + 4 * q;
    float xv[RL][4];
#pragma unroll
    for (int i = 0; i < RL; ++i) load4(reinterpret_cast<const T*>(rt + (rg + G * i) * ROW) + d, xv[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float wv[4];
      load4(wt + (d + e) * 4 * U + 4 * cg, wv);
#pragma unroll
      for (int i = 0; i < RL; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv[i][e], wv[c], acc[i][c]);
      }
    }
  }
}

template <typename TX, typename TW, typename TS>
using Out = typename std::conditional<sizeof(TX) == 2 && sizeof(TW) == 2 && sizeof(TS) == 2,
                                      __nv_bfloat16, float>::type;

template <typename TX, typename TW, typename TS, int U, int RL>
__global__ void __launch_bounds__(THREADS, 1)
lstm_cell_kernel_sm90(__grid_constant__ const CUtensorMap mwx,
                      __grid_constant__ const CUtensorMap mwh, const Args a) {
  using namespace hopper;
  using Ge = Geo<TX, TW, TS, U, RL>;
  using TO = Out<TX, TW, TS>;
  constexpr int R = Ge::R;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(ring + Ge::RED);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Ge::BAR);
  uint64_t* empty = full + STAGES;

  const int u0 = blockIdx.x * U;
  const int r0 = blockIdx.y * R;
  const int xs = (a.n_in + D - 1) / D;  // stages over Wx and x, then over Wh and h
  const int stages = xs + (a.n + D - 1) / D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool async_copy =
      a.w_route == ROUTE_WORDS || a.x_route != ROUTE_ELEMENTS || a.h_route != ROUTE_ELEMENTS;
  const bool plain_copy =
      a.w_route == ROUTE_ELEMENTS || a.x_route == ROUTE_ELEMENTS || a.h_route == ROUTE_ELEMENTS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // producer thread 0's arrival (with the TMA bytes), and one a producer
      // thread for each way of copying this launch uses
      mbar_init(&full[s], 1 + PRODUCERS * (async_copy + plain_copy));
      mbar_init(&empty[s], WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= WARPS) {  // the producer warpgroup
    const int p = threadIdx.x - CONSUMERS;
    const TW* wx = static_cast<const TW*>(a.wx);
    const TW* wh = static_cast<const TW*>(a.wh);
    const int live = min(R, a.B - r0);
    if (p == 0 && a.w_route == ROUTE_WIDE) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mwx)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&mwh)) : "memory");
    }
    for (int j = 0; j < stages; ++j) {
      const int s = j & (STAGES - 1);
      if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
      unsigned char* st = ring + s * Ge::STAGE;
      const bool xp = j < xs;
      const int k = (xp ? j : j - xs) * D;
      const int len = xp ? a.n_in : a.n;
      const int route = xp ? a.x_route : a.h_route;
      if (a.w_route == ROUTE_WIDE) {
        if (p == 0) {
          mbar_expect_tx(&full[s], Ge::W_BYTES);
          tma_load_3d(st, xp ? &mwx : &mwh, &full[s], u0, 0, k);
        }
      } else {
        fill_weights<TW, U>(st, xp ? wx : wh, len, a.n, k, u0, a.w_route, p);
        if (p == 0) mbar_arrive(&full[s]);
      }
      if (xp) {
        fill_rows<TX, R>(st + Ge::W_BYTES, static_cast<const TX*>(a.x), len, live, r0, k, route,
                         p);
      } else {
        fill_rows<TS, R>(st + Ge::W_BYTES, static_cast<const TS*>(a.h), len, live, r0, k, route,
                         p);
      }
      if (async_copy) cp_async_arrive(&full[s]);
      if (plain_copy) mbar_arrive(&full[s]);
    }
    return;
  }

  // a consumer; thread t also finishes output (row t / U, unit t % U)
  const int t = threadIdx.x;
  const int er = t / U;
  const int row = r0 + er;
  const int j = u0 + t % U;
  const bool live = er < R && row < a.B && j < a.n;
  float bias[4] = {0.f, 0.f, 0.f, 0.f}, peep[3] = {0.f, 0.f, 0.f}, cv = 0.f;
  if (live) {
    const TW* b = static_cast<const TW*>(a.b);
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = to_f32(b[g * a.n + j]);
    if (a.peep) {
      peep[0] = to_f32(static_cast<const TW*>(a.p_i)[j]);
      peep[1] = to_f32(static_cast<const TW*>(a.p_f)[j]);
      peep[2] = to_f32(static_cast<const TW*>(a.p_o)[j]);
    }
    cv = to_f32(static_cast<const TS*>(a.c)[static_cast<long long>(row) * a.n + j]);
  }

  const int rg = lane / U, cg = lane % U;
  float acc[RL][4];
#pragma unroll
  for (int i = 0; i < RL; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  for (int jj = 0; jj < stages; ++jj) {
    const int s = jj & (STAGES - 1);
    mbar_wait(&full[s], (jj / STAGES) & 1);
    const unsigned char* st = ring + s * Ge::STAGE;
    if (jj < xs) {
      mac<TX, TW, U, RL>(acc, st, warp, rg, cg);
    } else {
      mac<TS, TW, U, RL>(acc, st, warp, rg, cg);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // the warp's sums into red[warp][gate][row][unit]: columns 4 cg .. 4 cg + 3
  // are gate 4 cg / U, units 4 cg % U ..
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int r = rg + Ge::G * i;
    float* p = red + ((warp * 4 + 4 * cg / U) * R + r) * U + (4 * cg) % U;
    *reinterpret_cast<float4*>(p) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  named_barrier(1, CONSUMERS);
  if (!live) return;

  // z = the warps' sums in warp order, then the bias
  float z[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float* p = red + (g * R + er) * U + t % U;
    float sum = p[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, p[w * 4 * R * U]);
    z[g] = __fadd_rn(sum, bias[g]);
  }
  float ig, fg, og, cn;
  const float gg = tanhf(z[3]);
  if (a.peep) {
    ig = sigmoid(z[0] + peep[0] * cv);
    fg = sigmoid(z[1] + peep[1] * cv);
    cn = fg * cv + ig * gg;
    og = sigmoid(z[2] + peep[2] * cn);
  } else {
    ig = sigmoid(z[0]);
    fg = sigmoid(z[1]);
    og = sigmoid(z[2]);
    cn = fg * cv + ig * gg;
  }
  const long long at = static_cast<long long>(row) * a.n + j;
  store(static_cast<TO*>(a.h_out) + at, og * tanhf(cn));
  store(static_cast<TO*>(a.c_out) + at, cn);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
// The weight map of Wx or Wh (rows x 4n, of f32 or bf16) seen as (rows, 4,
// n): boxes of (U units, 4 gates, D depths), no swizzle, zero-filled past n
// and rows. Encoded every call: a variant that kept the last few maps
// (a map is a pure function of these arguments) read the same host time
// (PERF.md § 6, PR 17).
int weight_map(CUtensorMap* out, const void* base, bool bf16, int n, int rows, int units) {
  hopper::EncodeTiled encode = hopper::encode_fn();
  if (encode == nullptr) return hopper::MAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t elt = bf16 ? 2 : 4;
  cuuint64_t gdim[3] = {static_cast<cuuint64_t>(n), 4, static_cast<cuuint64_t>(rows)};
  cuuint64_t gstride[2] = {elt * n, 4 * elt * n};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(units), 4, D};
  cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = encode(
      out, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
      const_cast<void*>(base), gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::MAP_ERROR + static_cast<int>(r);
}

template <typename TX, typename TW, typename TS, int U, int RL>
int launch(const Args& a, cudaStream_t s) {
  using Ge = Geo<TX, TW, TS, U, RL>;
  constexpr bool w_bf16 = sizeof(TW) == 2;
  CUtensorMap mwx{}, mwh{};
  if (a.w_route == ROUTE_WIDE) {
    int err = weight_map(&mwx, a.wx, w_bf16, a.n, a.n_in, U);
    if (err != 0) return err;
    err = weight_map(&mwh, a.wh, w_bf16, a.n, a.n, U);
    if (err != 0) return err;
  }
  static bool done[64] = {};  // per instantiation: each opts in for itself
  const int err = hopper::opt_in_smem(lstm_cell_kernel_sm90<TX, TW, TS, U, RL>, Ge::BYTES, done);
  if (err != 0) return err;
  const dim3 grid((a.n + U - 1) / U, (a.B + Ge::R - 1) / Ge::R);
  lstm_cell_kernel_sm90<TX, TW, TS, U, RL><<<grid, THREADS, Ge::BYTES, s>>>(mwx, mwh, a);
  return static_cast<int>(cudaGetLastError());
}

// (units, rows) -> the instantiation: U 4 (f32 weights only: a TMA box row
// is at least 16 bytes) or 8, R = RL * 32 / U of 8, 16 or 32
template <typename TX, typename TW, typename TS>
int dispatch(const Args& a, int units, int rows, cudaStream_t s) {
  if (units == 8) {
    if (rows == 8) return launch<TX, TW, TS, 8, 2>(a, s);
    if (rows == 16) return launch<TX, TW, TS, 8, 4>(a, s);
    if (rows == 32) return launch<TX, TW, TS, 8, 8>(a, s);
  }
  if constexpr (sizeof(TW) == 4) {
    if (units == 4) {
      if (rows == 8) return launch<TX, TW, TS, 4, 1>(a, s);
      if (rows == 16) return launch<TX, TW, TS, 4, 2>(a, s);
      if (rows == 32) return launch<TX, TW, TS, 4, 4>(a, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// whether an operand of rows of `row_bytes` at `base` can take `route`
bool route_ok(int route, long long row_bytes, const void* base) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  if (route == ROUTE_WIDE) return row_bytes % 16 == 0 && p % 16 == 0;
  if (route == ROUTE_WORDS) return row_bytes % 4 == 0 && p % 4 == 0;
  return route == ROUTE_ELEMENTS;
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// tile sizes: 0 -> depths of [x | h] a stage, 1 -> consumer warps (each
// sums DW = D / WARPS depths of every stage), 2 -> stages in the ring
int dl4j_fused_lstm_tile(int which) { return which == 0 ? D : which == 1 ? WARPS : STAGES; }

// x (b, n_in), h and c (b, n), wx (n_in, 4n), wh (n, 4n), b (4n,), and with
// peephole = 1 p_i, p_f, p_o (n,) -> h_out, c_out (b, n). x_bf16, w_bf16,
// s_bf16 give the types of x, of the weights (wx, wh, b and the peepholes)
// and of the carries (h, c): 0 f32, 1 bf16. The outputs are bf16 when all
// three are bf16, else f32. units (4 with f32 weights, or 8) and rows (8,
// 16 or 32): a block's tile (fused_lstm.py lstm_tiles). w_route, x_route,
// h_route: how the weights, x and h reach the stages (0 wide: rows of n
// (n_in) elements a multiple of 16 bytes and 16-byte aligned bases; 1
// words: 4 bytes; 2 elements).
int dl4j_fused_lstm_cell(const void* x, const void* h, const void* c, const void* wx,
                         const void* wh, const void* b, const void* p_i, const void* p_f,
                         const void* p_o, void* h_out, void* c_out, int batch, int n_in, int n,
                         int x_bf16, int w_bf16, int s_bf16, int peephole, int units, int rows,
                         int w_route, int x_route, int h_route, void* stream) {
  if (batch <= 0 || n_in <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (peephole && (p_i == nullptr || p_f == nullptr || p_o == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ew = w_bf16 ? 2 : 4, ex = x_bf16 ? 2 : 4, es = s_bf16 ? 2 : 4;
  if (!route_ok(w_route, n * ew, wx) || !route_ok(w_route, n * ew, wh) ||
      !route_ok(x_route, n_in * ex, x) || !route_ok(h_route, n * es, h) ||
      (batch + rows - 1) / (rows > 0 ? rows : 1) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, h, c, wx, wh, b, p_i, p_f, p_o, h_out, c_out, batch, n_in, n, peephole ? 1 : 0,
               w_route, x_route, h_route};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = (x_bf16 ? 4 : 0) | (w_bf16 ? 2 : 0) | (s_bf16 ? 1 : 0);
  switch (code) {
    case 0: return dispatch<float, float, float>(a, units, rows, s);
    case 1: return dispatch<float, float, bf16>(a, units, rows, s);
    case 2: return dispatch<float, bf16, float>(a, units, rows, s);
    case 3: return dispatch<float, bf16, bf16>(a, units, rows, s);
    case 4: return dispatch<bf16, float, float>(a, units, rows, s);
    case 5: return dispatch<bf16, float, bf16>(a, units, rows, s);
    case 6: return dispatch<bf16, bf16, float>(a, units, rows, s);
    default: return dispatch<bf16, bf16, bf16>(a, units, rows, s);
  }
}

}  // extern "C"
