// Fused conv+BN+ReLU forward kernel for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes; see ../build.py and ../fused_conv.py).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   pw_conv forward  <- deeplearning4j_tpu/nn/ops/fused_conv.py _pw_fwd_kernel
//   conv3x3 forward  <- deeplearning4j_tpu/nn/ops/fused_conv.py _c3_fwd_kernel
//
// Both compute   y, stats = conv(act(x * scale + shift), W)
//   - the upstream BatchNormalization's folded affine (scale, shift, f32) and
//     an optional ReLU are applied to the input tile as it is read, in f32
//     with the plain version's rounding (a product, then a sum: no FMA),
//     then rounded to bf16 for the tensor cores;
//   - y is accumulated in f32 and stored as bf16;
//   - stats = [colsum(y); colsum(y*y)] over the valid output rows, taken from
//     the f32 accumulator.
//
// Design. One kernel serves both ops as an implicit GEMM: rows M = output
// pixels, columns = Cout, depth = taps x Cin (one tap for the pointwise
// conv, nine for the 3x3 SAME stride-1 conv), in steps of 64 input channels
// of one tap. A block owns a tile of 128 pixel rows x N output channels (N =
// 64, 128 or 256: Cout rounded up; the grid covers a wider Cout in such
// tiles): a producer warp and two consumer warpgroups of 64 rows. At N = 256
// the accumulator alone is 128 registers a thread: the producer is then a
// whole warpgroup that hands its registers to the consumers (setmaxnreg 40 /
// 232). Where the tiles would leave most SMs idle over a deep product (the
// 3x3 conv at 7x7, small batches), several blocks share a tile's steps
// (split depth, chosen by the wrapper) and splitk_reduce_kernel adds their
// f32 sums in split order.
// - The producer streams, per step, the x tile (128 rows x 64 channels) and
//   the W tile (64 rows of Cin x N: W is (Cin, Cout), read MN-major) into a
//   ring of stages on full/empty mbarriers (TMA, 128-byte swizzle, zero fill
//   past M, Cin and Cout), with the step's 64 entries of scale and shift
//   beside them (bulk copies: no global load waits in the consumers' loop).
//   W is read through a 3-D map (Cout, Cin, taps), so a 64-channel box past
//   Cin is zero-filled and never reads the next tap's rows.
// - 3x3 taps: the tap (dy, dx) of output pixel (n, h, w) reads the fold of x
//   at (n, h+dy-1, w+dx-1), which in NHWC is the flattened row m + (dy-1)W +
//   (dx-1): the producer loads the x tile at that row offset (TMA takes a
//   negative or past-the-end start and zero-fills; a box wholly outside x is
//   not loaded). The halo is decided by POSITION, never by value: a row whose
//   source pixel lies outside its image (the SAME padding, the neighbouring
//   image's first or last row, the other end of the image row) gives 0 in A,
//   as the reference's zero-padded xp_ref after the fold. A zero-filled x
//   would fold to act(shift), which is not 0. (Per-tap loads, not a halo'd
//   band: a 128-row tile does not align with image rows, and the loads are
//   not what bounds the kernel; PERF.md.)
// - The fold, formed into register A: each consumer thread reads its two rows
//   and sixteen channels of a step from the swizzled x tile (conflict-free
//   32-bit reads), computes act(x scale + shift) and packs it in bf16 pairs
//   straight into wgmma's register A layout. Rows at or past M and source
//   pixels outside the image give 0 by select; past Cin, scale and shift are
//   taken as 0 (a NaN in the step's stale slice never reaches the product)
//   and x is TMA's zero fill. One step's wgmma stays in flight while the next
//   step's A is formed; the accumulator stays in f32 registers over the
//   whole depth.
// - Epilogue, from the accumulator registers: y rounded to bf16 into a shared
//   tile (over the spent ring) and stored by TMA, which writes no row past M
//   and no column past Cout; colsum(y) and colsum(y^2) of the thread's valid
//   rows go to a shared table of the block's 64 row groups (columns swizzled
//   by row group: conflict-free), the threads of each column add its groups
//   in a fixed order into the block's partials, and stats_reduce_kernel sums
//   those over the row tiles in order. No float atomics: reruns give the same
//   bits.
//
// Bound on an H100: at ResNet-50's shapes the pointwise convs are bound by
// bytes (x read, y written once) and the 3x3 convs and the deepest pointwise
// ones by tensor-core operations. Times are in PERF.md.

#include "fused_conv_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int FWD_BM = 128;                    // pixel rows per block
constexpr int FWD_BK = 64;                     // input channels per step
constexpr int FWD_CONSUMERS = 256;             // two consumer warpgroups
constexpr int FWD_GROUPS = FWD_CONSUMERS / 4;  // row groups of 2 rows: a quad's lanes share them
constexpr int PANEL_BYTES = FWD_BK * 128;      // a W panel: 64 rows of 64 columns

template <int N>
struct Fwd {
  static constexpr int NW = N < 128 ? N : 128;  // columns per wgmma
  static constexpr int NH = N / NW;             // wgmmas per k-step
  static constexpr int STAGES = 4;
  static constexpr int MIN_BLOCKS = N == 64 ? 2 : 1;
  static constexpr bool WIDE = N == 256;        // a producer warpgroup, setmaxnreg
  static constexpr int THREADS = FWD_CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int X_BYTES = FWD_BM * FWD_BK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + (N / 64) * PANEL_BYTES;  // x, W; 1024-aligned
  static constexpr int SC = STAGES * STAGE_BYTES;  // [stage][scale, shift][64] f32
  static constexpr int BAR = SC + STAGES * 2 * FWD_BK * 4;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + the alignment slack
  static constexpr int Y_BYTES = FWD_BM * N * 2;             // the y tile, over the spent ring
  static constexpr int RED_BYTES = 2 * FWD_GROUPS * N * 4;   // the column sums, after it
  static_assert(Y_BYTES + RED_BYTES <= STAGES * STAGE_BYTES, "the epilogue reuses the ring");
};

struct FwdArgs {
  const float* scale;   // round8(Cin) entries, 16-byte aligned
  const float* shift;
  float* partial;       // (row blocks, 2, Cout)
  float* ws;            // (splits, M, round8(Cout)) f32 when splits > 1
  int M, H, W, taps, Cin, Cout, relu_in, col_tiles, splits;
};

template <int N>
__global__ void __launch_bounds__(Fwd<N>::THREADS, Fwd<N>::MIN_BLOCKS)
fused_conv_fwd_kernel_sm90(__grid_constant__ const CUtensorMap mx,
                           __grid_constant__ const CUtensorMap mw,
                           __grid_constant__ const CUtensorMap my, const FwdArgs a) {
  using namespace hopper;
  using L = Fwd<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem;
  float* ssc = reinterpret_cast<float*>(smem + L::SC);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + L::STAGES;

  // the splits of one tile, then the column tiles of one row block, are
  // neighbours in launch order: they share x in L2
  const int split = blockIdx.x % a.splits;
  const int tile = blockIdx.x / a.splits;
  const int tile_m = tile / a.col_tiles;
  const int m0 = tile_m * FWD_BM;
  const int n0 = (tile - tile_m * a.col_tiles) * N;
  const int nk = (a.Cin + FWD_BK - 1) / FWD_BK;
  // this block's steps of the depth (taps x 64-channel chunks): [j0, j0 + steps)
  const int j0 = static_cast<int>(static_cast<long long>(a.taps) * nk * split / a.splits);
  const int steps =
      static_cast<int>(static_cast<long long>(a.taps) * nk * (split + 1) / a.splits) - j0;
  const int panels = min(N / 64, (a.Cout - n0 + 63) / 64);  // W panels with a column < Cout
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FWD_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= FWD_CONSUMERS) {  // the producer
    if constexpr (L::WIDE) regs_dec<40>();
    if (threadIdx.x == FWD_CONSUMERS) {
      const int cin8 = (a.Cin + 7) / 8 * 8;
      for (int i = 0; i < steps; ++i) {
        const int s = i % L::STAGES;
        if (i >= L::STAGES) mbar_wait(&empty[s], (i / L::STAGES - 1) & 1);
        const int tap = (j0 + i) / nk;
        const int c0 = (j0 + i - tap * nk) * FWD_BK;
        const int row = m0 + (a.taps == 1 ? 0 : (tap / 3 - 1) * a.W + tap % 3 - 1);
        // a box wholly outside x feeds no row (every one is masked by position)
        const bool load_x = row < a.M && row + FWD_BM > 0;
        // scale and shift of the step: Cin8 - c0 is a multiple of 8, so whole 32 bytes
        const uint32_t cbytes = min(FWD_BK, cin8 - c0) * 4;
        unsigned char* st = ring + s * L::STAGE_BYTES;
        mbar_expect_tx(&full[s], (load_x ? L::X_BYTES : 0) + panels * PANEL_BYTES + 2 * cbytes);
        if (load_x) tma_load_2d(st, &mx, &full[s], c0, row);
        for (int p = 0; p < panels; ++p) {
          tma_load_3d(st + L::X_BYTES + p * PANEL_BYTES, &mw, &full[s], n0 + p * 64, c0, tap);
        }
        bulk_load(ssc + s * 2 * FWD_BK, a.scale + c0, cbytes, &full[s]);
        bulk_load(ssc + s * 2 * FWD_BK + FWD_BK, a.shift + c0, cbytes, &full[s]);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns tile rows [wg*64, wg*64 + 64); this thread
  // holds tile rows lr (slot 0) and lr + 8 (slot 1)
  if constexpr (L::WIDE) regs_inc<232>();
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const int lr = wg * 64 + (warp % 4) * 16 + g;
  bool live[2];
  int ph[2], pw[2];  // the rows' pixel position in their image (3x3 taps)
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int m = m0 + lr + 8 * slot;
    live[slot] = m < a.M;
    ph[slot] = pw[slot] = 0;
    if (a.taps != 1) {
      const int r = m % (a.H * a.W);
      ph[slot] = r / a.W;
      pw[slot] = r - ph[slot] * a.W;
    }
  }
  float acc[L::NH][L::NW / 2];
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 2; ++i) acc[h][i] = 0.f;
  }

  // the fold of this block's step i in wgmma's register A layout: a[kk] =
  // {(slot 0, channels 16kk + 2c, +1), (slot 1, the same), (slot 0, 8
  // channels on), (slot 1, 8 on)}
  const auto build = [&](uint32_t (&av)[FWD_BK / 16][4], int i) {
    const int s = i % L::STAGES;
    const int tap = (j0 + i) / nk;
    const int c0 = (j0 + i - tap * nk) * FWD_BK;
    const int dy = a.taps == 1 ? 0 : tap / 3 - 1;
    const int dx = a.taps == 1 ? 0 : tap % 3 - 1;
    bool ok[2];
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      // the halo by position: (h + dy, w + dx) inside the image (for the
      // pointwise conv H = W = 1 and dy = dx = 0)
      ok[slot] = live[slot] && static_cast<unsigned>(ph[slot] + dy) < static_cast<unsigned>(a.H) &&
                 static_cast<unsigned>(pw[slot] + dx) < static_cast<unsigned>(a.W);
    }
    const unsigned char* tx = ring + s * L::STAGE_BYTES;
    const float* sc = ssc + s * 2 * FWD_BK;
#pragma unroll
    for (int kk = 0; kk < FWD_BK / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = 16 * kk + 8 * half + 2 * c;  // the step's channel
        const bool in0 = c0 + cc < a.Cin, in1 = c0 + cc + 1 < a.Cin;
        // past Cin, scale and shift 0: the fold of TMA's zero fill is then
        // 0, whatever stale value the step's slice holds there
        const float2 s2 = *reinterpret_cast<const float2*>(sc + cc);
        const float2 t2 = *reinterpret_cast<const float2*>(sc + FWD_BK + cc);
        const float s0 = in0 ? s2.x : 0.f, s1 = in1 ? s2.y : 0.f;
        const float t0 = in0 ? t2.x : 0.f, t1 = in1 ? t2.y : 0.f;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const uint32_t wx = sw128_word(tx, lr + 8 * slot, 2 * kk + half, c);
          const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wx));
          float u0 = __fadd_rn(__fmul_rn(fx.x, s0), t0);
          float u1 = __fadd_rn(__fmul_rn(fx.y, s1), t1);
          if (a.relu_in) {
            u0 = relu_nan(u0);
            u1 = relu_nan(u1);
          }
          av[kk][2 * half + slot] = ok[slot] ? pack_bf16(u0, u1) : 0u;
        }
      }
    }
  };
  // y += A W for step i (W's tile, 64 rows of Cin by N of Cout, is
  // MN-major: 64-column panels PANEL_BYTES apart). The wgmma of step i - 1
  // is then waited for, which frees its stage and its A registers (next),
  // and the next step's A is formed there while step i's wgmma runs: the
  // tensor cores always hold one step's products.
  const auto step = [&](const uint32_t (&av)[FWD_BK / 16][4],
                        uint32_t (&next)[FWD_BK / 16][4], int i) {
    const __nv_bfloat16* tw = reinterpret_cast<const __nv_bfloat16*>(
        ring + (i % L::STAGES) * L::STAGE_BYTES + L::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FWD_BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < L::NH; ++h) {
        wgmma_rs<1>(acc[h], av[kk],
                    desc_mnmajor(tw + h * (L::NW / 64) * FWD_BK * 64 + kk * 16 * 64, PANEL_BYTES),
                    1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % L::STAGES]);
    }
    if (i + 1 < steps) {
      mbar_wait(&full[(i + 1) % L::STAGES], ((i + 1) / L::STAGES) & 1);
      build(next, i + 1);
    }
  };
  uint32_t a0[FWD_BK / 16][4], a1[FWD_BK / 16][4];
  mbar_wait(&full[0], 0);
  build(a0, 0);
  for (int i = 0; i < steps; i += 2) {
    step(a0, a1, i);
    if (i + 1 < steps) step(a1, a0, i + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < L::NH; ++h) fence_regs(acc[h]);

  if (a.splits > 1) {
    // a split of the depth: its f32 sums of the tile's valid rows and
    // columns go to the workspace, and splitk_reduce_kernel adds the
    // splits in order, rounds y and takes the statistics
    const int ld = (a.Cout + 7) / 8 * 8;
    float* out = a.ws + static_cast<long long>(split) * a.M * ld;
#pragma unroll
    for (int h = 0; h < L::NH; ++h) {
#pragma unroll
      for (int i = 0; i < L::NW / 8; ++i) {
        const int col = n0 + h * L::NW + 8 * i + 2 * c;
        if (col >= a.Cout) continue;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          if (!live[slot]) continue;
          *reinterpret_cast<float2*>(out + static_cast<long long>(m0 + lr + 8 * slot) * ld + col) =
              make_float2(acc[h][4 * i + 2 * slot], acc[h][4 * i + 2 * slot + 1]);
        }
      }
    }
    return;
  }

  // epilogue: y into its tile and the column sums into their table, both
  // over the spent ring
  unsigned char* sy = ring;                                       // N / 64 panels of 128 rows
  float* red = reinterpret_cast<float*>(ring + L::Y_BYTES);       // [sum, sum sq][64 groups][N]
  named_barrier(1, FWD_CONSUMERS);  // both warpgroups are done with the ring
  const int rg = warp * 8 + g;      // this thread's row group
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 8; ++i) {
      const int cl = h * L::NW + 8 * i + 2 * c;  // the block's column of this pair
      unsigned char* panel = sy + (cl / 64) * FWD_BM * 128;
      float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const int r = lr + 8 * slot;
        const float y0 = acc[h][4 * i + 2 * slot], y1 = acc[h][4 * i + 2 * slot + 1];
        *reinterpret_cast<uint32_t*>(panel + r * 128 + ((((cl % 64) / 8) ^ (r & 7)) << 4) +
                                     4 * c) = pack_bf16(y0, y1);
        if (live[slot]) {
          s0 += y0;
          s1 += y1;
          q0 += y0 * y0;
          q1 += y1 * y1;
        }
      }
      const int pc = cl ^ (g << 3);  // swizzled by row group: conflict-free
      *reinterpret_cast<float2*>(red + rg * N + pc) = make_float2(s0, s1);
      *reinterpret_cast<float2*>(red + (FWD_GROUPS + rg) * N + pc) = make_float2(q0, q1);
    }
  }
  fence_proxy_async();  // y in the tile, for the TMA store
  named_barrier(1, FWD_CONSUMERS);
  if (threadIdx.x == 0) {
    for (int p = 0; p < panels; ++p) tma_store_2d(&my, sy + p * FWD_BM * 128, n0 + p * 64, m0);
    tma_store_commit();
  }
  {
    // each column's 64 row groups: PARTS neighbouring threads take every
    // PARTS-th group in order, then add in a fixed butterfly
    constexpr int PARTS = FWD_CONSUMERS / N;
    const int cl = threadIdx.x / PARTS;
    const int part = threadIdx.x % PARTS;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 16
    for (int r = part; r < FWD_GROUPS; r += PARTS) {
      const int pc = cl ^ ((r & 7) << 3);
      s1 += red[r * N + pc];
      s2 += red[(FWD_GROUPS + r) * N + pc];
    }
#pragma unroll
    for (int o = 1; o < PARTS; o <<= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const int col = n0 + cl;
    if (part == 0 && col < a.Cout) {
      const long long base = static_cast<long long>(tile_m) * 2 * a.Cout + col;
      a.partial[base] = s1;
      a.partial[base + a.Cout] = s2;
    }
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

// The epilogue of a depth split in `splits` blocks: y = bf16(the splits'
// f32 sums added in split order) and the column partials of each 128-row
// block, as the one-split epilogue writes them. A block takes 128 rows x 64
// columns: a thread takes a column's 32 rows in order, and the four quarters
// add in order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int Cout,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ partial) {
  __shared__ float red[2][4][64];
  const int ld = (Cout + 7) / 8 * 8;
  const int cl = threadIdx.x % 64;
  const int q = threadIdx.x / 64;
  const int col = blockIdx.y * 64 + cl;
  const int m0 = blockIdx.x * FWD_BM + q * 32;
  float s1 = 0.f, s2 = 0.f;
  if (col < Cout) {
    for (int m = m0; m < min(m0 + 32, M); ++m) {
      float v = 0.f;
      for (int k = 0; k < splits; ++k) v += ws[(static_cast<long long>(k) * M + m) * ld + col];
      y[static_cast<long long>(m) * ld + col] = __float2bfloat16_rn(v);
      s1 += v;
      s2 += v * v;
    }
  }
  red[0][q][cl] = s1;
  red[1][q][cl] = s2;
  __syncthreads();
  if (q == 0 && col < Cout) {
    const long long base = static_cast<long long>(blockIdx.x) * 2 * Cout + col;
    partial[base] = ((red[0][0][cl] + red[0][1][cl]) + red[0][2][cl]) + red[0][3][cl];
    partial[base + Cout] = ((red[1][0][cl] + red[1][1][cl]) + red[1][2][cl]) + red[1][3][cl];
  }
}

template <int N>
int launch_fwd_sm90(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
                    FwdArgs a, int row_tiles, void* y, float* stats, cudaStream_t s) {
  const int bytes = Fwd<N>::BYTES;
  static bool done[64] = {};  // per N: each instantiation opts in for itself
  const int err = hopper::opt_in_smem(fused_conv_fwd_kernel_sm90<N>, bytes, done);
  if (err != 0) return err;
  a.col_tiles = (a.Cout + N - 1) / N;
  const long long blocks = static_cast<long long>(row_tiles) * a.col_tiles * a.splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_conv_fwd_kernel_sm90<N><<<static_cast<unsigned>(blocks), Fwd<N>::THREADS, bytes, s>>>(
      mx, mw, my, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.splits > 1) {
    const dim3 grid(row_tiles, (a.Cout + 63) / 64);
    splitk_reduce_kernel<<<grid, 256, 0, s>>>(a.ws, a.splits, a.M, a.Cout,
                                              static_cast<__nv_bfloat16*>(y), a.partial);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(launch_stats_reduce(a.partial, row_tiles, 2 * a.Cout, stats, s));
}

int launch(int taps, const void* x, const void* scale, const void* shift, const void* w,
           void* y, void* partial, void* stats, void* ws, int m, int h, int wd, int cin,
           int cout, int relu_in, int n, int splits, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const int steps = taps * ((cin + FWD_BK - 1) / FWD_BK);
  if (m <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || misaligned(x) ||
      misaligned(scale) || misaligned(shift) || misaligned(w) || misaligned(y) ||
      misaligned(ws) || (n != 64 && n != 128 && n != 256) || splits < 1 || splits > steps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cin8 = (cin + 7) / 8 * 8, cout8 = (cout + 7) / 8 * 8;
  CUtensorMap mx, mw, my;
  int rc = hopper::encode_rows(&mx, x, cin, m, cin8, FWD_BM);
  if (rc == 0) rc = hopper::encode_stack(&mw, w, cout, cin, taps, cout8, FWD_BK);
  if (rc == 0) rc = hopper::encode_rows(&my, y, cout, m, cout8, FWD_BM);
  if (rc != 0) return rc;
  const FwdArgs a{static_cast<const float*>(scale), static_cast<const float*>(shift),
                  static_cast<float*>(partial), static_cast<float*>(ws), m, h, wd, taps, cin,
                  cout, relu_in, 0, splits};
  const int row_tiles = (m + FWD_BM - 1) / FWD_BM;
  auto* st = static_cast<float*>(stats);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto run = n == 64 ? launch_fwd_sm90<64> : n == 128 ? launch_fwd_sm90<128>
                                                            : launch_fwd_sm90<256>;
  return run(mx, mw, my, a, row_tiles, y, st, s);
}

}  // namespace

extern "C" {

// tile sizes: 0 -> rows per block (sizes the (row blocks, 2, Cout)
// partials), 1 -> the widest column tile, 2 -> input channels per step
int dl4j_fused_conv_tile(int which) { return which == 0 ? FWD_BM : which == 1 ? 256 : FWD_BK; }

// x (m, cin) bf16, scale/shift (cin,) f32, w (cin, cout) bf16
// -> y (m, cout) bf16, stats (2, cout) f32; partial is (ceil(m/128), 2, cout)
// f32. tile_n: the column tile (64, 128 or 256); splits: the blocks that
// share a tile's depth (1 to taps * ceil(cin/64)), whose f32 sums go through
// ws (splits, m, round8(cout)) when splits > 1. What TMA reads and writes: x
// with row stride round8(cin), w and y with row stride round8(cout), scale
// and shift with round8(cin) readable entries; x, w, y, scale, shift and ws
// 16-byte aligned. Returns cudaGetLastError(), or 1000 + the CUresult of a
// failed tensor-map encoding.
int dl4j_pw_conv_fwd(const void* x, const void* scale, const void* shift, const void* w,
                     void* y, void* partial, void* stats, void* ws, int m, int cin, int cout,
                     int relu_in, int tile_n, int splits, void* stream) {
  return launch(1, x, scale, shift, w, y, partial, stats, ws, m, 1, 1, cin, cout, relu_in,
                tile_n, splits, stream);
}

// x (n, h, wd, cin) bf16 NHWC, w (3, 3, cin, cout) bf16 HWIO -> y (n, h, wd,
// cout); the same tiles, strides and alignment as dl4j_pw_conv_fwd
int dl4j_conv3x3_fwd(const void* x, const void* scale, const void* shift, const void* w,
                     void* y, void* partial, void* stats, void* ws, int n, int h, int wd,
                     int cin, int cout, int relu_in, int tile_n, int splits, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || static_cast<long long>(n) * h * wd > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(9, x, scale, shift, w, y, partial, stats, ws, n * h * wd, h, wd, cin, cout,
                relu_in, tile_n, splits, stream);
}

}  // extern "C"
