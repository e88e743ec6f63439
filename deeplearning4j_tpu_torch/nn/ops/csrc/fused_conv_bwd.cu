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
// Design. All four are Hopper kernels (TMA rings on full/empty mbarriers,
// wgmma with the A operand formed in registers, dz_eff formed on chip):
// pw_bwd_dx_kernel_sm90, conv3x3_bwd_dx_kernel_sm90, pw_bwd_dw_kernel_sm90
// and conv3x3_bwd_dw_kernel_sm90 below.
//
// dx (both): rows = pixels, columns = Cin, depth = Cout (for the 3x3, nine
//   taps x Cout). A = dz_eff, formed from the dz and z tiles and dst as it
//   is read into registers. The 3x3's tap (dy, dx) of output pixel (h, w)
//   reads dz_eff at (h+1-dy, w+1-dx): the transposed conv with the taps
//   flipped, loaded by TMA at the negated row offset of the forward's tap.
//   An out-of-image tap gives 0, NOT dz_eff of a zero pixel (which would add
//   dst[0]): the Pallas kernel forms dz_eff over the valid pixels only and
//   scatters into a zero halo. The epilogue recomputes u from x, applies the
//   ReLU mask and the scale, stores dx, and writes per-block column partials
//   of du*x and du that a second kernel sums over the row tiles in a fixed
//   order.
// dW (both): rows = Cin (for the 3x3, (tap, Cin)), columns = Cout, depth =
//   pixels. The output is small and the depth huge (stage 1 at batch 32:
//   one 64x256 tile over 100352 pixels). The TPU accumulated over a
//   sequential grid (dw_ref +=); here the pixels are split into chunks across
//   blocks, each writes an f32 partial tile, and dw_reduce_kernel sums the
//   partials in a fixed order and rounds to bf16 only after the sum. No float
//   atomics: the result is the same on every run. The 3x3 input halo is zero
//   AFTER the fold, as in the forward.
//
// Bound on an H100: the deep 3x3 GEMMs are bound by tensor-core operations,
// the pointwise ones and the 64-channel stage-1 ones by bytes (see
// chip_smoke.py phase 2b). Times are in PERF.md.

#include "fused_conv_common.cuh"
#include "hopper.cuh"

namespace {

__device__ __forceinline__ float dz_eff(float dz, float z, float d0, float d1) {
  // (dz + dst0) + (2z) * dst1, each step rounded, as the plain version
  return __fadd_rn(__fadd_rn(dz, d0), __fmul_rn(2.f * z, d1));
}

// ---------------------------------------------------------------------------
// pointwise dx, dscale, dshift on Hopper: TMA ring, register-A wgmma, fused
// prologue and epilogue
// ---------------------------------------------------------------------------
// A GEMM with rows = pixels (M), columns = Cin, depth = Cout. A block owns
// 128 pixel rows x N input channels (N = 64, 128 or 256: Cin rounded up,
// at most 256): a producer warp and two consumer warpgroups of 64 rows. At
// N = 256 the accumulator alone
// is 128 registers a thread: the producer is then a whole warpgroup (384
// threads) that hands its registers to the consumers (setmaxnreg: 40 for
// the producer, 232 for each consumer thread), where 288 threads would be
// held to 168 and spill.
// - The producer first loads the block's x tile (128 x N) for the epilogue
//   into a buffer of its own, then streams, per 64 channels of Cout, the dz
//   and z tiles (128 x 64) and the W tile (N x 64: W is (Cin, Cout), K-major
//   as stored) into a ring of stages on full/empty mbarriers (TMA, 128-byte
//   swizzle, zero fill past M, Cin and Cout), with the stage's 64 columns
//   of dst[0] and dst[1] beside them (bulk copies: no global load waits in
//   the consumers' loop).
// - Prologue: each consumer thread forms dz_eff for its two rows and sixteen
//   depth columns of a stage from the shared tiles (conflict-free 32-bit
//   reads of the swizzled rows), in f32 with the plain version's rounding,
//   and packs it in bf16 pairs straight into wgmma's register A layout. Rows
//   at or past M give 0: TMA's zero fill would leave dst[0] there, and the
//   reference masks rows >= m_valid. The next stage's dz_eff is formed while
//   this stage's wgmma runs (two sets of A registers); dxn = dz_eff W^T
//   accumulates in registers over the whole depth.
// - Epilogue: dx_epilogue below, from the accumulator registers.
// Bound on an H100: at ResNet-50's shapes the bytes (x, dz, z, dx once).
constexpr int PW_BM = 128;                 // pixel rows per block
constexpr int PW_BK = 64;                  // Cout depth per stage
constexpr int PW_CONSUMERS = 256;          // two consumer warpgroups
constexpr int PW_GROUPS = PW_CONSUMERS / 4;  // row groups of 2 rows: a quad's lanes share them

template <int N>
struct PwDx {
  static constexpr int NW = N < 128 ? N : 128;     // columns per wgmma
  static constexpr int NH = N / NW;                // wgmmas per k-step
  static constexpr int STAGES = N == 128 ? 3 : 2;
  static constexpr int MIN_BLOCKS = N == 64 ? 2 : 1;
  static constexpr bool WIDE = N == 256;           // a producer warpgroup, setmaxnreg
  static constexpr int THREADS = PW_CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int ROWS_BYTES = PW_BM * PW_BK * 2;   // a dz or z tile
  static constexpr int W_BYTES = N * PW_BK * 2;
  static constexpr int STAGE_BYTES = 2 * ROWS_BYTES + W_BYTES;  // dz, z, W; 1024-aligned
  static constexpr int X_BYTES = PW_BM * N * 2;         // x, then dx: N / 64 panels of 128 rows
  static constexpr int RING = X_BYTES;                  // stage s at RING + s * STAGE_BYTES
  static constexpr int DST = RING + STAGES * STAGE_BYTES;  // [STAGES][dst0, dst1][64] f32
  static constexpr int BAR = DST + STAGES * 2 * PW_BK * 4;  // full[STAGES], empty[STAGES], x
  static constexpr int SC = BAR + 64;                   // scale, shift of the N channels
  static constexpr int BYTES = SC + 2 * N * 4 + 1024;   // + the alignment slack
  static constexpr int RED_BYTES = 2 * PW_GROUPS * N * 4;  // the row sums, over the spent ring
  static_assert(RED_BYTES <= STAGES * STAGE_BYTES, "the row sums reuse the ring");
  static_assert((2 * STAGES + 1) * 8 <= 64, "the barriers fit");
};

// Where a dx block's epilogue finds its tiles
struct DxTiles {
  unsigned char* sx;   // the x tile, N / 64 panels of 128 rows: x, then dx
  float* red;          // [du*x, du][PW_GROUPS row groups][N], over the spent ring
  float* ssc;          // [scale; shift] of the block's N channels
  uint64_t* bar_x;     // the x tile's barrier
  int m0, n0, tile_m;  // the block's first row and channel, its row tile
};

// The dx kernels' epilogue (the consumers), from the accumulator registers:
// x of the thread's rows and channels from the shared x tile (0 past M and
// Cin, as the reference's zero-padded rows), u = x scale + shift, the ReLU
// mask, dx = bf16(du scale) written over x in the tile and stored by TMA
// (which writes no row past M and no column past Cin). du*x and du of the
// thread's rows below M (live0, live1: by position) go to a shared table of
// the block's 64 row groups (columns swizzled by row group: conflict-free),
// and one thread per channel sums its 64 entries in order into the block's
// partials (row tiles, 2, Cin), which stats_reduce_kernel sums over the row
// tiles in order. No float atomics: reruns give the same bits.
template <int N>
__device__ __forceinline__ void dx_epilogue(float (&acc)[PwDx<N>::NH][PwDx<N>::NW / 2],
                                            const DxTiles& t, const CUtensorMap* mdx,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift,
                                            float* __restrict__ partial, int Cin, int relu_in,
                                            bool live0, bool live1) {
  using namespace hopper;
  using L = PwDx<N>;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int c = threadIdx.x % 4;
  const int lr = (warp / 4) * 64 + (warp % 4) * 16 + g;  // the thread's rows lr, lr + 8
  // the block's scale and shift (0 past Cin) beside the tile
  for (int i = threadIdx.x; i < 2 * N; i += PW_CONSUMERS) {
    const int col = t.n0 + (i < N ? i : i - N);
    t.ssc[i] = col < Cin ? __ldg((i < N ? scale : shift) + col) : 0.f;
  }
  mbar_wait(t.bar_x, 0);
  named_barrier(1, PW_CONSUMERS);  // both warpgroups are done with the ring; ssc is written
  const int rg = warp * 8 + g;     // this thread's row group
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 8; ++i) {
      const int cl = h * L::NW + 8 * i + 2 * c;  // the block's column of this pair
      const float2 sc = *reinterpret_cast<const float2*>(t.ssc + cl);
      const float2 sh = *reinterpret_cast<const float2*>(t.ssc + N + cl);
      unsigned char* panel = t.sx + (cl / 64) * PW_BM * 128;
      float dux0 = 0.f, dux1 = 0.f, du0s = 0.f, du1s = 0.f;
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const int r = lr + 8 * slot;
        uint32_t* word = reinterpret_cast<uint32_t*>(
            panel + r * 128 + ((((cl % 64) / 8) ^ (r & 7)) << 4) + 4 * c);
        const uint32_t wx = *word;
        const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wx));
        float du0 = acc[h][4 * i + 2 * slot], du1 = acc[h][4 * i + 2 * slot + 1];
        if (relu_in) {
          if (!(__fadd_rn(__fmul_rn(fx.x, sc.x), sh.x) > 0.f)) du0 = 0.f;
          if (!(__fadd_rn(__fmul_rn(fx.y, sc.y), sh.y) > 0.f)) du1 = 0.f;
        }
        *word = pack_bf16(__fmul_rn(du0, sc.x), __fmul_rn(du1, sc.y));
        if (slot ? live1 : live0) {
          dux0 += du0 * fx.x;
          dux1 += du1 * fx.y;
          du0s += du0;
          du1s += du1;
        }
      }
      const int pc = cl ^ (g << 3);  // swizzled by row group: conflict-free
      *reinterpret_cast<float2*>(t.red + rg * N + pc) = make_float2(dux0, dux1);
      *reinterpret_cast<float2*>(t.red + (PW_GROUPS + rg) * N + pc) = make_float2(du0s, du1s);
    }
  }
  fence_proxy_async();             // dx in the tile, for the TMA store
  named_barrier(1, PW_CONSUMERS);
  if (threadIdx.x == 0) {
    for (int p = 0; p < N / 64; ++p) tma_store_2d(mdx, t.sx + p * PW_BM * 128, t.n0 + p * 64, t.m0);
    tma_store_commit();
  }
  for (int cl = threadIdx.x; cl < N; cl += PW_CONSUMERS) {
    const int col = t.n0 + cl;
    if (col >= Cin) break;
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < PW_GROUPS; ++r) {
      const int pc = cl ^ ((r & 7) << 3);
      s1 += t.red[r * N + pc];
      s2 += t.red[(PW_GROUPS + r) * N + pc];
    }
    const long long base = static_cast<long long>(t.tile_m) * 2 * Cin + col;
    partial[base] = s1;
    partial[base + Cin] = s2;
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

template <int N>
__global__ void __launch_bounds__(PwDx<N>::THREADS, PwDx<N>::MIN_BLOCKS)
pw_bwd_dx_kernel_sm90(__grid_constant__ const CUtensorMap mdz,
                      __grid_constant__ const CUtensorMap mz,
                      __grid_constant__ const CUtensorMap mw,
                      __grid_constant__ const CUtensorMap mx,
                      __grid_constant__ const CUtensorMap mdx,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const float* __restrict__ dst,
                      float* __restrict__ partial,
                      int M, int Cin, int Cout, int relu_in) {
  using namespace hopper;
  using L = PwDx<N>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sx = smem;
  unsigned char* ring = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* bar_x = empty + STAGES;
  float* sdst = reinterpret_cast<float*>(smem + L::DST);
  float* ssc = reinterpret_cast<float*>(smem + L::SC);   // [scale; shift] of the block's N

  const int m0 = blockIdx.x * PW_BM;
  const int n0 = blockIdx.y * N;
  const int nk = (Cout + PW_BK - 1) / PW_BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PW_CONSUMERS / 32);
    }
    mbar_init(bar_x, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= PW_CONSUMERS) {  // the producer
    if constexpr (L::WIDE) regs_dec<40>();
    if (threadIdx.x == PW_CONSUMERS) {
      mbar_expect_tx(bar_x, L::X_BYTES);
      for (int p = 0; p < N / 64; ++p) {
        tma_load_2d(sx + p * PW_BM * 128, &mx, bar_x, n0 + p * 64, m0);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        unsigned char* st = ring + s * L::STAGE_BYTES;
        // dst's columns of the stage: Cout is a multiple of 8, so whole 32 bytes
        const uint32_t dbytes = min(PW_BK, Cout - j * PW_BK) * 4;
        mbar_expect_tx(&full[s], L::STAGE_BYTES + 2 * dbytes);
        tma_load_2d(st, &mdz, &full[s], j * PW_BK, m0);
        tma_load_2d(st + L::ROWS_BYTES, &mz, &full[s], j * PW_BK, m0);
        tma_load_2d(st + 2 * L::ROWS_BYTES, &mw, &full[s], j * PW_BK, n0);
        bulk_load(sdst + s * 2 * PW_BK, dst + j * PW_BK, dbytes, &full[s]);
        bulk_load(sdst + s * 2 * PW_BK + PW_BK, dst + Cout + j * PW_BK, dbytes, &full[s]);
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
  const bool live0 = m0 + lr < M, live1 = m0 + lr + 8 < M;
  float acc[L::NH][L::NW / 2];
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 2; ++i) acc[h][i] = 0.f;
  }

  // stage j's dz_eff in wgmma's register A layout: a[kk] = {(slot 0, cols
  // 16kk + 2c, +1), (slot 1, the same), (slot 0, 8 columns on), (slot 1, 8 on)}
  const auto build = [&](uint32_t (&a)[PW_BK / 16][4], int j) {
    const unsigned char* tdz = ring + (j % STAGES) * L::STAGE_BYTES;
    const unsigned char* tz = tdz + L::ROWS_BYTES;
    const float* sd = sdst + (j % STAGES) * 2 * PW_BK;
#pragma unroll
    for (int kk = 0; kk < PW_BK / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = 16 * kk + 8 * half + 2 * c;   // the stage's column
        // past Cout the shared slice holds stale values: 0 (Cout is even)
        const bool in = j * PW_BK + cc < Cout;
        const float2 s0 = *reinterpret_cast<const float2*>(sd + cc);
        const float2 s1 = *reinterpret_cast<const float2*>(sd + PW_BK + cc);
        const float2 d0 = in ? s0 : make_float2(0.f, 0.f);
        const float2 d1 = in ? s1 : make_float2(0.f, 0.f);
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const int r = lr + 8 * slot;
          const uint32_t wdz = sw128_word(tdz, r, 2 * kk + half, c);
          const uint32_t wz = sw128_word(tz, r, 2 * kk + half, c);
          const float2 fdz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wdz));
          const float2 fz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wz));
          a[kk][2 * half + slot] =
              (slot ? live1 : live0) ? pack_bf16(dz_eff(fdz.x, fz.x, d0.x, d1.x),
                                                 dz_eff(fdz.y, fz.y, d0.y, d1.y))
                                     : 0u;
        }
      }
    }
  };
  // dxn += dz_eff W^T for stage j (W's tile, N rows of Cin by 64 of Cout, is
  // K-major); the next stage's A is formed under it, then the stage is freed
  const auto step = [&](const uint32_t (&a)[PW_BK / 16][4], uint32_t (&next)[PW_BK / 16][4],
                        int j) {
    const __nv_bfloat16* tw = reinterpret_cast<const __nv_bfloat16*>(
        ring + (j % STAGES) * L::STAGE_BYTES + 2 * L::ROWS_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PW_BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < L::NH; ++h) {
        wgmma_rs<0>(acc[h], a[kk], desc_kmajor(tw + h * L::NW * 64 + kk * 16), 1);
      }
    }
    wgmma_commit();
    if (j + 1 < nk) {
      mbar_wait(&full[(j + 1) % STAGES], ((j + 1) / STAGES) & 1);
      build(next, j + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < L::NH; ++h) fence_regs(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % STAGES]);
  };
  uint32_t a0[PW_BK / 16][4], a1[PW_BK / 16][4];
  mbar_wait(&full[0], 0);
  build(a0, 0);
  for (int j = 0; j < nk; j += 2) {
    step(a0, a1, j);
    if (j + 1 < nk) step(a1, a0, j + 1);
  }

  const DxTiles tiles{sx, reinterpret_cast<float*>(ring), ssc, bar_x, m0, n0,
                      static_cast<int>(blockIdx.x)};
  dx_epilogue<N>(acc, tiles, &mdx, scale, shift, partial, Cin, relu_in, live0, live1);
}

template <int N>
int launch_pw_dx_sm90(const CUtensorMap& mdz, const CUtensorMap& mz, const CUtensorMap& mw,
                      const CUtensorMap& mx, const CUtensorMap& mdx, const void* scale,
                      const void* shift, const void* dst, void* partial, void* gst, int m,
                      int cin, int cout, int relu_in, cudaStream_t s) {
  const int bytes = PwDx<N>::BYTES;
  static bool done[64] = {};  // per N: each instantiation opts in for itself
  const int err = hopper::opt_in_smem(pw_bwd_dx_kernel_sm90<N>, bytes, done);
  if (err != 0) return err;
  const dim3 grid((m + PW_BM - 1) / PW_BM, (cin + N - 1) / N);
  pw_bwd_dx_kernel_sm90<N><<<grid, PwDx<N>::THREADS, bytes, s>>>(
      mdz, mz, mw, mx, mdx, static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(dst), static_cast<float*>(partial), m, cin, cout, relu_in);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_stats_reduce(static_cast<const float*>(partial),
                                              static_cast<int>(grid.x), 2 * cin,
                                              static_cast<float*>(gst), s));
}

// ---------------------------------------------------------------------------
// 3x3 dx, dscale, dshift on Hopper: the pointwise dx over nine flipped taps
// ---------------------------------------------------------------------------
// The transposed 3x3 SAME conv as one GEMM: rows = pixels (M), columns =
// Cin, depth = 9 taps x Cout, in stages of 64 channels of Cout of one tap.
// A block owns 128 pixel rows x N input channels (N = 64 or 128, planned by
// the wrapper: fused_conv.c3_dx_tiles) in PwDx<N>'s geometry, ring and
// epilogue, with a producer warp; the column tiles of one row tile are neighbours in launch order,
// so the dz and z tiles they share come from L2.
// - The producer loads the block's x tile for the epilogue, then streams,
//   per stage, the dz and z tiles (128 x 64) of the tap's source pixels and
//   the tap's W tile (N x 64 of (Cin, Cout), K-major as stored), with the
//   stage's 64 entries of dst[0] and dst[1] beside them (bulk copies). The
//   flipped tap: tap (dy, dx) of output pixel m reads dz_eff at pixel m -
//   ((dy-1)W + (dx-1)), the reference's (h+1-dy, w+1-dx), so the tiles load
//   at row m0 minus the forward's offset (TMA takes a negative or
//   past-the-end start and zero-fills; a box wholly outside dz is not loaded:
//   every row of it is masked). W goes through a 3-D map (Cout, Cin, taps):
//   a box past Cin is zero-filled and never reads the next tap's rows.
// - A = dz_eff formed straight into wgmma's register A layout, as in the
//   pointwise dx, then the halo by POSITION: a row whose tap source lies
//   outside its image (past the SAME padding, at the other end of the image
//   row, in the neighbouring image: at 7x7 and 13x10 a tile spans images),
//   or a row at or past M, gives 0. Not dz_eff of TMA's zero fill, which is
//   dst[0]. The rows are the block's fixed output pixels, so each thread
//   finds its two rows' nine in-image bits once, in the prologue, and the
//   loop counts (tap, Cout chunk) on: no division in it. The next stage's A
//   is formed while this stage's wgmma runs.
// - Epilogue: dx_epilogue, the pointwise dx's.
// Bound on an H100: bytes at ResNet-50's 56x56 and 28x28 shapes (x, dz, z,
// dx once), tensor-core operations at 14x14 and 7x7 (9 Cin Cout MACs a
// pixel).
struct C3DxArgs {
  const float* scale;   // (Cin,)
  const float* shift;
  const float* dst;     // [dst0; dst1], rows of ldy entries, 16-byte aligned
  float* partial;       // (row tiles, 2, Cin)
  int M, H, W, Cin, Cout, ldy, relu_in, col_tiles;
};

template <int N>
__global__ void __launch_bounds__(PwDx<N>::THREADS, PwDx<N>::MIN_BLOCKS)
conv3x3_bwd_dx_kernel_sm90(__grid_constant__ const CUtensorMap mdz,
                           __grid_constant__ const CUtensorMap mz,
                           __grid_constant__ const CUtensorMap mw,
                           __grid_constant__ const CUtensorMap mx,
                           __grid_constant__ const CUtensorMap mdx, const C3DxArgs a) {
  using namespace hopper;
  using L = PwDx<N>;
  static_assert(!L::WIDE, "the 3x3 dx takes N = 64 or 128");
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sx = smem;
  unsigned char* ring = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* bar_x = empty + STAGES;
  float* sdst = reinterpret_cast<float*>(smem + L::DST);

  const int tile_m = blockIdx.x / a.col_tiles;
  const int m0 = tile_m * PW_BM;
  const int n0 = (blockIdx.x - tile_m * a.col_tiles) * N;
  const int steps = 9 * ((a.Cout + PW_BK - 1) / PW_BK);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PW_CONSUMERS / 32);
    }
    mbar_init(bar_x, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= PW_CONSUMERS) {  // the producer
    if (threadIdx.x == PW_CONSUMERS) {
      mbar_expect_tx(bar_x, L::X_BYTES);
      for (int p = 0; p < N / 64; ++p) {
        tma_load_2d(sx + p * PW_BM * 128, &mx, bar_x, n0 + p * 64, m0);
      }
      int tap = 0, c0 = 0;  // stage j's tap and first channel of Cout
      for (int j = 0; j < steps; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        unsigned char* st = ring + s * L::STAGE_BYTES;
        const int row = m0 - ((tap / 3 - 1) * a.W + tap % 3 - 1);  // the flipped tap
        const bool rows_in = row < a.M && row + PW_BM > 0;
        // dst's entries of the stage: ldy is a multiple of 8, so whole 32 bytes
        const uint32_t dbytes = min(PW_BK, a.ldy - c0) * 4;
        mbar_expect_tx(&full[s], (rows_in ? 2 * L::ROWS_BYTES : 0) + L::W_BYTES + 2 * dbytes);
        if (rows_in) {
          tma_load_2d(st, &mdz, &full[s], c0, row);
          tma_load_2d(st + L::ROWS_BYTES, &mz, &full[s], c0, row);
        }
        tma_load_3d(st + 2 * L::ROWS_BYTES, &mw, &full[s], c0, n0, tap);
        bulk_load(sdst + s * 2 * PW_BK, a.dst + c0, dbytes, &full[s]);
        bulk_load(sdst + s * 2 * PW_BK + PW_BK, a.dst + a.ldy + c0, dbytes, &full[s]);
        c0 += PW_BK;
        if (c0 >= a.Cout) {
          c0 = 0;
          ++tap;
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns tile rows [wg*64, wg*64 + 64); this thread
  // holds tile rows lr (slot 0) and lr + 8 (slot 1)
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const int lr = wg * 64 + (warp % 4) * 16 + g;
  // the halo of the two rows: bit tap set where the row lies below M and its
  // tap source (h+1-dy, w+1-dx) in its image
  uint32_t halo[2];
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int m = m0 + lr + 8 * slot;
    const int r = m % (a.H * a.W);
    const int h = r / a.W, w = r - h * a.W;
    halo[slot] = 0u;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const bool in = static_cast<unsigned>(h + 1 - tap / 3) < static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(w + 1 - tap % 3) < static_cast<unsigned>(a.W);
      halo[slot] |= (m < a.M && in ? 1u : 0u) << tap;
    }
  }
  float acc[L::NH][L::NW / 2];
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 2; ++i) acc[h][i] = 0.f;
  }

  // stage j's dz_eff in wgmma's register A layout, as the pointwise dx's,
  // then the halo. The stages are formed in order: f_tap and f_c0 are the
  // next one's tap and first channel of Cout.
  int f_tap = 0, f_c0 = 0;
  const auto build = [&](uint32_t (&av)[PW_BK / 16][4], int j) {
    const unsigned char* tdz = ring + (j % STAGES) * L::STAGE_BYTES;
    const unsigned char* tz = tdz + L::ROWS_BYTES;
    const float* sd = sdst + (j % STAGES) * 2 * PW_BK;
    const bool ok0 = (halo[0] >> f_tap) & 1u, ok1 = (halo[1] >> f_tap) & 1u;
#pragma unroll
    for (int kk = 0; kk < PW_BK / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = 16 * kk + 8 * half + 2 * c;  // the stage's column
        // past Cout dst is 0 (the shared slice may hold stale values there);
        // dst[0] and 2 dst[1], doubled once for both rows: z (2 dst[1]) is
        // the same rounding as dz_eff()'s (2z) dst[1]. Calling dz_eff() here
        // measured 0.81 -> 1.19 ms a step on an H100 (PERF.md)
        const bool in0 = f_c0 + cc < a.Cout, in1 = f_c0 + cc + 1 < a.Cout;
        const float2 s0 = *reinterpret_cast<const float2*>(sd + cc);
        const float2 s1 = *reinterpret_cast<const float2*>(sd + PW_BK + cc);
        const float d0x = in0 ? s0.x : 0.f, d0y = in1 ? s0.y : 0.f;
        const float d1x = in0 ? 2.f * s1.x : 0.f, d1y = in1 ? 2.f * s1.y : 0.f;
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const int r = lr + 8 * slot;
          const uint32_t wdz = sw128_word(tdz, r, 2 * kk + half, c);
          const uint32_t wz = sw128_word(tz, r, 2 * kk + half, c);
          const float2 fdz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wdz));
          const float2 fz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wz));
          const float e0 = __fadd_rn(__fadd_rn(fdz.x, d0x), __fmul_rn(fz.x, d1x));
          const float e1 = __fadd_rn(__fadd_rn(fdz.y, d0y), __fmul_rn(fz.y, d1y));
          // the halo by position, after forming
          av[kk][2 * half + slot] = (slot ? ok1 : ok0) ? pack_bf16(e0, e1) : 0u;
        }
      }
    }
    f_c0 += PW_BK;
    if (f_c0 >= a.Cout) {
      f_c0 = 0;
      ++f_tap;
    }
  };
  // dxn += dz_eff W^T for stage j (W's tile, N rows of Cin by 64 of Cout, is
  // K-major); the next stage's A is formed under it, then the stage is freed
  const auto step = [&](const uint32_t (&av)[PW_BK / 16][4], uint32_t (&next)[PW_BK / 16][4],
                        int j) {
    const __nv_bfloat16* tw = reinterpret_cast<const __nv_bfloat16*>(
        ring + (j % STAGES) * L::STAGE_BYTES + 2 * L::ROWS_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PW_BK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < L::NH; ++h) {
        wgmma_rs<0>(acc[h], av[kk], desc_kmajor(tw + h * L::NW * 64 + kk * 16), 1);
      }
    }
    wgmma_commit();
    if (j + 1 < steps) {
      mbar_wait(&full[(j + 1) % STAGES], ((j + 1) / STAGES) & 1);
      build(next, j + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < L::NH; ++h) fence_regs(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % STAGES]);
  };
  uint32_t a0[PW_BK / 16][4], a1[PW_BK / 16][4];
  mbar_wait(&full[0], 0);
  build(a0, 0);
  for (int j = 0; j < steps; j += 2) {
    step(a0, a1, j);
    if (j + 1 < steps) step(a1, a0, j + 1);
  }

  const DxTiles tiles{sx, reinterpret_cast<float*>(ring),
                      reinterpret_cast<float*>(smem + L::SC), bar_x, m0, n0, tile_m};
  dx_epilogue<N>(acc, tiles, &mdx, a.scale, a.shift, a.partial, a.Cin, a.relu_in,
                 m0 + lr < a.M, m0 + lr + 8 < a.M);
}

template <int N>
int launch_c3_dx_sm90(const CUtensorMap& mdz, const CUtensorMap& mz, const CUtensorMap& mw,
                      const CUtensorMap& mx, const CUtensorMap& mdx, C3DxArgs a, void* gst,
                      cudaStream_t s) {
  const int bytes = PwDx<N>::BYTES;
  static bool done[64] = {};  // per N: each instantiation opts in for itself
  const int err = hopper::opt_in_smem(conv3x3_bwd_dx_kernel_sm90<N>, bytes, done);
  if (err != 0) return err;
  const int row_tiles = (a.M + PW_BM - 1) / PW_BM;
  a.col_tiles = (a.Cin + N - 1) / N;
  const long long blocks = static_cast<long long>(row_tiles) * a.col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_bwd_dx_kernel_sm90<N><<<static_cast<unsigned>(blocks), PwDx<N>::THREADS, bytes, s>>>(
      mdz, mz, mw, mx, mdx, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_stats_reduce(a.partial, row_tiles, 2 * a.Cin, static_cast<float*>(gst), s));
}

// ---------------------------------------------------------------------------
// dW, split over pixel chunks: the f32 partials of the chunks summed in order
// ---------------------------------------------------------------------------

// partial (splits, n) f32 -> out (n) bf16, summed over the splits in order
__global__ void dw_reduce_kernel(const float* __restrict__ partial, int splits,
                                 long long n, __nv_bfloat16* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(long long)k * n + i];
  out[i] = __float2bfloat16_rn(s);
}

cudaError_t launch_dw_reduce(const float* partial, int splits, long long n, void* dw,
                             cudaStream_t s) {
  dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      partial, splits, n, static_cast<__nv_bfloat16*>(dw));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// pointwise dW on Hopper: TMA ring, xn^T formed into register A, dz_eff
// formed on chip as the shared B operand
// ---------------------------------------------------------------------------
// A GEMM with rows = input channels, columns = output channels, depth = the
// pixels: dW = xn^T dz_eff. A block owns 128 channels of Cin x N channels of
// Cout (N = 64, 128 or 256: Cout rounded up, at most 256) over one chunk of
// the pixels (a whole number of 32-pixel stages, planned by the wrapper):
// a producer warp and two consumer warpgroups of 64 channels. At N = 256 the
// producer is a whole warpgroup that hands its registers to the consumers
// (setmaxnreg 40 / 232), as in the pointwise dx. The Cin tiles, then the
// Cout tiles of one chunk are neighbours in launch order: the dz, z and x
// tiles they share are read from L2.
// - The producer streams, per stage of 32 pixels, the x tile (32 pixels x
//   128 channels as stored: two 64-channel panels) and the dz and z tiles
//   (32 x N) into a ring on full/empty mbarriers (TMA, 128-byte swizzle,
//   zero fill past M, Cin and Cout; a panel wholly past Cin or Cout is not
//   loaded).
// - B = dz_eff, formed on chip once per stage: each consumer thread owns an
//   8-column chunk of the tile (its dst[0] and dst[1] in registers, 0 past
//   Cout) and some rows of it (a quarter-warp takes 8 consecutive rows:
//   conflict-free 16-byte accesses of the swizzled rows). It forms dz_eff in
//   f32 with the plain version's rounding, rounds it to bf16 and writes it
//   over dz at the same offsets. Rows at or past M are 0 by position: TMA's
//   zero fill would leave dst[0] there, and the reference masks rows >=
//   m_valid. Then fence.proxy.async and a barrier of the consumers, and
//   wgmma reads the tile MN-major, as the forward reads W.
// - A = xn^T from registers: ldmatrix.trans reads each warp's 16 channels by
//   16 pixels of the stored tile transposed, straight into wgmma's register
//   A layout. A thread's A rows are two fixed channels, so their scale and
//   shift stay in registers (0 past Cin: nothing is read past the vectors)
//   and the fold is a product, a sum and a ReLU per element, with the plain
//   version's rounding. The next stage's B and A are formed while this
//   stage's wgmma runs. Rows past Cin (the second warpgroup's where a Cin
//   tile has at most 64 channels, its x panel not loaded) are computed and
//   never stored.
// - Epilogue: the block's f32 tile (rows < Cin, columns < Cout) goes from the
//   registers into its chunk's slice of partial (splits, Cin, Cout), and
//   dw_reduce_kernel sums the splits in order and rounds to bf16. No float
//   atomics: reruns give the same bits.
// Bound on an H100: at ResNet-50's shapes the bytes (x, z and dz read once).
constexpr int DW_ROWS = 128;                  // input channels per block
constexpr int DW_BK = 32;                     // pixels per stage
constexpr int DW_KS = DW_BK / 16;             // wgmma k-steps per stage
constexpr int DW_PANEL = DW_BK * 128;         // a stage's 64-column panel, 1024-aligned
constexpr int DW_CONSUMERS = 256;             // two consumer warpgroups

template <int N>
struct PwDw {
  static constexpr int NW = N < 128 ? N : 128;               // columns per wgmma
  static constexpr int NH = N / NW;                          // wgmmas per k-step
  static constexpr int STAGES = N == 256 ? 4 : 6;
  static constexpr int MIN_BLOCKS = N == 64 ? 2 : 1;
  static constexpr bool WIDE = N == 256;                     // a producer warpgroup, setmaxnreg
  static constexpr int THREADS = DW_CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int X_BYTES = 2 * DW_PANEL;               // x: two 64-channel panels
  static constexpr int Y_BYTES = (N / 64) * DW_PANEL;        // dz (then dz_eff), z
  static constexpr int STAGE_BYTES = X_BYTES + 2 * Y_BYTES;
  static constexpr int BAR = STAGES * STAGE_BYTES;           // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + the alignment slack
  static constexpr int TPC = 2048 / N;                       // threads per 8-column chunk of B
  static constexpr int ROWS = DW_BK / TPC;                   // B rows a thread forms per stage
};

struct DwArgs {
  const float* scale;   // (Cin,)
  const float* shift;
  const float* dst;     // (2, Cout)
  float* partial;       // (splits, Cin, Cout)
  int M, Cin, Cout, relu_in, chunk, cin_tiles, col_tiles;
};

// a bf16 pair of one channel folded, act(x * scale + shift), with the plain
// version's rounding (a product, then a sum: no FMA), rounded to bf16
__device__ __forceinline__ uint32_t fold2(uint32_t v, float s, float t, int relu_in) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  float u0 = __fadd_rn(__fmul_rn(f.x, s), t);
  float u1 = __fadd_rn(__fmul_rn(f.y, s), t);
  if (relu_in) {
    u0 = hopper::relu_nan(u0);
    u1 = hopper::relu_nan(u1);
  }
  return hopper::pack_bf16(u0, u1);
}

template <int N>
__global__ void __launch_bounds__(PwDw<N>::THREADS, PwDw<N>::MIN_BLOCKS)
pw_bwd_dw_kernel_sm90(__grid_constant__ const CUtensorMap mx,
                      __grid_constant__ const CUtensorMap mdz,
                      __grid_constant__ const CUtensorMap mz, const DwArgs a) {
  using namespace hopper;
  using L = PwDw<N>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BAR);
  uint64_t* empty = full + STAGES;

  const int c_tile = blockIdx.x % a.cin_tiles;
  const int rest = blockIdx.x / a.cin_tiles;
  const int split = rest / a.col_tiles;
  const int ci0 = c_tile * DW_ROWS;
  const int n0 = (rest - split * a.col_tiles) * N;
  const int p0 = split * a.chunk;
  const int steps = (min(a.M - p0, a.chunk) + DW_BK - 1) / DW_BK;
  const int x_panels = a.Cin - ci0 > 64 ? 2 : 1;  // x panels with a channel < Cin
  const int panels = min(N / 64, (a.Cout - n0 + 63) / 64);  // dz/z panels with a column < Cout
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DW_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= DW_CONSUMERS) {  // the producer
    if constexpr (L::WIDE) regs_dec<40>();
    if (threadIdx.x == DW_CONSUMERS) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* st = ring + s * L::STAGE_BYTES;
        const int row = p0 + i * DW_BK;
        mbar_expect_tx(&full[s], (x_panels + 2 * panels) * DW_PANEL);
        for (int p = 0; p < x_panels; ++p) {
          tma_load_2d(st + p * DW_PANEL, &mx, &full[s], ci0 + 64 * p, row);
        }
        for (int p = 0; p < panels; ++p) {
          tma_load_2d(st + L::X_BYTES + p * DW_PANEL, &mdz, &full[s], n0 + 64 * p, row);
          tma_load_2d(st + L::X_BYTES + L::Y_BYTES + p * DW_PANEL, &mz, &full[s], n0 + 64 * p,
                      row);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns 64 channels; this thread's A rows are
  // channels ch0 and ch0 + 8
  if constexpr (L::WIDE) regs_inc<232>();
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const int ch0 = ci0 + 64 * wg + (warp % 4) * 16 + g;
  const float sc0 = ch0 < a.Cin ? __ldg(a.scale + ch0) : 0.f;
  const float sh0 = ch0 < a.Cin ? __ldg(a.shift + ch0) : 0.f;
  const float sc1 = ch0 + 8 < a.Cin ? __ldg(a.scale + ch0 + 8) : 0.f;
  const float sh1 = ch0 + 8 < a.Cin ? __ldg(a.shift + ch0 + 8) : 0.f;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8, which is pixels
  // 8 (l / 16) .. + 7 of a k-step by channels 16 (warp % 4) + 8 ((l / 8) & 1)
  // .. + 7 of the warpgroup's panel
  const int lm_row = 8 * (lane / 16) + lane % 8;
  const int lm_off = wg * DW_PANEL + lm_row * 128 +
                     (((2 * (warp % 4) + ((lane / 8) & 1)) ^ (lane % 8)) << 4);
  // B: this thread's 8-column chunk cc of the tile, rows sub + TPC q
  const int cc = threadIdx.x / L::TPC;
  const int sub = threadIdx.x % L::TPC;
  const int col = n0 + 8 * cc;
  float d0[8], d1[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool in = col + e < a.Cout;
    d0[e] = in ? __ldg(a.dst + col + e) : 0.f;
    d1[e] = in ? __ldg(a.dst + a.Cout + col + e) : 0.f;
  }
  const int b_off = L::X_BYTES + (cc / 8) * DW_PANEL;  // the chunk's panel of dz in a stage

  float acc[L::NH][L::NW / 2];
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 2; ++i) acc[h][i] = 0.f;
  }

  // stage i's dz_eff over its dz: rows at or past M, and chunks past Cout, 0
  const auto form = [&](int i) {
    unsigned char* tdz = ring + (i % STAGES) * L::STAGE_BYTES + b_off;
    const unsigned char* tz = tdz + L::Y_BYTES;
    const int left = col < a.Cout ? a.M - (p0 + i * DW_BK) : 0;  // live rows of the stage
#pragma unroll
    for (int q = 0; q < L::ROWS; ++q) {
      const int r = sub + L::TPC * q;
      const int off = r * 128 + (((cc % 8) ^ (r & 7)) << 4);
      const uint4 vdz = *reinterpret_cast<const uint4*>(tdz + off);
      const uint4 vz = *reinterpret_cast<const uint4*>(tz + off);
      const uint32_t* wdz = reinterpret_cast<const uint32_t*>(&vdz);
      const uint32_t* wz = reinterpret_cast<const uint32_t*>(&vz);
      uint4 out;
      uint32_t* wo = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fdz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wdz[e]));
        const float2 fz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wz[e]));
        wo[e] = r < left ? pack_bf16(dz_eff(fdz.x, fz.x, d0[2 * e], d1[2 * e]),
                                     dz_eff(fdz.y, fz.y, d0[2 * e + 1], d1[2 * e + 1]))
                         : 0u;
      }
      *reinterpret_cast<uint4*>(tdz + off) = out;
    }
  };
  // stage i's fold of x, transposed, in wgmma's register A layout: av[kk] =
  // {(ch0, pixels 16kk + 2c, +1), (ch0 + 8, the same), (ch0, 8 pixels on),
  // (ch0 + 8, 8 on)}
  const auto build = [&](uint32_t (&av)[DW_KS][4], int i) {
    const unsigned char* tx = ring + (i % STAGES) * L::STAGE_BYTES + lm_off;
#pragma unroll
    for (int kk = 0; kk < DW_KS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, tx + kk * 16 * 128);
      av[kk][0] = fold2(r[0], sc0, sh0, a.relu_in);
      av[kk][1] = fold2(r[1], sc1, sh1, a.relu_in);
      av[kk][2] = fold2(r[2], sc0, sh0, a.relu_in);
      av[kk][3] = fold2(r[3], sc1, sh1, a.relu_in);
    }
  };
  // dW += xn^T dz_eff for stage i (dz_eff's tile, 32 pixel rows by N, is
  // MN-major: 64-column panels DW_PANEL apart). The wgmma of stage i - 1 is
  // then waited for, which frees its stage and its A registers (next), and
  // the next stage's B and A are formed while stage i's wgmma runs.
  const auto step = [&](const uint32_t (&av)[DW_KS][4], uint32_t (&next)[DW_KS][4], int i) {
    const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(
        ring + (i % STAGES) * L::STAGE_BYTES + L::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_KS; ++kk) {
#pragma unroll
      for (int h = 0; h < L::NH; ++h) {
        wgmma_rs<1>(acc[h], av[kk],
                    desc_mnmajor(tb + h * (L::NW / 64) * DW_BK * 64 + kk * 16 * 64, DW_PANEL), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    if (i + 1 < steps) {
      mbar_wait(&full[(i + 1) % STAGES], ((i + 1) / STAGES) & 1);
      form(i + 1);
      fence_proxy_async();  // dz_eff in the tile, for wgmma
      build(next, i + 1);
      named_barrier(1, DW_CONSUMERS);
    }
  };
  uint32_t a0[DW_KS][4], a1[DW_KS][4];
  mbar_wait(&full[0], 0);
  form(0);
  fence_proxy_async();
  build(a0, 0);
  named_barrier(1, DW_CONSUMERS);
  for (int i = 0; i < steps; i += 2) {
    step(a0, a1, i);
    if (i + 1 < steps) step(a1, a0, i + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < L::NH; ++h) fence_regs(acc[h]);

  // the tile's rows < Cin and columns < Cout into the chunk's partial
  float* out = a.partial + static_cast<long long>(split) * a.Cin * a.Cout;
  const bool pairs = (a.Cout & 1) == 0;  // 8-byte aligned column pairs
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 8; ++i) {
      const int co = n0 + h * L::NW + 8 * i + 2 * c;
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const int ci = ch0 + 8 * slot;
        if (ci >= a.Cin || co >= a.Cout) continue;
        float* p = out + static_cast<long long>(ci) * a.Cout + co;
        const float v0 = acc[h][4 * i + 2 * slot], v1 = acc[h][4 * i + 2 * slot + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (co + 1 < a.Cout) p[1] = v1;
        }
      }
    }
  }
}

template <int N>
int launch_pw_dw_sm90(const CUtensorMap& mx, const CUtensorMap& mdz, const CUtensorMap& mz,
                      DwArgs a, int splits, void* dw, cudaStream_t s) {
  const int bytes = PwDw<N>::BYTES;
  static bool done[64] = {};  // per N: each instantiation opts in for itself
  const int err = hopper::opt_in_smem(pw_bwd_dw_kernel_sm90<N>, bytes, done);
  if (err != 0) return err;
  a.cin_tiles = (a.Cin + DW_ROWS - 1) / DW_ROWS;
  a.col_tiles = (a.Cout + N - 1) / N;
  const long long blocks = static_cast<long long>(a.cin_tiles) * a.col_tiles * splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pw_bwd_dw_kernel_sm90<N><<<static_cast<unsigned>(blocks), PwDw<N>::THREADS, bytes, s>>>(
      mx, mdz, mz, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      launch_dw_reduce(a.partial, splits, static_cast<long long>(a.Cin) * a.Cout, dw, s));
}

// ---------------------------------------------------------------------------
// 3x3 dW on Hopper: one GEMM over (tap, Cin) rows; xn^T at the tap's row
// offset formed into register A, the halo by position; dz_eff formed on chip
// as the B operand the taps share
// ---------------------------------------------------------------------------
// dW (3, 3, Cin, Cout) is the row-major (9 Cin, Cout) matrix with rows (tap,
// ci): dW = sum over the pixels p of A[(tap, ci), p] B[p, co], where A is the
// fold of x at p's tap neighbour (0 outside the image) and B = dz_eff, the
// same for all nine taps. The rows are cut into 64-row panels that never
// straddle a tap (ceil(Cin / 64) a tap, tap-major), and a block takes two
// neighbouring panels, one per consumer warpgroup, by N columns of Cout (64,
// 128 or 256: Cout rounded up) over one chunk of whole 32-pixel stages:
// PwDw<N>'s geometry and ring. At Cin 64 a block's two warpgroups are two
// taps of the same channels; at Cin 128, 256 or 512 two halves of 128
// channels of one tap. Either way they share the stage's B tile. The panels
// of one chunk, then its column tiles, are neighbours in launch order: the
// dz, z and x tiles they share come from L2. (All nine taps in one block
// would hold nine accumulators: 9 N / 2 registers a thread.)
// - The producer streams, per stage, each panel's x tile (32 pixels x 64
//   channels) from the row of the stage's tap neighbours, p + (dy-1)W +
//   (dx-1) (TMA takes a negative or past-the-end start and zero-fills; a box
//   that would lie wholly outside x starts one row inside it instead, so
//   every A value is finite), and the stage's dz and z tiles (32 x N). A
//   panel past the last (an odd panel count) is not loaded.
// - A = xn^T from registers, as in the pointwise dW: ldmatrix.trans, then
//   the fold with the panel's per-thread scale and shift (0 past Cin). The
//   halo by POSITION, after the fold: each warp takes the stage's 32 pixels,
//   one a lane, finds whether the pixel's tap neighbour lies in its image
//   (each lane's (h, w) moves on by 32 pixels a stage: no division in the
//   loop), and a ballot gives the stage's 32-bit mask; a thread ANDs each
//   folded bf16 pair with its two pixels' bits. Never by value, and never
//   by TMA's zero fill: an offset row inside x still wraps past the image
//   row's end or into the next image (at 7x7 and 13x10 a stage spans
//   images), and a zero-filled x folds to act(shift), not 0.
// - B = dz_eff, formed once a stage over dz in shared memory as in the
//   pointwise dW (rows at or past M 0 by position: their A is not masked),
//   read by both warpgroups' wgmma MN-major. The next stage's B and A are
//   formed while this stage's wgmma runs.
// - Epilogue: with one chunk the block rounds its tile to bf16 and stores
//   it into dW (the bits of a one-split reduce); with more, its f32 tile goes
//   into its chunk's slice of partial (splits, 9, Cin, Cout), and
//   dw_reduce_kernel sums the splits in order and rounds. No float atomics:
//   reruns give the same bits.
// Bound on an H100: tensor-core operations at ResNet-50's shapes (9 Cin Cout
// MACs a pixel against 2 (Cin + 2 Cout) bytes). Measured, the consumers'
// forming of B and A holds it well above that bound (PERF.md).
struct C3DwArgs {
  const float* scale;   // (Cin,)
  const float* shift;
  const float* dst;     // (2, Cout)
  float* partial;       // (splits, 9, Cin, Cout) when splits > 1
  __nv_bfloat16* dw;    // (9, Cin, Cout)
  int M, H, W, Cin, Cout, relu_in, chunk, splits, row_tiles, col_tiles;
};

template <int N>
__global__ void __launch_bounds__(PwDw<N>::THREADS, PwDw<N>::MIN_BLOCKS)
conv3x3_bwd_dw_kernel_sm90(__grid_constant__ const CUtensorMap mx,
                           __grid_constant__ const CUtensorMap mdz,
                           __grid_constant__ const CUtensorMap mz, const C3DwArgs a) {
  using namespace hopper;
  using L = PwDw<N>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BAR);
  uint64_t* empty = full + STAGES;

  const int r_tile = blockIdx.x % a.row_tiles;
  const int rest = blockIdx.x / a.row_tiles;
  const int split = rest / a.col_tiles;
  const int n0 = (rest - split * a.col_tiles) * N;
  const int p0 = split * a.chunk;
  const int steps = (min(a.M - p0, a.chunk) + DW_BK - 1) / DW_BK;
  const int per_tap = (a.Cin + 63) / 64;  // 64-channel panels of a tap
  const int panels = 9 * per_tap;         // panels that exist
  const int ypanels = min(N / 64, (a.Cout - n0 + 63) / 64);  // dz/z panels with a column < Cout
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // panel 2 r_tile + k: its tap, first channel and the row offset of the tap
  const auto tap_of = [&](int k) { return (2 * r_tile + k) / per_tap; };
  const auto offset_of = [&](int tap) { return (tap / 3 - 1) * a.W + tap % 3 - 1; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DW_CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= DW_CONSUMERS) {  // the producer
    if constexpr (L::WIDE) regs_dec<40>();
    if (threadIdx.x == DW_CONSUMERS) {
      const int xpanels = 2 * r_tile + 1 < panels ? 2 : 1;
      int c0[2], off[2];
      for (int k = 0; k < 2; ++k) {
        c0[k] = (2 * r_tile + k - tap_of(k) * per_tap) * 64;
        off[k] = offset_of(tap_of(k));
      }
      for (int i = 0; i < steps; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* st = ring + s * L::STAGE_BYTES;
        const int row = p0 + i * DW_BK;
        mbar_expect_tx(&full[s], (xpanels + 2 * ypanels) * DW_PANEL);
        for (int k = 0; k < xpanels; ++k) {
          // every row of a box wholly outside x is masked (halo or past M):
          // one row inside keeps the load legal and the values finite
          const int r = min(max(row + off[k], 1 - DW_BK), a.M - 1);
          tma_load_2d(st + k * DW_PANEL, &mx, &full[s], c0[k], r);
        }
        for (int p = 0; p < ypanels; ++p) {
          tma_load_2d(st + L::X_BYTES + p * DW_PANEL, &mdz, &full[s], n0 + 64 * p, row);
          tma_load_2d(st + L::X_BYTES + L::Y_BYTES + p * DW_PANEL, &mz, &full[s], n0 + 64 * p,
                      row);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns panel 2 r_tile + wg (tap, channels from
  // ci0); this thread's A rows are channels ch0 and ch0 + 8 of it
  if constexpr (L::WIDE) regs_inc<232>();
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const bool real = 2 * r_tile + wg < panels;  // not the panel past the last
  const int tap = tap_of(wg);
  const int ci0 = (2 * r_tile + wg - tap * per_tap) * 64;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int ch0 = ci0 + (warp % 4) * 16 + g;
  const float sc0 = ch0 < a.Cin ? __ldg(a.scale + ch0) : 0.f;
  const float sh0 = ch0 < a.Cin ? __ldg(a.shift + ch0) : 0.f;
  const float sc1 = ch0 + 8 < a.Cin ? __ldg(a.scale + ch0 + 8) : 0.f;
  const float sh1 = ch0 + 8 < a.Cin ? __ldg(a.shift + ch0 + 8) : 0.f;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8, which is pixels
  // 8 (l / 16) .. + 7 of a k-step by channels 16 (warp % 4) + 8 ((l / 8) & 1)
  // .. + 7 of the warpgroup's panel
  const int lm_row = 8 * (lane / 16) + lane % 8;
  const int lm_off = wg * DW_PANEL + lm_row * 128 +
                     (((2 * (warp % 4) + ((lane / 8) & 1)) ^ (lane % 8)) << 4);
  // B: this thread's 8-column chunk cc of the tile, rows sub + TPC q
  const int cc = threadIdx.x / L::TPC;
  const int sub = threadIdx.x % L::TPC;
  const int col = n0 + 8 * cc;
  // dst[0] and 2 dst[1]: (2z) dst[1] and z (2 dst[1]) are one rounding of
  // the same product
  float d0[8], d1x2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool in = col + e < a.Cout;
    d0[e] = in ? __ldg(a.dst + col + e) : 0.f;
    d1x2[e] = in ? 2.f * __ldg(a.dst + a.Cout + col + e) : 0.f;
  }
  const int b_off = L::X_BYTES + (cc / 8) * DW_PANEL;  // the chunk's panel of dz in a stage
  // lane j's pixel of the next stage to build, (qh, qw) in its image; a
  // stage moves it by 32 pixels, adv_h rows (mod H) and adv_w columns
  int qw = (p0 + lane) % a.W;
  int qh = ((p0 + lane) / a.W) % a.H;
  const int adv_w = DW_BK % a.W, adv_h = (DW_BK / a.W) % a.H;

  float acc[L::NH][L::NW / 2];
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 2; ++i) acc[h][i] = 0.f;
  }

  // stage i's dz_eff over its dz: rows at or past M, and chunks past Cout, 0
  const auto form = [&](int i) {
    unsigned char* tdz = ring + (i % STAGES) * L::STAGE_BYTES + b_off;
    const unsigned char* tz = tdz + L::Y_BYTES;
    const int left = col < a.Cout ? a.M - (p0 + i * DW_BK) : 0;  // live rows of the stage
#pragma unroll
    for (int q = 0; q < L::ROWS; ++q) {
      const int r = sub + L::TPC * q;
      const int off = r * 128 + (((cc % 8) ^ (r & 7)) << 4);
      const uint4 vdz = *reinterpret_cast<const uint4*>(tdz + off);
      const uint4 vz = *reinterpret_cast<const uint4*>(tz + off);
      const uint32_t* wdz = reinterpret_cast<const uint32_t*>(&vdz);
      const uint32_t* wz = reinterpret_cast<const uint32_t*>(&vz);
      uint4 out;
      uint32_t* wo = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fdz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wdz[e]));
        const float2 fz = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wz[e]));
        const auto eff = [&](float d, float zz, int k) {  // column 2e + k, as dz_eff()
          return __fadd_rn(__fadd_rn(d, d0[2 * e + k]), __fmul_rn(zz, d1x2[2 * e + k]));
        };
        wo[e] = r < left ? pack_bf16(eff(fdz.x, fz.x, 0), eff(fdz.y, fz.y, 1)) : 0u;
      }
      *reinterpret_cast<uint4*>(tdz + off) = out;
    }
  };
  // the next stage's halo: bit j set where pixel j's tap neighbour lies in
  // its image (called once a stage, in order: no division in the loop)
  const auto inside = [&]() -> uint32_t {
    const bool ok = static_cast<unsigned>(qh + dy) < static_cast<unsigned>(a.H) &&
                    static_cast<unsigned>(qw + dx) < static_cast<unsigned>(a.W);
    qw += adv_w;
    const int carry = qw >= a.W ? 1 : 0;
    qw -= carry * a.W;
    qh += adv_h + carry;      // < 2H
    qh -= qh >= a.H ? a.H : 0;
    return __ballot_sync(0xffffffffu, ok);
  };
  // the bf16-pair mask of stage pixels j and j + 1: bit j rotated to bit 7
  // of one word and bit j + 1 of another, each byte's sign spread over its
  // half of the mask (prmt's sign-replicating selectors 8 and C)
  const auto pair = [](uint32_t bits, int j) {
    const uint32_t lo = __funnelshift_l(bits, bits, (7 - j) & 31);
    const uint32_t hi = __funnelshift_l(bits, bits, (6 - j) & 31);
    uint32_t m;
    asm("prmt.b32 %0, %1, %2, 0xCC88;" : "=r"(m) : "r"(lo), "r"(hi));
    return m;
  };
  // stage i's fold of x, transposed, in wgmma's register A layout, the halo
  // 0: av[kk] = {(ch0, pixels 16kk + 2c, +1), (ch0 + 8, the same), (ch0, 8
  // pixels on), (ch0 + 8, 8 on)}
  const auto build = [&](uint32_t (&av)[DW_KS][4], int i) {
    const unsigned char* tx = ring + (i % STAGES) * L::STAGE_BYTES + lm_off;
    const uint32_t bits = inside();
#pragma unroll
    for (int kk = 0; kk < DW_KS; ++kk) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, tx + kk * 16 * 128);
      const uint32_t m0 = pair(bits, 16 * kk + 2 * c), m1 = pair(bits, 16 * kk + 8 + 2 * c);
      av[kk][0] = fold2(r[0], sc0, sh0, a.relu_in) & m0;
      av[kk][1] = fold2(r[1], sc1, sh1, a.relu_in) & m0;
      av[kk][2] = fold2(r[2], sc0, sh0, a.relu_in) & m1;
      av[kk][3] = fold2(r[3], sc1, sh1, a.relu_in) & m1;
    }
  };
  // dW += xn^T dz_eff for stage i (dz_eff's tile, 32 pixel rows by N, is
  // MN-major: 64-column panels DW_PANEL apart). The wgmma of stage i - 1 is
  // then waited for, which frees its stage and its A registers (next), and
  // the next stage's B and A are formed while stage i's wgmma runs.
  const auto step = [&](const uint32_t (&av)[DW_KS][4], uint32_t (&next)[DW_KS][4], int i) {
    const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(
        ring + (i % STAGES) * L::STAGE_BYTES + L::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW_KS; ++kk) {
#pragma unroll
      for (int h = 0; h < L::NH; ++h) {
        wgmma_rs<1>(acc[h], av[kk],
                    desc_mnmajor(tb + h * (L::NW / 64) * DW_BK * 64 + kk * 16 * 64, DW_PANEL), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    if (i + 1 < steps) {
      mbar_wait(&full[(i + 1) % STAGES], ((i + 1) / STAGES) & 1);
      form(i + 1);
      fence_proxy_async();  // dz_eff in the tile, for wgmma
      build(next, i + 1);
      named_barrier(1, DW_CONSUMERS);
    }
  };
  uint32_t a0[DW_KS][4], a1[DW_KS][4];
  mbar_wait(&full[0], 0);
  form(0);
  fence_proxy_async();
  build(a0, 0);
  named_barrier(1, DW_CONSUMERS);
  for (int i = 0; i < steps; i += 2) {
    step(a0, a1, i);
    if (i + 1 < steps) step(a1, a0, i + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < L::NH; ++h) fence_regs(acc[h]);
  if (!real) return;

  // the tile's rows < Cin and columns < Cout: dW row tap Cin + ci, into dW
  // itself (one split) or the chunk's partial
  const long long row0 = static_cast<long long>(tap) * a.Cin;
  float* out = a.partial + static_cast<long long>(split) * 9 * a.Cin * a.Cout;
  const bool pairs = (a.Cout & 1) == 0;  // aligned column pairs
#pragma unroll
  for (int h = 0; h < L::NH; ++h) {
#pragma unroll
    for (int i = 0; i < L::NW / 8; ++i) {
      const int co = n0 + h * L::NW + 8 * i + 2 * c;
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const int ci = ch0 + 8 * slot;
        if (ci >= a.Cin || co >= a.Cout) continue;
        const long long o = (row0 + ci) * a.Cout + co;
        const float v0 = acc[h][4 * i + 2 * slot], v1 = acc[h][4 * i + 2 * slot + 1];
        if (a.splits == 1) {
          // as dw_reduce_kernel rounds one split: 0 + v (a -0 sum gives +0)
          const float r0 = __fadd_rn(0.f, v0), r1 = __fadd_rn(0.f, v1);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(a.dw + o) = pack_bf16(r0, r1);
          } else {
            a.dw[o] = __float2bfloat16_rn(r0);
            if (co + 1 < a.Cout) a.dw[o + 1] = __float2bfloat16_rn(r1);
          }
        } else if (pairs) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          out[o] = v0;
          if (co + 1 < a.Cout) out[o + 1] = v1;
        }
      }
    }
  }
}

template <int N>
int launch_c3_dw_sm90(const CUtensorMap& mx, const CUtensorMap& mdz, const CUtensorMap& mz,
                      C3DwArgs a, cudaStream_t s) {
  const int bytes = PwDw<N>::BYTES;
  static bool done[64] = {};  // per N: each instantiation opts in for itself
  const int err = hopper::opt_in_smem(conv3x3_bwd_dw_kernel_sm90<N>, bytes, done);
  if (err != 0) return err;
  a.row_tiles = (9 * ((a.Cin + 63) / 64) + 1) / 2;
  a.col_tiles = (a.Cout + N - 1) / N;
  const long long blocks = static_cast<long long>(a.row_tiles) * a.col_tiles * a.splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_bwd_dw_kernel_sm90<N><<<static_cast<unsigned>(blocks), PwDw<N>::THREADS, bytes, s>>>(
      mx, mdz, mz, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  return static_cast<int>(
      launch_dw_reduce(a.partial, a.splits, 9LL * a.Cin * a.Cout, a.dw, s));
}

}  // namespace

extern "C" {

// tile sizes: 0 -> rows per 3x3 dx block, 1 -> rows per pointwise dx block
// (each sizes its kernel's (row tiles, 2, Cin) partials), 2 -> dW rows per
// block (input channels of a pointwise dW block; two 64-row panels of the
// 3x3's (tap, Cin) rows), 3 -> pixels per dW stage (a pixel chunk of either
// dW is a multiple)
int dl4j_fused_conv_bwd_tile(int which) {
  const int tiles[4] = {PW_BM, PW_BM, DW_ROWS, DW_BK};
  return which >= 0 && which < 4 ? tiles[which] : 0;
}

// x (m, cin) bf16, scale/shift (cin,) f32, w (cin, cout) bf16, z/dz (m,
// cout) bf16, dst (2, cout) f32 -> dx (m, cin) bf16, gst (2, cin) f32 =
// [dscale; dshift]; x and dx with row stride ld; partial is (ceil(m/128), 2,
// cin) f32. What TMA reads and writes: cout and ld multiples of 8, x, dx, w,
// z, dz and dst 16-byte aligned. Returns cudaGetLastError(),
// or 1000 + the CUresult of a failed tensor-map encoding.
int dl4j_pw_conv_bwd_dx(const void* x, const void* scale, const void* shift,
                        const void* w, const void* z, const void* dz, const void* dst,
                        void* dx, void* partial, void* gst, int m, int cin, int cout, int ld,
                        int relu_in, void* stream) {
  const auto misaligned = [](const void* p, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(p) & (to - 1)) != 0;
  };
  if (m <= 0 || cin <= 0 || cout <= 0 || cout % 8 || ld < cin || ld % 8 ||
      (cin + 63) / 64 > 65535 || misaligned(x, 16) || misaligned(dx, 16) ||
      misaligned(w, 16) || misaligned(z, 16) || misaligned(dz, 16) || misaligned(dst, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = cin <= 64 ? 64 : cin <= 128 ? 128 : 256;
  CUtensorMap mdz, mz, mw, mx, mdx;
  int rc = hopper::encode_rows(&mdz, dz, cout, m, cout, PW_BM);
  if (rc == 0) rc = hopper::encode_rows(&mz, z, cout, m, cout, PW_BM);
  if (rc == 0) rc = hopper::encode_rows(&mw, w, cout, cin, cout, n);
  if (rc == 0) rc = hopper::encode_rows(&mx, x, cin, m, ld, PW_BM);
  if (rc == 0) rc = hopper::encode_rows(&mdx, dx, cin, m, ld, PW_BM);
  if (rc != 0) return rc;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto run = n == 64 ? launch_pw_dx_sm90<64>
                   : n == 128 ? launch_pw_dx_sm90<128> : launch_pw_dx_sm90<256>;
  return run(mdz, mz, mw, mx, mdx, scale, shift, dst, partial, gst, m, cin, cout, relu_in, s);
}

// NHWC x (n, h, wd, cin) bf16 with row stride ldx, scale/shift (cin,) f32,
// HWIO w (3, 3, cin, cout) and z/dz (n, h, wd, cout) bf16 with row stride
// ldy, dst (2, ldy) f32 (0 past cout) -> dx (n, h, wd, cin) bf16 with row
// stride ldx, gst (2, cin) f32 = [dscale; dshift]; partial is (ceil(m/128),
// 2, cin) f32. tile_n: the column tile (64 or 128). What TMA reads and
// writes: ldx and ldy multiples of 8, x, dx, w, z, dz and dst 16-byte
// aligned. Returns cudaGetLastError(), or 1000 + the CUresult of a failed
// tensor-map encoding.
int dl4j_conv3x3_bwd_dx(const void* x, const void* scale, const void* shift, const void* w,
                        const void* z, const void* dz, const void* dst, void* dx, void* partial,
                        void* gst, int n, int h, int wd, int cin, int cout, int ldx, int ldy,
                        int relu_in, int tile_n, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const long long m = static_cast<long long>(n) * h * wd;
  // the furthest row a block reads: m0 + 127 + (wd + 1) < m + wd + 128
  if (n <= 0 || h <= 0 || wd <= 0 || m + wd + PW_BM > 0x7fffffffLL || cin <= 0 || cout <= 0 ||
      ldx < cin || ldx % 8 || ldy < cout || ldy % 8 || (tile_n != 64 && tile_n != 128) ||
      misaligned(x) || misaligned(dx) || misaligned(w) || misaligned(z) || misaligned(dz) ||
      misaligned(dst)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = static_cast<int>(m);
  CUtensorMap mdz, mz, mw, mx, mdx;
  int rc = hopper::encode_rows(&mdz, dz, cout, rows, ldy, PW_BM);
  if (rc == 0) rc = hopper::encode_rows(&mz, z, cout, rows, ldy, PW_BM);
  if (rc == 0) rc = hopper::encode_stack(&mw, w, cout, cin, 9, ldy, tile_n);
  if (rc == 0) rc = hopper::encode_rows(&mx, x, cin, rows, ldx, PW_BM);
  if (rc == 0) rc = hopper::encode_rows(&mdx, dx, cin, rows, ldx, PW_BM);
  if (rc != 0) return rc;
  const C3DxArgs a{static_cast<const float*>(scale), static_cast<const float*>(shift),
                   static_cast<const float*>(dst), static_cast<float*>(partial), rows, h, wd,
                   cin, cout, ldy, relu_in, 0};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto run = tile_n == 64 ? launch_c3_dx_sm90<64> : launch_c3_dx_sm90<128>;
  return run(mdz, mz, mw, mx, mdx, a, gst, s);
}

// x (m, cin) bf16 with row stride ldx, scale/shift (cin,) f32, z/dz (m, cout)
// bf16 with row stride ldy, dst (2, cout) f32 -> dw (cin, cout) bf16;
// partial is (ceil(m/chunk), cin, cout) f32. tile_n: the column tile (64,
// 128 or 256); chunk: the pixels of a split, a multiple of the 32-pixel
// stage. What TMA reads: ldx and ldy multiples of 8, x, z and dz 16-byte
// aligned. Returns cudaGetLastError(), or 1000 + the CUresult of a failed
// tensor-map encoding.
int dl4j_pw_conv_bwd_dw(const void* x, const void* scale, const void* shift, const void* z,
                        const void* dz, const void* dst, void* partial, void* dw, int m,
                        int cin, int cout, int ldx, int ldy, int relu_in, int tile_n, int chunk,
                        void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (m <= 0 || cin <= 0 || cout <= 0 || ldx < cin || ldx % 8 || ldy < cout || ldy % 8 ||
      (tile_n != 64 && tile_n != 128 && tile_n != 256) || chunk <= 0 || chunk % DW_BK ||
      static_cast<long long>(m) + chunk > 0x7fffffffLL || misaligned(x) || misaligned(z) ||
      misaligned(dz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mx, mdz, mz;
  int rc = hopper::encode_rows(&mx, x, cin, m, ldx, DW_BK);
  if (rc == 0) rc = hopper::encode_rows(&mdz, dz, cout, m, ldy, DW_BK);
  if (rc == 0) rc = hopper::encode_rows(&mz, z, cout, m, ldy, DW_BK);
  if (rc != 0) return rc;
  const DwArgs a{static_cast<const float*>(scale), static_cast<const float*>(shift),
                 static_cast<const float*>(dst), static_cast<float*>(partial), m, cin, cout,
                 relu_in, chunk, 0, 0};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto run = tile_n == 64 ? launch_pw_dw_sm90<64>
                   : tile_n == 128 ? launch_pw_dw_sm90<128> : launch_pw_dw_sm90<256>;
  return run(mx, mdz, mz, a, (m + chunk - 1) / chunk, dw, s);
}

// NHWC x (n, h, wd, cin) bf16 with row stride ldx, scale/shift (cin,) f32,
// z/dz (n, h, wd, cout) bf16 with row stride ldy, dst (2, cout) f32 -> dw
// (3, 3, cin, cout) bf16. tile_n: the column tile (64, 128 or 256); chunk:
// the pixels of a split, a multiple of the 32-pixel stage; with more than
// one split, partial is (splits, 9, cin, cout) f32 (else unused). What TMA
// reads: ldx and ldy multiples of 8, x, z and dz 16-byte aligned; dw 16-byte
// aligned. Returns cudaGetLastError(), or 1000 + the CUresult of a failed
// tensor-map encoding.
int dl4j_conv3x3_bwd_dw(const void* x, const void* scale, const void* shift, const void* z,
                        const void* dz, const void* dst, void* partial, void* dw, int n, int h,
                        int wd, int cin, int cout, int ldx, int ldy, int relu_in, int tile_n,
                        int chunk, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  const long long m = static_cast<long long>(n) * h * wd;
  if (n <= 0 || h <= 0 || wd <= 0 || m + chunk > 0x7fffffffLL || cin <= 0 || cout <= 0 ||
      ldx < cin || ldx % 8 || ldy < cout || ldy % 8 ||
      (tile_n != 64 && tile_n != 128 && tile_n != 256) || chunk <= 0 || chunk % DW_BK ||
      misaligned(x) || misaligned(z) || misaligned(dz) || misaligned(dw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = static_cast<int>((m + chunk - 1) / chunk);
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mdz, mz;
  int rc = hopper::encode_rows(&mx, x, cin, static_cast<int>(m), ldx, DW_BK);
  if (rc == 0) rc = hopper::encode_rows(&mdz, dz, cout, static_cast<int>(m), ldy, DW_BK);
  if (rc == 0) rc = hopper::encode_rows(&mz, z, cout, static_cast<int>(m), ldy, DW_BK);
  if (rc != 0) return rc;
  const C3DwArgs a{static_cast<const float*>(scale), static_cast<const float*>(shift),
                   static_cast<const float*>(dst), static_cast<float*>(partial),
                   static_cast<__nv_bfloat16*>(dw), static_cast<int>(m), h, wd, cin, cout,
                   relu_in, chunk, splits, 0, 0};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto run = tile_n == 64 ? launch_c3_dw_sm90<64>
                   : tile_n == 128 ? launch_c3_dw_sm90<128> : launch_c3_dw_sm90<256>;
  return run(mx, mdz, mz, a, s);
}

}  // extern "C"
