// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../build.py and ../flash_attention.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   deeplearning4j_tpu/nn/ops/flash_attention.py _fwd_kernel (pallas_call in _fwd_impl)
//
// For one (batch, head) and a block of query rows, with the keys and values
// of the head:
//   s   = (q . k^T) * scale                              f32
//   s   = -1e30 where (causal and key > query) or seg[query] != seg[key]
//   online over key tiles: m' = max(m, rowmax(s)), p = exp(s - m'),
//   alpha = exp(m - m'), l = l*alpha + rowsum(p), o = o*alpha + p~ . v
//   o   = o / max(l, 1e-30) rounded once to the operand type;
//   lse = m + log(max(l, 1e-30))                         f32, (b*h, T)
// where p~ is p rounded to the operand type (the reference's
// p.astype(v.dtype) before the p.v product). The running max starts at
// -1e30, as in the reference, so a tile masked whole for a row contributes
// p = 1 until a live key rescales it to 0 (alpha = exp(-1e30 - m) = 0).
// The softmax state and every elementwise step are f32 (bf16: exp as the
// hardware's exp2 of x log2(e), denormals flushed; f32: expf; logf).
//
// Bound on an H100: at the serving and train shapes (12 heads of 64, T 128
// to 2048, causal, bf16) the work is 2*T^2*hd*b*h FLOPs (causal) against
// 8*T*hd*b*h bytes; the bytes bound it below T ~ 600, the tensor-core FLOPs
// above (PERF.md). At b 1 a launch is latency- and occupancy-bound.
//
// bf16: a warp-specialized kernel (FlashAttention-3's shape). A block of
// 288 threads owns 128 query rows of one (b, h): a producer warp and two
// consumer warpgroups of 64 rows each.
// - The producer issues TMA loads (one thread; tensor maps built on the
//   host per call, 128-byte swizzled tiles): Q once, then the K and V tiles
//   (and the key tile's segment ids, a bulk copy) into a ring of 3 stages,
//   each completing on a `full` mbarrier; it refills a stage when both
//   consumer warpgroups have arrived on its `empty` mbarrier.
// - Each consumer warpgroup computes S = Q K^T for its 64 rows with wgmma
//   (both from shared memory, K-major), keeps S in registers, masks only
//   the tiles that cross its diagonal (and every tile under segment ids),
//   takes row max and sum by shuffles among the 4 lanes that hold a row,
//   rescales its output accumulator in registers, rounds p to bf16 pairs in
//   place as the register A operand of O += P~ V (wgmma, V from shared
//   memory as the MN-major B), whose completion it waits for only under the
//   next tile's S (then it releases the tile's stage). The epilogue divides
//   once, writes lse and stores o through the output strides.
// - Key tiles are 128 wide at hd <= 64 and 64 at hd <= 128 (registers):
//   independent of T and b, and every row visits them in the same order, so
//   a row's bits do not depend on T (a prefill at a bucket equals the
//   forward at the full length), on the batch, the other heads or the run.
// - Head dims up to 64 are read as one 64-column panel, up to 128 as two;
//   TMA fills the columns past hd with zeros. An operand TMA cannot take
//   (a ragged hd, a misaligned view) is copied by the wrapper into a padded
//   buffer first: a layout copy, the same kernel.
// - Blocks run longest causal rows first: causal, wave y of the grid takes
//   the row block n_blocks - 1 - y (the last rows visit the most key tiles).
// Needs T % 128 == 0 (the reference's own rule).
//
// f32: f32 FMAs on the CUDA cores (no TF32, no tensor cores: fp32 means fp32
// in this port), one block of 4 warps per 64 query rows, K and V tiles
// staged in shared memory, the score tile and the output accumulator in
// shared memory; not on the main path.
//
// q, k, v may be strided views (the model's head split is a transpose): the
// kernels take each tensor's batch, head and time strides; the head
// dimension must be unit-stride. o is written through strides as well, so
// the wrapper can hand back a (b, h, T, hd) view of a (b, T, h, hd) buffer.
//
// Determinism. Every output row is computed by one block, its sums in a
// fixed order, with no atomics: a row's bits do not depend on the batch,
// on the other heads or on the run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int MAX_HD = 128;
constexpr float NEG_INF = -1e30f;

// ---- bf16: TMA, wgmma, warp specialization -------------------------------------------
constexpr int BM = 128;                 // query rows per block (2 consumer warpgroups)
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;  // + the producer warp
constexpr int STAGES = 3;

template <int HD>
struct Fwd {
  static constexpr int BN = HD == 64 ? 128 : 64;   // keys per tile
  static constexpr int PANELS = HD / 64;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  // shared memory, every tile 1024-byte aligned
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                 // stage s at K + s * KV_BYTES
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int SEG = V + STAGES * KV_BYTES;     // BN ints per stage
  static constexpr int BAR = SEG + STAGES * BN * 4;     // q, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + the alignment slack
};

struct HArgs {
  const int* seg;               // (b, T) int32 or null
  void* o;
  float* lse;                   // (b*h, T)
  int h, T, hd;
  int os[3];                    // o's element strides of batch, head, time
  float scale;
  int causal;
  MapPos qp, kp, vp;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel_sm90(__grid_constant__ const CUtensorMap mq,
                          __grid_constant__ const CUtensorMap mk,
                          __grid_constant__ const CUtensorMap mv, const HArgs a) {
  using L = Fwd<HD>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::V);
  int* segk = reinterpret_cast<int*>(smem + L::SEG);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + STAGES;

  const int T = a.T;
  const int bh = blockIdx.x;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  // the longest causal rows first
  const int qb = a.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int n_kv = a.causal ? (qb + 1) * BM / BN : T / BN;
  const bool has_seg = a.seg != nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_rows(sq + p * BM * 64, &mq, bar_q, p * 64, qb * BM, hi, bi, a.qp);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::KV_BYTES + (has_seg ? BN * 4 : 0));
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_rows(sk + s * BN * HD + p * BN * 64, &mk, &full[s], p * 64, j * BN, hi, bi,
                        a.kp);
          tma_load_rows(sv + s * BN * HD + p * BN * 64, &mv, &full[s], p * 64, j * BN, hi, bi,
                        a.vp);
        }
        if (has_seg) bulk_load(segk + s * BN, a.seg + bi * T + j * BN, BN * 4, &full[s]);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows [wg*64, wg*64 + 64) of the block;
  // this thread holds rows r0 (slot 0) and r0 + 8 (slot 1)
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const int first_row = qb * BM + wg * 64;
  const int r0 = first_row + (warp % 4) * 16 + g;
  int sq0 = 0, sq1 = 0;
  if (has_seg) {
    sq0 = a.seg[bi * T + r0];
    sq1 = a.seg[bi * T + r0 + 8];
  }
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[HD / 2];
  float sacc[BN / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
  const bf16* qw = sq + wg * 64 * 64;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const bf16* kt = sk + s * BN * HD;
    const bf16* vt = sv + s * BN * HD;

    // S = Q K^T (64 x BN), f32 in registers
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<0>(sacc, desc_kmajor(qw + (kk / 4) * BM * 64 + (kk % 4) * 16),
                  desc_kmajor(kt + (kk / 4) * BN * 64 + (kk % 4) * 16), kk > 0);
    }
    wgmma_commit();
    if (j > 0) {  // the previous tile's P~ V is done: its stage goes back to the producer
      wgmma_wait<1>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(sacc);

    // scale, mask (only the tiles that cross this warpgroup's diagonal, and
    // every tile under segment ids: selects, no branches), row max over the
    // 4 lanes of a row
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (has_seg || (a.causal && j * BN + BN - 1 > first_row)) {
      const int* sg = segk + s * BN;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * c + e;
          const int key = j * BN + col;
          const int sk_ = has_seg ? sg[col] : 0;
          const bool dead0 = (a.causal & (key > r0)) | (sq0 != sk_);
          const bool dead1 = (a.causal & (key > r0 + 8)) | (sq1 != sk_);
          const float v0 = dead0 ? NEG_INF : sacc[4 * i + e] * a.scale;
          const float v1 = dead1 ? NEG_INF : sacc[4 * i + 2 + e] * a.scale;
          sacc[4 * i + e] = v0;
          sacc[4 * i + 2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * i + e] *= a.scale;
          sacc[4 * i + 2 + e] *= a.scale;
          mx0 = fmaxf(mx0, sacc[4 * i + e]);
          mx1 = fmaxf(mx1, sacc[4 * i + 2 + e]);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp_ftz(m0 - mn0), al1 = exp_ftz(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp_ftz(sacc[4 * i + e] - mn0);
        const float p1 = exp_ftz(sacc[4 * i + 2 + e] - mn1);
        sacc[4 * i + e] = p0;
        sacc[4 * i + 2 + e] = p1;
        sum0 += p0;
        sum1 += p1;
      }
    }
    // per-lane partial sums; the 4 lanes of a row add theirs in the epilogue
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= al0;
      o[4 * i + 1] *= al0;
      o[4 * i + 2] *= al1;
      o[4 * i + 3] *= al1;
    }

    // O += P~ V: p rounded to bf16 pairs, the register A operand
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_rs<1>(o, pa[kk], desc_mnmajor(vt + kk * 16 * 64, BN * 128), 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);

  // epilogue: the row sums, one division, one rounding
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
  if (c == 0) {
    a.lse[static_cast<long long>(bh) * T + r0] = m0 + logf(ls0);
    a.lse[static_cast<long long>(bh) * T + r0 + 8] = m1 + logf(ls1);
  }
  bf16* og = static_cast<bf16*>(a.o) + static_cast<long long>(bi) * a.os[0] +
             static_cast<long long>(hi) * a.os[1];
  bf16* o0 = og + static_cast<long long>(r0) * a.os[2];
  bf16* o1 = og + static_cast<long long>(r0 + 8) * a.os[2];
  const bool pairs = ((a.hd | a.os[0] | a.os[1] | a.os[2]) & 1) == 0;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (col >= a.hd) continue;
    const float x00 = o[4 * i] / ls0, x01 = o[4 * i + 1] / ls0;
    const float x10 = o[4 * i + 2] / ls1, x11 = o[4 * i + 3] / ls1;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(x00, x01);
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(x10, x11);
    } else {
      o0[col] = __float2bfloat16_rn(x00);
      o1[col] = __float2bfloat16_rn(x10);
      if (col + 1 < a.hd) {
        o0[col + 1] = __float2bfloat16_rn(x01);
        o1[col + 1] = __float2bfloat16_rn(x11);
      }
    }
  }
}

template <int HD>
int launch_sm90(const HArgs& a, const HeadMap& q, const HeadMap& k, const HeadMap& v, int bh,
                int n_blocks, cudaStream_t stream) {
  const int bytes = Fwd<HD>::BYTES;
  static bool done[64] = {};  // per HD: each instantiation opts in for itself
  const int err = opt_in_smem(flash_fwd_kernel_sm90<HD>, bytes, done);
  if (err != 0) return err;
  flash_fwd_kernel_sm90<HD><<<dim3(bh, n_blocks), THREADS, bytes, stream>>>(q.map, k.map,
                                                                              v.map, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: CUDA cores ----------------------------------------------------------------------
constexpr int F_BM = 64;        // query rows per block
constexpr int F_BN = 64;        // keys per tile
constexpr int F_THREADS = 128;  // 4 warps, each owns 16 query rows

struct FArgs {
  const float* q;
  const float* k;
  const float* v;
  const int* seg;               // (b, T) int32 or null
  float* o;
  float* lse;                   // (b*h, T)
  int h, T, hd, hdp;            // hdp: hd rounded up to a multiple of 16
  int qs[3], ks[3], vs[3], os[3];  // element strides of batch, head, time
  float scale;
  int causal;
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout: every region starts 128-byte aligned; odd leading
// dimensions break bank conflicts.
struct FLayout {
  int ldq, lds, ldo;
  size_t q, k, v, s, o, segq, segk, rowl, rowa, total;
};

__host__ __device__ FLayout f_layout(int hdp) {
  FLayout m{};
  m.ldq = hdp + 1;
  m.lds = F_BN + 1;
  m.ldo = hdp + 1;
  size_t off = 0;
  m.q = off; off = align128(off + sizeof(float) * F_BM * m.ldq);
  m.k = off; off = align128(off + sizeof(float) * F_BN * m.ldq);
  m.v = off; off = align128(off + sizeof(float) * F_BN * m.ldq);
  m.s = off; off = align128(off + sizeof(float) * F_BM * m.lds);
  m.o = off; off = align128(off + sizeof(float) * F_BM * m.ldo);
  m.segq = off; off = align128(off + sizeof(int) * F_BM);
  m.segk = off; off = align128(off + sizeof(int) * F_BN);
  m.rowl = off; off = align128(off + sizeof(float) * F_BM);
  m.rowa = off; off = align128(off + sizeof(float) * F_BM);
  m.total = off;
  return m;
}

// rows [r0, r0 + 64) of one head (src: its row 0, st: its time stride) into
// dst (leading dimension ld); columns hd .. hdp - 1 are zero-filled
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int st, int r0, int hd, int hdp) {
  for (int i = threadIdx.x; i < F_BM * hdp; i += F_THREADS) {
    const int r = i / hdp;
    const int c = i - r * hdp;
    dst[r * ld + c] = c < hd ? src[static_cast<long long>(r0 + r) * st + c] : 0.f;
  }
}

// S[warp rows][c] for c = lane, lane + 32: f32 FMAs over d in order
__device__ __forceinline__ void scores_f32(const float* qs, const float* ks, float* s,
                                           const FLayout& L, int hdp, int warp, int lane) {
  float a0[16], a1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) a0[r] = a1[r] = 0.f;
  const float* k0 = ks + lane * L.ldq;
  const float* k1 = ks + (lane + 32) * L.ldq;
  const float* q0 = qs + warp * 16 * L.ldq;
  for (int d = 0; d < hdp; ++d) {
    const float kv0 = k0[d], kv1 = k1[d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = q0[r * L.ldq + d];
      a0[r] = fmaf(qv, kv0, a0[r]);
      a1[r] = fmaf(qv, kv1, a1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    s[(warp * 16 + r) * L.lds + lane] = a0[r];
    s[(warp * 16 + r) * L.lds + lane + 32] = a1[r];
  }
}

// O[r][d] = O[r][d] * alpha_r + sum_c P[r][c] V[c][d] for the warp's rows,
// d = lane + 32 j: the reference's o*alpha + pv, pv summed over c in order
__device__ __forceinline__ void pv_f32(const float* p, const float* vs, float* o,
                                       const float* rowa, const FLayout& L, int hdp,
                                       int warp, int lane) {
  for (int d = lane; d < hdp; d += 32) {
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    for (int c = 0; c < F_BN; ++c) {
      const float vv = vs[c * L.ldq + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = fmaf(p[(warp * 16 + r) * L.lds + c], vv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      o[row * L.ldo + d] = o[row * L.ldo + d] * rowa[row] + acc[r];
    }
  }
}

__global__ void __launch_bounds__(F_THREADS) flash_fwd_kernel_f32(const FArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FLayout L = f_layout(a.hdp);
  float* qsm = reinterpret_cast<float*>(smem + L.q);
  float* ksm = reinterpret_cast<float*>(smem + L.k);
  float* vsm = reinterpret_cast<float*>(smem + L.v);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* o = reinterpret_cast<float*>(smem + L.o);
  int* segq = reinterpret_cast<int*>(smem + L.segq);
  int* segk = reinterpret_cast<int*>(smem + L.segk);
  float* rowl = reinterpret_cast<float*>(smem + L.rowl);
  float* rowa = reinterpret_cast<float*>(smem + L.rowa);

  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int qb = T / F_BM - 1 - static_cast<int>(blockIdx.x);  // the longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_seg = a.seg != nullptr;

  const long long bl = bi, hl = hi;
  const float* qg = a.q + bl * a.qs[0] + hl * a.qs[1];
  const float* kg = a.k + bl * a.ks[0] + hl * a.ks[1];
  const float* vg = a.v + bl * a.vs[0] + hl * a.vs[1];
  float* og = a.o + bl * a.os[0] + hl * a.os[1];

  load_tile(qsm, L.ldq, qg, a.qs[2], qb * F_BM, hd, hdp);
  for (int i = threadIdx.x; i < F_BM * L.ldo; i += F_THREADS) o[i] = 0.f;
  if (has_seg) {
    for (int i = threadIdx.x; i < F_BM; i += F_THREADS) segq[i] = a.seg[bi * T + qb * F_BM + i];
  }
  __syncthreads();

  // the softmax state of one row, kept alike by the row's two lanes
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int grow = qb * F_BM + row;
  float m = NEG_INF, l = 0.f;
  float* srow = s + row * L.lds;
  const int n_kv = a.causal ? qb + 1 : T / F_BN;

  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ksm, L.ldq, kg, a.ks[2], j * F_BN, hd, hdp);
    load_tile(vsm, L.ldq, vg, a.vs[2], j * F_BN, hd, hdp);
    if (has_seg) {
      for (int i = threadIdx.x; i < F_BN; i += F_THREADS) segk[i] = a.seg[bi * T + j * F_BN + i];
    }
    __syncthreads();

    scores_f32(qsm, ksm, s, L, hdp, warp, lane);
    __syncwarp();

    // online-softmax update: lane (row, half) takes columns [32 half, 32 half + 32)
    const int c0 = half * (F_BN / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + F_BN / 2; ++c) {
      float sc = srow[c] * a.scale;
      if (a.causal && j * F_BN + c > grow) sc = NEG_INF;
      if (has_seg && segq[row] != segk[c]) sc = NEG_INF;
      srow[c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + F_BN / 2; ++c) {
      const float pc = expf(srow[c] - m_new);
      sum += pc;
      srow[c] = pc;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    if (half == 0) rowa[row] = alpha;
    __syncwarp();

    pv_f32(s, vsm, o, rowa, L, hdp, warp, lane);
    __syncwarp();
  }

  // epilogue: one division; the warp stores its 16 rows
  const float l_safe = fmaxf(l, 1e-30f);
  if (half == 0) {
    rowl[row] = l_safe;
    a.lse[static_cast<long long>(bh) * T + grow] = m + logf(l_safe);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r;
    float* dst = og + static_cast<long long>(qb * F_BM + lr) * a.os[2];
    const float lr_safe = rowl[lr];
    for (int d = lane; d < hd; d += 32) dst[d] = o[lr * L.ldo + d] / lr_safe;
  }
}

int launch_f32(const FArgs& a, int bh, cudaStream_t stream) {
  const size_t bytes = f_layout(a.hdp).total;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel_f32<<<dim3(a.T / F_BM, bh), F_THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

void set3(int (&dst)[3], int s0, int s1, int s2) {
  dst[0] = s0;
  dst[1] = s1;
  dst[2] = s2;
}

}  // namespace

extern "C" {

// which: 0 -> query rows per block, 1 -> keys per tile at hd <= 64,
// 2 -> largest head dim (the bf16 kernel; the f32 kernel takes 64 x 64)
int dl4j_flash_tile(int which) {
  return which == 0 ? BM : which == 1 ? Fwd<64>::BN : MAX_HD;
}

// q, k, v: (b, h, T, hd) through strides (batch, head, time; the head dim
// unit-stride), all bf16 or all f32; seg: (b, T) int32 contiguous or null;
// o: (b, h, T, hd) of the operand type through its strides; lse: (b*h, T)
// f32 contiguous. bf16: qd, kd, vd are the operands' own last dims (>= hd;
// zero past hd), each operand TMA-readable (16-byte aligned base, strides
// multiples of 8 elements). Needs T % 128 == 0, 1 <= hd <= 128. Returns cudaGetLastError(), or 1000 + a
// driver error of the tensor-map encoding.
int dl4j_flash_fwd(const void* q, const void* k, const void* v, const void* seg, void* o,
                   void* lse, int b, int h, int T, int hd, int causal, int is_bf16,
                   int qsb, int qsh, int qst, int ksb, int ksh, int kst, int vsb, int vsh,
                   int vst, int osb, int osh, int ost, int qd, int kd, int vd, float scale,
                   void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || T % BM || hd < 1 || hd > MAX_HD || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    FArgs a{};
    a.q = static_cast<const float*>(q);
    a.k = static_cast<const float*>(k);
    a.v = static_cast<const float*>(v);
    a.seg = static_cast<const int*>(seg);
    a.o = static_cast<float*>(o);
    a.lse = static_cast<float*>(lse);
    a.h = h;
    a.T = T;
    a.hd = hd;
    a.hdp = (hd + 15) / 16 * 16;
    set3(a.qs, qsb, qsh, qst);
    set3(a.ks, ksb, ksh, kst);
    set3(a.vs, vsb, vsh, vst);
    set3(a.os, osb, osh, ost);
    a.scale = scale;
    a.causal = causal;
    return launch_f32(a, b * h, st);
  }
  const int n_blocks = T / BM;
  if (qd < hd || kd < hd || vd < hd || qd > MAX_HD || kd > MAX_HD || vd > MAX_HD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bn = hd <= 64 ? Fwd<64>::BN : Fwd<128>::BN;
  HeadMap mq, mk, mv;
  int rc = encode_heads(&mq, q, qd, T, h, b, qsb, qsh, qst, BM);
  if (rc == 0) rc = encode_heads(&mk, k, kd, T, h, b, ksb, ksh, kst, bn);
  if (rc == 0) rc = encode_heads(&mv, v, vd, T, h, b, vsb, vsh, vst, bn);
  if (rc != 0) return rc;
  HArgs a{};
  a.seg = static_cast<const int*>(seg);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.h = h;
  a.T = T;
  a.hd = hd;
  set3(a.os, osb, osh, ost);
  a.scale = scale;
  a.causal = causal;
  a.qp = mq.pos;
  a.kp = mk.pos;
  a.vp = mv.pos;
  return hd <= 64 ? launch_sm90<64>(a, mq, mk, mv, b * h, n_blocks, st)
                  : launch_sm90<128>(a, mq, mk, mv, b * h, n_blocks, st);
}

}  // extern "C"
