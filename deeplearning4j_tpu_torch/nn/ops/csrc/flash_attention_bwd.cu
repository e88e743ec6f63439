// Flash-attention backward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../build.py and ../flash_attention.py).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   deeplearning4j_tpu/nn/ops/flash_attention.py _dq_kernel  (pallas_call in _bwd_impl)
//   deeplearning4j_tpu/nn/ops/flash_attention.py _dkv_kernel (pallas_call in _bwd_impl)
//
// For one (batch, head), with the forward's lse (f32, (b*h, T)) and
// D = rowsum(dO * O) (f32, (b*h, T), computed outside as the reference's
// XLA reduction):
//   s  = (q . k^T) * scale                                f32
//   s  = -1e30 where (causal and key > query) or seg[query] != seg[key]
//   p  = exp(s - lse)                                     f32
//   dp = dO . v^T                                         f32
//   ds = p * (dp - D) * scale                             f32
//   dq = ds~ . k        dv = p~^T . dO        dk = ds~^T . q
// where ~ is a rounding to the operand type (the reference's astype before
// each product), every product summed in f32, and each output rounded once.
// Masked entries give p = exp(-1e30 - lse) = 0 exactly, so the forward's
// lse (which a fully masked tile did not disturb) is all the backward needs.
//
// bf16: two warp-specialized Hopper kernels (TMA tile loads on mbarriers,
// wgmma, every score, probability and accumulator in registers):
// - dq (flash_bwd_dq_kernel_sm90): one block per (b*h, 128 query rows); Q
//   and dO arrive once, the key tiles of K and V stream through a ring; dS~
//   is the register A operand of dQ += dS~ K, and dQ stays in registers
//   until it is rounded once at the end.
// - dkv (flash_bwd_dkv_kernel_sm90): one block per (b*h, 128 keys); K and V
//   arrive once, the query tiles stream; dK and dV stay in registers.
// Each output tile is owned by one block and summed in a fixed order, with
// no atomics, so two runs give the same bits. Tensor maps are built on the
// host per call (hopper.cuh); an operand TMA cannot take is copied by the
// wrapper into a padded buffer first.
//
// f32 (q, k, v, dO and the outputs all f32): f32 FMAs on the CUDA cores (no
// TF32: fp32 means fp32 in this port), one block per (b*h, 64-row block),
// 4 warps; not on the main path. Each warp owns 16 rows of the block's own
// tile and computes their 16 x 64 score and dp tiles against the streamed
// tile in shared memory; two lanes per row form p and ds on them.
//
// Bound on an H100: per (b, h) the dq kernel does 6*T^2*hd FLOPs and the dkv
// kernel 8*T^2*hd (half of each when causal) on ~5*T*hd operand elements, so
// at the train shapes (T 512 and 2048, hd 64) the tensor-core FLOPs bound
// both (PERF.md).
//
// q, k, v and dO are read, and dq, dk, dv written, through their batch,
// head and time strides (the head dimension unit-stride), so the wrapper can
// hand in the model's head-split views and hand back (b, h, T, hd) views of
// (b, T, h, hd) buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;          // rows of the block's own tile (f32); the T rule's unit
constexpr int BN = 64;          // rows of each streamed tile (f32)
constexpr int WARPS = 4;        // each warp owns 16 rows of the own tile
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HD = 128;
constexpr int NJ = MAX_HD / 32; // head-dim columns per lane at most
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;             // (b*h, T)
  const float* dcap;            // (b*h, T)
  const int* seg;               // (b, T) int32 or null
  void* dq;
  void* dk;
  void* dv;
  int b, h, T, hd, hdp;         // hdp: hd rounded up to a multiple of 16
  int qs[3], ks[3], vs[3], ds[3], dqs[3], dks[3], dvs[3];  // batch, head, time strides
  float scale;
  int causal;
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared memory (f32): the block's two own tiles and the two streamed tiles
// (BM = BN rows), the score and dp tiles, the streamed rows' lse and D
// (dkv) or the own rows' (dq), and the segment ids of both.
struct Layout {
  int ld, lds;
  size_t own0, own1, str0, str1, s, dp, lse, dcap, segown, segstr, total;
};

__host__ __device__ Layout layout(int hdp) {
  Layout m{};
  m.ld = hdp + 1;
  m.lds = BN + 1;
  size_t off = 0;
  m.own0 = off; off = align128(off + sizeof(float) * BM * m.ld);
  m.own1 = off; off = align128(off + sizeof(float) * BM * m.ld);
  m.str0 = off; off = align128(off + sizeof(float) * BN * m.ld);
  m.str1 = off; off = align128(off + sizeof(float) * BN * m.ld);
  m.s = off; off = align128(off + sizeof(float) * BM * m.lds);
  m.dp = off; off = align128(off + sizeof(float) * BM * m.lds);
  m.lse = off; off = align128(off + sizeof(float) * BN);
  m.dcap = off; off = align128(off + sizeof(float) * BN);
  m.segown = off; off = align128(off + sizeof(int) * BM);
  m.segstr = off; off = align128(off + sizeof(int) * BN);
  m.total = off;
  return m;
}

// rows [r0, r0 + 64) of one head (src: its row 0, st: its time stride) into
// dst (leading dimension ld); columns hd .. hdp - 1 are zero-filled
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int st, int r0, int hd, int hdp) {
  for (int i = threadIdx.x; i < BM * hdp; i += THREADS) {
    const int r = i / hdp;
    const int c = i - r * hdp;
    dst[r * ld + c] = c < hd ? src[static_cast<long long>(r0 + r) * st + c] : 0.f;
  }
}

// C[warp rows][c] for c = lane, lane + 32: A[row] . B[c], f32 FMAs over d in order
__device__ __forceinline__ void abt_f32(const float* a, const float* bm, float* c, int ld,
                                        int ldc, int hdp, int warp, int lane) {
  float a0[16], a1[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) a0[r] = a1[r] = 0.f;
  const float* b0 = bm + lane * ld;
  const float* b1 = bm + (lane + 32) * ld;
  const float* ar = a + warp * 16 * ld;
  for (int d = 0; d < hdp; ++d) {
    const float bv0 = b0[d], bv1 = b1[d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float av = ar[r * ld + d];
      a0[r] = fmaf(av, bv0, a0[r]);
      a1[r] = fmaf(av, bv1, a1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    c[(warp * 16 + r) * ldc + lane] = a0[r];
    c[(warp * 16 + r) * ldc + lane + 32] = a1[r];
  }
}

// acc[j][r] += sum_c P[warp row r][c] B[c][lane + 32 j], over c in order
__device__ __forceinline__ void ab_f32(const float* p, int ldp, const float* bm, int ld,
                                       float (&acc)[NJ][16], int hdp, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    if (d < hdp) {
      for (int c = 0; c < BN; ++c) {
        const float bv = bm[c * ld + d];
#pragma unroll
        for (int r = 0; r < 16; ++r) acc[j][r] = fmaf(p[(warp * 16 + r) * ldp + c], bv, acc[j][r]);
      }
    }
  }
}

__device__ __forceinline__ void write_f32(const float (&acc)[NJ][16], float* dst, int ts, int hd,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    if (d < hd) {
#pragma unroll
      for (int r = 0; r < 16; ++r) dst[static_cast<long long>(r) * ts + d] = acc[j][r];
    }
  }
}

__device__ __forceinline__ const float* head_ptr(const void* base, const int (&st)[3], int bi,
                                                 int hi) {
  return static_cast<const float*>(base) + static_cast<long long>(bi) * st[0] +
         static_cast<long long>(hi) * st[1];
}

__device__ __forceinline__ float* head_ptr_out(void* base, const int (&st)[3], int bi, int hi) {
  return static_cast<float*>(base) + static_cast<long long>(bi) * st[0] +
         static_cast<long long>(hi) * st[1];
}

// ---- f32 dq: one block per (b*h, 64-row query block) ----------------------------
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(a.hdp);
  float* qsm = reinterpret_cast<float*>(smem + L.own0);
  float* dosm = reinterpret_cast<float*>(smem + L.own1);
  float* ksm = reinterpret_cast<float*>(smem + L.str0);
  float* vsm = reinterpret_cast<float*>(smem + L.str1);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  float* lse = reinterpret_cast<float*>(smem + L.lse);
  float* dcap = reinterpret_cast<float*>(smem + L.dcap);
  int* segq = reinterpret_cast<int*>(smem + L.segown);
  int* segk = reinterpret_cast<int*>(smem + L.segstr);

  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int qb = T / BM - 1 - static_cast<int>(blockIdx.x);  // the longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_seg = a.seg != nullptr;

  const float* qg = head_ptr(a.q, a.qs, bi, hi);
  const float* kg = head_ptr(a.k, a.ks, bi, hi);
  const float* vg = head_ptr(a.v, a.vs, bi, hi);
  const float* dg = head_ptr(a.dout, a.ds, bi, hi);

  load_tile(qsm, L.ld, qg, a.qs[2], qb * BM, hd, hdp);
  load_tile(dosm, L.ld, dg, a.ds[2], qb * BM, hd, hdp);
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    lse[i] = a.lse[static_cast<long long>(bh) * T + qb * BM + i];
    dcap[i] = a.dcap[static_cast<long long>(bh) * T + qb * BM + i];
    if (has_seg) segq[i] = a.seg[bi * T + qb * BM + i];
  }

  float acc[NJ][16];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[j][r] = 0.f;
  }

  // the row a lane helps with, and its half of the 64 columns
  const int row = warp * 16 + lane / 2;
  const int c0 = (lane & 1) * (BN / 2);
  const int grow = qb * BM + row;
  const int n_kv = a.causal ? qb + 1 : T / BN;

  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ksm, L.ld, kg, a.ks[2], j * BN, hd, hdp);
    load_tile(vsm, L.ld, vg, a.vs[2], j * BN, hd, hdp);
    if (has_seg) {
      for (int i = threadIdx.x; i < BN; i += THREADS) segk[i] = a.seg[bi * T + j * BN + i];
    }
    __syncthreads();

    abt_f32(qsm, ksm, s, L.ld, L.lds, hdp, warp, lane);
    abt_f32(dosm, vsm, dp, L.ld, L.lds, hdp, warp, lane);
    __syncwarp();

    const float lr = lse[row], dr = dcap[row];
    for (int c = c0; c < c0 + BN / 2; ++c) {
      float sc = s[row * L.lds + c] * a.scale;
      if (a.causal && j * BN + c > grow) sc = NEG_INF;
      if (has_seg && segq[row] != segk[c]) sc = NEG_INF;
      const float p = expf(sc - lr);
      s[row * L.lds + c] = p * (dp[row * L.lds + c] - dr) * a.scale;
    }
    __syncwarp();

    ab_f32(s, L.lds, ksm, L.ld, acc, hdp, warp, lane);
  }

  float* dst = head_ptr_out(a.dq, a.dqs, bi, hi) +
               static_cast<long long>(qb * BM + warp * 16) * a.dqs[2];
  write_f32(acc, dst, a.dqs[2], hd, lane);
}

// ---- f32 dk, dv: one block per (b*h, key block) ----------------------------------
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel_f32(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(a.hdp);
  float* ksm = reinterpret_cast<float*>(smem + L.own0);
  float* vsm = reinterpret_cast<float*>(smem + L.own1);
  float* qsm = reinterpret_cast<float*>(smem + L.str0);
  float* dosm = reinterpret_cast<float*>(smem + L.str1);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  float* lse = reinterpret_cast<float*>(smem + L.lse);
  float* dcap = reinterpret_cast<float*>(smem + L.dcap);
  int* segk = reinterpret_cast<int*>(smem + L.segown);
  int* segq = reinterpret_cast<int*>(smem + L.segstr);

  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int kb = static_cast<int>(blockIdx.x);  // key block 0 has the most causal work
  const int bh = blockIdx.y;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_seg = a.seg != nullptr;

  const float* qg = head_ptr(a.q, a.qs, bi, hi);
  const float* kg = head_ptr(a.k, a.ks, bi, hi);
  const float* vg = head_ptr(a.v, a.vs, bi, hi);
  const float* dg = head_ptr(a.dout, a.ds, bi, hi);

  load_tile(ksm, L.ld, kg, a.ks[2], kb * BM, hd, hdp);
  load_tile(vsm, L.ld, vg, a.vs[2], kb * BM, hd, hdp);
  if (has_seg) {
    for (int i = threadIdx.x; i < BM; i += THREADS) segk[i] = a.seg[bi * T + kb * BM + i];
  }

  float dk_f[NJ][16], dv_f[NJ][16];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int r = 0; r < 16; ++r) dk_f[j][r] = dv_f[j][r] = 0.f;
  }

  // the key row a lane helps with, and its half of the 64 query columns
  const int row = warp * 16 + lane / 2;
  const int c0 = (lane & 1) * (BN / 2);
  const int gkey = kb * BM + row;
  const int n_q = T / BN;

  for (int i = a.causal ? kb : 0; i < n_q; ++i) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(qsm, L.ld, qg, a.qs[2], i * BN, hd, hdp);
    load_tile(dosm, L.ld, dg, a.ds[2], i * BN, hd, hdp);
    for (int r = threadIdx.x; r < BN; r += THREADS) {
      lse[r] = a.lse[static_cast<long long>(bh) * T + i * BN + r];
      dcap[r] = a.dcap[static_cast<long long>(bh) * T + i * BN + r];
      if (has_seg) segq[r] = a.seg[bi * T + i * BN + r];
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys, columns the queries
    abt_f32(ksm, qsm, s, L.ld, L.lds, hdp, warp, lane);
    abt_f32(vsm, dosm, dp, L.ld, L.lds, hdp, warp, lane);
    __syncwarp();

    for (int c = c0; c < c0 + BN / 2; ++c) {
      float sc = s[row * L.lds + c] * a.scale;
      if (a.causal && gkey > i * BN + c) sc = NEG_INF;
      if (has_seg && segk[row] != segq[c]) sc = NEG_INF;
      const float p = expf(sc - lse[c]);
      s[row * L.lds + c] = p;
      dp[row * L.lds + c] = p * (dp[row * L.lds + c] - dcap[c]) * a.scale;
    }
    __syncwarp();

    ab_f32(s, L.lds, dosm, L.ld, dv_f, hdp, warp, lane);
    ab_f32(dp, L.lds, qsm, L.ld, dk_f, hdp, warp, lane);
  }

  const long long r0 = kb * BM + warp * 16;
  write_f32(dk_f, head_ptr_out(a.dk, a.dks, bi, hi) + r0 * a.dks[2], a.dks[2], hd, lane);
  write_f32(dv_f, head_ptr_out(a.dv, a.dvs, bi, hi) + r0 * a.dvs[2], a.dvs[2], hd, lane);
}

// ---- bf16 dk, dv: TMA, wgmma, warp specialization ----------------------------------
// A block of 288 threads owns 128 keys of one (b, h): a producer warp and
// two consumer warpgroups of 64 keys. K and V arrive once (TMA); the
// producer streams the query tiles of Q, dO, lse, D (and the segment ids)
// through a ring of 2 stages on full/empty mbarriers, from the diagonal
// when causal. Per query tile each consumer warpgroup computes, with dK and
// dV accumulating in registers for the whole loop:
//   S^T  = K Q^T           wgmma, both K-major from shared memory
//   dP^T = V dO^T          wgmma, both K-major
//   P^T  = exp(S^T scale - lse), masked only on the diagonal band (and
//          under segment ids, by selects), in registers (exp as the
//          hardware's exp2, denormals flushed)
//   dV  += P~^T dO         wgmma, P~ the register A operand, dO MN-major
//   dS^T = P^T (dP^T - D) scale, in registers
//   dK  += dS~^T Q         wgmma, dS~ from registers, Q MN-major
// (~: rounded to bf16). No dq here: it would need atomics; the dq kernel
// keeps it. Wave y of the grid takes the key block y: causal, key block 0
// has the longest loop, so the longest loops start first.
constexpr int KB = 128;                 // keys per block
constexpr int H_CONSUMER_WARPS = 8;
constexpr int H_THREADS = (H_CONSUMER_WARPS + 1) * 32;
constexpr int H_STAGES = 2;

template <int HD>
struct Dkv {
  static constexpr int BQ = HD == 64 ? 64 : 32;     // queries per streamed tile (registers)
  static constexpr int PANELS = HD / 64;
  static constexpr int KV_BYTES = KB * HD * 2;
  static constexpr int TILE_BYTES = BQ * HD * 2;
  // shared memory, every tile 1024-byte aligned
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;                    // stage s at Q + s * TILE_BYTES
  static constexpr int DO = Q + H_STAGES * TILE_BYTES;
  static constexpr int VEC = DO + H_STAGES * TILE_BYTES;    // per stage: lse, D, seg (BQ each)
  static constexpr int BAR = VEC + H_STAGES * 3 * BQ * 4;   // kv, full[H_STAGES], empty[H_STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * H_STAGES) * 8 + 1024;  // + the alignment slack
};

struct HArgs {
  const float* lse;             // (b*h, T)
  const float* dcap;            // (b*h, T)
  const int* seg;               // (b, T) int32 or null
  void* dk;
  void* dv;
  int h, T, hd;
  int dks[3], dvs[3];           // batch, head, time strides of dk and dv
  float scale;
  int causal;
  MapPos qp, kp, vp, dp;
};

// rows r (slot 0) and r + 8 (slot 1) of a (64 x HD) accumulator, rounded
// once, to dst through its strides (rows at or past T are not stored)
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], bf16* base,
                                           const int (&st)[3], int r, int T, int hd, int c) {
  const bool pairs = ((hd | st[0] | st[1] | st[2]) & 1) == 0;
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int row = r + 8 * slot;
    if (row >= T) continue;
    bf16* dst = base + static_cast<long long>(row) * st[2];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = 8 * i + 2 * c;
      if (col >= hd) continue;
      const float x0 = acc[4 * i + 2 * slot], x1 = acc[4 * i + 2 * slot + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[col] = __float2bfloat16_rn(x0);
        if (col + 1 < hd) dst[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(H_THREADS, 1)
    flash_bwd_dkv_kernel_sm90(__grid_constant__ const CUtensorMap mq,
                              __grid_constant__ const CUtensorMap mk,
                              __grid_constant__ const CUtensorMap mv,
                              __grid_constant__ const CUtensorMap mdo, const HArgs a) {
  using L = Dkv<HD>;
  constexpr int BQ = L::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::V);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L::DO);
  float* vec = reinterpret_cast<float*>(smem + L::VEC);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + H_STAGES;

  const int T = a.T;
  const int bh = blockIdx.x;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int kb = blockIdx.y;  // key block 0 has the longest causal loop
  const int i0 = a.causal ? kb * KB / BQ : 0;
  const int n_q = T / BQ;
  const bool has_seg = a.seg != nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < H_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], H_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == H_CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::KV_BYTES);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_rows(sk + p * KB * 64, &mk, bar_kv, p * 64, kb * KB, hi, bi, a.kp);
        tma_load_rows(sv + p * KB * 64, &mv, bar_kv, p * 64, kb * KB, hi, bi, a.vp);
      }
      for (int n = 0; i0 + n < n_q; ++n) {
        const int i = i0 + n;
        const int s = n % H_STAGES;
        if (n >= H_STAGES) mbar_wait(&empty[s], (n / H_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::TILE_BYTES + (has_seg ? 3 : 2) * BQ * 4);
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_rows(sq + s * BQ * HD + p * BQ * 64, &mq, &full[s], p * 64, i * BQ, hi, bi,
                        a.qp);
          tma_load_rows(sdo + s * BQ * HD + p * BQ * 64, &mdo, &full[s], p * 64, i * BQ, hi,
                        bi, a.dp);
        }
        float* v = vec + s * 3 * BQ;
        const long long at = static_cast<long long>(bh) * T + i * BQ;
        bulk_load(v, a.lse + at, BQ * 4, &full[s]);
        bulk_load(v + BQ, a.dcap + at, BQ * 4, &full[s]);
        if (has_seg) bulk_load(v + 2 * BQ, a.seg + bi * T + i * BQ, BQ * 4, &full[s]);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns keys [wg*64, wg*64 + 64) of the block;
  // this thread holds keys k0 (slot 0) and k0 + 8 (slot 1)
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const int first_key = kb * KB + wg * 64;
  const int k0 = first_key + (warp % 4) * 16 + g;
  int sk0 = 0, sk1 = 0;
  if (has_seg) {
    sk0 = k0 < T ? a.seg[bi * T + k0] : -1;
    sk1 = k0 + 8 < T ? a.seg[bi * T + k0 + 8] : -1;
  }
  float dk[HD / 2], dv[HD / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
  const bf16* kw = sk + wg * 64 * 64;
  const bf16* vw = sv + wg * 64 * 64;
  mbar_wait(bar_kv, 0);

  for (int n = 0; i0 + n < n_q; ++n) {
    const int i = i0 + n;
    const int s = n % H_STAGES;
    mbar_wait(&full[s], (n / H_STAGES) & 1);
    const bf16* qt = sq + s * BQ * HD;
    const bf16* dt = sdo + s * BQ * HD;
    const float* lse_t = vec + s * 3 * BQ;
    const float* d_t = lse_t + BQ;
    const int* seg_t = reinterpret_cast<const int*>(lse_t + 2 * BQ);

    // S^T = K Q^T and dP^T = V dO^T, two groups in flight
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<0>(st, desc_kmajor(kw + (kk / 4) * KB * 64 + (kk % 4) * 16),
                  desc_kmajor(qt + (kk / 4) * BQ * 64 + (kk % 4) * 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<0>(dpt, desc_kmajor(vw + (kk / 4) * KB * 64 + (kk % 4) * 16),
                  desc_kmajor(dt + (kk / 4) * BQ * 64 + (kk % 4) * 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T = exp(S^T scale - lse), masked on the diagonal band and under
    // segment ids
    if (has_seg || (a.causal && i * BQ < first_key + 63)) {
#pragma unroll
      for (int ii = 0; ii < BQ / 8; ++ii) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * ii + 2 * c + e;
          const int qrow = i * BQ + col;
          const int sq_ = has_seg ? seg_t[col] : 0;
          const bool dead0 = (a.causal & (k0 > qrow)) | (sk0 != sq_);
          const bool dead1 = (a.causal & (k0 + 8 > qrow)) | (sk1 != sq_);
          const float s0 = dead0 ? NEG_INF : st[4 * ii + e] * a.scale;
          const float s1 = dead1 ? NEG_INF : st[4 * ii + 2 + e] * a.scale;
          st[4 * ii + e] = exp_ftz(s0 - lse_t[col]);
          st[4 * ii + 2 + e] = exp_ftz(s1 - lse_t[col]);
        }
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < BQ / 8; ++ii) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * ii + 2 * c + e;
          st[4 * ii + e] = exp_ftz(st[4 * ii + e] * a.scale - lse_t[col]);
          st[4 * ii + 2 + e] = exp_ftz(st[4 * ii + 2 + e] * a.scale - lse_t[col]);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);

    // dS^T = P^T (dP^T - D) scale; both rounded to bf16 pairs as A operands
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int ii = 0; ii < BQ / 8; ++ii) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * ii + 2 * c + e;
        dpt[4 * ii + e] = st[4 * ii + e] * (dpt[4 * ii + e] - d_t[col]) * a.scale;
        dpt[4 * ii + 2 + e] = st[4 * ii + 2 + e] * (dpt[4 * ii + 2 + e] - d_t[col]) * a.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }

    // dV += P~^T dO, dK += dS~^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<1>(dv, pa[kk], desc_mnmajor(dt + kk * 16 * 64, BQ * 128), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<1>(dk, da[kk], desc_mnmajor(qt + kk * 16 * 64, BQ * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_rows<HD>(dk, static_cast<bf16*>(a.dk) + static_cast<long long>(bi) * a.dks[0] +
                         static_cast<long long>(hi) * a.dks[1],
                 a.dks, k0, T, a.hd, c);
  store_rows<HD>(dv, static_cast<bf16*>(a.dv) + static_cast<long long>(bi) * a.dvs[0] +
                         static_cast<long long>(hi) * a.dvs[1],
                 a.dvs, k0, T, a.hd, c);
}

template <int HD>
int launch_dkv_sm90(const HArgs& a, const HeadMap& q, const HeadMap& k, const HeadMap& v,
                    const HeadMap& d, int bh, int n_blocks, cudaStream_t stream) {
  const int bytes = Dkv<HD>::BYTES;
  static bool done[64] = {};  // per HD: each instantiation opts in for itself
  const int err = opt_in_smem(flash_bwd_dkv_kernel_sm90<HD>, bytes, done);
  if (err != 0) return err;
  flash_bwd_dkv_kernel_sm90<HD><<<dim3(bh, n_blocks), H_THREADS, bytes, stream>>>(
      q.map, k.map, v.map, d.map, a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 dq: TMA, wgmma, warp specialization ---------------------------------------
// A block of 288 threads owns 128 query rows of one (b, h): a producer warp
// and two consumer warpgroups of 64 rows. Q and dO arrive once (TMA); the
// producer streams the key tiles of K and V (and their segment ids) through
// a ring of 3 stages on full/empty mbarriers, up to the diagonal when
// causal. Each consumer thread reads the lse, D (and segment ids) of its
// two rows once. Per key tile each consumer warpgroup computes, with dQ
// accumulating in registers for the whole loop:
//   S  = Q K^T             wgmma, both K-major from shared memory
//   dP = dO V^T            wgmma, both K-major
//   P  = exp(S scale - lse), masked only on the tiles that cross the
//        warpgroup's diagonal (and under segment ids), by selects
//   dS = P (dP - D) scale, in registers, rounded to bf16 pairs
//   dQ += dS~ K            wgmma, dS~ the register A operand, K MN-major
// The ring's empty barriers count the warps that read the tiles: a
// warpgroup whose rows all lie at or past T (the last block when T % 128 ==
// 64) reads none, and a causal warpgroup stops at its own diagonal, after
// which the producer loads nothing more. Wave y of the grid takes the query
// block n - 1 - y when causal, so the longest loops start first.
template <int HD>
struct Dq {
  static constexpr int BK = HD == 64 ? 64 : 32;     // keys per streamed tile (registers)
  static constexpr int STAGES = 3;
  static constexpr int PANELS = HD / 64;
  static constexpr int ROW_BYTES = KB * HD * 2;     // Q or dO: 128 rows
  static constexpr int TILE_BYTES = BK * HD * 2;
  // shared memory, every tile 1024-byte aligned
  static constexpr int Q = 0;
  static constexpr int DO = Q + ROW_BYTES;
  static constexpr int K = DO + ROW_BYTES;                  // stage s at K + s * TILE_BYTES
  static constexpr int V = K + STAGES * TILE_BYTES;
  static constexpr int SEG = V + STAGES * TILE_BYTES;       // BK key segment ids per stage
  static constexpr int BAR = SEG + STAGES * BK * 4;         // qdo, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + the alignment slack
};

struct QArgs {
  const float* lse;             // (b*h, T)
  const float* dcap;            // (b*h, T)
  const int* seg;               // (b, T) int32 or null
  void* dq;
  int h, T, hd;
  int dqs[3];                   // batch, head, time strides of dq
  float scale;
  int causal;
  MapPos qp, kp, vp, dp;
};

template <int HD>
__global__ void __launch_bounds__(H_THREADS, 1)
    flash_bwd_dq_kernel_sm90(__grid_constant__ const CUtensorMap mq,
                             __grid_constant__ const CUtensorMap mk,
                             __grid_constant__ const CUtensorMap mv,
                             __grid_constant__ const CUtensorMap mdo, const QArgs a) {
  using L = Dq<HD>;
  constexpr int BK = L::BK;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::V);
  int* segk = reinterpret_cast<int*>(smem + L::SEG);
  uint64_t* bar_qdo = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = bar_qdo + 1;
  uint64_t* empty = full + STAGES;

  const int T = a.T;
  const int bh = blockIdx.x;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  // the longest causal rows first
  const int qb = a.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q_end = min(T, (qb + 1) * KB);  // a multiple of 64, so of BK
  const int n_kv = a.causal ? q_end / BK : T / BK;
  const bool has_seg = a.seg != nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // the warps that read the tiles: the second warpgroup's rows may lie past T
    const int readers = (qb * KB + 64 < T ? 2 : 1) * 4;
    mbar_init(bar_qdo, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], readers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == H_CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(bar_qdo, 2 * L::ROW_BYTES);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_rows(sq + p * KB * 64, &mq, bar_qdo, p * 64, qb * KB, hi, bi, a.qp);
        tma_load_rows(sdo + p * KB * 64, &mdo, bar_qdo, p * 64, qb * KB, hi, bi, a.dp);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::TILE_BYTES + (has_seg ? BK * 4 : 0));
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_rows(sk + s * BK * HD + p * BK * 64, &mk, &full[s], p * 64, j * BK, hi, bi,
                        a.kp);
          tma_load_rows(sv + s * BK * HD + p * BK * 64, &mv, &full[s], p * 64, j * BK, hi, bi,
                        a.vp);
        }
        if (has_seg) bulk_load(segk + s * BK, a.seg + bi * T + j * BK, BK * 4, &full[s]);
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows [wg*64, wg*64 + 64) of the block;
  // this thread holds rows r0 (slot 0) and r0 + 8 (slot 1)
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c = lane % 4;
  const int first_row = qb * KB + wg * 64;
  if (first_row >= T) return;  // rows past T: nothing to read, nothing to store
  const int r0 = first_row + (warp % 4) * 16 + g;
  // a causal warpgroup's last tile is the one that holds its last row's key
  const int n_mine = a.causal ? (first_row + 64) / BK : n_kv;
  const long long at = static_cast<long long>(bh) * T;
  const float lse0 = a.lse[at + r0], lse1 = a.lse[at + r0 + 8];
  const float d0 = a.dcap[at + r0], d1 = a.dcap[at + r0 + 8];
  int sq0 = 0, sq1 = 0;
  if (has_seg) {
    sq0 = a.seg[bi * T + r0];
    sq1 = a.seg[bi * T + r0 + 8];
  }
  float dq[HD / 2], sacc[BK / 2], pacc[BK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sacc[i] = pacc[i] = 0.f;
  const bf16* qw = sq + wg * 64 * 64;
  const bf16* dw = sdo + wg * 64 * 64;
  mbar_wait(bar_qdo, 0);

  for (int j = 0; j < n_mine; ++j) {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const bf16* kt = sk + s * BK * HD;
    const bf16* vt = sv + s * BK * HD;

    // S = Q K^T and dP = dO V^T, two groups in flight
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<0>(sacc, desc_kmajor(qw + (kk / 4) * KB * 64 + (kk % 4) * 16),
                  desc_kmajor(kt + (kk / 4) * BK * 64 + (kk % 4) * 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<0>(pacc, desc_kmajor(dw + (kk / 4) * KB * 64 + (kk % 4) * 16),
                  desc_kmajor(vt + (kk / 4) * BK * 64 + (kk % 4) * 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sacc);

    // P = exp(S scale - lse): masked only where the tile crosses this
    // warpgroup's diagonal, and under segment ids (selects, no branches)
    if (has_seg || (a.causal && j * BK + BK - 1 > first_row)) {
      const int* sg = segk + s * BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * i + 2 * c + e;
          const int key = j * BK + col;
          const int sk_ = has_seg ? sg[col] : 0;
          const bool dead0 = (a.causal & (key > r0)) | (sq0 != sk_);
          const bool dead1 = (a.causal & (key > r0 + 8)) | (sq1 != sk_);
          const float v0 = dead0 ? NEG_INF : sacc[4 * i + e] * a.scale;
          const float v1 = dead1 ? NEG_INF : sacc[4 * i + 2 + e] * a.scale;
          sacc[4 * i + e] = exp_ftz(v0 - lse0);
          sacc[4 * i + 2 + e] = exp_ftz(v1 - lse1);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[4 * i + e] = exp_ftz(sacc[4 * i + e] * a.scale - lse0);
          sacc[4 * i + 2 + e] = exp_ftz(sacc[4 * i + 2 + e] * a.scale - lse1);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(pacc);

    // dS = P (dP - D) scale, rounded to bf16 pairs: the register A operand
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pacc[4 * i + e] = sacc[4 * i + e] * (pacc[4 * i + e] - d0) * a.scale;
        pacc[4 * i + 2 + e] = sacc[4 * i + 2 + e] * (pacc[4 * i + 2 + e] - d1) * a.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(pacc[8 * kk + 2 * r], pacc[8 * kk + 2 * r + 1]);
    }

    // dQ += dS~ K: the key tile read MN-major (keys are the depth)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<1>(dq, da[kk], desc_mnmajor(kt + kk * 16 * 64, BK * 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  store_rows<HD>(dq, static_cast<bf16*>(a.dq) + static_cast<long long>(bi) * a.dqs[0] +
                         static_cast<long long>(hi) * a.dqs[1],
                 a.dqs, r0, T, a.hd, c);
}

template <int HD>
int launch_dq_sm90(const QArgs& a, const HeadMap& q, const HeadMap& k, const HeadMap& v,
                   const HeadMap& d, int bh, int n_blocks, cudaStream_t stream) {
  const int bytes = Dq<HD>::BYTES;
  static bool done[64] = {};  // per HD: each instantiation opts in for itself
  const int err = opt_in_smem(flash_bwd_dq_kernel_sm90<HD>, bytes, done);
  if (err != 0) return err;
  flash_bwd_dq_kernel_sm90<HD><<<dim3(bh, n_blocks), H_THREADS, bytes, stream>>>(
      q.map, k.map, v.map, d.map, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dq_f32(const Args& a, cudaStream_t stream) {
  const size_t bytes = layout(a.hdp).total;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.T / BM, a.b * a.h);
  flash_bwd_dq_kernel_f32<<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkv_f32(const Args& a, cudaStream_t stream) {
  const size_t bytes = layout(a.hdp).total;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.T / BM, a.b * a.h);
  flash_bwd_dkv_kernel_f32<<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int b, int h, int T, int hd) {
  return b <= 0 || h <= 0 || T <= 0 || T % BM || hd < 1 || hd > MAX_HD || b * h > 65535;
}

// the operands' own last dims (bf16): at least hd, at most the widest kernel
bool bad_dims(int hd, int qd, int kd, int vd, int dd) {
  return qd < hd || kd < hd || vd < hd || dd < hd || qd > MAX_HD || kd > MAX_HD ||
         vd > MAX_HD || dd > MAX_HD;
}

void set3(int (&dst)[3], int s0, int s1, int s2) {
  dst[0] = s0;
  dst[1] = s1;
  dst[2] = s2;
}

Args common(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* dcap, const void* seg, int b, int h, int T, int hd, int causal,
            int qsb, int qsh, int qst, int ksb, int ksh, int kst, int vsb, int vsh, int vst,
            int dsb, int dsh, int dst, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.seg = static_cast<const int*>(seg);
  a.b = b;
  a.h = h;
  a.T = T;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  set3(a.qs, qsb, qsh, qst);
  set3(a.ks, ksb, ksh, kst);
  set3(a.vs, vsb, vsh, vst);
  set3(a.ds, dsb, dsh, dst);
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

extern "C" {

// which: 0 -> the T rule's unit (rows per f32 block), 1 -> rows per f32 streamed
// tile, 2 -> largest head dim
int dl4j_flash_bwd_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : MAX_HD;
}

// q, k, v, dout: (b, h, T, hd) through strides (batch, head, time; the head
// dim unit-stride), all bf16 or all f32; lse, dcap: (b*h, T) f32 contiguous;
// seg: (b, T) int32 contiguous or null; dq: (b, h, T, hd) of the operand
// type through its strides. Needs T % 64 == 0, 1 <= hd <= 128. bf16: qd, kd,
// vd, dd are the operands' own last dims (>= hd; zero past hd), each operand
// TMA-readable (16-byte aligned base, strides multiples of 8 elements), seg
// 16-byte aligned (ceil(T / 128) query blocks). Returns cudaGetLastError(),
// or 1000 + the CUresult of a failed tensor-map encoding.
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dcap, const void* seg, void* dq, int b,
                      int h, int T, int hd, int causal, int is_bf16, int qsb, int qsh, int qst,
                      int ksb, int ksh, int kst, int vsb, int vsh, int vst, int dsb, int dsh,
                      int dst, int dqsb, int dqsh, int dqst, int qd, int kd, int vd, int dd,
                      float scale, void* stream) {
  if (bad_shape(b, h, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    Args a = common(q, k, v, dout, lse, dcap, seg, b, h, T, hd, causal, qsb, qsh, qst, ksb,
                    ksh, kst, vsb, vsh, vst, dsb, dsh, dst, scale);
    a.dq = dq;
    set3(a.dqs, dqsb, dqsh, dqst);
    return launch_dq_f32(a, stm);
  }
  if (bad_dims(hd, qd, kd, vd, dd)) return static_cast<int>(cudaErrorInvalidValue);
  const int bk = hd <= 64 ? Dq<64>::BK : Dq<128>::BK;
  HeadMap mq, mk, mv, md;
  int rc = encode_heads(&mq, q, qd, T, h, b, qsb, qsh, qst, KB);
  if (rc == 0) rc = encode_heads(&mk, k, kd, T, h, b, ksb, ksh, kst, bk);
  if (rc == 0) rc = encode_heads(&mv, v, vd, T, h, b, vsb, vsh, vst, bk);
  if (rc == 0) rc = encode_heads(&md, dout, dd, T, h, b, dsb, dsh, dst, KB);
  if (rc != 0) return rc;
  QArgs a{};
  a.lse = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.seg = static_cast<const int*>(seg);
  a.dq = dq;
  a.h = h;
  a.T = T;
  a.hd = hd;
  set3(a.dqs, dqsb, dqsh, dqst);
  a.scale = scale;
  a.causal = causal;
  a.qp = mq.pos;
  a.kp = mk.pos;
  a.vp = mv.pos;
  a.dp = md.pos;
  const int n_blocks = (T + KB - 1) / KB;
  return hd <= 64 ? launch_dq_sm90<64>(a, mq, mk, mv, md, b * h, n_blocks, stm)
                  : launch_dq_sm90<128>(a, mq, mk, mv, md, b * h, n_blocks, stm);
}

// as dl4j_flash_bwd_dq; dk, dv: (b, h, T, hd) of the operand type through
// their strides. bf16: qd, kd, vd, dd are the operands' own last dims (>= hd;
// zero past hd), each operand TMA-readable (16-byte aligned base, strides
// multiples of 8 elements), lse, dcap and seg 16-byte aligned (ceil(T / 128)
// key blocks). Returns
// cudaGetLastError(), or 1000 + a driver error of the tensor-map encoding.
int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dcap, const void* seg, void* dk, void* dv,
                       int b, int h, int T, int hd, int causal, int is_bf16, int qsb, int qsh,
                       int qst, int ksb, int ksh, int kst, int vsb, int vsh, int vst, int dsb,
                       int dsh, int dst, int dksb, int dksh, int dkst, int dvsb, int dvsh,
                       int dvst, int qd, int kd, int vd, int dd, float scale,
                       void* stream) {
  if (bad_shape(b, h, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    Args a = common(q, k, v, dout, lse, dcap, seg, b, h, T, hd, causal, qsb, qsh, qst, ksb,
                    ksh, kst, vsb, vsh, vst, dsb, dsh, dst, scale);
    a.dk = dk;
    a.dv = dv;
    set3(a.dks, dksb, dksh, dkst);
    set3(a.dvs, dvsb, dvsh, dvst);
    return launch_dkv_f32(a, stm);
  }
  const int n_blocks = (T + KB - 1) / KB;
  if (bad_dims(hd, qd, kd, vd, dd)) return static_cast<int>(cudaErrorInvalidValue);
  const int bq = hd <= 64 ? Dkv<64>::BQ : Dkv<128>::BQ;
  HeadMap mq, mk, mv, md;
  int rc = encode_heads(&mq, q, qd, T, h, b, qsb, qsh, qst, bq);
  if (rc == 0) rc = encode_heads(&mk, k, kd, T, h, b, ksb, ksh, kst, KB);
  if (rc == 0) rc = encode_heads(&mv, v, vd, T, h, b, vsb, vsh, vst, KB);
  if (rc == 0) rc = encode_heads(&md, dout, dd, T, h, b, dsb, dsh, dst, bq);
  if (rc != 0) return rc;
  HArgs a{};
  a.lse = static_cast<const float*>(lse);
  a.dcap = static_cast<const float*>(dcap);
  a.seg = static_cast<const int*>(seg);
  a.dk = dk;
  a.dv = dv;
  a.h = h;
  a.T = T;
  a.hd = hd;
  set3(a.dks, dksb, dksh, dkst);
  set3(a.dvs, dvsb, dvsh, dvst);
  a.scale = scale;
  a.causal = causal;
  a.qp = mq.pos;
  a.kp = mk.pos;
  a.vp = mv.pos;
  a.dp = md.pos;
  return hd <= 64 ? launch_dkv_sm90<64>(a, mq, mk, mv, md, b * h, n_blocks, stm)
                  : launch_dkv_sm90<128>(a, mq, mk, mv, md, b * h, n_blocks, stm);
}

}  // extern "C"
