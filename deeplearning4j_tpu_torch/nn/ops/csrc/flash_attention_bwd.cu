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
// dq kernel: one block per (b*h, 64-row query block); it loops over the key
// tiles (up to the diagonal tile when causal, masked inside it). dkv kernel:
// one block per (b*h, 64-row key block); it loops over the query tiles
// (from the diagonal tile when causal, masked inside it). Each output tile is
// owned by one block and summed in a fixed order, with no atomics, so two
// runs give the same bits.
//
// Types. q, k, v, dO and the outputs are all bf16 or all f32. bf16: the
// four products of a tile run on the tensor cores (WMMA 16x16x16 bf16, f32
// accumulation, the accumulators in registers). f32: f32 FMAs on the CUDA
// cores (no TF32: fp32 means fp32 in this port).
//
// Bound on an H100: per (b, h) the dq kernel does 6*T^2*hd FLOPs and the dkv
// kernel 8*T^2*hd (half of each when causal) on ~5*T*hd operand elements, so
// at the train shape (T 512, hd 64) the tensor-core FLOPs bound both. This
// first version is latency-bound like the forward: scalar tile loads,
// 4 warps of 16 rows each, the score tiles through shared memory.
//
// Layout. Each warp owns 16 rows of the block's own tile (queries in dq,
// keys in dkv) and computes their 16 x 64 score and dp tiles against the
// streamed tile; two lanes per row form p and ds on them. Head dims 1 to 128
// are padded to a multiple of 16 with zeros in shared memory. q, k, v and dO
// are read, and dq, dk, dv written, through their batch, head and time
// strides (the head dimension unit-stride), so the wrapper can hand in the
// model's head-split views and hand back (b, h, T, hd) views of (b, T, h, hd)
// buffers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;          // rows of the block's own tile
constexpr int BN = 64;          // rows of each streamed tile
constexpr int WARPS = 4;        // each warp owns 16 rows of the own tile
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HD = 128;
constexpr int NT = MAX_HD / 16; // 16-wide head-dim tiles at most
constexpr int NJ = MAX_HD / 32; // head-dim columns per lane at most (f32)
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

// Shared memory: the block's two own tiles and the two streamed tiles (all
// BM = BN rows of the operand type), the f32 score and dp tiles, the bf16
// p~ and ds~ tiles (tensor-core path), the streamed rows' lse and D (dkv)
// or the own rows' (dq), and the segment ids of both.
struct Layout {
  int ld, lds, ldp;
  size_t own0, own1, str0, str1, s, dp, pb, db, lse, dcap, segown, segstr, total;
};

template <typename TI>
__host__ __device__ Layout layout(int hdp) {
  constexpr bool tc = std::is_same<TI, bf16>::value;
  Layout m{};
  m.ld = tc ? hdp + 8 : hdp + 1;
  m.lds = tc ? BN + 4 : BN + 1;
  m.ldp = BN + 8;
  size_t off = 0;
  m.own0 = off; off = align128(off + sizeof(TI) * BM * m.ld);
  m.own1 = off; off = align128(off + sizeof(TI) * BM * m.ld);
  m.str0 = off; off = align128(off + sizeof(TI) * BN * m.ld);
  m.str1 = off; off = align128(off + sizeof(TI) * BN * m.ld);
  m.s = off; off = align128(off + sizeof(float) * BM * m.lds);
  m.dp = off; off = align128(off + sizeof(float) * BM * m.lds);
  m.pb = off; if (tc) off = align128(off + sizeof(bf16) * BM * m.ldp);
  m.db = off; if (tc) off = align128(off + sizeof(bf16) * BM * m.ldp);
  m.lse = off; off = align128(off + sizeof(float) * BN);
  m.dcap = off; off = align128(off + sizeof(float) * BN);
  m.segown = off; off = align128(off + sizeof(int) * BM);
  m.segstr = off; off = align128(off + sizeof(int) * BN);
  m.total = off;
  return m;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename TI> __device__ __forceinline__ TI zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16_rn(0.f); }

// rows [r0, r0 + 64) of one head (src: its row 0, st: its time stride) into
// dst (leading dimension ld); columns hd .. hdp - 1 are zero-filled
template <typename TI>
__device__ __forceinline__ void load_tile(TI* dst, int ld, const TI* __restrict__ src,
                                          int st, int r0, int hd, int hdp) {
  for (int i = threadIdx.x; i < BM * hdp; i += THREADS) {
    const int r = i / hdp;
    const int c = i - r * hdp;
    dst[r * ld + c] = c < hd ? src[static_cast<long long>(r0 + r) * st + c] : zero<TI>();
  }
}

// ---- bf16: tensor cores -----------------------------------------------------
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// C[warp rows][0, 64) = A[warp rows][0, hdp) . B[0, 64)[0, hdp)^T (A, B in
// shared memory with leading dimension ld; C with ldc)
__device__ __forceinline__ void abt_tc(const bf16* a, const bf16* bm, float* c, int ld,
                                       int ldc, int hdp, int warp) {
  FragA af;
  FragBt bf;
  FragAcc acc;
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t * 16 < hdp) {
        wmma::load_matrix_sync(af, a + warp * 16 * ld + t * 16, ld);
        // B^T as a col-major (hd x 64) matrix: element (d, r) at bm[r * ld + d]
        wmma::load_matrix_sync(bf, bm + n * 16 * ld + t * 16, ld);
        wmma::mma_sync(acc, af, bf, acc);
      }
    }
    wmma::store_matrix_sync(c + warp * 16 * ldc + n * 16, acc, ldc, wmma::mem_row_major);
  }
}

// acc[d tile] += P[warp rows][0, 64) . B[0, 64)[d tile] (P bf16 with ldp,
// B with ld)
__device__ __forceinline__ void ab_tc(const bf16* p, int ldp, const bf16* bm, int ld,
                                      FragAcc (&acc)[NT], int hdp, int warp) {
  FragA pf;
  FragB bf;
#pragma unroll
  for (int kk = 0; kk < BN; kk += 16) {
    wmma::load_matrix_sync(pf, p + warp * 16 * ldp + kk, ldp);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t * 16 < hdp) {
        wmma::load_matrix_sync(bf, bm + kk * ld + t * 16, ld);
        wmma::mma_sync(acc[t], pf, bf, acc[t]);
      }
    }
  }
}

// the warp's 16 rows of acc, rounded once, to dst (row r0 of the warp's
// rows; time stride ts), staged 16 x 16 at a time through stage (ld lds)
template <typename TI>
__device__ __forceinline__ void write_tc(FragAcc (&acc)[NT], float* stage, int lds, TI* dst,
                                         int ts, int hd, int hdp, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t * 16 < hdp) {
      wmma::store_matrix_sync(stage, acc[t], lds, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16;
        const int d = t * 16 + (e % 16);
        if (d < hd) store(dst + static_cast<long long>(r) * ts + d, stage[r * lds + (e % 16)]);
      }
      __syncwarp();
    }
  }
}

// ---- f32: CUDA cores --------------------------------------------------------
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

template <typename TI>
__device__ __forceinline__ void write_f32(const float (&acc)[NJ][16], TI* dst, int ts, int hd,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    if (d < hd) {
#pragma unroll
      for (int r = 0; r < 16; ++r) store(dst + static_cast<long long>(r) * ts + d, acc[j][r]);
    }
  }
}

template <typename TI>
__device__ __forceinline__ const TI* head_ptr(const void* base, const int (&st)[3], int bi,
                                              int hi) {
  return static_cast<const TI*>(base) + static_cast<long long>(bi) * st[0] +
         static_cast<long long>(hi) * st[1];
}

template <typename TI>
__device__ __forceinline__ TI* head_ptr_out(void* base, const int (&st)[3], int bi, int hi) {
  return static_cast<TI*>(base) + static_cast<long long>(bi) * st[0] +
         static_cast<long long>(hi) * st[1];
}

// ---- dq: one block per (b*h, query block) ------------------------------------
template <typename TI>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args a) {
  constexpr bool tc = std::is_same<TI, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<TI>(a.hdp);
  TI* qsm = reinterpret_cast<TI*>(smem + L.own0);
  TI* dosm = reinterpret_cast<TI*>(smem + L.own1);
  TI* ksm = reinterpret_cast<TI*>(smem + L.str0);
  TI* vsm = reinterpret_cast<TI*>(smem + L.str1);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  bf16* db = reinterpret_cast<bf16*>(smem + L.db);
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

  const TI* qg = head_ptr<TI>(a.q, a.qs, bi, hi);
  const TI* kg = head_ptr<TI>(a.k, a.ks, bi, hi);
  const TI* vg = head_ptr<TI>(a.v, a.vs, bi, hi);
  const TI* dg = head_ptr<TI>(a.dout, a.ds, bi, hi);

  load_tile(qsm, L.ld, qg, a.qs[2], qb * BM, hd, hdp);
  load_tile(dosm, L.ld, dg, a.ds[2], qb * BM, hd, hdp);
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    lse[i] = a.lse[static_cast<long long>(bh) * T + qb * BM + i];
    dcap[i] = a.dcap[static_cast<long long>(bh) * T + qb * BM + i];
    if (has_seg) segq[i] = a.seg[bi * T + qb * BM + i];
  }

  FragAcc acc_tc[NT];
  float acc_f[NJ][16];
  if constexpr (tc) {
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc_tc[t], 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int r = 0; r < 16; ++r) acc_f[j][r] = 0.f;
    }
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

    if constexpr (tc) {
      abt_tc(qsm, ksm, s, L.ld, L.lds, hdp, warp);
      abt_tc(dosm, vsm, dp, L.ld, L.lds, hdp, warp);
    } else {
      abt_f32(qsm, ksm, s, L.ld, L.lds, hdp, warp, lane);
      abt_f32(dosm, vsm, dp, L.ld, L.lds, hdp, warp, lane);
    }
    __syncwarp();

    const float lr = lse[row], dr = dcap[row];
    for (int c = c0; c < c0 + BN / 2; ++c) {
      float sc = s[row * L.lds + c] * a.scale;
      if (a.causal && j * BN + c > grow) sc = NEG_INF;
      if (has_seg && segq[row] != segk[c]) sc = NEG_INF;
      const float p = expf(sc - lr);
      const float dsv = p * (dp[row * L.lds + c] - dr) * a.scale;
      if constexpr (tc) {
        db[row * L.ldp + c] = __float2bfloat16_rn(dsv);
      } else {
        s[row * L.lds + c] = dsv;
      }
    }
    __syncwarp();

    if constexpr (tc) {
      ab_tc(db, L.ldp, ksm, L.ld, acc_tc, hdp, warp);
    } else {
      ab_f32(s, L.lds, ksm, L.ld, acc_f, hdp, warp, lane);
    }
  }

  TI* dst = head_ptr_out<TI>(a.dq, a.dqs, bi, hi) +
            static_cast<long long>(qb * BM + warp * 16) * a.dqs[2];
  __syncwarp();
  if constexpr (tc) {
    write_tc(acc_tc, s + warp * 16 * L.lds, L.lds, dst, a.dqs[2], hd, hdp, lane);
  } else {
    write_f32(acc_f, dst, a.dqs[2], hd, lane);
  }
}

// ---- dk, dv: one block per (b*h, key block) ----------------------------------
template <typename TI>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const Args a) {
  constexpr bool tc = std::is_same<TI, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<TI>(a.hdp);
  TI* ksm = reinterpret_cast<TI*>(smem + L.own0);
  TI* vsm = reinterpret_cast<TI*>(smem + L.own1);
  TI* qsm = reinterpret_cast<TI*>(smem + L.str0);
  TI* dosm = reinterpret_cast<TI*>(smem + L.str1);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* dp = reinterpret_cast<float*>(smem + L.dp);
  bf16* pb = reinterpret_cast<bf16*>(smem + L.pb);
  bf16* db = reinterpret_cast<bf16*>(smem + L.db);
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

  const TI* qg = head_ptr<TI>(a.q, a.qs, bi, hi);
  const TI* kg = head_ptr<TI>(a.k, a.ks, bi, hi);
  const TI* vg = head_ptr<TI>(a.v, a.vs, bi, hi);
  const TI* dg = head_ptr<TI>(a.dout, a.ds, bi, hi);

  load_tile(ksm, L.ld, kg, a.ks[2], kb * BM, hd, hdp);
  load_tile(vsm, L.ld, vg, a.vs[2], kb * BM, hd, hdp);
  if (has_seg) {
    for (int i = threadIdx.x; i < BM; i += THREADS) segk[i] = a.seg[bi * T + kb * BM + i];
  }

  FragAcc dk_tc[NT], dv_tc[NT];
  float dk_f[NJ][16], dv_f[NJ][16];
  if constexpr (tc) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      wmma::fill_fragment(dk_tc[t], 0.f);
      wmma::fill_fragment(dv_tc[t], 0.f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int r = 0; r < 16; ++r) dk_f[j][r] = dv_f[j][r] = 0.f;
    }
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
    if constexpr (tc) {
      abt_tc(ksm, qsm, s, L.ld, L.lds, hdp, warp);
      abt_tc(vsm, dosm, dp, L.ld, L.lds, hdp, warp);
    } else {
      abt_f32(ksm, qsm, s, L.ld, L.lds, hdp, warp, lane);
      abt_f32(vsm, dosm, dp, L.ld, L.lds, hdp, warp, lane);
    }
    __syncwarp();

    for (int c = c0; c < c0 + BN / 2; ++c) {
      float sc = s[row * L.lds + c] * a.scale;
      if (a.causal && gkey > i * BN + c) sc = NEG_INF;
      if (has_seg && segk[row] != segq[c]) sc = NEG_INF;
      const float p = expf(sc - lse[c]);
      const float dsv = p * (dp[row * L.lds + c] - dcap[c]) * a.scale;
      if constexpr (tc) {
        pb[row * L.ldp + c] = __float2bfloat16_rn(p);
        db[row * L.ldp + c] = __float2bfloat16_rn(dsv);
      } else {
        s[row * L.lds + c] = p;
        dp[row * L.lds + c] = dsv;
      }
    }
    __syncwarp();

    if constexpr (tc) {
      ab_tc(pb, L.ldp, dosm, L.ld, dv_tc, hdp, warp);
      ab_tc(db, L.ldp, qsm, L.ld, dk_tc, hdp, warp);
    } else {
      ab_f32(s, L.lds, dosm, L.ld, dv_f, hdp, warp, lane);
      ab_f32(dp, L.lds, qsm, L.ld, dk_f, hdp, warp, lane);
    }
  }

  const long long r0 = kb * BM + warp * 16;
  TI* dkd = head_ptr_out<TI>(a.dk, a.dks, bi, hi) + r0 * a.dks[2];
  TI* dvd = head_ptr_out<TI>(a.dv, a.dvs, bi, hi) + r0 * a.dvs[2];
  __syncwarp();
  if constexpr (tc) {
    write_tc(dk_tc, s + warp * 16 * L.lds, L.lds, dkd, a.dks[2], hd, hdp, lane);
    write_tc(dv_tc, s + warp * 16 * L.lds, L.lds, dvd, a.dvs[2], hd, hdp, lane);
  } else {
    write_f32(dk_f, dkd, a.dks[2], hd, lane);
    write_f32(dv_f, dvd, a.dvs[2], hd, lane);
  }
}

template <typename TI>
int launch_dq(const Args& a, cudaStream_t stream) {
  const size_t bytes = layout<TI>(a.hdp).total;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<TI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.T / BM, a.b * a.h);
  flash_bwd_dq_kernel<TI><<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t bytes = layout<TI>(a.hdp).total;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<TI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.T / BM, a.b * a.h);
  flash_bwd_dkv_kernel<TI><<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int b, int h, int T, int hd) {
  return b <= 0 || h <= 0 || T <= 0 || T % BM || hd < 1 || hd > MAX_HD || b * h > 65535;
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

// which: 0 -> rows per block, 1 -> rows per streamed tile, 2 -> largest head dim
int dl4j_flash_bwd_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : MAX_HD;
}

// q, k, v, dout: (b, h, T, hd) through strides (batch, head, time; the head
// dim unit-stride), all bf16 or all f32; lse, dcap: (b*h, T) f32 contiguous;
// seg: (b, T) int32 contiguous or null; dq: (b, h, T, hd) of the operand
// type through its strides. Needs T % 64 == 0, 1 <= hd <= 128. Returns
// cudaGetLastError().
int dl4j_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dcap, const void* seg, void* dq, int b,
                      int h, int T, int hd, int causal, int is_bf16, int qsb, int qsh, int qst,
                      int ksb, int ksh, int kst, int vsb, int vsh, int vst, int dsb, int dsh,
                      int dst, int dqsb, int dqsh, int dqst, float scale, void* stream) {
  if (bad_shape(b, h, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = common(q, k, v, dout, lse, dcap, seg, b, h, T, hd, causal, qsb, qsh, qst, ksb, ksh,
                  kst, vsb, vsh, vst, dsb, dsh, dst, scale);
  a.dq = dq;
  set3(a.dqs, dqsb, dqsh, dqst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dq<bf16>(a, st) : launch_dq<float>(a, st);
}

// as dl4j_flash_bwd_dq; dk, dv: (b, h, T, hd) of the operand type through
// their strides
int dl4j_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dcap, const void* seg, void* dk, void* dv,
                       int b, int h, int T, int hd, int causal, int is_bf16, int qsb, int qsh,
                       int qst, int ksb, int ksh, int kst, int vsb, int vsh, int vst, int dsb,
                       int dsh, int dst, int dksb, int dksh, int dkst, int dvsb, int dvsh,
                       int dvst, float scale, void* stream) {
  if (bad_shape(b, h, T, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = common(q, k, v, dout, lse, dcap, seg, b, h, T, hd, causal, qsb, qsh, qst, ksb, ksh,
                  kst, vsb, vsh, vst, dsb, dsh, dst, scale);
  a.dk = dk;
  a.dv = dv;
  set3(a.dks, dksb, dksh, dkst);
  set3(a.dvs, dvsb, dvsh, dvst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dkv<bf16>(a, st) : launch_dkv<float>(a, st);
}

}  // extern "C"
