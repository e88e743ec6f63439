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
//
// Types. q, k, v and o are all bf16 or all f32. bf16: both products run on
// the tensor cores (WMMA 16x16x16 bf16, f32 accumulation). f32: f32 FMAs on
// the CUDA cores (no TF32, no tensor cores: fp32 means fp32 in this port).
// The softmax state and every elementwise step are f32 (expf, logf).
//
// Bound on an H100: at the serving shapes (b 1-2, 12 heads of 64, T 128 to
// 1024, causal, bf16) the work is ~2*T^2*hd*b*h FLOPs against 4*T*hd*b*h*2
// bytes; the bytes bound it below T ~ 600, the tensor-core FLOPs above
// (PERF.md). At these sizes a launch is latency- and occupancy-bound: the
// grid is T/64 x b*h blocks, 24 to 384 blocks on 132 SMs.
//
// Design. A block of 4 warps owns 64 query rows of one (b, h); each warp
// owns 16 of them. The block walks the key/value tiles of 64 keys, staged
// in shared memory (causal: only up to the diagonal tile, masked inside
// it). Per tile each warp computes its 16 x 64 scores (tensor cores, Q
// fragments kept in registers across tiles), then two lanes per row run
// the online-softmax update on them, write p~ and rescale the row's f32
// output accumulator, which lives in shared memory (the WMMA accumulator
// layout is opaque, so the per-row rescale goes through shared memory);
// then the warp adds p~ . v to it. The epilogue divides once and stores
// the warp's rows with the lanes along the head dimension. Head dims 1 to
// 128 are padded to a multiple of 16 with zeros in shared memory (the TPU
// wrapper pads to 128 lanes: the same math). q, k, v may be strided views
// (the model's head split is a transpose): the kernel takes each tensor's
// batch, head and time strides; the head dimension must be unit-stride.
// Output o is written through strides as well, so the wrapper can hand
// back a (b, h, T, hd) view of a (b, T, h, hd) buffer.
//
// Determinism. Every output row is computed by one block, its sums in a
// fixed order, with no atomics: a row's bits do not depend on the batch,
// on the other heads or on the run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per tile
constexpr int WARPS = 4;        // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HD = 128;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;               // (b, T) int32 or null
  void* o;
  float* lse;                   // (b*h, T)
  int b, h, T, hd, hdp;         // hdp: hd rounded up to a multiple of 16
  int qs[3], ks[3], vs[3], os[3];  // element strides of batch, head, time
  float scale;
  int causal;
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory layout: every region starts 128-byte aligned and every
// leading dimension keeps WMMA's 32-byte tile alignment (bf16) or breaks
// bank conflicts (f32).
struct Layout {
  int ldq, lds, ldp, ldo;
  size_t q, k, v, s, p, o, segq, segk, rowl, rowa, total;
};

template <typename TI>
__host__ __device__ Layout layout(int hdp) {
  constexpr bool tc = std::is_same<TI, bf16>::value;
  Layout m{};
  m.ldq = tc ? hdp + 8 : hdp + 1;
  m.lds = tc ? BN + 4 : BN + 1;
  m.ldp = BN + 8;
  m.ldo = tc ? hdp + 4 : hdp + 1;
  size_t off = 0;
  m.q = off; off = align128(off + sizeof(TI) * BM * m.ldq);
  m.k = off; off = align128(off + sizeof(TI) * BN * m.ldq);
  m.v = off; off = align128(off + sizeof(TI) * BN * m.ldq);
  m.s = off; off = align128(off + sizeof(float) * BM * m.lds);
  m.p = off; if (tc) off = align128(off + sizeof(bf16) * BM * m.ldp);
  m.o = off; off = align128(off + sizeof(float) * BM * m.ldo);
  m.segq = off; off = align128(off + sizeof(int) * BM);
  m.segk = off; off = align128(off + sizeof(int) * BN);
  m.rowl = off; off = align128(off + sizeof(float) * BM);
  m.rowa = off; off = align128(off + sizeof(float) * BM);
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
using FragQ = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragKt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragV = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// S[warp rows][0, 64) = Q_w K^T, Q_w from registers
__device__ __forceinline__ void scores_tc(const FragQ (&qf)[MAX_HD / 16], const bf16* ks,
                                          float* s, const Layout& L, int hdp, int warp) {
  FragKt kf;
  FragAcc acc;
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) {
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int t = 0; t < MAX_HD / 16; ++t) {
      if (t * 16 < hdp) {
        // K^T as a col-major (hd x 64) matrix: element (d, key) at ks[key * ld + d]
        wmma::load_matrix_sync(kf, ks + n * 16 * L.ldq + t * 16, L.ldq);
        wmma::mma_sync(acc, qf[t], kf, acc);
      }
    }
    wmma::store_matrix_sync(s + warp * 16 * L.lds + n * 16, acc, L.lds, wmma::mem_row_major);
  }
}

// O[warp rows] += P~_w V (O already rescaled by alpha)
__device__ __forceinline__ void pv_tc(const bf16* p, const bf16* vs, float* o,
                                      const Layout& L, int hdp, int warp) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
  FragV vf;
  FragAcc acc;
  for (int dn = 0; dn < hdp; dn += 16) {
    float* ot = o + warp * 16 * L.ldo + dn;
    wmma::load_matrix_sync(acc, ot, L.ldo, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::load_matrix_sync(pf, p + warp * 16 * L.ldp + kk, L.ldp);
      wmma::load_matrix_sync(vf, vs + kk * L.ldq + dn, L.ldq);
      wmma::mma_sync(acc, pf, vf, acc);
    }
    wmma::store_matrix_sync(ot, acc, L.ldo, wmma::mem_row_major);
  }
}

// ---- f32: CUDA cores --------------------------------------------------------
// S[warp rows][c] for c = lane, lane + 32: f32 FMAs over d in order
__device__ __forceinline__ void scores_f32(const float* qs, const float* ks, float* s,
                                           const Layout& L, int hdp, int warp, int lane) {
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
                                       const float* rowa, const Layout& L, int hdp,
                                       int warp, int lane) {
  for (int d = lane; d < hdp; d += 32) {
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.f;
    for (int c = 0; c < BN; ++c) {
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

template <typename TI>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  constexpr bool tc = std::is_same<TI, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<TI>(a.hdp);
  TI* qsm = reinterpret_cast<TI*>(smem + L.q);
  TI* ksm = reinterpret_cast<TI*>(smem + L.k);
  TI* vsm = reinterpret_cast<TI*>(smem + L.v);
  float* s = reinterpret_cast<float*>(smem + L.s);
  bf16* p = reinterpret_cast<bf16*>(smem + L.p);
  float* o = reinterpret_cast<float*>(smem + L.o);
  int* segq = reinterpret_cast<int*>(smem + L.segq);
  int* segk = reinterpret_cast<int*>(smem + L.segk);
  float* rowl = reinterpret_cast<float*>(smem + L.rowl);
  float* rowa = reinterpret_cast<float*>(smem + L.rowa);

  const int T = a.T, hd = a.hd, hdp = a.hdp;
  const int nqb = T / BM;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // the longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / a.h;
  const int hi = bh - bi * a.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_seg = a.seg != nullptr;

  const TI* qg = static_cast<const TI*>(a.q) + static_cast<long long>(bi) * a.qs[0] +
                 static_cast<long long>(hi) * a.qs[1];
  const TI* kg = static_cast<const TI*>(a.k) + static_cast<long long>(bi) * a.ks[0] +
                 static_cast<long long>(hi) * a.ks[1];
  const TI* vg = static_cast<const TI*>(a.v) + static_cast<long long>(bi) * a.vs[0] +
                 static_cast<long long>(hi) * a.vs[1];
  TI* og = static_cast<TI*>(a.o) + static_cast<long long>(bi) * a.os[0] +
           static_cast<long long>(hi) * a.os[1];

  load_tile(qsm, L.ldq, qg, a.qs[2], qb * BM, hd, hdp);
  for (int i = threadIdx.x; i < BM * L.ldo; i += THREADS) o[i] = 0.f;
  if (has_seg) {
    for (int i = threadIdx.x; i < BM; i += THREADS) segq[i] = a.seg[bi * T + qb * BM + i];
  }
  __syncthreads();

  FragQ qf[MAX_HD / 16];
  if constexpr (tc) {
#pragma unroll
    for (int t = 0; t < MAX_HD / 16; ++t) {
      if (t * 16 < hdp) wmma::load_matrix_sync(qf[t], qsm + warp * 16 * L.ldq + t * 16, L.ldq);
    }
  }

  // the softmax state of one row, kept alike by the row's two lanes
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int grow = qb * BM + row;
  float m = NEG_INF, l = 0.f;
  float* srow = s + row * L.lds;
  const int n_kv = a.causal ? qb + 1 : T / BN;

  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ksm, L.ldq, kg, a.ks[2], j * BN, hd, hdp);
    load_tile(vsm, L.ldq, vg, a.vs[2], j * BN, hd, hdp);
    if (has_seg) {
      for (int i = threadIdx.x; i < BN; i += THREADS) segk[i] = a.seg[bi * T + j * BN + i];
    }
    __syncthreads();

    if constexpr (tc) {
      scores_tc(qf, ksm, s, L, hdp, warp);
    } else {
      scores_f32(qsm, ksm, s, L, hdp, warp, lane);
    }
    __syncwarp();

    // online-softmax update: lane (row, half) takes columns [32 half, 32 half + 32)
    const int c0 = half * (BN / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + BN / 2; ++c) {
      float sc = srow[c] * a.scale;
      if (a.causal && j * BN + c > grow) sc = NEG_INF;
      if (has_seg && segq[row] != segk[c]) sc = NEG_INF;
      srow[c] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + BN / 2; ++c) {
      const float pc = expf(srow[c] - m_new);
      sum += pc;
      if constexpr (tc) {
        p[row * L.ldp + c] = __float2bfloat16_rn(pc);
      } else {
        srow[c] = pc;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    if constexpr (tc) {
      float* orow = o + row * L.ldo;
      for (int d = half; d < hdp; d += 2) orow[d] *= alpha;
    } else {
      if (half == 0) rowa[row] = alpha;
    }
    __syncwarp();

    if constexpr (tc) {
      pv_tc(p, vsm, o, L, hdp, warp);
    } else {
      pv_f32(s, vsm, o, rowa, L, hdp, warp, lane);
    }
    __syncwarp();
  }

  // epilogue: one division, one rounding; the warp stores its 16 rows
  const float l_safe = fmaxf(l, 1e-30f);
  if (half == 0) {
    rowl[row] = l_safe;
    a.lse[static_cast<long long>(bh) * T + grow] = m + logf(l_safe);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int lr = warp * 16 + r;
    TI* dst = og + static_cast<long long>(qb * BM + lr) * a.os[2];
    const float lr_safe = rowl[lr];
    for (int d = lane; d < hd; d += 32) store(dst + d, o[lr * L.ldo + d] / lr_safe);
  }
}

template <typename TI>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = layout<TI>(a.hdp).total;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<TI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.T / BM, a.b * a.h);
  flash_fwd_kernel<TI><<<grid, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// which: 0 -> query rows per block, 1 -> keys per tile, 2 -> largest head dim
int dl4j_flash_tile(int which) {
  return which == 0 ? BM : which == 1 ? BN : MAX_HD;
}

// q, k, v: (b, h, T, hd) through strides (batch, head, time; the head dim
// unit-stride), all bf16 or all f32; seg: (b, T) int32 contiguous or null;
// o: (b, h, T, hd) of the operand type through its strides; lse: (b*h, T)
// f32 contiguous. Needs T % 64 == 0, 1 <= hd <= 128. Returns cudaGetLastError().
int dl4j_flash_fwd(const void* q, const void* k, const void* v, const void* seg, void* o,
                   void* lse, int b, int h, int T, int hd, int causal, int is_bf16,
                   int qsb, int qsh, int qst, int ksb, int ksh, int kst, int vsb, int vsh,
                   int vst, int osb, int osh, int ost, float scale, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || T % BM || hd < 1 || hd > MAX_HD || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg = static_cast<const int*>(seg);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.b = b;
  a.h = h;
  a.T = T;
  a.hd = hd;
  a.hdp = (hd + 15) / 16 * 16;
  const int qsv[3] = {qsb, qsh, qst}, ksv[3] = {ksb, ksh, kst};
  const int vsv[3] = {vsb, vsh, vst}, osv[3] = {osb, osh, ost};
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = qsv[i];
    a.ks[i] = ksv[i];
    a.vs[i] = vsv[i];
    a.os[i] = osv[i];
  }
  a.scale = scale;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(a, st) : launch<float>(a, st);
}

}  // extern "C"
