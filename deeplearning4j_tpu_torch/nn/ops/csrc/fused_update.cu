// One-pass Adam update for Hopper (sm_90a), bound to Python through a plain
// C interface (ctypes; see ../build.py and ../fused_update.py).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   deeplearning4j_tpu/nn/ops/fused_update.py _adam_kernel (pallas_call in fused_adam_apply)
//
// Over a flat f32 group of the ZeRO-1 sharded update (the rank's chunk of
// one (updater, dtype) group, ../../../parallel/zero.py) it computes
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p' = p - (alpha*m') / (sqrt(v') + eps)
// with alpha = lr*sqrt(1-b2^t)/(1-b1^t) computed on the host by the same
// scalar pipeline as the eager updater (updaters.Adam.alpha). Two entries:
// dl4j_fused_adam takes alpha by value; dl4j_fused_adam_dev reads it from a
// device pointer, the one f32 a bundled train step's CUDA graph reads for
// its step (the host writes each step's alpha there before a replay).
//
// Bit-exactness. The contract is torch.equal against the port's eager
// Adam.apply on the card (p, m and v, the zero padding lanes included), as
// the reference's probe asserts array_equal. Eager torch rounds every
// operation on its own: each product, sum, square root and quotient below is
// an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fsqrt_rn, __fdiv_rn), which nvcc never contracts into an FMA, in torch's
// order of evaluation: ((1-b2)*g)*g left to right, alpha*m' before the
// division. The scalars arrive as torch hands Python floats to its f32
// kernels: 1-b1, 1-b2 and eps are computed in double by the caller and
// rounded once to f32 (not 1.0f - b1f), alpha is the f32 value itself.
// Zero lanes stay zero: g = m = v = 0 gives 0 / (0 + eps) = 0.
//
// Bound on an H100: bytes. Each element reads p, g, m, v and writes p', m',
// v': 28 bytes for ~10 flops, far below the card's ~20 flops per byte; at
// ResNet-50's 25.6 M parameters that is 0.72 GB, ~0.21 ms at 3.35 TB/s.
//
// Design. One flat pass, grid-stride: each thread takes 16-byte vectors
// (four elements) when all seven pointers are 16-byte aligned, else single
// elements; the ragged tail past the last whole vector is masked, nothing is
// padded. The grid is capped by the caller at a few blocks per SM. Each
// element is read and written by one thread only, so the outputs may alias
// the inputs (no __restrict__, no read-only cache loads); the wrapper hands
// fresh outputs, because the reference's update is functional and the
// caller's state must not change under it. No atomics, no reductions: two
// runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;  // floats per 16-byte vector

struct Scalars {
  float alpha, b1, c1, b2, c2, eps;  // c1 = f32(1 - b1), c2 = f32(1 - b2)
};

__device__ __forceinline__ void adam(float p, float g, float m, float v, const Scalars& s,
                                     float& po, float& mo, float& vo) {
  const float mn = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  const float vn = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.c2, g), g));
  const float upd = __fdiv_rn(__fmul_rn(s.alpha, mn), __fadd_rn(__fsqrt_rn(vn), s.eps));
  po = __fsub_rn(p, upd);
  mo = mn;
  vo = vn;
}

__device__ __forceinline__ void adam_at(const float* p, const float* g, const float* m,
                                        const float* v, float* po, float* mo, float* vo,
                                        long long i, const Scalars& s) {
  float a, b, c;
  adam(p[i], g[i], m[i], v[i], s, a, b, c);
  po[i] = a;
  mo[i] = b;
  vo[i] = c;
}

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(const float* p, const float* g, const float* m, const float* v, float* po,
                  float* mo, float* vo, long long n, int vectorized, Scalars s,
                  const float* alpha_ptr) {
  if (alpha_ptr != nullptr) s.alpha = *alpha_ptr;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  long long done = 0;
  if (vectorized) {
    const long long n4 = n / VEC;
    for (long long j = first; j < n4; j += stride) {
      const float4 P = reinterpret_cast<const float4*>(p)[j];
      const float4 G = reinterpret_cast<const float4*>(g)[j];
      const float4 M = reinterpret_cast<const float4*>(m)[j];
      const float4 V = reinterpret_cast<const float4*>(v)[j];
      float4 Po, Mo, Vo;
      adam(P.x, G.x, M.x, V.x, s, Po.x, Mo.x, Vo.x);
      adam(P.y, G.y, M.y, V.y, s, Po.y, Mo.y, Vo.y);
      adam(P.z, G.z, M.z, V.z, s, Po.z, Mo.z, Vo.z);
      adam(P.w, G.w, M.w, V.w, s, Po.w, Mo.w, Vo.w);
      reinterpret_cast<float4*>(po)[j] = Po;
      reinterpret_cast<float4*>(mo)[j] = Mo;
      reinterpret_cast<float4*>(vo)[j] = Vo;
    }
    done = n4 * VEC;
  }
  for (long long i = done + first; i < n; i += stride) adam_at(p, g, m, v, po, mo, vo, i, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// alpha_ptr null: alpha by value; else the kernel reads alpha there
int launch_adam(const void* p, const void* g, const void* m, const void* v, void* po, void* mo,
                void* vo, int n, int max_blocks, float alpha, const float* alpha_ptr, float b1,
                float c1, float b2, float c2, float eps, void* stream) {
  if (n <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) &&
                   aligned16(po) && aligned16(mo) && aligned16(vo);
  const long long items = vec ? ((long long)n + VEC - 1) / VEC : (long long)n;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  const Scalars s{alpha, b1, c1, b2, c2, eps};
  fused_adam_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g), static_cast<const float*>(m),
      static_cast<const float*>(v), static_cast<float*>(po), static_cast<float*>(mo),
      static_cast<float*>(vo), (long long)n, vec ? 1 : 0, s, alpha_ptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 0 -> threads per block, 1 -> floats per vector
int dl4j_fused_adam_tile(int which) { return which == 0 ? THREADS : VEC; }

// p, g, m, v (n,) f32 -> p', m', v' (n,) f32, any of which may alias its
// input. max_blocks caps the grid (the caller passes a few blocks per SM).
int dl4j_fused_adam(const void* p, const void* g, const void* m, const void* v, void* po,
                    void* mo, void* vo, int n, int max_blocks, float alpha, float b1, float c1,
                    float b2, float c2, float eps, void* stream) {
  return launch_adam(p, g, m, v, po, mo, vo, n, max_blocks, alpha, nullptr, b1, c1, b2, c2, eps,
                     stream);
}

// The same update with alpha read from the device: alpha points to one f32
// on the card, read by every thread when the kernel runs (a captured CUDA
// graph replays this launch with whatever the host copied there since).
int dl4j_fused_adam_dev(const void* p, const void* g, const void* m, const void* v,
                        const void* alpha, void* po, void* mo, void* vo, int n, int max_blocks,
                        float b1, float c1, float b2, float c2, float eps, void* stream) {
  return launch_adam(p, g, m, v, po, mo, vo, n, max_blocks, 0.0f,
                     static_cast<const float*>(alpha), b1, c1, b2, c2, eps, stream);
}

}  // extern "C"
