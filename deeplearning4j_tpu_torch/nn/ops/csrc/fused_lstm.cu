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
// Only h' and c' leave the kernel: z and the gates live in registers.
//
// Types. Each operand keeps the type it arrives in: x (TX), the weights
// Wx/Wh/b/pI/pF/pO (TW) and the carries h/c (TS) are each f32 or bf16
// (under compute_dtype="bfloat16" the reference feeds bf16 x and weights
// with f32 carries). bf16 widens exactly; every product and sum is an f32
// FMA on the CUDA cores (no TF32, no tensor cores); the gate chain runs in
// f32 with expf/tanhf; h' and c' are rounded once, to bf16 when x, the
// weights and the carries are all bf16, else stored as f32 (the type JAX's
// promotion gives the reference's outputs).
//
// Bound on an H100: at the serving shapes (B = 1 per prefill step, B = the
// slot count per decode step; n_in = 77 or 256, n = 256) the cell reads the
// (n_in + n) x 4n weights once per row tile and does 4 B (n_in + n) n FMAs:
// counted once, the weight bytes bound it up to about 40 rows and the f32
// FMAs above (PERF.md has both terms). Launch latency dominates at these
// sizes: the grid is ceil(n / 64) x ceil(B / 8) blocks, 4..32 blocks on
// 132 SMs.
//
// Design. A block of 64 threads owns 64 hidden units [j0, j0 + 64) and 8
// rows [r0, r0 + 8): each thread keeps the four gate sums of its unit for
// the 8 rows in registers (32 accumulators), so the four gates of one unit
// never leave the thread and the epilogue runs the whole gate chain. The
// rows of [x | h] are staged in shared memory, 128 depths per step, widened
// to f32 and read as broadcasts; the weights are read in place, row-major
// (K, 4n), one coalesced load per gate and depth across the block's 64
// units; the depth loop is unrolled by 4 so that 16 weight loads are in
// flight per thread. Nothing is packed or padded per call: ragged B, n_in
// and n are masked inside the kernel.
//
// Batch invariance. A row's sums run over k = 0 .. n_in + n - 1 in order,
// one FMA each, whatever the batch and whichever block the row lands in; no
// sum crosses rows. So a row's h' and c' are the same bits at B = 1 and at
// B = 32 (the generation engine's "a slot among others == the slot alone").

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 64;   // hidden units per block, one per thread
constexpr int ROWS = 8;     // rows per block (per-thread register tile)
constexpr int KS = 128;     // depths of [x | h] staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

template <typename TX, typename TW, typename TS, typename TO, bool PEEP>
__global__ void __launch_bounds__(UNITS)
lstm_cell_kernel(const TX* __restrict__ x, const TS* __restrict__ h, const TS* __restrict__ c,
                 const TW* __restrict__ wx, const TW* __restrict__ wh, const TW* __restrict__ b,
                 const TW* __restrict__ p_i, const TW* __restrict__ p_f,
                 const TW* __restrict__ p_o, TO* __restrict__ h_out, TO* __restrict__ c_out,
                 int B, int n_in, int n) {
  __shared__ float xs[ROWS][KS];

  const int tid = threadIdx.x;
  const int j = blockIdx.x * UNITS + tid;
  const int r0 = blockIdx.y * ROWS;
  const int K = n_in + n;
  const long long n4 = 4LL * n;
  const bool live = j < n;

  float acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
  }

  for (int kb = 0; kb < K; kb += KS) {
    const int nk = min(KS, K - kb);
    __syncthreads();  // every thread is done reading the previous step's xs
    for (int i = tid; i < ROWS * KS; i += UNITS) {
      const int r = i / KS;
      const int kk = i % KS;
      const int k = kb + kk;
      const int row = r0 + r;
      float v = 0.f;
      if (row < B && kk < nk) {
        v = k < n_in ? to_f32(x[(long long)row * n_in + k])
                     : to_f32(h[(long long)row * n + (k - n_in)]);
      }
      xs[r][kk] = v;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const int k = kb + kk;
        const TW* w = k < n_in ? wx + (long long)k * n4 : wh + (long long)(k - n_in) * n4;
        const float w0 = to_f32(w[j]);
        const float w1 = to_f32(w[n + j]);
        const float w2 = to_f32(w[2 * n + j]);
        const float w3 = to_f32(w[3 * n + j]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = xs[r][kk];
          acc[r][0] = fmaf(xv, w0, acc[r][0]);
          acc[r][1] = fmaf(xv, w1, acc[r][1]);
          acc[r][2] = fmaf(xv, w2, acc[r][2]);
          acc[r][3] = fmaf(xv, w3, acc[r][3]);
        }
      }
    }
  }
  if (!live) return;

  const float bi = to_f32(b[j]);
  const float bf = to_f32(b[n + j]);
  const float bo = to_f32(b[2 * n + j]);
  const float bg = to_f32(b[3 * n + j]);
  float pi = 0.f, pf = 0.f, po = 0.f;
  if (PEEP) {
    pi = to_f32(p_i[j]);
    pf = to_f32(p_f[j]);
    po = to_f32(p_o[j]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = r0 + r;
    if (row >= B) break;
    const long long at = (long long)row * n + j;
    const float cv = to_f32(c[at]);
    const float zi = acc[r][0] + bi;
    const float zf = acc[r][1] + bf;
    const float zo = acc[r][2] + bo;
    const float zg = acc[r][3] + bg;
    float ig, fg, og, cn;
    const float gg = tanhf(zg);
    if (PEEP) {
      ig = sigmoid(zi + pi * cv);
      fg = sigmoid(zf + pf * cv);
      cn = fg * cv + ig * gg;
      og = sigmoid(zo + po * cn);
    } else {
      ig = sigmoid(zi);
      fg = sigmoid(zf);
      og = sigmoid(zo);
      cn = fg * cv + ig * gg;
    }
    store(h_out + at, og * tanhf(cn));
    store(c_out + at, cn);
  }
}

template <typename TX, typename TW, typename TS, typename TO>
int launch(const void* x, const void* h, const void* c, const void* wx, const void* wh,
           const void* b, const void* p_i, const void* p_f, const void* p_o, void* h_out,
           void* c_out, int B, int n_in, int n, bool peep, cudaStream_t s) {
  const dim3 grid((n + UNITS - 1) / UNITS, (B + ROWS - 1) / ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const TX* xb = static_cast<const TX*>(x);
  const TS* hb = static_cast<const TS*>(h);
  const TS* cb = static_cast<const TS*>(c);
  const TW* wxb = static_cast<const TW*>(wx);
  const TW* whb = static_cast<const TW*>(wh);
  const TW* bb = static_cast<const TW*>(b);
  const TW* pib = static_cast<const TW*>(p_i);
  const TW* pfb = static_cast<const TW*>(p_f);
  const TW* pob = static_cast<const TW*>(p_o);
  TO* ho = static_cast<TO*>(h_out);
  TO* co = static_cast<TO*>(c_out);
  if (peep) {
    lstm_cell_kernel<TX, TW, TS, TO, true><<<grid, UNITS, 0, s>>>(
        xb, hb, cb, wxb, whb, bb, pib, pfb, pob, ho, co, B, n_in, n);
  } else {
    lstm_cell_kernel<TX, TW, TS, TO, false><<<grid, UNITS, 0, s>>>(
        xb, hb, cb, wxb, whb, bb, pib, pfb, pob, ho, co, B, n_in, n);
  }
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// tile sizes: 0 -> hidden units per block, 1 -> rows per block,
// 2 -> depths of [x | h] staged per step
int dl4j_fused_lstm_tile(int which) { return which == 0 ? UNITS : which == 1 ? ROWS : KS; }

// x (b, n_in), h and c (b, n), wx (n_in, 4n), wh (n, 4n), b (4n,), and with
// peephole = 1 p_i, p_f, p_o (n,) -> h_out, c_out (b, n). x_bf16, w_bf16,
// s_bf16 give the types of x, of the weights (wx, wh, b and the peepholes)
// and of the carries (h, c): 0 f32, 1 bf16. The outputs are bf16 when all
// three are bf16, else f32.
int dl4j_fused_lstm_cell(const void* x, const void* h, const void* c, const void* wx,
                         const void* wh, const void* b, const void* p_i, const void* p_f,
                         const void* p_o, void* h_out, void* c_out, int batch, int n_in, int n,
                         int x_bf16, int w_bf16, int s_bf16, int peephole, void* stream) {
  if (batch <= 0 || n_in <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (peephole && (p_i == nullptr || p_f == nullptr || p_o == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pe = peephole != 0;
  const int code = (x_bf16 ? 4 : 0) | (w_bf16 ? 2 : 0) | (s_bf16 ? 1 : 0);
#define DL4J_LSTM(TX, TW, TS, TO) \
  launch<TX, TW, TS, TO>(x, h, c, wx, wh, b, p_i, p_f, p_o, h_out, c_out, batch, n_in, n, pe, s)
  switch (code) {
    case 0: return DL4J_LSTM(float, float, float, float);
    case 1: return DL4J_LSTM(float, float, bf16, float);
    case 2: return DL4J_LSTM(float, bf16, float, float);
    case 3: return DL4J_LSTM(float, bf16, bf16, float);
    case 4: return DL4J_LSTM(bf16, float, float, float);
    case 5: return DL4J_LSTM(bf16, float, bf16, float);
    case 6: return DL4J_LSTM(bf16, bf16, float, float);
    default: return DL4J_LSTM(bf16, bf16, bf16, bf16);
  }
#undef DL4J_LSTM
}

}  // extern "C"
