// Hopper (sm_90a) building blocks of the flash-attention kernels, the fused
// conv kernels and the int8 matmul: mbarriers, TMA tile loads, transposed
// ldmatrix, wgmma descriptors and instructions, and the host-side encoding
// of a head-split operand, a row-major matrix (bf16 or int8) or a stack of
// them as a TMA tensor map.
//
// Shared-memory tiles are 128-byte swizzled rows of 64 bf16 (the layout TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with layout type 1):
// a tile of R rows and 64 columns is R x 128 bytes, 1024-byte aligned; a
// head dim of 128 is two such column panels, one after the other. Such a
// tile is read by wgmma either K-major (the 64 columns are the product's
// depth: Q and K in Q.K^T) or MN-major (the columns are the output's N: V in
// P.V), see desc_kmajor and desc_mnmajor.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -----------------------------------------------------------------------
// where the time, head and batch coordinates of a head map sit (1..3; the
// column is coordinate 0)
struct MapPos {
  int t, h, b;
};

// one box of a head map (64 columns from `col`, the box's rows from `row`,
// of one head) into dst, completing on bar
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int col, int row, int head, int batch,
                                              MapPos pos) {
  const auto pick = [&](int i) { return pos.t == i ? row : pos.h == i ? head : batch; };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(pick(1)),
      "r"(pick(2)), "r"(pick(3))
      : "memory");
}

// one box of a row-major matrix map (64 columns from `col`, the box's rows
// from `row`) into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// one box of a stacked-matrix map (64 columns from `col`, the box's rows
// from `row`, of matrix `mat`) into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row, int mat) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(mat)
      : "memory");
}

// one box of a row-major matrix map stored from src (shared memory, in the
// map's swizzled layout); out-of-bounds rows and columns are not written.
// Before it: fence_proxy_async() by every thread that wrote src, then a
// barrier; after it: tma_store_commit(), and tma_store_wait_read() before
// src is reused or the block exits.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// makes this thread's generic writes to shared memory visible to the async
// proxy (TMA stores, wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) into dst,
// completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------------
// A shared-memory matrix descriptor of a 128-byte swizzled tile (layout type
// 1). K-major: the 8-row groups of the M or N extent are 1024 bytes apart
// (sbo), the 16 columns of one k-step start at p. MN-major: p is the first
// of the k-step's 16 rows; 8-row groups along K are 1024 bytes apart (sbo),
// 64-column panels along N `panel` bytes apart (lbo).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* p) {
  return desc_sw128(p, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const __nv_bfloat16* p, uint32_t panel) {
  return desc_sw128(p, panel, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a barrier among `threads` threads of the block (a multiple of 32): the
// consumer warpgroups meet on it once the producer warp has left
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's register budget, moved at run time (every warp of the
// warpgroup executes it): the producer gives registers back, the consumers
// take them
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// the 32-bit word (two bf16 columns) at row r, 16-byte chunk `chunk` (0..7)
// and word w (0..3) of a 128-byte swizzled tile: TMA's SWIZZLE_128B puts
// chunk j of row r at chunk j ^ (r % 8)
__device__ __forceinline__ uint32_t sw128_word(const unsigned char* tile, int r, int chunk,
                                               int w) {
  return *reinterpret_cast<const uint32_t*>(tile + r * 128 + ((chunk ^ (r & 7)) << 4) + 4 * w);
}

// four 8x8 bf16 matrices of shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes); register j of thread t
// gets elements (2(t%4), t/4) and (2(t%4)+1, t/4) of matrix j (stored row,
// column), the first in the low half. Read from a tile whose rows are the
// product's depth, that is wgmma's register A of the tile's transpose.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// max(u, 0) that keeps a NaN, as torch.maximum does, in one instruction
__device__ __forceinline__ float relu_nan(float u) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(u));
  return r;
}

// exp(x) as the hardware's exp2 of x log2(e), denormals flushed (one MUFU
// instruction: __expf adds a denormal fix-up of four more around it)
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// two f32 rounded to a bf16 pair (lo: the lower column), as one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Register layouts (m64nNk16, thread t of the warpgroup, warp w = t / 32,
// g = (t % 32) / 4, c = t % 4). Accumulator: rows 16w + g (slot 0) and
// 16w + g + 8 (slot 1); d[4i + 2 slot + e] is column 8i + 2c + e. A from
// registers, k-step kk: a[0] = (slot 0, cols 16kk + 2c, +1), a[1] = (slot 1,
// the same cols), a[2] and a[3] the same 8 columns on. So the accumulator of
// one product, rounded in pairs, is the A operand of the next:
//   a[kk] = {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
//            pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])}.
// TB: 0 when B is K-major, 1 when it is MN-major.

// D (64 x 32) += A (64 x 16, shared memory) . B (16 x 32, shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 64) += A (64 x 16, shared memory) . B (16 x 64, shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 32) += A (64 x 16, registers) . B (16 x 32, shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 128) += A (64 x 16, shared memory) . B (16 x 128, shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared memory)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// ---- host: launches ---------------------------------------------------------------
// the kernel's dynamic shared memory above 48 KB, asked for once per device:
// `done` is the caller's own flags, one array per kernel instantiation (two
// instantiations of a kernel template share a function type, so the flags
// cannot be keyed on it)
template <typename K>
int opt_in_smem(K* kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

// ---- host: tensor maps -------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda)
inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a failed encoding: 1000 + the driver's CUresult (apart from cudaError_t)
constexpr int MAP_ERROR = 1000;

struct HeadMap {
  CUtensorMap map;
  MapPos pos;
};

// A bf16 operand of shape (b, h, T, d) read through its element strides
// (batch, head, time; d unit-stride) as a 4-D tensor map: d first, then the
// three others ordered by stride (a dimension of size 1 last), boxes of 64
// columns by `rows` rows of one head, 128-byte swizzled, zero-filled out of
// bounds (the padding of d up to 64 or 128 and of rows past T). The caller
// has checked what TMA needs: a 16-byte aligned base and strides that are
// multiples of 8 elements. Returns 0 or MAP_ERROR + the driver's code.
inline int encode_heads(HeadMap* out, const void* base, int d, int T, int h, int b,
                        long long sb, long long sh, long long st, int rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return MAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  struct Dim {
    long long size, stride;
    int which;  // 0 time, 1 head, 2 batch
  } dims[3] = {{T, st, 0}, {h, sh, 1}, {b, sb, 2}};
  long long span = d;
  for (const Dim& x : dims) span = std::max(span, x.size > 1 ? x.size * x.stride : 0);
  for (Dim& x : dims) {
    if (x.size == 1) x.stride = (span + 7) / 8 * 8;  // any aligned stride past the data
  }
  std::stable_sort(dims, dims + 3, [](const Dim& x, const Dim& y) {
    return (x.size == 1) != (y.size == 1) ? y.size == 1 : x.stride < y.stride;
  });
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3] = {0, 0, 0};
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = static_cast<cuuint64_t>(dims[i].size);
    gstride[i] = static_cast<cuuint64_t>(dims[i].stride) * 2;
    if (dims[i].which == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
    pos[dims[i].which] = i + 1;
  }
  out->pos = MapPos{pos[0], pos[1], pos[2]};
  const CUresult r = encode(&out->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(base), gdim, gstride, box, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

// A row-major bf16 matrix (rows x cols, row stride `stride` elements) as a
// 2-D tensor map: boxes of 64 columns by `box_rows` rows, 128-byte swizzled,
// zero-filled out of bounds. The caller has checked a 16-byte aligned base
// and a stride that is a multiple of 8. Returns 0 or MAP_ERROR + the
// CUresult.
inline int encode_rows(CUtensorMap* out, const void* base, int cols, int rows,
                       long long stride, int box_rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return MAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t gdim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t gstride[1] = {static_cast<cuuint64_t>(stride) * 2};
  cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

// A row-major int8 matrix (rows x cols, row stride `stride` bytes) as a 2-D
// tensor map: boxes of 128 columns (128 bytes) by `box_rows` rows, 128-byte
// swizzled (byte c of row r lands in 16-byte chunk (c / 16) ^ (r % 8) of the
// box's row r), zero-filled out of bounds. The caller has checked a 16-byte
// aligned base and a stride that is a multiple of 16. Returns 0 or
// MAP_ERROR + the CUresult.
inline int encode_bytes(CUtensorMap* out, const void* base, int cols, int rows,
                        long long stride, int box_rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return MAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t gdim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t gstride[1] = {static_cast<cuuint64_t>(stride)};
  cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

// `mats` row-major bf16 matrices stored one after the other (rows x cols
// each, row stride `stride` elements, matrix stride rows * stride) as a 3-D
// tensor map: boxes of 64 columns by `box_rows` rows of one matrix,
// 128-byte swizzled, zero-filled past cols and rows, so a box never reads
// into the next matrix. The caller has checked a 16-byte aligned base and a
// stride that is a multiple of 8. Returns 0 or MAP_ERROR + the CUresult.
inline int encode_stack(CUtensorMap* out, const void* base, int cols, int rows, int mats,
                        long long stride, int box_rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return MAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t gdim[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(mats)};
  cuuint64_t gstride[2] = {static_cast<cuuint64_t>(stride) * 2,
                           static_cast<cuuint64_t>(stride) * rows * 2};
  cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

}  // namespace hopper
