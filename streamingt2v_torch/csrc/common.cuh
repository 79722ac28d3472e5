// Shared device helpers for the hand-written Hopper kernels.
//
// The simple kernels compute their matrix products through `mma_tile`: a warp
// multiplies a 16-row tile of A by an 8-column tile of B, both held in shared
// memory, and accumulates into four f32 registers per lane laid out as the
// accumulator of `mma.sync.m16n8k16`:
//
//   lane = 4*g + t holds C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
//
// A is row-major with row stride `lda`; B is given transposed (Bt, one row per
// output column, the contraction axis contiguous) with row stride `ldb`.
// bf16 operands go to the tensor cores (mma.sync, f32 accumulation); f32
// operands run the same tile on the FMA units in full f32 (no TF32), so a
// kernel body is written once for both types.
//
// The pipelined kernels (the bf16 bodies of K1/K2 at D=64 and D=512, K3, K4
// and K6 at D=64) hold their fragments in registers instead: `ldmatrix`
// fills A and B fragments from shared memory (`.trans` for a B stored with
// the contraction axis as rows), `mma_bf16` multiplies them, and
// `cp_async_16` stages tiles into shared memory ahead of use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace st2v {

typedef __nv_bfloat16 bf16;

// Shared-memory rows are padded by 16 bytes so that the 8 row groups of a
// fragment load fall into distinct banks.
template <typename T> struct RowPad;
template <> struct RowPad<float> { static constexpr int value = 4; };
template <> struct RowPad<bf16> { static constexpr int value = 8; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// c += A (16x16, four b16x2 registers) * B (16x8, two), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
// Lane 4g+t receives, of matrix i, row g columns 2t and 2t+1 (with `.trans`:
// rows 2t and 2t+1 of column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared, asynchronously; zeros when `pred` is false (the
// source is then not read).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tile(float c[4], const bf16* A, int lda,
                                         const bf16* Bt, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * lda + 2 * t;
  const bf16* a_hi = a_lo + 8 * lda;
  const bf16* b = Bt + g * ldb + 2 * t;
  for (int k = 0; k < K; k += 16) {
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(a_lo + k),
                           *reinterpret_cast<const uint32_t*>(a_hi + k),
                           *reinterpret_cast<const uint32_t*>(a_lo + k + 8),
                           *reinterpret_cast<const uint32_t*>(a_hi + k + 8)};
    mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(b + k),
             *reinterpret_cast<const uint32_t*>(b + k + 8));
  }
}

__device__ __forceinline__ void mma_tile(float c[4], const float* A, int lda,
                                         const float* Bt, int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = A + g * lda;
  const float* a_hi = a_lo + 8 * lda;
  const float* b_lo = Bt + (2 * t) * ldb;
  const float* b_hi = b_lo + ldb;
  for (int k = 0; k < K; ++k) {
    const float x0 = a_lo[k], x1 = a_hi[k], y0 = b_lo[k], y1 = b_hi[k];
    c[0] = fmaf(x0, y0, c[0]);
    c[1] = fmaf(x0, y1, c[1]);
    c[2] = fmaf(x1, y0, c[2]);
    c[3] = fmaf(x1, y1, c[3]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- wgmma (K3's GEMM core, the flash D=512 body's S = Q K^T) ----

// A tile of rows x 64 bf16 (128 bytes a row) in the 128-byte swizzle that
// wgmma reads: row r's 16-byte chunk c at byte r * 128 + ((c ^ (r % 8)) * 16),
// in atoms of 8 rows (1024 bytes, aligned to 1024), so the 8 rows of a core
// matrix fall into distinct banks.
__host__ __device__ constexpr int sw128_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// K-major, 128-byte swizzle: 8-row atoms 1024 bytes apart (SBO); a k16 slice
// starts 32 bytes further along the row.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t smem_addr) {
  return uint64_t((smem_addr >> 4) & 0x3FFF) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// all but the newest N committed groups of products are done
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators are read only after the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// this thread's landed cp.async copies (generic proxy) become visible to
// wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Opt in to more than 48 KB of dynamic shared memory, then report the first
// error of the launch sequence (0 when the kernel was accepted).
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace st2v
