// Hopper (sm_90a) primitives shared by the tensor-core kernels of this
// package: asynchronous 16-byte copies into shared memory (cp.async),
// ldmatrix, the warp-level bf16 product mma.sync.m16n8k16 with f32
// accumulators and the int8 product mma.sync.m16n8k32 with int32 ones.
//
// Users: ln_matmul.cu (K6), attention_mma.cuh (K1-K4), quant_matmul.cu (K5).
//
// Fragment layouts of mma.sync.m16n8k16, with g = lane / 4 and t = lane % 4
// (each register holds two bf16 values, or one f32):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)      a1 (g+8, 2t..2t+1)
//                      a2 (g, 2t+8..2t+9)    a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, f32):   c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// so the accumulators of two neighbouring 8-column blocks of one product,
// rounded to bf16 and packed, are the A operand of the next product over
// those 16 columns. mma.sync.m16n8k32 with int8 operands (four to a
// register) puts the same bytes in the same registers: A (16 x 32 int8) is
// the 16 x 16 bf16 block above read as bytes, B (32 x 8) holds bytes
// 4t..4t+3 and 16+4t..16+4t+3 of column g, and C (int32) is laid out as the
// f32 one. So with both operands stored K-contiguous, one ldmatrix_x4
// (8 x 8 b16 blocks = 8 rows of 16 bytes) loads either fragment.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` of this thread's newest groups are in flight
template <int Pending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 blocks from shared memory into mma.sync's operand layout;
// lane l passes the address of row l % 8 of block l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 operands, int32 accumulator;
// the sum is exact (no saturation is needed below 2^31)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

}  // namespace
