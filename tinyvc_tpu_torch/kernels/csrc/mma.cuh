// Warp-level tensor-core products and asynchronous copies (sm_80 and up),
// each in one small helper so that a host model of the same fragment layouts
// can stand in for them.
//
// mma.sync m16n8k16, bf16 operands, fp32 accumulators; with g = lane / 4 and
// t = lane % 4 a lane holds
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k-major):    b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C, D (16 x 8):          c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// two bf16 values to a 32-bit register, the lower index in the low half.
// ldmatrix .x4: lanes 8m..8m+7 give the addresses of matrix m's eight rows
// (16 bytes each); register m of lane l receives row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1, of matrix m, or with .trans the elements
// [2 (l % 4)][l / 4] and [2 (l % 4) + 1][l / 4].
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += a b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, or 16 zero bytes where !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n of this thread's committed groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
