// What the tensor-core instances (ftp_dense.cu's, ftp_bsr.cu's and
// flash_mha.cu's `tc`) share: the FTP ring's stage depth, the cp.async,
// ldmatrix and mma.sync wrappers (flash_mha.cu takes only these) and the
// pair of bf16 {0,1} values the warpgroup MMA's A fragments are built from
// (ftp_wgmma.cuh).
//
// The product is the reference's own (_unpack_fold): T {0,1} planes stacked
// into MMA rows against a (k, n) weight tile, bf16 operands with f32
// accumulation, exact per product.  Bit t of word (m, k) becomes bf16 1.0
// (0x3F80) or 0 in a register, so no unpacked plane reaches memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftp {
namespace tc {

constexpr int kBK = 64;  // K depth of one ring stage
constexpr uint32_t kOneBf16 = 0x3F80u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy; bytes past src_bytes (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two bf16 {0,1} values in one register: bit `sh` of w0 (low half) and of
// w1 (high half), or zeros when the row's plane is dead (live == 0).
__device__ __forceinline__ uint32_t plane_pair(uint32_t w0, uint32_t w1,
                                               int sh, uint32_t live) {
  return (((w0 >> sh) & live) | (((w1 >> sh) & live) << 16)) * kOneBf16;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Four 8 x 8 b16 matrices, not transposed: lane l gives the address of
// row l % 8 of matrix l / 8 and receives (row l / 4, columns 2 (l % 4),
// 2 (l % 4) + 1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tc
}  // namespace ftp
