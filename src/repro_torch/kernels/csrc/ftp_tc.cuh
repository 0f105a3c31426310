// What the tensor-core instances (ftp_dense.cu's, ftp_bsr.cu's and
// flash_mha.cu's `tc`) share: the FTP ring's stage geometry, the cp.async,
// ldmatrix and mma.sync wrappers (flash_mha.cu takes only these), the A
// fragments built from spike words, the B fragments of a stage's weight
// tile and the sum of a cluster's partial tiles in ascending rank order.
//
// The product is the reference's own (_unpack_fold): T {0,1} planes stacked
// into MMA rows r = t * bm + m against a (k, n) weight tile, bf16 operands
// with f32 accumulation, exact per product.  Bit t of word (m, k) becomes
// bf16 1.0 (0x3F80) or 0 in a register, so no unpacked plane reaches
// memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftp {
namespace tc {

constexpr int kBN = 64;           // output columns per block
constexpr int kBK = 64;           // K depth of one ring stage
constexpr int kStages = 4;        // ring depth
constexpr int kWPitch = kBN + 8;  // bf16 per weight row: 144 B, ldmatrix conflict-free
constexpr int kAPitch = kBK + 8;  // words per spike row: 288 B
constexpr int kPPitch = kBN + 4;  // floats per row of the partial-sum tile
constexpr int kMaxSplits = 8;     // a portable cluster
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

// B fragments of the 2 * NP n8 tiles from n8 tile 2 * p0 on, for the k16
// step ks of a (kBK x kWPitch) weight tile in shared memory.
template <int NP>
__device__ __forceinline__ void b_frags(uint32_t (&bf)[2 * NP][2],
                                        const __nv_bfloat16* ws, int ks,
                                        int p0, int lane) {
  const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, ws + kr * kWPitch + (p0 + p) * 16 + (lane >> 4) * 8);
    bf[2 * p][0] = r[0];
    bf[2 * p][1] = r[1];
    bf[2 * p + 1][0] = r[2];
    bf[2 * p + 1][1] = r[3];
  }
}

// A fragment of one m16 tile for the k16 step at words lo / hi (the rows g
// and g + 8 of the tile, offset to the step's column c2): the planes sh_lo
// and sh_hi of those words, zero where the plane is dead.
__device__ __forceinline__ void a_frag(uint32_t (&af)[4], const int32_t* lo,
                                       const int32_t* hi, int sh_lo,
                                       int sh_hi, uint32_t live_lo,
                                       uint32_t live_hi) {
  const int2 lo0 = *reinterpret_cast<const int2*>(lo);
  const int2 lo8 = *reinterpret_cast<const int2*>(lo + 8);
  const int2 hi0 = *reinterpret_cast<const int2*>(hi);
  const int2 hi8 = *reinterpret_cast<const int2*>(hi + 8);
  af[0] = plane_pair(lo0.x, lo0.y, sh_lo, live_lo);
  af[1] = plane_pair(hi0.x, hi0.y, sh_hi, live_hi);
  af[2] = plane_pair(lo8.x, lo8.y, sh_lo, live_lo);
  af[3] = plane_pair(hi8.x, hi8.y, sh_hi, live_hi);
}

// The full sums x[t] (t < T) of spike row m, column n: the cluster's S
// partial tiles (rows t * bm + m, pitch kPPitch) added in ascending rank
// order, so the order is fixed by S alone.
__device__ __forceinline__ void rank_sum(float (&x)[32],
                                         const float* const* parts, int S,
                                         int T, int bm_shift, int m, int n) {
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    x[t] = 0.f;
    if (t < T) {
      const int at = ((t << bm_shift) + m) * kPPitch + n;
      float v = parts[0][at];
#pragma unroll
      for (int q = 1; q < kMaxSplits; ++q)
        if (q < S) v = __fadd_rn(v, parts[q][at]);
      x[t] = v;
    }
  }
}

}  // namespace tc
}  // namespace ftp
