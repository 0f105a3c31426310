// Hopper's asynchronous building blocks for the tensor-core FTP kernels
// (the `tc` instances of ftp_dense.cu and ftp_bsr.cu): mbarriers, the 2D TMA
// load and the host's tensor map, the cluster and named barriers, register
// hand-over between warpgroups (setmaxnreg), and the warpgroup MMA (64 or 128
// columns) with A in registers and B an MN-major bf16 tile in shared memory
// with 128-byte swizzle.
//
// B's layout is the one a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes
// for a (K, N) row-major weight: boxes of 64 columns (128 bytes, the
// swizzle span) by kBK rows, 128 bytes a row, 8 rows a 1024-byte swizzle
// atom.  In the matrix descriptor of an MN-major operand the leading byte
// offset is the stride between 64-column boxes and the stride byte offset
// the stride between 8-row groups along K; bf16 wgmma takes such a B
// (N contiguous) with its transpose flag set, so the weight needs no
// transpose pass.
//
// A comes from registers in the mma.m16n8k16 A layout: warp w of the
// warpgroup owns rows 16 w .. 16 w + 15 of the 64, and ftp_tc.cuh's
// plane_pair builds it from spike words (a_frag_planes below).  The
// accumulator of m64nNk16 has the m16n8 layout repeated: d[4 j + e] is row
// 16 w + lane / 4 (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + (e & 1).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ftp_tc.cuh"

namespace ftp {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// one arrival, made when every cp.async this thread issued so far has
// landed (counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// the box at (c0 inner, c1 outer) of `map` into `dst`, completing on `bar`;
// elements outside the tensor arrive as zeros and count as bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Host: cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda).  Errors come back as kDriverError + the CUresult, or the runtime's
// own code when the entry point is missing.
constexpr int kDriverError = 100000;

// A 2D tensor map with 128-byte swizzle: `inner` x `outer` elements of
// `type`, rows `row_bytes` apart, loaded in boxes of box_inner x box_outer.
inline int encode_2d_b128(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, uint64_t inner, uint64_t outer,
                          uint64_t row_bytes, uint32_t box_inner,
                          uint32_t box_outer) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  static cudaError_t found = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q != cudaDriverEntryPointSuccess)
      e = cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
    return e;
  }();
  if (found != cudaSuccess) return (int)found;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kDriverError + (int)r;
}

// ---- barriers and distributed shared memory ----------------------------------

// every thread of every block of the cluster; needs no warp convergence
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}
// the shared::cluster address of `saddr` (this block's shared memory) in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t saddr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(saddr), "r"(rank));
  return out;
}
// 16 bytes of distributed shared memory (a 16-byte aligned address)
__device__ __forceinline__ float4 ld_cluster_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
// named barrier `id` over `threads` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// The registers a thread of this warpgroup may hold: down for a producer,
// up for consumers.  An increase waits until the block's pool holds the
// registers, so the warpgroups' new counts must fit the count the kernel was
// launched with.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma ------------------------------------------------------------------

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
// keeps the compiler from moving a register's reads or writes across the
// asynchronous MMA's fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Matrix descriptor of an MN-major bf16 operand with 128-byte swizzle at
// shared address `saddr` (1024-byte aligned atoms): `box_stride` bytes
// between 64-element boxes along N, `k8_stride` bytes between 8-row groups
// along K.
__device__ __forceinline__ uint64_t desc_mn_b128(uint32_t saddr,
                                                 uint32_t box_stride,
                                                 uint32_t k8_stride) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((box_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((k8_stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 128 f32, this thread's 64) += A (64 x 16 bf16 from registers,
// the m16n8k16 A layout) x B (16 x 128 bf16, MN-major, `desc`).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64 f32, this thread's 32) += A (64 x 16 bf16 from registers) x B
// (16 x 64 bf16, MN-major, `desc`): the same operands as the m64n128k16 form,
// one 64-column box of B.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// the m64nNk16 form for N = 64 or 128 output columns
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t desc) {
  static_assert(N == 64 || N == 128, "wgmma_rs takes 64 or 128 columns");
  if constexpr (N == 128)
    wgmma_m64n128k16_rs(d, a, desc);
  else
    wgmma_m64n64k16_rs(d, a, desc);
}

// ---- spike words ------------------------------------------------------------

// A stage's spike words as a TMA load with 128-byte swizzle leaves them: two
// boxes of 32 words (k 0..31, then 32..63) by the tile's rows, 128 bytes a
// row, `box_bytes` apart: word (m, k) sits in 16-byte chunk
// ((k % 32) / 4) ^ (m % 8) of row m of box k / 32.  Its byte offset:
__device__ __forceinline__ int word_offset_b128(int box_bytes, int m, int k) {
  return (k >> 5) * box_bytes + m * 128 + ((((k & 31) >> 2) ^ (m & 7)) << 4) +
         ((k & 3) << 2);
}
// the words (m, k) and (m, k + 1), k even
__device__ __forceinline__ int2 words2_b128(const unsigned char* tile,
                                            int box_bytes, int m, int k) {
  return *reinterpret_cast<const int2*>(tile +
                                        word_offset_b128(box_bytes, m, k));
}
// The words an A fragment reads for the k16 step at column k (= 16 ks + 2
// (lane % 4)) of rows m_lo and m_hi, from that layout: (m_lo, k), (m_hi,
// k), (m_lo, k + 8), (m_hi, k + 8), two words each.
__device__ __forceinline__ void a_words_b128(int2 (&w)[4],
                                             const unsigned char* tile,
                                             int box_bytes, int m_lo, int m_hi,
                                             int k) {
  w[0] = words2_b128(tile, box_bytes, m_lo, k);
  w[1] = words2_b128(tile, box_bytes, m_hi, k);
  w[2] = words2_b128(tile, box_bytes, m_lo, k + 8);
  w[3] = words2_b128(tile, box_bytes, m_hi, k + 8);
}
// The A fragment from those words: the planes sh_lo (rows g) and sh_hi
// (rows g + 8), zero where the plane is dead.
__device__ __forceinline__ void a_frag_planes(uint32_t (&af)[4],
                                              const int2 (&w)[4], int sh_lo,
                                              int sh_hi, uint32_t live_lo,
                                              uint32_t live_hi) {
  af[0] = ftp::tc::plane_pair(w[0].x, w[0].y, sh_lo, live_lo);
  af[1] = ftp::tc::plane_pair(w[1].x, w[1].y, sh_hi, live_hi);
  af[2] = ftp::tc::plane_pair(w[2].x, w[2].y, sh_lo, live_lo);
  af[3] = ftp::tc::plane_pair(w[3].x, w[3].y, sh_hi, live_hi);
}

}  // namespace wg
}  // namespace ftp
