// Dense-weight FTP spMspM: packed spike words x dense weights, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: src/repro/kernels/ftp_spmm.py::_ftp_spmm_kernel (entered through
// ftp_spmm: full sums) and ::_ftp_spmm_lif_kernel (entered through
// ftp_spmm_fused_lif: the fused hard-reset P-LIF), FUSE = 0 and FUSE = 1 of
// each instance below.
//
// What it computes, for the spike rows m of a tile and its columns n:
//   acc[t, m, n] = sum over k of bit_t(a[m, k]) * b[k, n]
//   FUSE = 1: hard-reset LIF over t in f32 (x = acc_t + u; c = x > v_th;
//             u = tau * x * (1 - c)); writes packed spike words (M, N)
//             (bit t = c_t) and the final U (M, N).
//   FUSE = 0: writes the full sums (T, M, N).
//
// What bounds it on the H100: at decode (M = a few batch rows) the dense
// weight it must stream once (llama3.2-1b's FFN: 2048 x 8192 bf16 = 33.6 MB
// per GEMM, ~10 us at 3.35 TB/s).  In prefill (M = B * prompt rows) the
// products grow with M while the weight does not: 2 T M K N operations
// (68.7 GFLOP at M = 512, T = 4; ~70 us at the bf16 tensor-core peak).
//
// Two instances; the host routes by (weight dtype, N, alignment) alone:
//
// * tc (bf16 weights, 16-byte aligned, N * 2 % 16 == 0): the reference's
//   own product.  _unpack_fold stacks T {0,1} planes into (T * bm, bk) rows
//   r = t * bm + m and runs one f32-accumulated dot on the MXU; here the
//   same rows feed the warpgroup MMA, wgmma.m64n128k16 bf16 with f32
//   accumulation, exact per product ({0,1} x bf16).  A block is one or two
//   consumer warpgroups and a producer warpgroup; each consumer warpgroup
//   owns MT m64 tiles of MMA rows (one tile: 64 rows, for M * T' <= 64;
//   else two warpgroups of two: 256 rows) and all 128 columns.
//   - A from registers: each consumer thread builds its A fragments from
//     the spike words in shared memory (bit t of word (m, k) -> bf16 1.0 or
//     0; rows with t >= T or m >= M are 0), so no unpacked plane reaches
//     shared or device memory.  One read of a k16 step's words feeds every
//     tile the thread owns (bm <= 64, so a thread's spike rows are the same
//     in each; only the plane differs), and one build feeds a 64 x 128 x 16
//     product where the mma.sync design it replaces spent it on 16 x 8 x 16.
//     ptxas serialises the MMAs if A registers are built while any of them
//     runs, so a warpgroup waits for its stage's MMAs before building the
//     next; the other warpgroup's MMAs fill the gap.
//   - B and the words by TMA: one producer warp streams the weight through
//     a 6-stage ring of 64-deep stages (2 boxes of 64 x 64 bf16) and the
//     stage's words beside it (2 boxes of 32 words x bm rows), both with
//     128-byte swizzle, against full and empty mbarriers.  The weight is
//     (K, N) with N contiguous, which wgmma reads as an MN-major B: no
//     transpose pass.  TMA's zero fill covers the K, N and M tails.  Words
//     whose rows are not 16-byte multiples come by cp.async in the same
//     layout.  With two tiles a warpgroup the consumers need more than the
//     168 registers a 384-thread block launches with: the producer
//     warpgroup hands them its registers (setmaxnreg: 56 a producer
//     thread, 224 a consumer thread; at 40 the producer spilled).
//   - Bytes at decode: the weight is read once; K is split across the
//     blocks of a thread-block cluster until the small-M grid has 64
//     blocks.  Operations in prefill: a block's 256 MMA rows read each
//     weight tile once for 64 spike rows (at T' = 4) and its 128 columns
//     read each word once for 128 columns, where the mma.sync design read
//     them for 32 rows and 64 columns; and wgmma, unlike mma.sync, can
//     reach the tensor cores' full rate.
//   - Order: splits (1, 2, 4 or 8), their 64-deep boundaries, the 128
//     columns and the instruction shape are functions of (K, N) only, never
//     of M.  Each split sums its k range in ascending k16 steps (the same
//     instruction sequence for one tile or two); the splits' partial tiles
//     meet in distributed shared memory and are added in ascending rank
//     order (no scratch, no atomics).  Every output element's sum order is
//     therefore fixed by (K, N): rows are batch-invariant, runs
//     deterministic, and a column slab launched with its parent's N equals
//     the parent's columns.  Only the rows a block holds (bm = rows / T',
//     T' = T rounded up to a power of two, at least 4) and the number of
//     blocks grow with M.
//   - Shared memory: the ring holds 120 KiB (64 rows: 16 KiB of weight and
//     4 KiB of words a stage) or 192 KiB (256 rows: 16 + 16 KiB), one block
//     an SM.  After the K loop the split's partial tile (rows x 128 f32, as
//     two 64-column sub-tiles) is written over it; rank s of the cluster
//     sums its 1/S of the tile's live pairs over every rank's tile, 16 bytes
//     a load with all ranks' loads in flight (distributed shared memory is
//     slow to answer), then writes the full sums or runs the LIF (ftp::lif)
//     over them.  Ragged M, K, N and T are masked in the kernel.
// * simt (f32 weights, or an unaligned N): one thread block per output
//   tile of 32 columns walks K in 128-deep steps, adding in ascending k
//   with __fadd_rn: the BSR kernel's (ftp_bsr.cu) order and instructions,
//   so on block-pruned weights its full sums equal kernel 3's bit for bit.
//   Each thread owns one column and RPT rows with a (RPT x TMAX) f32
//   accumulator in registers; bits gate additions, never multiplications.
//   T up to 32 through the accumulator buckets of ftp_common.cuh.
//
// The tc instance's sums are the exact products added in another order
// than kernel 3's, so on bf16 weights the two agree within f32 rounding,
// not bit for bit.

#include <cstdio>

#include "ftp_common.cuh"
#include "ftp_tc.cuh"
#include "ftp_wgmma.cuh"

namespace {

using ftp::kCols;
using ftp::kThreads;
using ftp::kWarps;
constexpr int kBK = 128;  // K step staged in shared memory

template <typename W, int RPT, int TMAX, bool FUSE>
__global__ void __launch_bounds__(kThreads) ftp_dense_kernel(
    const int32_t* __restrict__ a, int M, int K, const W* __restrict__ b,
    int N, int vec_ok, int T, float v_th, float tau, void* __restrict__ out,
    float* __restrict__ u_out) {
  constexpr int BM = kWarps * RPT;
  constexpr int VEC = 16 / sizeof(W);  // weight elements per 16-byte load
  __shared__ __align__(16) unsigned char w_raw[kBK * kCols * sizeof(W)];
  __shared__ int32_t a_s[BM * kBK];
  W* w_s = reinterpret_cast<W*>(w_raw);  // [kBK][kCols]

  const int col0 = blockIdx.x * kCols;
  const int i = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = vec_ok && col0 + kCols <= N;

  float acc[RPT][TMAX];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int t = 0; t < TMAX; ++t) acc[r][t] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kn = min(kBK, K - k0);
    if (vec) {
      constexpr int chunks = kCols / VEC;
      for (int idx = threadIdx.x; idx < kn * chunks; idx += kThreads) {
        const int kk = idx / chunks, ch = idx % chunks;
        *reinterpret_cast<uint4*>(w_s + kk * kCols + ch * VEC) =
            *reinterpret_cast<const uint4*>(b + (size_t)(k0 + kk) * N + col0 +
                                            ch * VEC);
      }
    } else {
      for (int idx = threadIdx.x; idx < kn * kCols; idx += kThreads) {
        const int kk = idx / kCols, c = idx % kCols;
        // a column past N is never written out, so its value is left as is
        if (col0 + c < N) w_s[idx] = b[(size_t)(k0 + kk) * N + col0 + c];
      }
    }
    for (int idx = threadIdx.x; idx < BM * kBK; idx += kThreads) {
      const int row = i * BM + idx / kBK, kk = idx % kBK;
      a_s[idx] = (row < M && kk < kn) ? a[(size_t)row * K + k0 + kk] : 0;
    }
    __syncthreads();

    for (int kk = 0; kk < kn; ++kk) {
      const float w = ftp::to_f32(w_s[kk * kCols + lane]);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        ftp::accumulate(acc[r], (uint32_t)a_s[(warp * RPT + r) * kBK + kk], w,
                        T);
    }
    __syncthreads();
  }

  const int col = col0 + lane;
  if (col >= N) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i * BM + warp * RPT + r;
    if (row >= M) continue;
    const size_t at = (size_t)row * N + col;
    if (FUSE) {
      reinterpret_cast<int32_t*>(out)[at] =
          (int32_t)ftp::lif(acc[r], T, v_th, tau, &u_out[at]);
    } else {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int t = 0; t < TMAX; ++t)
        if (t < T) o[(size_t)t * M * N + at] = acc[r][t];
    }
  }
}

template <typename W>
struct Launch {
  template <int RPT, int TMAX>
  static int run(const void* a, int M, int K, const void* b, int N,
                 int vec_ok, int T, float v_th, float tau, int fuse_lif,
                 void* out, void* u_out, cudaStream_t stream) {
    constexpr int BM = kWarps * RPT;
    const dim3 grid((N + kCols - 1) / kCols, (M + BM - 1) / BM);
#define FTP_DENSE_KERNEL_ARGS                                             \
  static_cast<const int32_t*>(a), M, K, static_cast<const W*>(b), N,      \
      vec_ok, T, v_th, tau, out, static_cast<float*>(u_out)
    if (fuse_lif)
      ftp_dense_kernel<W, RPT, TMAX, true>
          <<<grid, kThreads, 0, stream>>>(FTP_DENSE_KERNEL_ARGS);
    else
      ftp_dense_kernel<W, RPT, TMAX, false>
          <<<grid, kThreads, 0, stream>>>(FTP_DENSE_KERNEL_ARGS);
#undef FTP_DENSE_KERNEL_ARGS
    return (int)cudaGetLastError();
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core instance (bf16 weights, N * 2 % 16 == 0, 16-byte aligned)
// ---------------------------------------------------------------------------
namespace tc {

namespace cg = cooperative_groups;
// using-declarations, not a directive: the SIMT instance's kBK (128) must
// not meet the ring's (64) in the enclosing scope
using ftp::tc::cp_async4;
using ftp::tc::kBK;
namespace wg = ftp::wg;

constexpr int kBN = 128;          // output columns per block: m64n128k16
constexpr int kBox = 64;          // weight columns of a TMA box: 128 bytes
constexpr int kBoxBytes = kBK * kBox * 2;  // 8 KiB
constexpr int kWTile = kBK * kBN * 2;      // 16 KiB: a stage's weight, 2 boxes
constexpr int kWordBox = 32;      // words of a TMA box: 128 bytes
constexpr int kStages = 6;        // ring depth
constexpr int kPitch = kBox + 8;  // floats a row of a partial sub-tile
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

// A block of NWG consumer warpgroups, each owning MT m64 tiles of MMA rows
// (rows = 64 NWG MT), and a producer warpgroup (one warp issues, three
// idle).  With two tiles a warpgroup (128 accumulators a thread) the
// consumers need more than the 168 registers a 384-thread block launches
// with: the producer hands them its registers (setmaxnreg), else ptxas
// serialises the MMAs.  Its shared memory: the ring (kStages weight tiles,
// then kStages word tiles: two boxes of rows / 4 spike rows x 32 words),
// and after the K loop, over the ring, the split's f32 partial tile as two
// 64-column sub-tiles of (rows x kPitch); then the full and empty
// barriers.  Every box starts on a 1024-byte swizzle atom.
template <int NWG, int MT>
struct Shape {
  static constexpr int kRows = 64 * NWG * MT;
  static constexpr int kCT = 128 * NWG;  // consumer threads
  static constexpr int kThreads = kCT + 128;
  static constexpr bool kHandOver = MT == 2;
  // the registers the block must launch with for the hand-over
  static constexpr int kRegPool = 128 * kProducerRegs + kCT * kConsumerRegs;
  static constexpr int kWBoxBytes = (kRows / 4) * kWordBox * 4;
  static constexpr int kATile = 2 * kWBoxBytes;
  static constexpr int kRing = kStages * (kWTile + kATile);
  static constexpr int kSub = kRows * kPitch;  // floats of one sub-tile
  static constexpr int kPart = (kBN / kBox) * kSub * 4;
  static constexpr int kBars = kRing > kPart ? kRing : kPart;
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;  // + alignment
};

// The epilogue's phase 1 for S splits: this rank's `share` of the block's
// (m, n) pairs (p = kBN m + n over the tile's live rows), all T planes, in
// items of 4 columns (item i: plane i / (share / 4), columns 4 (i % (share /
// 4)) of the share); each value the S partial tiles added in ascending rank
// order (the order of ftp_bsr.cu's split sum).  Distributed shared memory is
// slow to answer, so every rank's 16 bytes of kU items are loaded before
// the first add.  Kernel 1 writes the sums out; kernel 2 keeps them in this
// block's own tile (no peer reads this rank's values) for the LIF.
template <int S, bool FUSE, int kCT, int kSub>
__device__ __forceinline__ void sum_splits(float* part, int s, int share,
                                           int T, int bm_shift, int m0,
                                           int col0, int M, int N,
                                           float* __restrict__ out) {
  constexpr int kU = 16 / S;  // items at once: 16 x 16-byte loads in flight
  const uint32_t own = wg::smem_u32(part);
  uint32_t base[S];
#pragma unroll
  for (int r = 0; r < S; ++r) base[r] = wg::cluster_map(own, r);
  const int quads = share >> 2, items = T * quads;
  for (int i0 = threadIdx.x; i0 < items; i0 += kU * kCT) {
    int at[kU], t[kU], p[kU];
    bool ok[kU];
    float4 v[kU][S];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kCT;
      t[u] = i / quads;
      p[u] = s * share + 4 * (i - t[u] * quads);
      const int m = p[u] / kBN, n = p[u] % kBN;
      ok[u] = i < items && col0 + n < N;
      at[u] = ok[u] ? (n / kBox) * kSub + ((t[u] << bm_shift) + m) * kPitch +
                          n % kBox
                    : 0;
#pragma unroll
      for (int r = 0; r < S; ++r)
        v[u][r] = wg::ld_cluster_f32x4(base[r] + 4 * at[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float4 x = v[u][0];
#pragma unroll
      for (int r = 1; r < S; ++r) {
        x.x = __fadd_rn(x.x, v[u][r].x);
        x.y = __fadd_rn(x.y, v[u][r].y);
        x.z = __fadd_rn(x.z, v[u][r].z);
        x.w = __fadd_rn(x.w, v[u][r].w);
      }
      if (!ok[u]) continue;
      if (FUSE)
        *reinterpret_cast<float4*>(part + at[u]) = x;
      else
        *reinterpret_cast<float4*>(
            out + ((size_t)t[u] * M + m0 + p[u] / kBN) * N + col0 +
            p[u] % kBN) = x;
    }
  }
}

// Phase 2 of kernel 2: the LIF (ftp::lif over TP >= T planes) of each of
// this rank's pairs, 4 columns a thread.
template <int TP, int kCT, int kSub>
__device__ __forceinline__ void lif_pairs(const float* part, int s, int share,
                                          int T, int bm_shift, int m0,
                                          int col0, int N, float v_th,
                                          float tau, int32_t* __restrict__ out,
                                          float* __restrict__ u_out) {
  for (int q = threadIdx.x; q < (share >> 2); q += kCT) {
    const int p = s * share + 4 * q, m = p / kBN, n = p % kBN;
    if (col0 + n >= N) continue;
    const float* sub = part + (n / kBox) * kSub + m * kPitch + n % kBox;
    float x[4][TP];
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const float4 v =
          t < T ? *reinterpret_cast<const float4*>(sub + (t << bm_shift) * kPitch)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      x[0][t] = v.x;
      x[1][t] = v.y;
      x[2][t] = v.z;
      x[3][t] = v.w;
    }
    const size_t at = (size_t)(m0 + m) * N + col0 + n;
    float4 u;
    int4 w;
    w.x = (int32_t)ftp::lif(x[0], T, v_th, tau, &u.x);
    w.y = (int32_t)ftp::lif(x[1], T, v_th, tau, &u.y);
    w.z = (int32_t)ftp::lif(x[2], T, v_th, tau, &u.z);
    w.w = (int32_t)ftp::lif(x[3], T, v_th, tau, &u.w);
    *reinterpret_cast<int4*>(out + at) = w;
    *reinterpret_cast<float4*>(u_out + at) = u;
  }
}

// One block: split s = its cluster rank, kBN output columns from col0, the
// spike rows m0 .. m0 + bm.  Its MMA rows are r = t * bm + m (the
// reference's _unpack_fold): consumer warpgroup j owns the MT m64 tiles of
// rows 64 MT j .. 64 MT (j + 1) - 1 and all kBN columns, one m64n128k16 a
// tile and k16 step.  `amap` loads the words when a_vec (16-byte aligned
// rows), else they come by cp.async.
template <int NWG, int MT, bool FUSE>
__global__ void __launch_bounds__(Shape<NWG, MT>::kThreads, 1)
    ftp_dense_tc_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap amap,
                        const int32_t* __restrict__ a, int M, int K,
                        int a_vec, int N, int T, int bm_shift, int k_split,
                        float v_th, float tau, void* __restrict__ out,
                        float* __restrict__ u_out) {
  using S_ = Shape<NWG, MT>;
  constexpr int kCT = S_::kCT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024-byte aligned
  unsigned char* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S_::kBars);
  uint64_t* empty = full + kStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int s = static_cast<int>(cluster.block_rank());
  const int bm = 1 << bm_shift;
  const int col0 = blockIdx.z * kBN;
  const int m0 = blockIdx.y * bm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_begin = s * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nchunks = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto w_tile = [&](int st) { return smem + st * kWTile; };
  auto a_tile = [&](int st) {
    return smem + kStages * kWTile + st * S_::kATile;
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      // the producer's expect-tx arrival, and its 32 lanes' cp.async ones
      // when the words come that way
      wg::mbar_init(&full[st], a_vec ? 1 : 33);
      wg::mbar_init(&empty[st], 4 * NWG);  // one arrival a consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- the producer warpgroup: weight and words by TMA, from one warp ----
    // Rows past K (or past k_end: k_split is a multiple of kBK, so a box
    // never reaches into the next split's rows), columns past N and spike
    // rows past M arrive as zeros: a zero word adds nothing, and a zero
    // weight keeps 0 * garbage out of the sums.
    if constexpr (S_::kHandOver) wg::regs_dec<kProducerRegs>();
    if (warp > 4 * NWG) {  // idle warps
      wg::cluster_sync();
      wg::cluster_sync();
      return;
    }
    if (lane == 0) {
      wg::tma_prefetch(&wmap);
      if (a_vec) wg::tma_prefetch(&amap);
    }
    const uint32_t tx = kWTile + (a_vec ? 2 * bm * kWordBox * 4 : 0);
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % kStages;
      if (c >= kStages) wg::mbar_wait(&empty[st], ((c / kStages) - 1) & 1);
      const int k0 = k_begin + c * kBK;
      if (!a_vec) {
        // word rows that are not 16-byte multiples: 4-byte copies into the
        // TMA layout
        for (int idx = lane; idx < bm * kBK; idx += 32) {
          const int row = idx >> 6, kk = idx & 63;
          const int gm = m0 + row, gk = k0 + kk;
          const bool ok = gm < M && gk < k_end;
          cp_async4(a_tile(st) + wg::word_offset_b128(S_::kWBoxBytes, row, kk),
                    ok ? a + (size_t)gm * K + gk : a, ok ? 4 : 0);
        }
        wg::cp_async_arrive(&full[st]);
      }
      __syncwarp();  // the warp stays converged: no lane spins while lane 0 issues
      if (lane == 0) {
        wg::mbar_arrive_expect_tx(&full[st], tx);
#pragma unroll
        for (int i = 0; i < kBN / kBox; ++i)
          wg::tma_load_2d(w_tile(st) + i * kBoxBytes, &wmap, &full[st],
                          col0 + i * kBox, k0);
        if (a_vec)
          for (int i = 0; i < kBK / kWordBox; ++i)
            wg::tma_load_2d(a_tile(st) + i * S_::kWBoxBytes, &amap, &full[st],
                            k0 + i * kWordBox, m0);
      }
      __syncwarp();
    }
    wg::cluster_sync();  // the partial tiles are written
    wg::cluster_sync();  // no block leaves while a peer still reads its tile
    return;
  }

  // ---- the consumer warpgroups ---------------------------------------------
  if constexpr (S_::kHandOver) wg::regs_inc<kConsumerRegs>();
  // this thread's A-fragment rows in m64 tile i: g and g + 8 of its warp's
  // 16, spike rows m_lo / m_hi of planes sh_lo[i] / sh_hi[i]
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = 16 * (warp & 3) + g;  // the row within an m64 tile
  const int m_lo = r0 & (bm - 1), m_hi = (r0 + 8) & (bm - 1);
  int r_lo[MT], sh_lo[MT], sh_hi[MT];
  uint32_t live_lo[MT], live_hi[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    r_lo[i] = 64 * (MT * (warp >> 2) + i) + r0;
    sh_lo[i] = r_lo[i] >> bm_shift;
    sh_hi[i] = (r_lo[i] + 8) >> bm_shift;
    live_lo[i] = sh_lo[i] < T ? 1u : 0u;
    live_hi[i] = sh_hi[i] < T ? 1u : 0u;
  }
  // stage 0's descriptor; a stage adds kWTile bytes, a k16 step 16 rows
  const uint64_t desc0 =
      wg::desc_mn_b128(wg::smem_u32(smem), kBoxBytes, 8 * kBox * 2);

  float acc[MT][kBN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[i][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kStages;
    wg::mbar_wait(&full[st], (c / kStages) & 1);
    // bm <= 64, so this thread's spike rows m_lo / m_hi are the same in
    // every m64 tile (only the plane differs): their words are read once
    uint32_t af[MT][kBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      int2 w[4];
      wg::a_words_b128(w, a_tile(st), S_::kWBoxBytes, m_lo, m_hi,
                       ks * 16 + c2);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wg::a_frag_planes(af[i][ks], w, sh_lo[i], sh_hi[i], live_lo[i],
                          live_hi[i]);
        wg::fence_operands(af[i][ks]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) wg::fence_operands(acc[i]);
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int i = 0; i < MT; ++i)
        wg::wgmma_m64n128k16_rs(
            acc[i], af[i][ks],
            desc0 + ((st * kWTile + ks * 16 * kBox * 2) >> 4));
    wg::wgmma_commit();
    // ptxas serialises the MMAs if A registers are built while any of them
    // runs, so the next stage's fragments wait for these to finish
    wg::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i) wg::fence_operands(acc[i]);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[st]);
    __syncwarp();
  }

  // every consumer is done with the ring: this split's (rows, kBN) partial
  // sums go over it, then the cluster's splits are summed
  wg::bar_sync(1, kCT);
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float* sub = part + (j / 8) * S_::kSub + (j % 8) * 8 + c2;
      *reinterpret_cast<float2*>(sub + r_lo[i] * kPitch) =
          make_float2(acc[i][4 * j], acc[i][4 * j + 1]);
      *reinterpret_cast<float2*>(sub + (r_lo[i] + 8) * kPitch) =
          make_float2(acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  wg::cluster_sync();

  // rank s owns a contiguous 1/S of the (m, n) pairs of the tile's live rows
  const int share = (min(bm, M - m0) * kBN) / S;
  float* o = reinterpret_cast<float*>(out);
#define FTP_SUM_SPLITS(n)                                                   \
  sum_splits<n, FUSE, kCT, S_::kSub>(part, s, share, T, bm_shift, m0, col0, \
                                     M, N, o)
  switch (S) {
    case 1: FTP_SUM_SPLITS(1); break;
    case 2: FTP_SUM_SPLITS(2); break;
    case 4: FTP_SUM_SPLITS(4); break;
    default: FTP_SUM_SPLITS(8); break;
  }
#undef FTP_SUM_SPLITS
  if (FUSE) {
    wg::bar_sync(1, kCT);
    int32_t* words = reinterpret_cast<int32_t*>(out);
#define FTP_LIF_PAIRS(tp)                                                     \
  lif_pairs<tp, kCT, S_::kSub>(part, s, share, T, bm_shift, m0, col0, N, v_th, \
                               tau, words, u_out)
    if (T <= 4)
      FTP_LIF_PAIRS(4);
    else if (T <= 8)
      FTP_LIF_PAIRS(8);
    else if (T <= 16)
      FTP_LIF_PAIRS(16);
    else
      FTP_LIF_PAIRS(32);
#undef FTP_LIF_PAIRS
  }
  wg::cluster_sync();  // no block leaves while a peer still reads its tile
}

template <int NWG, int MT, bool FUSE>
int launch(const CUtensorMap& wmap, const CUtensorMap& amap, const void* a,
           int M, int K, int a_vec, int N, int T, int bm, int splits,
           int k_split, float v_th, float tau, void* out, void* u_out,
           cudaStream_t stream) {
  using S_ = Shape<NWG, MT>;
  auto kernel = ftp_dense_tc_kernel<NWG, MT, FUSE>;
  // setmaxnreg.inc waits for registers the block does not hold: refuse a
  // build whose launch register count cannot fund the hand-over
  static const cudaError_t ready = [kernel] {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess && S_::kHandOver &&
        fa.numRegs * S_::kThreads < S_::kRegPool)
      e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_::kSmem);
    return e;
  }();
  if (ready != cudaSuccess) return (int)ready;
  cudaLaunchConfig_t cfg = {};
  // the row tiles of one column tile run side by side: the weight tiles
  // they share are read from L2
  cfg.gridDim = dim3(splits, (M + bm - 1) / bm, (N + kBN - 1) / kBN);
  cfg.blockDim = dim3(S_::kThreads);
  cfg.dynamicSmemBytes = S_::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int bm_shift = 0;
  while ((1 << bm_shift) < bm) ++bm_shift;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, wmap, amap, static_cast<const int32_t*>(a), M, K, a_vec,
      N, T, bm_shift, k_split, v_th, tau, out, static_cast<float*>(u_out));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// The simt instance.  a: (M, K) int32 words; b: (K, N) row-major weights
// (weight_bf16: 1 = bf16, 0 = f32); vec_ok: 1 when b is 16-byte aligned and
// N a multiple of 16 bytes of weights.  Row tile bm = 4 * rows_per_thread
// (1 or 4 for T <= 8, 1 or 2 for 8 < T <= 32).  fuse_lif: out = (M, N)
// int32 words and u_out = (M, N) f32 U; else out = (T, M, N) f32 full sums
// and u_out unused.  Returns cudaGetLastError().
int ftp_dense_launch(const void* a, int M, int K, const void* b,
                     int weight_bf16, int N, int vec_ok, int rows_per_thread,
                     int T, float v_th, float tau, int fuse_lif, void* out,
                     void* u_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FTP_DENSE_ARGS a, M, K, b, N, vec_ok, T, v_th, tau, fuse_lif, out, \
    u_out, s
  if (weight_bf16)
    return ftp::launch_bucket<Launch<__nv_bfloat16>>(rows_per_thread, T,
                                                     FTP_DENSE_ARGS);
  return ftp::launch_bucket<Launch<float>>(rows_per_thread, T,
                                           FTP_DENSE_ARGS);
#undef FTP_DENSE_ARGS
}

// The tc instance.  a: (M, K) int32 words (a_vec: 1 when a is 16-byte
// aligned and K % 4 == 0); b: (K, N) bf16, 16-byte aligned, N % 8 == 0 (the
// tensor map's 16-byte row stride).  rows: MMA rows per block (64: one
// consumer warpgroup of one m64 tile; 256: two of two); bm: spike rows per
// block, a power of two with T <= rows / bm; splits (1, 2, 4, 8): the
// cluster's K splits, each k_split deep (a multiple of 64).  Outputs as for
// ftp_dense_launch.  Returns a cudaError_t, or ftp::wg::kDriverError + the
// CUresult of a refused tensor map.
int ftp_dense_tc_launch(const void* a, int M, int K, int a_vec, const void* b,
                        int N, int T, int rows, int bm, int splits,
                        int k_split, float v_th, float tau, int fuse_lif,
                        void* out, void* u_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pow2 = bm >= 2 && (bm & (bm - 1)) == 0;
  if (!pow2 || T < 1 || T * bm > rows || N % 8 || k_split % tc::kBK ||
      !(splits == 1 || splits == 2 || splits == 4 || splits == 8) ||
      (rows != 64 && rows != 256) || bm > rows / 4)
    return (int)cudaErrorInvalidValue;
  // the weight as (K rows, N columns) of bf16 in 64 x 64 boxes; the words,
  // when their rows are 16-byte multiples, as (M rows, K columns) of int32
  // in 32 x bm boxes (else the weight's map stands in, unused)
  CUtensorMap wmap, amap;
  int enc = ftp::wg::encode_2d_b128(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b,
                                    (uint64_t)N, (uint64_t)K, (uint64_t)N * 2,
                                    tc::kBox, tc::kBK);
  if (enc == 0 && a_vec)
    enc = ftp::wg::encode_2d_b128(&amap, CU_TENSOR_MAP_DATA_TYPE_INT32, a,
                                  (uint64_t)K, (uint64_t)M, (uint64_t)K * 4,
                                  tc::kWordBox, bm);
  else
    amap = wmap;
  if (enc != 0) return enc;
#define FTP_TC_ARGS wmap, amap, a, M, K, a_vec, N, T, bm, splits, k_split, \
    v_th, tau, out, u_out, s
  if (rows == 64)
    return fuse_lif ? tc::launch<1, 1, true>(FTP_TC_ARGS)
                    : tc::launch<1, 1, false>(FTP_TC_ARGS);
  return fuse_lif ? tc::launch<2, 2, true>(FTP_TC_ARGS)
                  : tc::launch<2, 2, false>(FTP_TC_ARGS);
#undef FTP_TC_ARGS
}

const char* ftp_dense_error_string(int code) {
  if (code >= ftp::wg::kDriverError) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the weight's "
             "tensor map: CUresult %d", code - ftp::wg::kDriverError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
