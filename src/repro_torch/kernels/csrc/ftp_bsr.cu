// Dual-sparse FTP spMspM over a load-time weight join plan, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: src/repro/kernels/ftp_spmm.py::_ftp_bsr_kernel (entered through
// ftp_spmm_bsr with tmap=None) and ::_ftp_bsr_adaptive_kernel (tmap given),
// both settings of fuse_lif.
//
// What it computes, for output tile (row tile i, column block j):
//   acc[t, r, n] = sum over live join slots jj < cnt[j], ascending, skipping
//                  spike-silent blocks (act[i, kidx[j, jj]] == 0), of
//                  sum over kk ascending of bit_t(a[r, kb*bk + kk]) *
//                  payload[vidx[j, jj], kk, n]
//   fuse_lif = 1: hard-reset LIF over t in f32 (x = acc_t + u; c = x > v_th;
//                 u = tau * x * (1 - c)); writes packed spike words (M, N)
//                 (bit t = c_t) and the final U (M, N).
//   fuse_lif = 0: writes the full sums (T, M, N) and a zero U (M, N).
//   adaptive (tmap != NULL): plane t adds nothing wherever tmap[t] == 0;
//                 the LIF epilogue still walks all T.  A plane the map gates
//                 at min_spikes = 1 has no bit set anywhere, so what remains
//                 is the full kernel's work in the full kernel's order: the
//                 outputs are equal bit for bit.
//
// What bounds it on the H100: at decode (M = batch rows, a handful) the
// bytes of the weight payload it must stream (one bf16 128x128 block is
// 32 KB; the llama3.2-1b FFN at block density 0.3 holds ~10 MB per GEMM,
// ~3 us at 3.35 TB/s).  In prefill (M = B * prompt rows) the bf16
// operations of the joined blocks grow with M while the payload does not
// (W_in at M = 512, T = 4: 20.6 GFLOP, ~21 us at the tensor-core peak).
//
// Two instances; the host routes by (payload dtype, bk, bn, alignment)
// alone (ftp_spmm.bsr_instance):
//
// * tc (bf16 payload, 16-byte aligned, bk % 16 == 0, bn % 64 == 0): the
//   reference's own product.  Per join slot, _unpack_fold stacks the T
//   {0,1} planes of the spike block into MMA rows and runs one
//   f32-accumulated dot with the (bk, bn) payload block on the MXU; here
//   the same rows feed the warpgroup MMA, wgmma.m64nNk16 bf16 with f32
//   accumulation, exact per product ({0,1} x bf16).  N, the block's
//   columns, is 128 where bn % 128 == 0 (the serve's 128 x 128 blocks) and
//   64 otherwise: two instances of one template.  A block is one or two
//   consumer warpgroups and a producer warpgroup; each consumer warpgroup
//   owns MT m64 tiles of MMA rows (two warpgroups of two, 256 rows, where
//   M * T' > 64 and such blocks fill a wave of SMs; else one tile, 64 rows,
//   two blocks an SM).  T' = T rounded up to a power of two, at least 4.
//   An m64 tile holds 64 / T' spike rows, all T' planes (row r = t * (64 /
//   T') + m), so it meets at most four act row tiles and a 256-row block
//   covers several (up to 16 at bm 4).
//   - B, the payload, by TMA: one 2D tensor map over the payload as
//     (nnzb * bk rows, bn columns) bf16 with 128-byte swizzle; join slot
//     (kb, v)'s 64-deep stage q is the box at row v * bk + 64 q, so the
//     gather by block index costs only the coordinate.  The payload is
//     (K, N) with N contiguous, which wgmma reads as an MN-major B: no
//     transpose.  One producer warp streams it through a ring (6 stages at
//     256 rows, 5 at 64 rows, two such blocks an SM) against full and empty
//     mbarriers, the stage's spike words beside it (TMA boxes of 32 words x
//     the block's spike rows, 128-byte swizzle; cp.async into the same
//     layout where word rows are not 16-byte multiples).  TMA's zero fill
//     covers the K and M tails.
//   - The join: the producer walks this rank's slots in ascending order, 32
//     at a time, each lane reading its slot's (kb, v) and the act entries of
//     the block's act row tiles; a slot some row tile is active at becomes
//     the next stage(s), its activity mask beside it in shared memory, and
//     a stage with mask 0 ends the list.  The payload is read once per
//     block: once per 256 MMA rows, where the mma.sync design it replaces
//     read it once per act row tile (at most 64 MMA rows at T' = 4).
//   - A from registers: each consumer thread builds its A fragments from
//     the words in shared memory (bit t of word (m, k) -> bf16 1.0 or 0;
//     rows with t >= T, gated planes, rows of a silent act row tile and
//     k past the stage's depth are 0), so no unpacked plane reaches memory.
//     An m64 tile whose act row tiles are all silent at the slot, whose
//     rows are all past M or whose planes are all gated issues no MMA (a
//     warpgroup-uniform branch).  ptxas serialises the MMAs if A registers
//     are built while any of them runs, so a warpgroup waits for its
//     stage's MMAs before building the next; the other warpgroup's MMAs
//     fill the gap.  At 256 rows and N = 128 the consumers need more than
//     the 168 registers a 384-thread block launches with: the producer
//     warpgroup hands them its registers (setmaxnreg 88 / 200; the join's
//     loads spill the producer below 88).
//   - Order: the split of each column block's join list over the S blocks
//     of a thread-block cluster (S 1, 2, 4 or 8; rank s takes slots
//     [s * per, (s + 1) * per)), the column tile and the instruction are
//     functions of the plan alone (nnb, bn, jmax), never of M: S doubles
//     while the smallest grid has fewer than 64 blocks and each rank keeps
//     4 slots, since every rank's partial tile costs prefill a pass through
//     distributed shared memory.  Each rank sums its slots in ascending
//     slot order and ascending k16 steps; the ranks' partial tiles meet in
//     distributed shared memory and are added in ascending rank order, 16
//     bytes a load with every rank in flight (no scratch, no atomics).  A
//     skipped silent block or tile, an empty rank and a zero row all add
//     exactly +0, so every output element's sum order is fixed by the plan:
//     rows are batch-invariant, runs deterministic, a column slab launched
//     with its parent's shape equals the parent's columns, and the rows a
//     block holds (64 or 256 MMA rows, chosen from M and the grid) decide
//     work, not results.  Adaptive: a gated plane's rows are zero, which
//     keeps kernel 4 == kernel 3.
//   - The epilogue: the partial tile over the ring, rank s summing its 1/S
//     of the live rows' (m, n) pairs, then the full sums (and a zero U) or
//     the LIF (ftp::lif, T rounded to 4 / 8 / 16 / 32); ragged M, columns
//     past n_out and T from 1 to 32 are masked in the kernel.
// * simt (f32 payloads, and plans whose blocks the tc instance does not
//   take: the small blocks pick_plan_blocks gives tiny layers): one thread
//   block owns one output tile of 32 columns and walks the join list in
//   ascending slot order; each slot stages its payload sub-tile and spike
//   words in shared memory, and each thread owns one column and RPT rows
//   with a (RPT x TMAX) f32 accumulator in registers, adding with
//   __fadd_rn where a bit is set (ftp_common.cuh).  It stays for f32
//   payloads because the tensor cores would have to round them to bf16 or
//   run them as TF32; its order (ascending join slot, then ascending k) is
//   the dense kernels' SIMT order, so on block-pruned f32 weights the two
//   are equal bit for bit.
//
// The tc instance's sums are the exact products added in another order
// than the SIMT instance's, so on bf16 payloads the two agree within f32
// rounding, not bit for bit.  Not built: a persistent grid, TMA multicast
// of a payload stage to the row blocks of one column tile.

#include <cstdio>

#include "ftp_common.cuh"
#include "ftp_tc.cuh"
#include "ftp_wgmma.cuh"

namespace {

using ftp::kCols;
using ftp::kThreads;
using ftp::kWarps;

template <typename W, int RPT, int TMAX, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads) ftp_bsr_kernel(
    const int32_t* __restrict__ a, int M, int K,
    const W* __restrict__ payload, int bk, int bn,
    const int32_t* __restrict__ kidx, const int32_t* __restrict__ vidx,
    const int32_t* __restrict__ cnt, int jmax,
    const int32_t* __restrict__ act, int nkb,
    const int32_t* __restrict__ tmap,
    int n_out, int T, float v_th, float tau, int fuse_lif,
    void* __restrict__ out, float* __restrict__ u_out) {
  constexpr int BM = kWarps * RPT;
  constexpr int VEC = 16 / sizeof(W);  // payload elements per 16-byte load
  extern __shared__ __align__(16) unsigned char smem[];
  W* w_s = reinterpret_cast<W*>(smem);                                // [bk][kCols]
  int32_t* a_s = reinterpret_cast<int32_t*>(smem + bk * kCols * sizeof(W));  // [BM][bk]

  const int subs = bn / kCols;
  const int j = blockIdx.x / subs;
  const int sub = blockIdx.x % subs;
  const int i = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  uint32_t live_planes = 0xFFFFFFFFu;
  if (ADAPTIVE) {
    live_planes = 0u;
    for (int t = 0; t < T; ++t)
      if (tmap[t] > 0) live_planes |= 1u << t;
  }

  float acc[RPT][TMAX];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int t = 0; t < TMAX; ++t) acc[r][t] = 0.f;

  const int n_slots = cnt[j];
  for (int jj = 0; jj < n_slots; ++jj) {
    const int kb = kidx[j * jmax + jj];
    if (act[i * nkb + kb] == 0) continue;  // same for the whole block
    const int v = vidx[j * jmax + jj];

    const W* src = payload + (size_t)v * bk * bn + sub * kCols;
    const int chunks = kCols / VEC;
    for (int idx = threadIdx.x; idx < bk * chunks; idx += kThreads) {
      const int kk = idx / chunks, ch = idx % chunks;
      *reinterpret_cast<uint4*>(w_s + kk * kCols + ch * VEC) =
          *reinterpret_cast<const uint4*>(src + (size_t)kk * bn + ch * VEC);
    }
    for (int idx = threadIdx.x; idx < BM * bk; idx += kThreads) {
      const int row = i * BM + idx / bk;
      const int k = kb * bk + idx % bk;
      a_s[idx] = (row < M && k < K) ? a[(size_t)row * K + k] : 0;
    }
    __syncthreads();

    for (int kk = 0; kk < bk; ++kk) {
      const float w = ftp::to_f32(w_s[kk * kCols + lane]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        uint32_t word = (uint32_t)a_s[(warp * RPT + r) * bk + kk];
        if (ADAPTIVE) word &= live_planes;  // gated planes add nothing
        ftp::accumulate(acc[r], word, w, T);
      }
    }
    __syncthreads();
  }

  const int col = j * bn + sub * kCols + lane;
  if (col >= n_out) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = i * BM + warp * RPT + r;
    if (row >= M) continue;
    const size_t at = (size_t)row * n_out + col;
    if (fuse_lif) {
      reinterpret_cast<int32_t*>(out)[at] =
          (int32_t)ftp::lif(acc[r], T, v_th, tau, &u_out[at]);
    } else {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int t = 0; t < TMAX; ++t)
        if (t < T) o[(size_t)t * M * n_out + at] = acc[r][t];
      u_out[at] = 0.f;
    }
  }
}

template <typename W>
struct Launch {
  template <int RPT, int TMAX>
  static int run(const void* a, int M, int K, const void* payload, int bk,
                 int bn, const void* kidx, const void* vidx, const void* cnt,
                 int nnb, int jmax, const void* act, int nkb,
                 const void* tmap, int n_out, int T, float v_th, float tau,
                 int fuse_lif, void* out, void* u_out, cudaStream_t stream) {
    constexpr int BM = kWarps * RPT;
    const dim3 grid(nnb * (bn / kCols), (M + BM - 1) / BM);
    const size_t smem = (size_t)bk * kCols * sizeof(W) + (size_t)BM * bk * 4;
#define FTP_BSR_KERNEL_ARGS                                                  \
  static_cast<const int32_t*>(a), M, K, static_cast<const W*>(payload), bk, \
      bn, static_cast<const int32_t*>(kidx),                                 \
      static_cast<const int32_t*>(vidx), static_cast<const int32_t*>(cnt),   \
      jmax, static_cast<const int32_t*>(act), nkb,                           \
      static_cast<const int32_t*>(tmap), n_out, T, v_th, tau, fuse_lif, out, \
      static_cast<float*>(u_out)
    if (tmap != nullptr)
      ftp_bsr_kernel<W, RPT, TMAX, true>
          <<<grid, kThreads, smem, stream>>>(FTP_BSR_KERNEL_ARGS);
    else
      ftp_bsr_kernel<W, RPT, TMAX, false>
          <<<grid, kThreads, smem, stream>>>(FTP_BSR_KERNEL_ARGS);
#undef FTP_BSR_KERNEL_ARGS
    return (int)cudaGetLastError();
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// The tensor-core instance (bf16 payload, bk % 16 == 0, bn % 64 == 0)
// ---------------------------------------------------------------------------
namespace tc {

namespace cg = cooperative_groups;
namespace wg = ftp::wg;
// using-declarations, not a directive: the SIMT instance's names stay apart
using ftp::tc::cp_async4;
using ftp::tc::kBK;

constexpr int kBox = 64;                   // payload columns of a TMA box: 128 bytes
constexpr int kBoxBytes = kBK * kBox * 2;  // 8 KiB
constexpr int kWordBox = 32;               // words of a TMA box: 128 bytes
constexpr int kPitch = kBox + 8;           // floats a row of a partial sub-tile
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 200;

// A block of BN columns with NWG consumer warpgroups, each owning MT m64
// tiles of MMA rows (rows = 64 NWG MT), and a producer warpgroup (one warp
// issues, three idle).  At 256 rows and 128 columns (128 accumulators a
// thread) the consumers need more than the 168 registers a 384-thread block
// launches with: the producer hands them its registers (setmaxnreg).  A
// 64-row block keeps under 128 registers and a 5-stage ring (100 KiB), so
// two run on an SM at decode.  Its shared memory: the ring (kStages payload tiles of
// BN / 64 boxes, then kStages word tiles: two boxes of up to rows / 4 spike
// rows x 32 words), and after the join loop, over the ring, the rank's f32
// partial tile as BN / 64 sub-tiles of (rows x kPitch); then the full and
// empty barriers and each stage's (activity mask, k16 steps).  Every box
// starts on a 1024-byte swizzle atom.
template <int BN, int NWG, int MT>
struct Shape {
  static constexpr int kRows = 64 * NWG * MT;
  static constexpr int kTiles = NWG * MT;
  static constexpr int kTileShift = kTiles == 4 ? 2 : 0;
  static constexpr int kCT = 128 * NWG;  // consumer threads
  static constexpr int kThreads = kCT + 128;
  static constexpr bool kHandOver = MT == 2 && BN == 128;
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;
  static constexpr int kStages = NWG == 1 ? 5 : 6;
  // the registers the block must launch with for the hand-over
  static constexpr int kRegPool = 128 * kProducerRegs + kCT * kConsumerRegs;
  static constexpr int kWTile = (BN / kBox) * kBoxBytes;
  static constexpr int kWBoxBytes = (kRows / 4) * kWordBox * 4;
  static constexpr int kATile = 2 * kWBoxBytes;
  static constexpr int kRing = kStages * (kWTile + kATile);
  static constexpr int kSub = kRows * kPitch;  // floats of one sub-tile
  static constexpr int kPart = (BN / kBox) * kSub * 4;
  static constexpr int kBars = kRing > kPart ? kRing : kPart;
  static constexpr int kSmem = kBars + kStages * (2 * 8 + 8) + 1024;  // + alignment
};

// 4 consecutive values of one output row from column n on (p at column n),
// those at N and past dropped; one 16-byte store where the address allows.
template <typename V, typename E>
__device__ __forceinline__ void store4(E* p, int n, int N, V x) {
  if (n + 3 < N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<V*>(p) = x;
    return;
  }
  const E v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (n + e < N) p[e] = v[e];
}

// The epilogue's phase 1 for S ranks: this rank's `share` of the block's
// (m, n) pairs (p = BN m + n over its live spike rows), all T planes, in
// items of 4 columns (item i: plane i / (share / 4), columns 4 (i % (share /
// 4)) of the share); each value the S partial tiles added in ascending rank
// order.  Distributed shared memory is slow to answer, so every rank's 16
// bytes of kU items are loaded before the first add.  Full sums go out with
// a zero U (plane 0's items write it); under the LIF they stay in this
// block's own tile (no peer reads this rank's values) for phase 2.
template <int S, bool FUSE, int BN, int kCT, int kSub>
__device__ __forceinline__ void sum_splits(float* part, int s, int share,
                                           int T, int bm_shift, int m0,
                                           int col0, int M, int N,
                                           float* __restrict__ out,
                                           float* __restrict__ u_out) {
  // items at once: 16 x 16-byte loads in flight (4 from this block's own
  // tile alone, which answers fast)
  constexpr int kU = S == 1 ? 4 : 16 / S;
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
      const int m = p[u] / BN, n = p[u] % BN;
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
      if (FUSE) {
        *reinterpret_cast<float4*>(part + at[u]) = x;
        continue;
      }
      const int gm = m0 + p[u] / BN, gn = col0 + p[u] % BN;
      store4(out + ((size_t)t[u] * M + gm) * N + gn, gn, N, x);
      if (t[u] == 0)
        store4(u_out + (size_t)gm * N + gn, gn, N,
               make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

// Phase 2 under the LIF: ftp::lif over TP >= T planes of each of this
// rank's pairs, 4 columns a thread.
template <int TP, int BN, int kCT, int kSub>
__device__ __forceinline__ void lif_pairs(const float* part, int s, int share,
                                          int T, int bm_shift, int m0,
                                          int col0, int N, float v_th,
                                          float tau, int32_t* __restrict__ out,
                                          float* __restrict__ u_out) {
  for (int q = threadIdx.x; q < (share >> 2); q += kCT) {
    const int p = s * share + 4 * q, m = p / BN, n = p % BN;
    const int gn = col0 + n;
    if (gn >= N) continue;
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
    const size_t at = (size_t)(m0 + m) * N + gn;
    float4 u;
    int4 w;
    w.x = (int32_t)ftp::lif(x[0], T, v_th, tau, &u.x);
    w.y = (int32_t)ftp::lif(x[1], T, v_th, tau, &u.y);
    w.z = (int32_t)ftp::lif(x[2], T, v_th, tau, &u.z);
    w.w = (int32_t)ftp::lif(x[3], T, v_th, tau, &u.w);
    store4(out + at, gn, N, w);
    store4(u_out + at, gn, N, u);
  }
}

// One stage's MMAs for the m64 tiles in USE (bit i: tile i runs), every k16
// step in ascending order, then a wait for all of them: the next stage's A
// registers are built only after.
template <int BN, int MT, int USE>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][BN / 2],
                                          uint32_t (&af)[MT][kBK / 16][4],
                                          uint64_t desc) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if ((USE >> i) & 1) wg::fence_operands(acc[i]);
  wg::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if ((USE >> i) & 1)
        wg::wgmma_rs<BN>(acc[i], af[i][ks],
                         desc + ((ks * 16 * kBox * 2) >> 4));
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if ((USE >> i) & 1) wg::fence_operands(acc[i]);
}

// One block: cluster rank s of row block blockIdx.y (spike rows m0 .. m0 +
// bm, bm = kTiles << tile_shift) and column tile blockIdx.z (column block
// j, its BN-column sub-tile sub).  M64 tile g (consumer warpgroup g / MT,
// its tile g % MT) holds spike rows m0 + g bm_t .. + bm_t - 1 (bm_t = 1 <<
// tile_shift = 64 / T'), its MMA row r = t * bm_t + m.  The act row tile of
// spike row m is m >> act_shift.  `amap` loads the words when a_vec
// (16-byte aligned rows), else they come by cp.async.
template <int BN, int NWG, int MT, bool FUSE>
__global__ void __launch_bounds__(Shape<BN, NWG, MT>::kThreads,
                                  Shape<BN, NWG, MT>::kMinBlocks)
    ftp_bsr_tc_kernel(const __grid_constant__ CUtensorMap pmap,
                      const __grid_constant__ CUtensorMap amap,
                      const int32_t* __restrict__ a, int M, int K, int a_vec,
                      int bk, int bn, const int32_t* __restrict__ kidx,
                      const int32_t* __restrict__ vidx,
                      const int32_t* __restrict__ cnt, int jmax,
                      const int32_t* __restrict__ act, int nkb, int act_shift,
                      const int32_t* __restrict__ tmap, int T, int tile_shift,
                      int slots_per_rank, int n_out, float v_th, float tau,
                      void* __restrict__ out, float* __restrict__ u_out) {
  using S_ = Shape<BN, NWG, MT>;
  constexpr int kCT = S_::kCT, kStages = S_::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024-byte aligned
  unsigned char* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S_::kBars);
  uint64_t* empty = full + kStages;
  int2* info = reinterpret_cast<int2*>(empty + kStages);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int s = static_cast<int>(cluster.block_rank());
  const int bm_t = 1 << tile_shift;
  const int bm_shift = tile_shift + S_::kTileShift;
  const int bm = 1 << bm_shift;
  const int subs = bn / BN;
  const int j = blockIdx.z / subs;
  const int sub = blockIdx.z - j * subs;
  const int m0 = blockIdx.y * bm;
  const int m_end = min(M, m0 + bm);  // the block's live spike rows
  const int col0 = j * bn + sub * BN;
  const int a0 = m0 >> act_shift;      // the block's first act row tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto w_tile = [&](int st) { return smem + st * S_::kWTile; };
  auto a_tile = [&](int st) {
    return smem + kStages * S_::kWTile + st * S_::kATile;
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
    // ---- the producer warpgroup: the join, then payload and words by TMA ----
    if constexpr (S_::kHandOver) wg::regs_dec<kProducerRegs>();
    if (warp > 4 * NWG) {  // idle warps
      wg::cluster_sync();
      wg::cluster_sync();
      return;
    }
    if (lane == 0) {
      wg::tma_prefetch(&pmap);
      if (a_vec) wg::tma_prefetch(&amap);
    }
    const int n_at = ((m_end - 1) >> act_shift) - a0 + 1;  // 1..16
    const uint32_t tx = S_::kWTile + (a_vec ? 2 * bm * kWordBox * 4 : 0);
    const int lo = s * slots_per_rank;
    const int end = min(jmax, lo + slots_per_rank);
    const int live_slots = cnt[j];
    int c = 0;  // stages issued
    auto acquire = [&](int st) {
      if (c >= kStages) wg::mbar_wait(&empty[st], ((c / kStages) - 1) & 1);
    };
    for (int base = lo; base < end; base += 32) {
      // lane l: slot base + l's block and which act row tiles are active
      // at it (bit i: act row tile a0 + i); the list's entries load beside
      // cnt, and the act entries all at once
      const int jj = base + lane;
      int kb = 0, v = 0;
      if (jj < end) {
        kb = kidx[j * jmax + jj];
        v = vidx[j * jmax + jj];
      }
      uint32_t mask = 0u;
      if (jj < min(end, live_slots)) {
        const int32_t* col = act + (size_t)a0 * nkb + kb;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (i < n_at && col[(size_t)i * nkb] != 0) mask |= 1u << i;
      }
      for (unsigned live = __ballot_sync(0xffffffffu, mask != 0u); live;
           live &= live - 1u) {
        const int src = __ffs(live) - 1;  // ascending slot order
        const int kb_s = __shfl_sync(0xffffffffu, kb, src);
        const int v_s = __shfl_sync(0xffffffffu, v, src);
        const uint32_t mask_s = __shfl_sync(0xffffffffu, mask, src);
        // the block's rows past K are padding: no stage reads them
        const int depth = min(bk, K - kb_s * bk);
        for (int q = 0; q * kBK < depth; ++q, ++c) {
          const int st = c % kStages;
          acquire(st);
          const int k0 = kb_s * bk + q * kBK;
          if (!a_vec) {
            // word rows that are not 16-byte multiples: 4-byte copies into
            // the TMA layout, zeros past M and K
            for (int idx = lane; idx < bm * kBK; idx += 32) {
              const int row = idx >> 6, kk = idx & 63;
              const int gm = m0 + row, gk = k0 + kk;
              const bool ok = gm < M && gk < K;
              cp_async4(a_tile(st) + wg::word_offset_b128(S_::kWBoxBytes, row, kk),
                        ok ? a + (size_t)gm * K + gk : a, ok ? 4 : 0);
            }
            wg::cp_async_arrive(&full[st]);
          }
          __syncwarp();  // the warp stays converged: no lane spins while lane 0 issues
          if (lane == 0) {
            // k16 steps with words of this slot (a K tail's last step may
            // reach past K, where the words are zero)
            const int steps = (min(kBK, depth - q * kBK) + 15) >> 4;
            info[st] = make_int2(static_cast<int>(mask_s), steps);
            wg::mbar_arrive_expect_tx(&full[st], tx);
#pragma unroll
            for (int i = 0; i < BN / kBox; ++i)
              wg::tma_load_2d(w_tile(st) + i * kBoxBytes, &pmap, &full[st],
                              sub * BN + i * kBox, v_s * bk + q * kBK);
            if (a_vec)
              for (int i = 0; i < kBK / kWordBox; ++i)
                wg::tma_load_2d(a_tile(st) + i * S_::kWBoxBytes, &amap,
                                &full[st], k0 + i * kWordBox, m0);
          }
          __syncwarp();
        }
      }
    }
    // the end of the list: a stage with activity mask 0 and no data
    const int st = c % kStages;
    acquire(st);
    if (!a_vec) wg::cp_async_arrive(&full[st]);
    __syncwarp();
    if (lane == 0) {
      info[st] = make_int2(0, 0);
      wg::mbar_arrive(&full[st]);
    }
    __syncwarp();
    wg::cluster_sync();  // the partial tiles are written
    wg::cluster_sync();  // no block leaves while a peer still reads its tile
    return;
  }

  // ---- the consumer warpgroups ---------------------------------------------
  if constexpr (S_::kHandOver) wg::regs_inc<kConsumerRegs>();
  // this thread's A-fragment rows: g and g + 8 of its warp's 16 in each of
  // its m64 tiles, planes sh_lo / sh_hi of spike rows row_lo[i] / row_hi[i]
  // (of the block), in act row tiles at_lo[i] / at_hi[i] (of the block's)
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = 16 * (warp & 3) + g;  // the row within an m64 tile
  const int sh_lo = r0 >> tile_shift, sh_hi = (r0 + 8) >> tile_shift;
  uint32_t live_planes = T >= 32 ? 0xFFFFFFFFu : (1u << T) - 1u;
  if (tmap != nullptr) {
    live_planes = 0u;
    for (int t = 0; t < T; ++t)
      if (tmap[t] > 0) live_planes |= 1u << t;
  }
  const uint32_t pl_lo = (live_planes >> sh_lo) & 1u;
  const uint32_t pl_hi = (live_planes >> sh_hi) & 1u;
  int row_lo[MT], row_hi[MT], at_lo[MT], at_hi[MT];
  uint32_t tile_bits[MT];  // the act row tiles of tile i's live rows
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int first = (MT * (warp >> 2) + i) * bm_t;  // the tile's spike rows
    row_lo[i] = first + (r0 & (bm_t - 1));
    row_hi[i] = first + ((r0 + 8) & (bm_t - 1));
    // a row past M is in no act row tile the mask names (bit 31 is never set)
    at_lo[i] = m0 + row_lo[i] < M ? ((m0 + row_lo[i]) >> act_shift) - a0 : 31;
    at_hi[i] = m0 + row_hi[i] < M ? ((m0 + row_hi[i]) >> act_shift) - a0 : 31;
    tile_bits[i] = 0u;
    if (m0 + first < M && live_planes != 0u) {
      const int b0 = ((m0 + first) >> act_shift) - a0;
      const int b1 = ((min(m_end, m0 + first + bm_t) - 1) >> act_shift) - a0;
      tile_bits[i] = (2u << b1) - (1u << b0);
    }
  }
  // stage 0's descriptor; a stage adds kWTile bytes, a k16 step 16 rows
  const uint64_t desc0 =
      wg::desc_mn_b128(wg::smem_u32(smem), kBoxBytes, 8 * kBox * 2);

  float acc[MT][BN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.f;

  for (int c = 0;; ++c) {
    const int st = c % kStages;
    wg::mbar_wait(&full[st], (c / kStages) & 1);
    const int2 inf = info[st];
    if (inf.x == 0) break;  // the end of the list
    const uint32_t mask = static_cast<uint32_t>(inf.x);
    int use = 0;  // the tiles that run: warpgroup-uniform
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (tile_bits[i] & mask) use |= 1 << i;
    if (use != 0) {
      uint32_t af[MT][kBK / 16][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!((use >> i) & 1)) continue;
        const uint32_t lo = pl_lo & (mask >> at_lo[i]);
        const uint32_t hi = pl_hi & (mask >> at_hi[i]);
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          const uint32_t in = ks < inf.y ? 1u : 0u;  // within the stage's depth
          int2 w[4];
          wg::a_words_b128(w, a_tile(st), S_::kWBoxBytes, row_lo[i], row_hi[i],
                           ks * 16 + c2);
          wg::a_frag_planes(af[i][ks], w, sh_lo, sh_hi, lo & in, hi & in);
          wg::fence_operands(af[i][ks]);
        }
      }
      const uint64_t desc = desc0 + ((st * S_::kWTile) >> 4);
      if constexpr (MT == 2) {
        if (use == 3)
          mma_tiles<BN, MT, 3>(acc, af, desc);
        else if (use == 1)
          mma_tiles<BN, MT, 1>(acc, af, desc);
        else
          mma_tiles<BN, MT, 2>(acc, af, desc);
      } else {
        mma_tiles<BN, MT, 1>(acc, af, desc);
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[st]);
    __syncwarp();
  }

  // every consumer is done with the ring: this rank's (rows, BN) partial
  // sums go over it, row t * bm + m for plane t of spike row m, then the
  // cluster's ranks are summed
  wg::bar_sync(1, kCT);
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p_lo = (sh_lo << bm_shift) + row_lo[i];
    const int p_hi = (sh_hi << bm_shift) + row_hi[i];
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      float* sub_t = part + (jn / 8) * S_::kSub + (jn % 8) * 8 + c2;
      *reinterpret_cast<float2*>(sub_t + p_lo * kPitch) =
          make_float2(acc[i][4 * jn], acc[i][4 * jn + 1]);
      *reinterpret_cast<float2*>(sub_t + p_hi * kPitch) =
          make_float2(acc[i][4 * jn + 2], acc[i][4 * jn + 3]);
    }
  }
  wg::cluster_sync();

  // rank s owns a contiguous 1/S of the (m, n) pairs of the block's live rows
  const int share = ((m_end - m0) * BN) / S;
  float* o = reinterpret_cast<float*>(out);
#define FTP_SUM_SPLITS(n)                                                      \
  sum_splits<n, FUSE, BN, kCT, S_::kSub>(part, s, share, T, bm_shift, m0, col0, \
                                         M, n_out, o, u_out)
  switch (S) {
    case 1:  // under the LIF a lone rank's tile is its sum already
      if (!FUSE) FTP_SUM_SPLITS(1);
      break;
    case 2: FTP_SUM_SPLITS(2); break;
    case 4: FTP_SUM_SPLITS(4); break;
    default: FTP_SUM_SPLITS(8); break;
  }
#undef FTP_SUM_SPLITS
  if (FUSE) {
    wg::bar_sync(1, kCT);
    int32_t* words = reinterpret_cast<int32_t*>(out);
#define FTP_LIF_PAIRS(tp)                                                   \
  lif_pairs<tp, BN, kCT, S_::kSub>(part, s, share, T, bm_shift, m0, col0,   \
                                   n_out, v_th, tau, words, u_out)
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

template <int BN, int NWG, int MT, bool FUSE>
int launch(const CUtensorMap& pmap, const CUtensorMap& amap, const void* a,
           int M, int K, int a_vec, int bk, int bn, const void* kidx,
           const void* vidx, const void* cnt, int nnb, int jmax,
           const void* act, int nkb, int act_shift, const void* tmap, int T,
           int tile_shift, int splits, int slots_per_rank, int n_out,
           float v_th, float tau, void* out, void* u_out,
           cudaStream_t stream) {
  using S_ = Shape<BN, NWG, MT>;
  auto kernel = ftp_bsr_tc_kernel<BN, NWG, MT, FUSE>;
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
  const int bm = S_::kTiles << tile_shift;
  cudaLaunchConfig_t cfg = {};
  // the row blocks of one column tile run side by side: the payload stages
  // they share are read from L2
  cfg.gridDim = dim3(splits, (M + bm - 1) / bm, nnb * (bn / BN));
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
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, pmap, amap, static_cast<const int32_t*>(a), M, K, a_vec,
      bk, bn, static_cast<const int32_t*>(kidx),
      static_cast<const int32_t*>(vidx), static_cast<const int32_t*>(cnt),
      jmax, static_cast<const int32_t*>(act), nkb, act_shift,
      static_cast<const int32_t*>(tmap), T, tile_shift, slots_per_rank, n_out,
      v_th, tau, out, static_cast<float*>(u_out));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// The simt instance.  Row tile of the kernel: bm = 4 * rows_per_thread (1
// or 4 for T <= 8, 1 or 2 for 8 < T <= 32).  payload_bf16: 1 = bf16
// payload, 0 = f32.  tmap: NULL for the full temporal walk, else a (T,)
// int32 device map (adaptive).  Returns cudaGetLastError().
int ftp_bsr_launch(const void* a, int M, int K, const void* payload,
                   int payload_bf16, int bk, int bn, const void* kidx,
                   const void* vidx, const void* cnt, int nnb, int jmax,
                   const void* act, int nkb, const void* tmap,
                   int rows_per_thread, int n_out, int T, float v_th,
                   float tau, int fuse_lif, void* out, void* u_out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FTP_BSR_ARGS a, M, K, payload, bk, bn, kidx, vidx, cnt, nnb, jmax, \
    act, nkb, tmap, n_out, T, v_th, tau, fuse_lif, out, u_out, s
  if (payload_bf16)
    return ftp::launch_bucket<Launch<__nv_bfloat16>>(rows_per_thread, T,
                                                     FTP_BSR_ARGS);
  return ftp::launch_bucket<Launch<float>>(rows_per_thread, T, FTP_BSR_ARGS);
#undef FTP_BSR_ARGS
}

// The tc instance.  a: (M, K) int32 words (a_vec: 1 when a is 16-byte
// aligned and K % 4 == 0); payload: (nnzb, bk, bn) bf16, 16-byte aligned,
// bk % 16 == 0, bn % bn_tile == 0.  act: (ceil(M / act_bm), nkb), act_bm 4,
// 8 or 16.  rows: MMA rows per block (64: one consumer warpgroup of one m64
// tile; 256: two of two), each m64 tile holding 64 / T' spike rows (T' = T
// rounded up to a power of two, at least 4); bn_tile: a block's columns, 64
// or 128 (the MMA's N); splits (1, 2, 4, 8): the cluster's ranks, rank s
// taking join slots [s * slots_per_rank, (s + 1) * slots_per_rank) of each
// column block.  Outputs as for ftp_bsr_launch.  Returns a cudaError_t, or
// ftp::wg::kDriverError + the CUresult of a refused tensor map.
int ftp_bsr_tc_launch(const void* a, int M, int K, int a_vec,
                      const void* payload, int nnzb, int bk, int bn,
                      const void* kidx, const void* vidx, const void* cnt,
                      int nnb, int jmax, const void* act, int nkb, int act_bm,
                      const void* tmap, int T, int rows, int bn_tile,
                      int splits, int slots_per_rank, int n_out, float v_th,
                      float tau, int fuse_lif, void* out, void* u_out,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int t_pad = 4;
  while (t_pad < T) t_pad *= 2;
  int act_shift = 0;
  while ((1 << act_shift) < act_bm) ++act_shift;
  int tile_shift = 0;
  while ((1 << tile_shift) < 64 / t_pad) ++tile_shift;
  const bool act_ok = act_bm == 4 || act_bm == 8 || act_bm == 16;
  if (!act_ok || T < 1 || T > 32 || (rows != 64 && rows != 256) || bk % 16 ||
      !(bn_tile == 64 || bn_tile == 128) || bn % bn_tile || nnzb < 1 ||
      !(splits == 1 || splits == 2 || splits == 4 || splits == 8) ||
      slots_per_rank < 1 || splits * slots_per_rank < jmax)
    return (int)cudaErrorInvalidValue;
  // the payload as (nnzb * bk rows, bn columns) of bf16 in 64 x 64 boxes;
  // the words, when their rows are 16-byte multiples, as (M rows, K columns)
  // of int32 in 32 x (rows / T') boxes (else the payload's map stands in,
  // unused)
  CUtensorMap pmap, amap;
  int enc = ftp::wg::encode_2d_b128(&pmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                    payload, (uint64_t)bn,
                                    (uint64_t)nnzb * bk, (uint64_t)bn * 2,
                                    tc::kBox, tc::kBK);
  if (enc == 0 && a_vec)
    enc = ftp::wg::encode_2d_b128(&amap, CU_TENSOR_MAP_DATA_TYPE_INT32, a,
                                  (uint64_t)K, (uint64_t)M, (uint64_t)K * 4,
                                  tc::kWordBox, rows / t_pad);
  else
    amap = pmap;
  if (enc != 0) return enc;
#define FTP_BSR_TC_ARGS pmap, amap, a, M, K, a_vec, bk, bn, kidx, vidx, cnt, \
    nnb, jmax, act, nkb, act_shift, tmap, T, tile_shift, splits,             \
    slots_per_rank, n_out, v_th, tau, out, u_out, s
#define FTP_BSR_TC_ROWS(BN)                                             \
  if (rows == 64)                                                      \
    return fuse_lif ? tc::launch<BN, 1, 1, true>(FTP_BSR_TC_ARGS)      \
                    : tc::launch<BN, 1, 1, false>(FTP_BSR_TC_ARGS);    \
  return fuse_lif ? tc::launch<BN, 2, 2, true>(FTP_BSR_TC_ARGS)        \
                  : tc::launch<BN, 2, 2, false>(FTP_BSR_TC_ARGS);
  if (bn_tile == 128) {
    FTP_BSR_TC_ROWS(128)
  }
  FTP_BSR_TC_ROWS(64)
#undef FTP_BSR_TC_ROWS
#undef FTP_BSR_TC_ARGS
}

const char* ftp_bsr_error_string(int code) {
  if (code >= ftp::wg::kDriverError) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused a tensor map: "
             "CUresult %d", code - ftp::wg::kDriverError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
