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
//   {0,1} planes of the (bm, bk) spike block into MMA rows r = t * bm + m
//   and runs one f32-accumulated dot with the (bk, bn) payload block on
//   the MXU; here the same rows feed mma.sync.m16n8k16 bf16 with f32
//   accumulation, exact per product, A fragments built in registers from
//   the spike words (ftp_tc.cuh).  One block owns 64 output columns of one
//   column block and exactly one act row tile (bm = 4, 8 or 16 spike rows,
//   rows = T' * bm MMA rows, T' = T rounded up to a power of two, at least
//   4; 4 warps, 8 at 256 rows).  It first compacts its share of the join
//   list into shared memory: the (kb, v) pairs of live slots whose spike
//   block is active, so no dependent act load sits in front of a copy.
//   Then each slot's (bk, 64) payload sub-tile streams as 64-deep stages
//   of a 4-stage cp.async ring (rows padded to 144 B, ldmatrix.trans), the
//   block's spike words beside it; the payload is read once per row tile.
//   Decode needs more blocks than column tiles, so the join list is split
//   across the S blocks of a thread-block cluster: S (1, 2, 4 or 8) and
//   each rank's slot range [s * per, (s + 1) * per) are functions of the
//   plan alone (nnb, bn, jmax), never of M.  Each rank sums its slots in
//   ascending slot order and ascending 16-deep k steps; the ranks' partial
//   tiles meet in distributed shared memory and are added in ascending rank
//   order (no scratch, no atomics).  A skipped silent block, an empty rank
//   and a zero row all add exactly +0, so every output element's sum order
//   is fixed by the plan: rows are batch-invariant, runs deterministic, and
//   the act row tile decides work, not results.  Adaptive: a gated plane's
//   rows are zero, and an m16 row group whose planes are all gated issues
//   no mma (the temporal skip), which keeps kernel 4 == kernel 3.
//   The epilogue (ftp::lif, or the full sums) runs on the summed values;
//   ragged M, K tails inside a block, columns past n_out and T from 1 to
//   32 are masked in the kernel.
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
// rounding, not bit for bit.  Next steps for speed: wgmma and TMA, several
// act row tiles per block in prefill, a persistent grid.

#include "ftp_common.cuh"
#include "ftp_tc.cuh"

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
using ftp::tc::a_frag;
using ftp::tc::b_frags;
using ftp::tc::cp_async16;
using ftp::tc::cp_async4;
using ftp::tc::cp_async_commit;
using ftp::tc::cp_async_wait;
using ftp::tc::kAPitch;
using ftp::tc::kBK;
using ftp::tc::kBN;
using ftp::tc::kMaxSplits;
using ftp::tc::kPPitch;
using ftp::tc::kStages;
using ftp::tc::kWPitch;
using ftp::tc::mma_bf16;
using ftp::tc::rank_sum;

constexpr int kMaxBm = 16;  // spike rows of the largest act row tile
// one ring stage: a 64-deep payload tile and the words of up to 16 rows
constexpr int kStageBytes = kBK * kWPitch * 2 + kMaxBm * kAPitch * 4;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxSmem = 232448;  // 227 KB, the H100's opt-in per block

// The warp grid of a block of ROWS MMA rows and 64 columns (8 n8 tiles):
// kWM warps along the rows, each owning kMTW m16 tiles, times kWN along
// the columns, each owning kNTW n8 tiles.  A warp keeps kMTW * kNTW * 4 f32
// sums: 8 at 16 rows up to 64 at 128 and, with 8 warps, at 256.
template <int ROWS>
struct Shape {
  static constexpr int kMTiles = ROWS / 16;
  static constexpr int kWarps = ROWS == 256 ? 8 : 4;
  static constexpr int kWM = kMTiles < kWarps ? kMTiles : kWarps;
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kMTW = kMTiles / kWM;
  static constexpr int kNTW = 8 / kWN;
  static constexpr int kThreads = kWarps * 32;
  // the ring, or the partial-sum tile that reuses it after the loop
  static constexpr int kBody =
      kRingBytes > ROWS * kPPitch * 4 ? kRingBytes : ROWS * kPPitch * 4;
};

__host__ __device__ constexpr size_t list_offset(int body) {
  return (size_t)body + 16;  // the live-slot count sits in the 16 bytes between
}

// One block: cluster rank s of column tile blockIdx.y (column block j, its
// 64-column sub-tile sub) and act row tile blockIdx.z (spike rows m0 ..
// m0 + bm).  Its MMA rows are r = t * bm + m, ROWS of them.
template <int ROWS>
__global__ void __launch_bounds__(Shape<ROWS>::kThreads) ftp_bsr_tc_kernel(
    const int32_t* __restrict__ a, int M, int K, int a_vec,
    const __nv_bfloat16* __restrict__ payload, int bk, int bn,
    const int32_t* __restrict__ kidx, const int32_t* __restrict__ vidx,
    const int32_t* __restrict__ cnt, int jmax,
    const int32_t* __restrict__ act, int nkb,
    const int32_t* __restrict__ tmap, int T, int bm_shift,
    int slots_per_rank, int n_out, float v_th, float tau, int fuse_lif,
    void* __restrict__ out, float* __restrict__ u_out) {
  using Sh = Shape<ROWS>;
  constexpr int MTW = Sh::kMTW, NTW = Sh::kNTW, NT = Sh::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int s = static_cast<int>(cluster.block_rank());
  const int bm = 1 << bm_shift;
  const int subs = bn / kBN;
  const int j = blockIdx.y / subs;
  const int sub = blockIdx.y - j * subs;
  const int i = blockIdx.z;
  const int m0 = i * bm;
  const int col0 = j * bn + sub * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / Sh::kWN, wn = warp % Sh::kWN;
  int* n_live_s = reinterpret_cast<int*>(smem + Sh::kBody);
  int2* list = reinterpret_cast<int2*>(smem + list_offset(Sh::kBody));

  // This rank's share of the join list, compacted by warp 0 in ascending
  // slot order: the (kb, v) of each live slot whose spike block is active.
  if (warp == 0) {
    const int lo = s * slots_per_rank;
    const int end = min(jmax, lo + slots_per_rank);
    const int hi = min(cnt[j], end);
    int n = 0;
    for (int base = lo; base < end; base += 32) {
      const int jj = base + lane;
      int kb = 0, v = 0;
      if (jj < end) {
        kb = kidx[j * jmax + jj];
        v = vidx[j * jmax + jj];
      }
      const bool ok = jj < hi && act[(size_t)i * nkb + kb] != 0;
      const unsigned ball = __ballot_sync(0xffffffffu, ok);
      if (ok) list[n + __popc(ball & ((1u << lane) - 1u))] = make_int2(kb, v);
      n += __popc(ball);
    }
    if (lane == 0) *n_live_s = n;
  }

  uint32_t live_planes = T >= 32 ? 0xFFFFFFFFu : (1u << T) - 1u;
  if (tmap != nullptr) {
    live_planes = 0u;
    for (int t = 0; t < T; ++t)
      if (tmap[t] > 0) live_planes |= 1u << t;
  }
  // this thread's A-fragment rows (g and g + 8 of each of its m16 tiles),
  // and which of its tiles hold a live plane at all
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  int m_lo[MTW], m_hi[MTW], sh_lo[MTW], sh_hi[MTW];
  uint32_t live_lo[MTW], live_hi[MTW];
  bool tile_live[MTW];
#pragma unroll
  for (int ii = 0; ii < MTW; ++ii) {
    const int r0 = (wm * MTW + ii) * 16;
    const int r = r0 + g;
    m_lo[ii] = r & (bm - 1);
    sh_lo[ii] = r >> bm_shift;
    live_lo[ii] = (live_planes >> sh_lo[ii]) & 1u;
    m_hi[ii] = (r + 8) & (bm - 1);
    sh_hi[ii] = (r + 8) >> bm_shift;
    live_hi[ii] = (live_planes >> sh_hi[ii]) & 1u;
    const int t0 = r0 >> bm_shift, nt = ((r0 + 15) >> bm_shift) - t0 + 1;
    tile_live[ii] = ((live_planes >> t0) & ((1u << nt) - 1u)) != 0u;
  }

  float acc[MTW][NTW][4];
#pragma unroll
  for (int ii = 0; ii < MTW; ++ii)
#pragma unroll
    for (int jn = 0; jn < NTW; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ii][jn][e] = 0.f;

  __syncthreads();  // the compacted list
  const int n_live = *n_live_s;
  const int nq = (bk + kBK - 1) / kBK;  // ring stages per join slot
  const int nchunks = n_live * nq;

  auto w_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * kStageBytes);
  };
  auto a_tile = [&](int st) {
    return reinterpret_cast<int32_t*>(smem + st * kStageBytes +
                                      kBK * kWPitch * 2);
  };

  // Stage q of compacted slot sl: payload rows [q * 64, q * 64 + depth) of
  // block v, the block's 64 columns, and the words of its spike rows at
  // k = kb * bk + q * 64 + kk.  Words past M and past K arrive as zeros;
  // payload rows past depth are not read by the step loop.
  auto load_chunk = [&](int c, int st) {
    const int sl = c / nq, q = c - sl * nq;
    const int2 e = list[sl];
    const int kin = q * kBK;
    const int depth = min(kBK, bk - kin);
    __nv_bfloat16* ws = w_tile(st);
    const __nv_bfloat16* src =
        payload + ((size_t)e.y * bk + kin) * bn + sub * kBN;
    for (int idx = tid; idx < depth * (kBN / 8); idx += NT) {
      const int kk = idx >> 3, ch = idx & 7;
      cp_async16(ws + kk * kWPitch + ch * 8, src + (size_t)kk * bn + ch * 8,
                 16);
    }
    int32_t* as = a_tile(st);
    const int k0 = e.x * bk + kin;
    const int k_end = min(K, k0 + depth);
    if (a_vec) {
      for (int idx = tid; idx < bm * (kBK / 4); idx += NT) {
        const int row = idx >> 4, ch = idx & 15;
        const int gm = m0 + row, gk = k0 + ch * 4;
        const int bytes = gm < M ? min(16, max(0, (k_end - gk) * 4)) : 0;
        cp_async16(as + row * kAPitch + ch * 4,
                   bytes ? a + (size_t)gm * K + gk : a, bytes);
      }
    } else {
      for (int idx = tid; idx < bm * kBK; idx += NT) {
        const int row = idx >> 6, kk = idx & 63;
        const int gm = m0 + row, gk = k0 + kk;
        const bool ok = gm < M && gk < k_end;
        cp_async4(as + row * kAPitch + kk, ok ? a + (size_t)gm * K + gk : a,
                  ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_chunk(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nc = c + kStages - 1;
    if (nc < nchunks) load_chunk(nc, nc % kStages);
    cp_async_commit();

    const __nv_bfloat16* ws = w_tile(c % kStages);
    const int32_t* as = a_tile(c % kStages);
    const int steps = min(kBK, bk - (c % nq) * kBK) / 16;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      if (ks >= steps) break;
      uint32_t bf[NTW][2];
      b_frags<NTW / 2>(bf, ws, ks, wn * (NTW / 2), lane);
#pragma unroll
      for (int ii = 0; ii < MTW; ++ii) {
        if (!tile_live[ii]) continue;  // every plane of the group gated
        uint32_t af[4];
        a_frag(af, as + m_lo[ii] * kAPitch + ks * 16 + c2,
               as + m_hi[ii] * kAPitch + ks * 16 + c2, sh_lo[ii], sh_hi[ii],
               live_lo[ii], live_hi[ii]);
#pragma unroll
        for (int jn = 0; jn < NTW; ++jn)
          mma_bf16(acc[ii][jn], af, bf[jn][0], bf[jn][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this rank's (ROWS, 64) partial sums into shared memory (the ring's
  // space), then the cluster's ranks summed in ascending rank order
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int ii = 0; ii < MTW; ++ii)
#pragma unroll
    for (int jn = 0; jn < NTW; ++jn) {
      const int r = (wm * MTW + ii) * 16 + g, n = (wn * NTW + jn) * 8 + c2;
      *reinterpret_cast<float2*>(part + r * kPPitch + n) =
          make_float2(acc[ii][jn][0], acc[ii][jn][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * kPPitch + n) =
          make_float2(acc[ii][jn][2], acc[ii][jn][3]);
    }
  cluster.sync();

  const float* parts[kMaxSplits];
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    parts[q] = q < S ? cluster.map_shared_rank(part, q) : part;
  // rank s owns a contiguous 1/S of the block's (m, n) pairs, all T planes
  const int per_rank = (bm * kBN) / S;
  for (int p = s * per_rank + tid; p < (s + 1) * per_rank; p += NT) {
    const int m = p / kBN, n = p % kBN;
    const int gm = m0 + m, gn = col0 + n;
    if (gm >= M || gn >= n_out) continue;
    float x[32];
    rank_sum(x, parts, S, T, bm_shift, m, n);
    const size_t at = (size_t)gm * n_out + gn;
    if (fuse_lif) {
      reinterpret_cast<int32_t*>(out)[at] =
          (int32_t)ftp::lif(x, T, v_th, tau, &u_out[at]);
    } else {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int t = 0; t < 32; ++t)
        if (t < T) o[(size_t)t * M * n_out + at] = x[t];
      u_out[at] = 0.f;
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

template <int ROWS>
int launch(const void* a, int M, int K, int a_vec, const void* payload,
           int bk, int bn, const void* kidx, const void* vidx,
           const void* cnt, int nnb, int jmax, const void* act, int nkb,
           const void* tmap, int T, int bm, int splits, int slots_per_rank,
           int n_out, float v_th, float tau, int fuse_lif, void* out,
           void* u_out, cudaStream_t stream) {
  using Sh = Shape<ROWS>;
  auto kernel = ftp_bsr_tc_kernel<ROWS>;
  const size_t smem = list_offset(Sh::kBody) + (size_t)slots_per_rank * 8;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel takes dynamic shared memory only once allowed;
  // raised as larger lists arrive (one host thread launches)
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, nnb * (bn / kBN), (M + bm - 1) / bm);
  cfg.blockDim = dim3(Sh::kThreads);
  cfg.dynamicSmemBytes = smem;
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
      &cfg, kernel, static_cast<const int32_t*>(a), M, K, a_vec,
      static_cast<const __nv_bfloat16*>(payload), bk, bn,
      static_cast<const int32_t*>(kidx), static_cast<const int32_t*>(vidx),
      static_cast<const int32_t*>(cnt), jmax,
      static_cast<const int32_t*>(act), nkb,
      static_cast<const int32_t*>(tmap), T, bm_shift, slots_per_rank, n_out,
      v_th, tau, fuse_lif, out, static_cast<float*>(u_out));
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
// bk % 16 == 0, bn % 64 == 0.  bm: the act row tile (4, 8 or 16); rows: MMA
// rows per block (T' * bm, T' = T rounded up to a power of two, >= 4);
// splits (1, 2, 4, 8): the cluster's ranks, rank s taking join slots
// [s * slots_per_rank, (s + 1) * slots_per_rank) of each column block.
// Outputs as for ftp_bsr_launch.
int ftp_bsr_tc_launch(const void* a, int M, int K, int a_vec,
                      const void* payload, int bk, int bn, const void* kidx,
                      const void* vidx, const void* cnt, int nnb, int jmax,
                      const void* act, int nkb, const void* tmap, int T,
                      int rows, int bm, int splits, int slots_per_rank,
                      int n_out, float v_th, float tau, int fuse_lif,
                      void* out, void* u_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bm_ok = bm == 4 || bm == 8 || bm == 16;
  const int t_pad = bm_ok ? rows / bm : 0;
  if (!bm_ok || T < 1 || T > t_pad || t_pad < 4 || t_pad > 32 ||
      t_pad * bm != rows || bk % 16 || bn % tc::kBN ||
      !(splits == 1 || splits == 2 || splits == 4 || splits == 8) ||
      slots_per_rank < 1 || splits * slots_per_rank < jmax)
    return (int)cudaErrorInvalidValue;
#define FTP_BSR_TC_ARGS a, M, K, a_vec, payload, bk, bn, kidx, vidx, cnt, \
    nnb, jmax, act, nkb, tmap, T, bm, splits, slots_per_rank, n_out, v_th,   \
    tau, fuse_lif, out, u_out, s
  switch (rows) {
    case 16: return tc::launch<16>(FTP_BSR_TC_ARGS);
    case 32: return tc::launch<32>(FTP_BSR_TC_ARGS);
    case 64: return tc::launch<64>(FTP_BSR_TC_ARGS);
    case 128: return tc::launch<128>(FTP_BSR_TC_ARGS);
    case 256: return tc::launch<256>(FTP_BSR_TC_ARGS);
  }
#undef FTP_BSR_TC_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* ftp_bsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
