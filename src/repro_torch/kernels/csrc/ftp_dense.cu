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
//   same rows feed mma.sync.m16n8k16 bf16 with f32 accumulation, which is
//   exact per product ({0,1} x bf16).  Each thread builds its A fragments
//   in registers from the spike words in shared memory (bit t of word
//   (m, k) -> bf16 1.0 or 0; rows with t >= T or m >= M are 0), so no
//   unpacked plane reaches device memory.  The weight streams through a
//   4-stage cp.async ring of 64 x 64 bf16 tiles (rows padded to 144 B so
//   ldmatrix.trans reads B fragments without bank conflicts), the words of
//   the tile's spike rows beside it.  Decode needs more blocks than column
//   tiles, so K is split across the blocks of a thread-block cluster:
//   splits (1, 2, 4 or 8) and the 64-deep split boundaries are functions
//   of (K, N) only, never of M.  Each split sums its k range in ascending
//   16-deep steps; the splits' partial tiles meet in distributed shared
//   memory and are added in ascending rank order (no scratch, no atomics).
//   Every output element's sum order is therefore fixed by (K, N): rows are
//   batch-invariant and runs deterministic, for any row tile.  The row
//   tile (64 or 128 MMA rows holding bm = rows / T' spike rows, T' = T
//   rounded up to a power of two, at least 4) grows with M only to re-read
//   the weight less in prefill.
//   The epilogue (the LIF through ftp::lif, or the full sums) runs on the
//   summed values; ragged M, K, N and T are masked in the kernel.
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
// not bit for bit.  Next steps for speed: wgmma and TMA, a persistent grid.

#include "ftp_common.cuh"
#include "ftp_tc.cuh"

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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__host__ __device__ constexpr int stage_bytes(int mtw) {
  // weight tile + the spike words of up to rows / 4 rows (T >= 4 rows each)
  return kBK * kWPitch * 2 + (16 * mtw) * kAPitch * 4;
}
__host__ __device__ constexpr int smem_bytes(int mtw) {
  return kStages * stage_bytes(mtw) > 64 * mtw * kPPitch * 4
             ? kStages * stage_bytes(mtw)
             : 64 * mtw * kPPitch * 4;
}

// One block: split s = its cluster rank, 64 output columns from col0, the
// spike rows m0 .. m0 + bm.  Its MMA rows are r = t * bm + m (the
// reference's _unpack_fold), 64 * MTW of them: warp w owns rows
// [16 MTW w, 16 MTW (w + 1)) and all 64 columns (MTW m16 x 8 n8 tiles).
template <int MTW, bool FUSE>
__global__ void __launch_bounds__(kThreads) ftp_dense_tc_kernel(
    const int32_t* __restrict__ a, int M, int K, int a_vec,
    const __nv_bfloat16* __restrict__ b, int N, int T, int bm_shift,
    int k_split, float v_th, float tau, void* __restrict__ out,
    float* __restrict__ u_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int s = static_cast<int>(cluster.block_rank());
  const int bm = 1 << bm_shift;
  const int col0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * bm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_begin = s * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nchunks = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto w_tile = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(smem + st * stage_bytes(MTW));
  };
  auto a_tile = [&](int st) {
    return reinterpret_cast<int32_t*>(smem + st * stage_bytes(MTW) +
                                      kBK * kWPitch * 2);
  };

  // Rows past k_end (the K tail, the next split's rows), columns past N and
  // spike rows past M arrive as zeros: a zero word adds nothing, and a zero
  // weight keeps 0 * (Inf or NaN) out of the sums.
  auto load_chunk = [&](int c, int st) {
    const int k0 = k_begin + c * kBK;
    __nv_bfloat16* ws = w_tile(st);
    for (int idx = tid; idx < kBK * (kBN / 8); idx += kThreads) {
      const int kk = idx >> 3, ch = idx & 7;
      const int gk = k0 + kk, gn = col0 + ch * 8;
      const bool ok = gk < k_end && gn < N;
      cp_async16(ws + kk * kWPitch + ch * 8,
                 ok ? b + (size_t)gk * N + gn : b, ok ? 16 : 0);
    }
    int32_t* as = a_tile(st);
    if (a_vec) {
      for (int idx = tid; idx < bm * (kBK / 4); idx += kThreads) {
        const int row = idx >> 4, ch = idx & 15;
        const int gm = m0 + row, gk = k0 + ch * 4;
        const int bytes = gm < M ? min(16, max(0, (k_end - gk) * 4)) : 0;
        cp_async16(as + row * kAPitch + ch * 4,
                   bytes ? a + (size_t)gm * K + gk : a, bytes);
      }
    } else {
      for (int idx = tid; idx < bm * kBK; idx += kThreads) {
        const int row = idx >> 6, kk = idx & 63;
        const int gm = m0 + row, gk = k0 + kk;
        const bool ok = gm < M && gk < k_end;
        cp_async4(as + row * kAPitch + kk, ok ? a + (size_t)gm * K + gk : a,
                  ok ? 4 : 0);
      }
    }
  };

  // this thread's A-fragment rows: g and g + 8 of each m16 tile
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  int m_lo[MTW], m_hi[MTW], sh_lo[MTW], sh_hi[MTW];
  uint32_t live_lo[MTW], live_hi[MTW];
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int r = (warp * MTW + i) * 16 + g;
    m_lo[i] = r & (bm - 1);
    sh_lo[i] = r >> bm_shift;
    live_lo[i] = sh_lo[i] < T ? 1u : 0u;
    m_hi[i] = (r + 8) & (bm - 1);
    sh_hi[i] = (r + 8) >> bm_shift;
    live_hi[i] = sh_hi[i] < T ? 1u : 0u;
  }

  float acc[MTW][8][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[8][2];
      b_frags<4>(bf, ws, ks, 0, lane);
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        uint32_t af[4];
        a_frag(af, as + m_lo[i] * kAPitch + ks * 16 + c2,
               as + m_hi[i] * kAPitch + ks * 16 + c2, sh_lo[i], sh_hi[i],
               live_lo[i], live_hi[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this split's (64 MTW, 64) partial sums into shared memory (the ring's
  // space), then the cluster's splits summed in ascending rank order
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = (warp * MTW + i) * 16 + g, n = j * 8 + c2;
      *reinterpret_cast<float2*>(part + r * kPPitch + n) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(part + (r + 8) * kPPitch + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  cluster.sync();

  const float* parts[kMaxSplits];
#pragma unroll
  for (int q = 0; q < kMaxSplits; ++q)
    parts[q] = q < S ? cluster.map_shared_rank(part, q) : part;
  // rank s owns a contiguous 1/S of the block's (m, n) pairs, all T planes
  const int per_rank = (bm * kBN) / S;
  for (int p = s * per_rank + tid; p < (s + 1) * per_rank; p += kThreads) {
    const int m = p / kBN, n = p % kBN;
    const int gm = m0 + m, gn = col0 + n;
    if (gm >= M || gn >= N) continue;
    float x[32];
    rank_sum(x, parts, S, T, bm_shift, m, n);
    const size_t at = (size_t)gm * N + gn;
    if (FUSE) {
      reinterpret_cast<int32_t*>(out)[at] =
          (int32_t)ftp::lif(x, T, v_th, tau, &u_out[at]);
    } else {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int t = 0; t < 32; ++t)
        if (t < T) o[(size_t)t * M * N + at] = x[t];
    }
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

template <int MTW, bool FUSE>
int launch(const void* a, int M, int K, int a_vec, const void* b, int N,
           int T, int bm, int splits, int k_split, float v_th, float tau,
           void* out, void* u_out, cudaStream_t stream) {
  auto kernel = ftp_dense_tc_kernel<MTW, FUSE>;
  constexpr int smem = smem_bytes(MTW);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kBN - 1) / kBN, (M + bm - 1) / bm);
  cfg.blockDim = dim3(kThreads);
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
      static_cast<const __nv_bfloat16*>(b), N, T, bm_shift, k_split,
      v_th, tau, out, static_cast<float*>(u_out));
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
// aligned and K % 4 == 0); b: (K, N) bf16, 16-byte aligned, N % 8 == 0.
// rows: MMA rows per block (64 or 128); bm: spike rows per block, a power of
// two with T <= rows / bm; splits (1, 2, 4, 8): the cluster's K splits,
// each k_split deep (a multiple of 64).  Outputs as for ftp_dense_launch.
int ftp_dense_tc_launch(const void* a, int M, int K, int a_vec, const void* b,
                        int N, int T, int rows, int bm, int splits,
                        int k_split, float v_th, float tau, int fuse_lif,
                        void* out, void* u_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pow2 = bm >= 2 && (bm & (bm - 1)) == 0;
  if (!pow2 || T < 1 || T * bm > rows || N % 8 || k_split % tc::kBK ||
      !(splits == 1 || splits == 2 || splits == 4 || splits == 8) ||
      (rows != 64 && rows != 128) || bm > rows / 4)
    return (int)cudaErrorInvalidValue;
#define FTP_TC_ARGS a, M, K, a_vec, b, N, T, bm, splits, k_split, v_th, tau, \
    out, u_out, s
  if (rows == 64)
    return fuse_lif ? tc::launch<1, true>(FTP_TC_ARGS)
                    : tc::launch<1, false>(FTP_TC_ARGS);
  return fuse_lif ? tc::launch<2, true>(FTP_TC_ARGS)
                  : tc::launch<2, false>(FTP_TC_ARGS);
#undef FTP_TC_ARGS
}

const char* ftp_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
