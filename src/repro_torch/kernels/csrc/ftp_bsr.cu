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
//   adaptive (tmap != NULL): the add of plane t is skipped wherever
//                 tmap[t] == 0 (the spike word is masked to the live
//                 planes before its bits are read); the LIF epilogue still
//                 walks all T.  A plane the map gates at min_spikes = 1 has
//                 no bit set anywhere, so the adds that remain, and their
//                 order, are the full kernel's: the outputs are equal bit
//                 for bit.
//
// What bounds it on the H100: at decode (M = batch rows, a handful) the
// bytes of the weight payload it must stream (one bf16 128x128 block is
// 32 KB; the llama3.2-1b FFN at block density 0.3 holds ~10 MB per GEMM,
// ~3 us at 3.35 TB/s).  In prefill (M = B * prompt rows) the work grows
// with M while the payload does not, and the kernel moves toward its
// compute bound.
//
// What the design does about it: the TPU grid walked (i, j, jj) in order
// with the accumulator in VMEM.  Here one thread block owns one output tile
// and walks the join list in a device-side loop over jj < cnt[j] (no grid
// padded to jmax, no split-K), so the accumulation order of each output
// element is fixed — ascending join slot, ascending kk — for every M and
// every row tile: outputs are row-parallel and batch-invariant.  Each slot
// stages its weight sub-tile into shared memory with 16-byte loads by all
// threads (the payload is read once per row tile), and the spike words of
// the tile beside it.  Each thread owns one output column and RPT rows and
// keeps the (T x RPT) f32 accumulator in registers; a spike word is the
// same for every lane of a warp, so the silent-neuron skip (word == 0) and
// the bit tests are warp-uniform branches.  Bits gate additions, never
// multiplications, so the f32 sums are exact up to the fixed order.
// Ragged rows (M not a multiple of the row tile), K tails and columns past
// n_out are masked here: the host pads nothing.
//
// T may be anything up to the 32 bits of a word.  The accumulator depth is
// a template bucket (TMAX = 8, 16 or 32, the smallest that holds T), and the
// rows a thread owns shrink as it grows (4 rows at TMAX 8, 2 above), so the
// (RPT x TMAX) f32 accumulator stays within the register file.  The
// accumulate step, the LIF epilogue and the bucket dispatch are shared with
// ftp_dense.cu (ftp_common.cuh).
//
// A simple SIMT kernel: wgmma/TMA/mma.sync come in later work.

#include "ftp_common.cuh"

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

extern "C" {

// Row tile of the kernel: bm = 4 * rows_per_thread (1 or 4 for T <= 8, 1 or
// 2 for 8 < T <= 32).  payload_bf16: 1 = bf16 payload, 0 = f32.  tmap: NULL
// for the full temporal walk, else a (T,) int32 device map (adaptive).
// Returns cudaGetLastError().
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

const char* ftp_bsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
