// Dual-sparse FTP spMspM over a load-time weight join plan, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: src/repro/kernels/ftp_spmm.py::_ftp_bsr_kernel (entered through
// ftp_spmm_bsr with tmap=None), both settings of fuse_lif.
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
// A simple SIMT kernel: wgmma/TMA/mma.sync come in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;   // output columns per thread block: one per lane
constexpr int kMaxT = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename W, int RPT>
__global__ void __launch_bounds__(kThreads) ftp_bsr_kernel(
    const int32_t* __restrict__ a, int M, int K,
    const W* __restrict__ payload, int bk, int bn,
    const int32_t* __restrict__ kidx, const int32_t* __restrict__ vidx,
    const int32_t* __restrict__ cnt, int jmax,
    const int32_t* __restrict__ act, int nkb,
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

  float acc[RPT][kMaxT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[r][t] = 0.f;

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
      const float w = to_f32(w_s[kk * kCols + lane]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const uint32_t word = (uint32_t)a_s[(warp * RPT + r) * bk + kk];
        if (word == 0u) continue;  // silent neuron: warp-uniform skip
#pragma unroll
        for (int t = 0; t < kMaxT; ++t)
          if (t < T && ((word >> t) & 1u)) acc[r][t] = __fadd_rn(acc[r][t], w);
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
      float u = 0.f;
      uint32_t packed = 0u;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (t < T) {
          // _rn intrinsics: never contracted into an FMA, so the epilogue
          // rounds exactly like the plain version's separate ops.
          const float x = __fadd_rn(acc[r][t], u);
          const bool c = x > v_th;
          u = __fmul_rn(__fmul_rn(tau, x), c ? 0.f : 1.f);
          packed |= (uint32_t)c << t;
        }
      }
      reinterpret_cast<int32_t*>(out)[at] = (int32_t)packed;
      u_out[at] = u;
    } else {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int t = 0; t < kMaxT; ++t)
        if (t < T) o[(size_t)t * M * n_out + at] = acc[r][t];
      u_out[at] = 0.f;
    }
  }
}

template <typename W, int RPT>
int launch(const void* a, int M, int K, const void* payload, int bk, int bn,
           const void* kidx, const void* vidx, const void* cnt, int nnb,
           int jmax, const void* act, int nkb, int n_out, int T, float v_th,
           float tau, int fuse_lif, void* out, void* u_out,
           cudaStream_t stream) {
  constexpr int BM = kWarps * RPT;
  const dim3 grid(nnb * (bn / kCols), (M + BM - 1) / BM);
  const size_t smem = (size_t)bk * kCols * sizeof(W) + (size_t)BM * bk * 4;
  ftp_bsr_kernel<W, RPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(a), M, K, static_cast<const W*>(payload),
      bk, bn, static_cast<const int32_t*>(kidx),
      static_cast<const int32_t*>(vidx), static_cast<const int32_t*>(cnt),
      jmax, static_cast<const int32_t*>(act), nkb, n_out, T, v_th, tau,
      fuse_lif, out, static_cast<float*>(u_out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tile of the kernel for rows_per_thread: bm = 4 * rows_per_thread.
// payload_bf16: 1 = bf16 payload, 0 = f32.  Returns cudaGetLastError().
int ftp_bsr_launch(const void* a, int M, int K, const void* payload,
                   int payload_bf16, int bk, int bn, const void* kidx,
                   const void* vidx, const void* cnt, int nnb, int jmax,
                   const void* act, int nkb, int rows_per_thread, int n_out,
                   int T, float v_th, float tau, int fuse_lif, void* out,
                   void* u_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FTP_BSR_ARGS a, M, K, payload, bk, bn, kidx, vidx, cnt, nnb, jmax, \
    act, nkb, n_out, T, v_th, tau, fuse_lif, out, u_out, s
  if (payload_bf16) {
    if (rows_per_thread == 1) return launch<__nv_bfloat16, 1>(FTP_BSR_ARGS);
    if (rows_per_thread == 4) return launch<__nv_bfloat16, 4>(FTP_BSR_ARGS);
  } else {
    if (rows_per_thread == 1) return launch<float, 1>(FTP_BSR_ARGS);
    if (rows_per_thread == 4) return launch<float, 4>(FTP_BSR_ARGS);
  }
#undef FTP_BSR_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* ftp_bsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
