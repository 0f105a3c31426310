// Dense-weight FTP spMspM: packed spike words x dense weights, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces: src/repro/kernels/ftp_spmm.py::_ftp_spmm_kernel (entered through
// ftp_spmm: full sums) and ::_ftp_spmm_lif_kernel (entered through
// ftp_spmm_fused_lif: the fused hard-reset P-LIF), the template's FUSE = 0
// and FUSE = 1.
//
// What it computes, for output tile (row tile i, 32 columns from col0):
//   acc[t, r, n] = sum over k ascending of bit_t(a[r, k]) * b[k, n]
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
// What the design does about it: the TPU grid walked (i, j, k) in order
// with a (T*bm, bn) accumulator in VMEM.  Here one thread block owns one
// output tile and walks K in a device-side loop of 128-deep steps (no
// split-K), so every output element is summed in one fixed order, ascending
// k, for every M and row tile: outputs are row-parallel and batch-invariant.
// That is kernel 3's order too (ftp_bsr.cu walks its join list in ascending
// k-block, then ascending k), so on block-pruned weights the full sums equal
// the BSR kernel's bit for bit: a pruned weight only adds +0.  Each step
// stages the weight sub-tile (128 x 32) into shared memory with 16-byte loads
// (read once per row tile), and the spike words of the tile beside it.
// Each thread owns one output column and RPT rows and keeps the (RPT x TMAX)
// f32 accumulator in registers; a spike word is the same for every lane of a
// warp, so the silent-neuron skip (word == 0) and the bit tests are
// warp-uniform branches.  Bits gate additions, never multiplications.
// Ragged rows, a K tail and columns past N are masked here: the host pads
// nothing (a ragged or unaligned N falls back to 2- or 4-byte loads).
//
// T may be anything up to the 32 bits of a word: the accumulator depth is a
// template bucket (TMAX = 8, 16 or 32), and the rows a thread owns shrink as
// it grows (4 rows at TMAX 8, 2 above).  The accumulate step, the LIF
// epilogue and the bucket dispatch are kernel 3's own (ftp_common.cuh).
//
// A simple SIMT kernel: wgmma/TMA/mma.sync come in later work.

#include "ftp_common.cuh"

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

extern "C" {

// a: (M, K) int32 words; b: (K, N) row-major weights (weight_bf16: 1 = bf16,
// 0 = f32); vec_ok: 1 when b is 16-byte aligned and N a multiple of 16 bytes
// of weights.  Row tile bm = 4 * rows_per_thread (1 or 4 for T <= 8, 1 or 2
// for 8 < T <= 32).  fuse_lif: out = (M, N) int32 words and u_out = (M, N)
// f32 U; else out = (T, M, N) f32 full sums and u_out unused.  Returns
// cudaGetLastError().
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

const char* ftp_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
