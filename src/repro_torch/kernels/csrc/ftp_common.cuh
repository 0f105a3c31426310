// What the FTP kernels' SIMT instances (ftp_bsr.cu's and ftp_dense.cu's)
// share: the thread layout, the bit-gated accumulate step, the hard-reset
// LIF epilogue and the dispatch over (rows per thread, accumulator depth)
// buckets.  Both add in f32 with the same instructions in the same order,
// which is what makes their full sums equal on block-pruned weights.  The
// tensor-core instances (ftp_tc.cuh) use the LIF epilogue alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ftp {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;  // output columns per thread block: one per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Adds w to acc[t] for every set bit t < T of one spike word.  A word is the
// same for every lane of a warp, so the silent-neuron skip (word == 0) and
// the bit tests are warp-uniform branches.  Bits gate additions, never
// multiplications; __fadd_rn is never contracted into an FMA.
template <int TMAX>
__device__ __forceinline__ void accumulate(float (&acc)[TMAX], uint32_t word,
                                           float w, int T) {
  if (word == 0u) return;
#pragma unroll
  for (int t = 0; t < TMAX; ++t)
    if (t < T && ((word >> t) & 1u)) acc[t] = __fadd_rn(acc[t], w);
}

// Hard-reset LIF over t < T in f32 (x = acc_t + u; c = x > v_th;
// u = tau * x * (1 - c)).  Returns the packed spike word (bit t = c_t) and
// leaves the final U in *u_final.  The _rn intrinsics round exactly like the
// plain version's separate ops.
template <int TMAX>
__device__ __forceinline__ uint32_t lif(const float (&acc)[TMAX], int T,
                                        float v_th, float tau,
                                        float* u_final) {
  float u = 0.f;
  uint32_t packed = 0u;
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    if (t < T) {
      const float x = __fadd_rn(acc[t], u);
      const bool c = x > v_th;
      u = __fmul_rn(__fmul_rn(tau, x), c ? 0.f : 1.f);
      packed |= (uint32_t)c << t;
    }
  }
  *u_final = u;
  return packed;
}

// Calls L::run<RPT, TMAX>(args...) for the smallest accumulator depth TMAX
// (8, 16 or 32) that holds T.  The rows a thread owns shrink as TMAX grows
// (1 or 4 at TMAX 8, 1 or 2 above), so the (RPT x TMAX) f32 accumulator
// stays within the register file.
template <typename L, typename... Args>
int launch_bucket(int rows_per_thread, int T, Args... args) {
  if (T >= 1 && T <= 8) {
    if (rows_per_thread == 1) return L::template run<1, 8>(args...);
    if (rows_per_thread == 4) return L::template run<4, 8>(args...);
  } else if (T > 8 && T <= 16) {
    if (rows_per_thread == 1) return L::template run<1, 16>(args...);
    if (rows_per_thread == 2) return L::template run<2, 16>(args...);
  } else if (T > 16 && T <= 32) {
    if (rows_per_thread == 1) return L::template run<1, 32>(args...);
    if (rows_per_thread == 2) return L::template run<2, 32>(args...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ftp
