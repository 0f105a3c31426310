// Flash attention, forward and backward, for Hopper (sm_90a), with a plain
// C interface loaded through ctypes.  Two instances of each kernel: `tc`
// (bf16 q, k, v, do: mma.sync on the tensor cores) and `simt` (SIMT f32
// FMA, which f32 inputs take: the reference tests' 3e-4 needs f32
// products).  The wrapper (kernels/flash_mha.py::flash_instance) picks one
// from the dtype alone.
//
// Replaces: src/repro/kernels/flash_mha.py::_fwd_kernel (entered through
// flash_mha_fwd: online-softmax attention that saves the row logsumexp),
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel (entered through flash_mha_bwd:
// p recomputed from the saved lse, dq per q tile, dk/dv per kv tile).  The
// custom_vjp over them (flash_mha) is the torch.autograd.Function in
// kernels/flash_mha.py; delta = rowsum(o * do) stays plain torch there, as it
// stays plain jnp outside the Pallas kernels in the reference.
//
// What it computes, per (bh, row), in f32 (SIMT: from inputs upcast on
// load; tc: bf16 products with f32 accumulation):
//   s = (q . k) * scale, scale passed in (true_dh^-0.5: the wrapper
//   zero-pads other dh up to the templates 32, 64, 128, 192, 256), after
//   the dot;
//   masked s = -1e30 (causal: jk > iq; window: jk <= iq - window, absolute
//   indices, no offset; none: nothing masked);
//   forward: m, l, acc by the online softmax over kv tiles, starting from
//   m = -1e30; l = max(l, 1e-30); o = acc / l (rounded to q's dtype);
//   lse = m + log(l);
//   backward: p = exp(s - lse); dp = do . v; ds = p * (dp - delta) * scale;
//   dq = ds k, dk = ds^T q, dv = p^T do (rounded to the inputs' dtypes).
// The tc instance carries the forward's p to the value product as three
// bf16 terms (f32 precision, see flash_fwd_tc_kernel) and rounds the
// backward's p and ds to bf16 as the A operand of the next product; sums
// stay f32.
// The -1e30 sentinel, not -inf, is the reference's: a row whose keys are all
// masked within a tile gets p = exp(0) = 1 there, and alpha = exp(-1e30 -
// m_real) = 0 clears that junk when its first visible key arrives, where
// -inf would give exp(-inf + inf) = NaN.
//
// What bounds it on the H100: the score tiles never leave the chip, so the
// bytes are q, k, v, o, lse (and do, dq, dk, dv backward), read or written
// once: attention at the train step's S = 128 is bytes-bound, at S = 4096 it
// is bound by 4 S^2 dh BH (forward) and 10 S^2 dh BH (backward) operations
// over the unmasked tiles, which the bf16 tensor cores do at 989 TFLOP/s
// (wgmma; mma.sync reaches a part of that) and SIMT f32 FMA at 67.
//
// What the design does: the TPU kernels carried their accumulators across
// a sequential grid axis in VMEM.  Here one thread block owns one 64-row
// tile and walks the other axis in a device-side loop: forward and dq one
// block per (bh, q tile) over kv tiles, dk/dv one block per (bh, kv tile)
// over q tiles.  Nothing is reduced across blocks, so there are no atomics:
// both backward kernels are deterministic, and each (bh) row of the outputs
// is independent of the batch.  A kv tile in which every (q row, key) pair
// of the block is masked is skipped: there it adds exactly nothing (p = 0
// once a row has a visible key; the junk of a row without one is cleared
// later).  The one exception keeps the reference's degenerate rows exact: a
// causal window row with no visible key at all (iq >= Skv + window - 1)
// averages v over every key, so a q tile holding such a row walks every kv
// tile.  Ragged S and Skv are masked on the device; the host pads nothing
// but dh.
//
// SIMT: tiles live in shared memory as f32, rows padded to dh + 1 floats
// (conflict-free column reads); 256 threads as 16 x 16, each owning a 4 x 4
// block of the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) and 4
// rows x dh / 16 columns of the output tile; row max and row sums reduce
// over the 16 lanes of a row group with warp shuffles; shared memory at
// dh = 128 with f32 tiles: forward 116 KB, dq 149 KB, dk/dv 165 KB.  At dh
// 192 and 256 the tiles are 32 rows (`Simt`; each thread a 2 x 2 score
// block and 2 rows x dh / 16 output columns): four 64-row tiles at dh 256
// would take 263 KB of the 227 KB a block may have; at 32 rows and dh 256,
// forward 101 KB, dq 133 KB, dk/dv 137 KB.  SIMT f32 FMA peaks at 67
// TFLOP/s, so even at that peak its forward at dh 256 (BH 8 x S 4096,
// causal) could not beat ~1 ms: only the tensor cores close the gap to the
// bound, and bf16 takes `tc` at every dh (kernels/flash_mha.py::
// flash_instance).
// tc: see the section's own notes below (bf16 tiles through a cp.async
// ring: forward 45 / 85 KB at dh 64 / 128, dq 54 / 102 KB, dk/dv 55 / 103
// KB; at dh 192 and 256 two warpgroups a tile, because a warp's
// accumulators for all DH columns would pass 255 registers: `Split`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ftp_tc.cuh"

namespace {

constexpr int kTile = 64;            // q rows and kv rows per tile (tc)
constexpr int kThreads = 256;        // 16 x 16 (SIMT)

// The SIMT instance's tile: 64 rows up to dh 128; 32 rows for dh 192 and
// 256, where four f32 tiles of 64 rows at stride dh + 1 would pass the
// 227 KB of shared memory a block may have (dq at dh 256: 263 KB).
template <int DH>
struct Simt {
  static constexpr int kRows = DH > 128 ? 32 : 64;  // rows per tile
  static constexpr int kSub = kRows / 16;  // rows (and score columns) a thread
  static constexpr int kLdP = kRows + 1;   // padded row of the score tile
};
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Reductions over the 16 lanes of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(int iq, int jk, int causal,
                                        int window) {
  if (!causal) return true;
  if (jk > iq) return false;
  return !(window && jk <= iq - window);
}

// Whether the (q rows [q0, q1), keys [k0, k1)) tile needs work: some pair
// in it is visible, or the q tile holds a row with no visible key anywhere
// (see the header).  The same for every thread of a block.
__device__ __forceinline__ bool tile_needed(int q0, int q1, int k0, int k1,
                                            int Skv, int causal, int window) {
  if (!causal) return true;
  if (window && q1 - 1 >= Skv + window - 1) return true;
  if (k0 > q1 - 1) return false;
  return !(window && k1 - 1 <= q0 - window);
}

// Rows [row0, row0 + Simt<DH>::kRows) of a (rows, DH) matrix into shared
// memory as f32 with row stride DH + 1; rows past ``rows`` are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < Simt<DH>::kRows * DH; idx += kThreads) {
    const int r = idx / DH, c = idx % DH, gr = row0 + r;
    dst[r * (DH + 1) + c] = gr < rows ? to_f32(src[(size_t)gr * DH + c]) : 0.f;
  }
}

// a[r] . b[c] for this thread's rows r = ty + 16 i and columns c = tx + 16 j
// of two shared tiles (stride DH + 1).
template <int DH>
__device__ __forceinline__ void dots(const float* a, const float* b, int ty,
                                     int tx,
                                     float (&s)[Simt<DH>::kSub][Simt<DH>::kSub]) {
  constexpr int kSub = Simt<DH>::kSub;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float x[kSub], y[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) x[i] = a[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) y[j] = b[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// Both score-shaped products of the backward in one pass over d.
template <int DH>
__device__ __forceinline__ void dots2(const float* a, const float* b,
                                      const float* g, const float* w, int ty,
                                      int tx,
                                      float (&s)[Simt<DH>::kSub][Simt<DH>::kSub],
                                      float (&dp)[Simt<DH>::kSub][Simt<DH>::kSub]) {
  constexpr int kSub = Simt<DH>::kSub;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float x[kSub], y[kSub], gx[kSub], wy[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      x[i] = a[(ty + 16 * i) * (DH + 1) + d];
      gx[i] = g[(ty + 16 * i) * (DH + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      y[j] = b[(tx + 16 * j) * (DH + 1) + d];
      wy[j] = w[(tx + 16 * j) * (DH + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[i][j] = fmaf(x[i], y[j], s[i][j]);
        dp[i][j] = fmaf(gx[i], wy[j], dp[i][j]);
      }
  }
}

// The masked, scaled score of one element (the reference's
// where(mask, dot * scale, -1e30)).
__device__ __forceinline__ float masked_score(float dot, float scale, int iq,
                                              int jk, int causal, int window) {
  return visible(iq, jk, causal, window) ? dot * scale : kNegInf;
}

// ---------------------------------------------------------------------------
// forward: one block per (bh, q tile), online softmax over kv tiles
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    int S, int Skv, float scale, int causal, int window, T* __restrict__ o,
    float* __restrict__ lse) {
  constexpr int LD = DH + 1, DSUB = DH / 16;
  // this instance's tile rows (Simt<DH>), in place of the tc instance's 64
  constexpr int kTile = Simt<DH>::kRows, kSub = Simt<DH>::kSub,
                kLdP = Simt<DH>::kLdP;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;  // [kTile][kLdP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // causal: heavy first
  const int q1 = min(q0 + kTile, S);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + (size_t)bh * Skv * DH;
  const T* vb = v + (size_t)bh * Skv * DH;

  load_tile<T, DH>(qs, q + (size_t)bh * S * DH, q0, S);
  float m[kSub], l[kSub], acc[kSub][DSUB];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    const int k1 = min(k0 + kTile, Skv);
    if (!tile_needed(q0, q1, k0, k1, Skv, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH>(ks, kb, k0, Skv);
    load_tile<T, DH>(vs, vb, k0, Skv);
    __syncthreads();
    float s[kSub][kSub];
    dots<DH>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int iq = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int jk = k0 + tx + 16 * j;
        s[i][j] = masked_score(s[i][j], scale, iq, jk, causal, window);
        if (jk < Skv) mx = fmaxf(mx, s[i][j]);
      }
      mx = max16(mx);
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int jk = k0 + tx + 16 * j;
        const float p = jk < Skv ? expf(s[i][j] - mx) : 0.f;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + sum16(rs);
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < DSUB; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[DSUB];
#pragma unroll
      for (int e = 0; e < DSUB; ++e) vv[e] = vs[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float p = ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int e = 0; e < DSUB; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)bh * S + r) * DH;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) orow[tx + 16 * e] = from_f32<T>(acc[i][e] / ll);
    if (tx == 0) lse[(size_t)bh * S + r] = m[i] + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// backward dq: one block per (bh, q tile), over kv tiles
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int S, int Skv, float scale, int causal,
    int window, T* __restrict__ dq) {
  constexpr int LD = DH + 1, DSUB = DH / 16;
  // this instance's tile rows (Simt<DH>), in place of the tc instance's 64
  constexpr int kTile = Simt<DH>::kRows, kSub = Simt<DH>::kSub,
                kLdP = Simt<DH>::kLdP;
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + kTile * LD;  // do
  float* ks = gs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;  // [kTile][kLdP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int q1 = min(q0 + kTile, S);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + (size_t)bh * Skv * DH;
  const T* vb = v + (size_t)bh * Skv * DH;

  load_tile<T, DH>(qs, q + (size_t)bh * S * DH, q0, S);
  load_tile<T, DH>(gs, dout + (size_t)bh * S * DH, q0, S);
  float lse_r[kSub], delta_r[kSub], acc[kSub][DSUB];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < S ? lse[(size_t)bh * S + r] : 0.f;
    delta_r[i] = r < S ? delta[(size_t)bh * S + r] : 0.f;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    const int k1 = min(k0 + kTile, Skv);
    if (!tile_needed(q0, q1, k0, k1, Skv, causal, window)) continue;
    __syncthreads();
    load_tile<T, DH>(ks, kb, k0, Skv);
    load_tile<T, DH>(vs, vb, k0, Skv);
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];
    dots2<DH>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int iq = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int jk = k0 + tx + 16 * j;
        const float p =
            expf(masked_score(s[i][j], scale, iq, jk, causal, window) - lse_r[i]);
        dss[(ty + 16 * i) * kLdP + tx + 16 * j] =
            jk < Skv ? p * (dp[i][j] - delta_r[i]) * scale : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kk[DSUB];
#pragma unroll
      for (int e = 0; e < DSUB; ++e) kk[e] = ks[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float g = dss[(ty + 16 * i) * kLdP + c];
#pragma unroll
        for (int e = 0; e < DSUB; ++e) acc[i][e] = fmaf(g, kk[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    T* row = dq + ((size_t)bh * S + r) * DH;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) row[tx + 16 * e] = from_f32<T>(acc[i][e]);
  }
}

// ---------------------------------------------------------------------------
// backward dk, dv: one block per (bh, kv tile), over q tiles
// ---------------------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, int S, int Skv, float scale, int causal,
    int window, T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int LD = DH + 1, DSUB = DH / 16;
  // this instance's tile rows (Simt<DH>), in place of the tc instance's 64
  constexpr int kTile = Simt<DH>::kRows, kSub = Simt<DH>::kSub,
                kLdP = Simt<DH>::kLdP;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* gs = qs + kTile * LD;   // do
  float* ps = gs + kTile * LD;   // [kTile q rows][kLdP]
  float* dss = ps + kTile * kLdP;
  float* lse_s = dss + kTile * kLdP;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // causal: low kv tiles are the heavy ones
  const int k1 = min(k0 + kTile, Skv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + (size_t)bh * S * DH;
  const T* gb = dout + (size_t)bh * S * DH;

  load_tile<T, DH>(ks, k + (size_t)bh * Skv * DH, k0, Skv);
  load_tile<T, DH>(vs, v + (size_t)bh * Skv * DH, k0, Skv);
  float acck[kSub][DSUB], accv[kSub][DSUB];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int e = 0; e < DSUB; ++e) acck[i][e] = accv[i][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int q1 = min(q0 + kTile, S);
    if (!tile_needed(q0, q1, k0, k1, Skv, causal, window)) continue;
    __syncthreads();
    load_tile<T, DH>(qs, qb, q0, S);
    load_tile<T, DH>(gs, gb, q0, S);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < S ? lse[(size_t)bh * S + r] : 0.f;
      delta_s[threadIdx.x] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    __syncthreads();
    // score tile: q rows ty + 16 i, keys tx + 16 j
    float s[kSub][kSub], dp[kSub][kSub];
    dots2<DH>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int rr = ty + 16 * i, iq = q0 + rr;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int cc = tx + 16 * j, jk = k0 + cc;
        const bool ok = iq < S && jk < Skv;
        const float p =
            ok ? expf(masked_score(s[i][j], scale, iq, jk, causal, window) -
                      lse_s[rr])
               : 0.f;
        ps[rr * kLdP + cc] = p;
        dss[rr * kLdP + cc] = ok ? p * (dp[i][j] - delta_s[rr]) * scale : 0.f;
      }
    }
    __syncthreads();
    // dv[c] += sum_r p[r][c] do[r]; dk[c] += sum_r ds[r][c] q[r], for this
    // thread's keys c = ty + 16 i and columns tx + 16 e
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float qq[DSUB], gg[DSUB];
#pragma unroll
      for (int e = 0; e < DSUB; ++e) {
        qq[e] = qs[r * LD + tx + 16 * e];
        gg[e] = gs[r * LD + tx + 16 * e];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float p = ps[r * kLdP + ty + 16 * i];
        const float g = dss[r * kLdP + ty + 16 * i];
#pragma unroll
        for (int e = 0; e < DSUB; ++e) {
          accv[i][e] = fmaf(p, gg[e], accv[i][e]);
          acck[i][e] = fmaf(g, qq[e], acck[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Skv) continue;
    T* krow = dk + ((size_t)bh * Skv + c) * DH;
    T* vrow = dv + ((size_t)bh * Skv + c) * DH;
#pragma unroll
    for (int e = 0; e < DSUB; ++e) {
      krow[tx + 16 * e] = from_f32<T>(acck[i][e]);
      vrow[tx + 16 * e] = from_f32<T>(accv[i][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core instance (`tc`): bf16 q, k, v, do
// ---------------------------------------------------------------------------
// FA2 on mma.sync: 4 warps, each owning 16 rows of the block's 64-row tile
// (q rows in the forward and dq kernels, kv rows in the dk/dv kernel); at
// dh 192 and 256 two such warpgroups, each owning half the output columns
// (`Split`).
// Tiles are bf16 in shared memory, rows padded to DH + 8 elements (ldmatrix
// conflict-free), and the walked operands come through a 2-stage cp.async
// ring, zero-filled past S or Skv.  Every product is mma.m16n8k16 bf16
// with f32 accumulation; the masked score, the softmax and the backward's
// p and ds run on the f32 accumulator fragments (rows g and g + 8 of the
// warp's 16, g = lane / 4; row max and sum over the 4 lanes of a quad) and
// are rounded to bf16 only as the A operand of the next product (the m16n8
// C layout reused as the m16k16 A layout; the forward's p as three bf16
// terms).  The semantics are the SIMT kernels': the same mask, sentinel,
// tile skip and epilogues.  What keeps the softmax from bounding the
// forward: a tile whose every pair is visible and in range (`tile_full`:
// all but the diagonal and window-edge tiles) skips the per-element mask,
// and exp is __expf (ex2.approx, ~2 ulp).

namespace tc {

using ftp::tc::cp_async16;
using ftp::tc::cp_async4;
using ftp::tc::cp_async_commit;
using ftp::tc::cp_async_wait;
using ftp::tc::ldmatrix_x4;
using ftp::tc::ldmatrix_x4_trans;
using ftp::tc::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;  // backward: score columns per pass

template <int DH>
struct Geom {
  static constexpr int kPitch = DH + 8;          // bf16 per tile row
  static constexpr int kElems = kTile * kPitch;  // bf16 per tile
  static constexpr int kSteps = DH / 16;         // k16 steps over dh
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + kTile) of a (rows, DH) bf16 matrix into a padded
// shared tile, 16 bytes per cp.async, by the block's NTHR threads; rows
// past ``rows`` are zero-filled.
template <int DH, int NTHR>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int rows) {
  constexpr int kPieces = DH / 8;
  for (int i = threadIdx.x; i < kTile * kPieces; i += NTHR) {
    const int r = i / kPieces, c = (i % kPieces) * 8, gr = row0 + r;
    const bool in = gr < rows;
    cp_async16(dst + r * Geom<DH>::kPitch + c,
               src + (size_t)(in ? gr : 0) * DH + c, in ? 16 : 0);
  }
}

// A fragment of the 16 tile rows from r0, k16 step at column c0.
template <int DH>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* t, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(a, t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Geom<DH>::kPitch +
                     c0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (b[0..1]: n0, b[2..3]: n0 + 8) whose n index
// is the tile's row (B = tile^T, e.g. k for q k^T), k16 step at column c0.
template <int DH>
__device__ __forceinline__ void b_frag_rows(uint32_t (&b)[4], const bf16* t,
                                            int n0, int c0, int lane) {
  ldmatrix_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * Geom<DH>::kPitch + c0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (columns n0 and n0 + 8 of the tile), k16 step
// over the tile's rows from k0 (B = tile, e.g. v for p v).
template <int DH>
__device__ __forceinline__ void b_frag_cols(uint32_t (&b)[4], const bf16* t,
                                            int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               Geom<DH>::kPitch + n0 + (lane >> 4) * 8);
}

// acc[NT][4] += A (16 x 16 k) times the two n8 tiles of each 16 columns.
template <int DH, int NP>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * NP][4],
                                         const uint32_t (&a)[4], const bf16* t,
                                         int n0, int c0, int lane) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint32_t b[4];
    b_frag_rows<DH>(b, t, n0 + 16 * p, c0, lane);
    mma_bf16(acc[2 * p], a, b[0], b[1]);
    mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
  }
}
// acc[W / 8][4] += A times the tile's rows from k0, columns [n0, n0 + W)
// (B = tile, e.g. k for ds k).
template <int DH, int W>
__device__ __forceinline__ void mma_cols(float (&acc)[W / 8][4],
                                         const uint32_t (&a)[4], const bf16* t,
                                         int k0, int lane, int n0) {
#pragma unroll
  for (int p = 0; p < W / 16; ++p) {
    uint32_t b[4];
    b_frag_cols<DH>(b, t, k0, n0 + 16 * p, lane);
    mma_bf16(acc[2 * p], a, b[0], b[1]);
    mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// The A fragment of the k16 step j of a score-shaped accumulator (its n8
// tiles 2 j and 2 j + 1), rounded to bf16.
template <int NT>
__device__ __forceinline__ void score_frag(uint32_t (&a)[4],
                                           const float (&s)[NT][4], int j) {
  a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
  a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
  a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
  a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
}

// What the bf16 rounding of score_frag left out: a[i] = bf16(x - hi(x)),
// so hi + lo carries x to ~16 bits.
template <int NT>
__device__ __forceinline__ void score_frag_lo(uint32_t (&a)[4],
                                              const float (&s)[NT][4], int j) {
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = s[2 * j + (i >> 2)][i & 3];
    r[i] = x - __bfloat162float(__float2bfloat16_rn(x));
  }
  a[0] = pack_bf16(r[0], r[1]);
  a[1] = pack_bf16(r[2], r[3]);
  a[2] = pack_bf16(r[4], r[5]);
  a[3] = pack_bf16(r[6], r[7]);
}

// The k16 step j of a score-shaped accumulator as three bf16 A fragments,
// a[0] = bf16(x), a[1] = bf16(x - a[0]), a[2] = bf16(x - a[0] - a[1]): their
// sum carries x to ~24 bits, as f32 does.
template <int NT>
__device__ __forceinline__ void score_frag3(uint32_t (&a)[3][4],
                                            const float (&s)[NT][4], int j) {
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = s[2 * j + (i >> 2)][i & 3];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      a[t][w] = pack_bf16(r[2 * w], r[2 * w + 1]);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&a[t][w]);
      r[2 * w] -= __low2float(h);
      r[2 * w + 1] -= __high2float(h);
    }
}

// acc[W / 8][4] += (a[0] + a[1] + a[2]) times the tile's rows from k0,
// columns [n0, n0 + W) (B = tile, e.g. v for p v).  The three products of
// each n8 tile go into a zeroed accumulator that is added to acc in f32:
// adding them into the running total inside the mma left over twice as
// many o elements on the other bf16 neighbour of the f64 result (the train
// step's inputs).
template <int DH, int W>
__device__ __forceinline__ void mma_cols3(float (&acc)[W / 8][4],
                                          const uint32_t (&a)[3][4],
                                          const bf16* t, int k0, int lane,
                                          int n0) {
#pragma unroll
  for (int p = 0; p < W / 16; ++p) {
    uint32_t b[4];
    b_frag_cols<DH>(b, t, k0, n0 + 16 * p, lane);
    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mma_bf16(d0, a[i], b[0], b[1]);
      mma_bf16(d1, a[i], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * p][e] += d0[e];
      acc[2 * p + 1][e] += d1[e];
    }
  }
}

// Whether q rows [q0, q1) hold a degenerate row (causal window, no visible
// key: p = 1 on every key, so ds is not a softmax gradient and grows with
// Skv).  Such a tile carries ds as a hi + lo bf16 pair (two products);
// elsewhere one bf16 ds keeps the gradients within a bf16 step.
__device__ __forceinline__ bool degenerate_rows(int q1, int Skv, int causal,
                                                int window) {
  return causal && window && q1 - 1 >= Skv + window - 1;
}

// Whether every (q row, key) pair of the full 64 x 64 tile pair is
// visible and in range: the tile needs no per-element mask.  The same for
// every thread of a block.
__device__ __forceinline__ bool tile_full(int q0, int k0, int S, int Skv,
                                          int causal, int window) {
  if (q0 + kTile > S || k0 + kTile > Skv) return false;
  if (!causal) return true;
  if (k0 + kTile - 1 > q0) return false;
  return !window || k0 > q0 + kTile - 1 - window;
}

using Full = std::true_type;
using Edge = std::false_type;

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One pass of the forward's online softmax over a warp's score fragments
// (NT n8 tiles; rows iq and iq + 8, key jk + 8 nt + (e & 1)): the scores
// scaled, masked on an Edge tile (keys past Skv out of the max); m moved
// to the new row max, alpha = exp(m_old - m); s becomes p = exp(s - m), 0
// past Skv; l = alpha l + the lane's sum of p (the quad shares m and
// alpha, so l stays this lane's partial sum).
template <typename Kind, int NT>
__device__ __forceinline__ void softmax_pass(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale, int iq, int jk,
                                             int Skv, int causal, int window) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = jk + 8 * nt + (e & 1);
      if constexpr (Kind::value) {
        s[nt][e] *= scale;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      } else {
        s[nt][e] = masked_score(s[nt][e], scale, iq + 8 * h, j, causal, window);
        if (j < Skv) mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = __expf(m[h] - mx[h]);
    m[h] = mx[h];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = jk + 8 * nt + (e & 1);
      s[nt][e] = __expf(s[nt][e] - m[h]);
      if constexpr (!Kind::value)
        if (j >= Skv) s[nt][e] = 0.f;
      rs[h] += s[nt][e];
    }
  l[0] = alpha[0] * l[0] + rs[0];
  l[1] = alpha[1] * l[1] + rs[1];
}

// The dq kernel's pass over a warp's s and dp fragments (rows iq and iq +
// 8 with their lse and delta, key jk + 8 nt + (e & 1)): s becomes ds = p
// (dp - delta) scale, p = exp(s scale - lse); masked and 0 past Skv on an
// Edge tile.
template <typename Kind, int NT>
__device__ __forceinline__ void dq_pass(float (&s)[NT][4],
                                        const float (&dp)[NT][4],
                                        const float (&lse_r)[2],
                                        const float (&delta_r)[2], float scale,
                                        int iq, int jk, int Skv, int causal,
                                        int window) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = jk + 8 * nt + (e & 1);
      float x = s[nt][e] * scale;
      if constexpr (!Kind::value)
        x = masked_score(s[nt][e], scale, iq + 8 * h, j, causal, window);
      const float p = __expf(x - lse_r[h]);
      s[nt][e] = p * (dp[nt][e] - delta_r[h]) * scale;
      if constexpr (!Kind::value)
        if (j >= Skv) s[nt][e] = 0.f;
    }
}

// The dk/dv kernel's pass over a warp's transposed fragments (kv rows jk
// and jk + 8, q column rr + 8 nt + (e & 1) of the tile from q0, whose lse
// and delta are in shared memory): st becomes p^T, dpt ds^T; masked and 0
// past S or Skv on an Edge tile.
template <typename Kind, int NT>
__device__ __forceinline__ void dkv_pass(float (&st)[NT][4], float (&dpt)[NT][4],
                                         const float* lse_t,
                                         const float* delta_t, float scale,
                                         int q0, int rr, int jk, int S, int Skv,
                                         int causal, int window) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = jk + 8 * (e >> 1);
      const int r = rr + 8 * nt + (e & 1), iq = q0 + r;
      float x = st[nt][e] * scale;
      if constexpr (!Kind::value)
        x = masked_score(st[nt][e], scale, iq, j, causal, window);
      float p = __expf(x - lse_t[r]);
      if constexpr (!Kind::value)
        if (iq >= S || j >= Skv) p = 0.f;
      st[nt][e] = p;
      dpt[nt][e] = p * (dpt[nt][e] - delta_t[r]) * scale;
    }
}

// The rows [r0, r0 + 16) of a warp's f32 accumulator fragments (columns
// [n0, n0 + W) of DH), divided by ``div`` per row half, as bf16 rows of
// ``out`` below ``rows``.
template <int DH, int W>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[W / 8][4],
                                           int r0, int rows, int lane,
                                           float div0, float div1, int n0) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= rows) continue;
    const float div = h ? div1 : div0;
    bf16* row = out + (size_t)r * DH + n0 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + 8 * nt) =
          pack_bf16(acc[nt][2 * h] / div, acc[nt][2 * h + 1] / div);
  }
}

// How a block's threads split its tile.  Up to dh 128 one warpgroup: warp
// i owns rows [16 i, 16 i + 16) and all DH output columns.  At dh 192 and
// 256 that would bound the kernels: a warp's f32 accumulators for all DH
// columns are 128 registers a thread for o or dq at dh 256, and 256 for dk
// + dv, over the 255 a thread may have before any score or fragment
// register.  So two warpgroups (256 threads) share the 64-row tile there:
// warp i of warpgroup w owns rows [16 i, 16 i + 16) and the output columns
// [w DH / 2, (w + 1) DH / 2) of o, dq, or dk and dv (64 accumulators a
// thread for o and dq at dh 256, 128 for dk + dv).  A score-shaped tile
// (S = Q K^T, dP = dO V^T, their transposes in dk/dv) needs the whole dh:
// each warp computes the partial over its warpgroup's dh half, and the two
// warps over the same 16 rows (a pair) swap their partials through shared
// memory (`pair_sum`, 64-thread named barriers) and both add part0 +
// part1, so both hold the same f32 tile bit for bit and agree on the
// softmax, p and ds.  Shared memory at dh 256: forward 181 KB, dq 214 KB,
// dk/dv 207 KB (192: 141 / 166 / 167 KB), one block of 8 warps an SM.
template <int DH>
struct Split {
  static constexpr int kGroups = DH > 128 ? 2 : 1;  // warpgroups a block
  static constexpr int kThreads = 128 * kGroups;     // 4 warps x 16 rows each
  static constexpr int kCols = DH / kGroups;  // output columns a warpgroup owns
  static constexpr int kSteps = kCols / 16;   // k16 steps over its dh part
  // dk/dv: a warp holding 2 x 64 accumulators (dh 128, or 256 split in
  // two) halves the chunk to stay under 255 registers without spills
  static constexpr int kDkvChunk = kCols == 128 ? kChunk / 2 : kChunk;
  // The first row and output column of a warp (0 for every warp of one
  // warpgroup: constant, so the narrow kernels' addresses fold).
  __device__ static int row0(int warp) {
    return (kGroups > 1 ? warp & 3 : warp) * 16;
  }
  __device__ static int col0(int warp) {
    return kGroups > 1 ? (warp >> 2) * kCols : 0;
  }
  // Bytes of the pair exchange for NT n8 tiles of score columns: one
  // float4 per (warp, n8 tile, lane); none for one warpgroup.
  static constexpr size_t xchg_bytes(int nt) {
    return kGroups > 1 ? (size_t)(kThreads / 32) * nt * 32 * sizeof(float4) : 0;
  }
};

__device__ __forceinline__ void pair_barrier(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// The sum of a pair's two partial score fragments, part0 + part1 in both
// warps: warp i of warpgroup w writes its slot, the pair meets, each reads
// the other's (the first barrier keeps a slot until its reader is done).
template <int NT>
__device__ __forceinline__ void pair_sum(float (&s)[NT][4], float4* xb,
                                         int warp, int lane) {
  const int pair = warp & 3, w = warp >> 2;
  float4* mine = xb + (2 * pair + w) * NT * 32 + lane;
  const float4* other = xb + (2 * pair + (w ^ 1)) * NT * 32 + lane;
  pair_barrier(pair);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    mine[32 * nt] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
  pair_barrier(pair);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float4 o = other[32 * nt];
    const float x[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = w ? x[e] + s[nt][e] : s[nt][e] + x[e];
  }
}

// forward: one block per (bh, q tile); Q resident in shared memory, K, V
// tiles through the ring, kFwdChunk keys of a tile per pass (the online
// softmax steps per pass).  p goes to the value product at f32 precision
// (score_frag3, mma_cols3): delta = rowsum(o * do) in the backward moves a
// whole dq row by ulp(o) * do * scale * mean(k) wherever o rounds to the
// other bf16 neighbour, so o must round from nearly the f32 value, as the
// plain version's does.  At dh <= 64 capped at 168 registers, 3 blocks an
// SM; no spills at any dh.
constexpr int kFwdChunk = 32;
template <int DH>
__global__ void __launch_bounds__(Split<DH>::kThreads, DH <= 64 ? 3 : 1)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, int S, int Skv, float scale,
                        int causal, int window, bf16* __restrict__ o,
                        float* __restrict__ lse) {
  using W = Split<DH>;
  constexpr int E = Geom<DH>::kElems, KS = W::kSteps, COLS = W::kCols,
                NC = kFwdChunk;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);  // stage s: K at 2 s E, V at (2 s + 1) E
  bf16* qs = ring + 4 * E;
  float4* xb = reinterpret_cast<float4*>(qs + E);  // the pair exchange

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // causal: heavy first
  const int q1 = min(q0 + kTile, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = W::row0(warp);
  const int n0 = W::col0(warp);  // this warpgroup's columns
  const bf16* kb = k + (size_t)bh * Skv * DH;
  const bf16* vb = v + (size_t)bh * Skv * DH;
  const int nkt = (Skv + kTile - 1) / kTile;
  auto next = [&](int t) {
    while (t < nkt && !tile_needed(q0, q1, t * kTile,
                                   min(t * kTile + kTile, Skv), Skv, causal,
                                   window))
      ++t;
    return t;
  };
  auto fill = [&](int stage, int t) {
    load_tile_async<DH, W::kThreads>(ring + 2 * stage * E, kb, t * kTile, Skv);
    load_tile_async<DH, W::kThreads>(ring + (2 * stage + 1) * E, vb, t * kTile,
                                     Skv);
  };

  // Q in the first stage's group: the loop's first wait covers it
  load_tile_async<DH, W::kThreads>(qs, q + (size_t)bh * S * DH, q0, S);
  int kt = next(0);
  if (kt < nkt) fill(0, kt);
  cp_async_commit();

  float acc[COLS / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(acc);
  for (int stage = 0; kt < nkt; stage ^= 1) {
    const int nxt = next(kt + 1);
    if (nxt < nkt) fill(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks_t = ring + 2 * stage * E;
    const bf16* vs_t = ks_t + E;
    const int k0 = kt * kTile;
    const bool full = tile_full(q0, k0, S, Skv, causal, window);
#pragma unroll 1
    for (int ch = 0; ch < kTile; ch += NC) {
      float s[NC / 8][4];
      zero(s);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        a_frag<DH>(qa, qs, r0, n0 + 16 * ks, lane);
        mma_rows<DH, NC / 16>(s, qa, ks_t, ch, n0 + 16 * ks, lane);
      }
      if constexpr (W::kGroups > 1) pair_sum(s, xb, warp, lane);
      float alpha[2];
      if (full)
        softmax_pass<Full>(s, m, l, alpha, scale, q0 + r0 + g, k0 + ch + 2 * c,
                           Skv, causal, window);
      else
        softmax_pass<Edge>(s, m, l, alpha, scale, q0 + r0 + g, k0 + ch + 2 * c,
                           Skv, causal, window);
#pragma unroll
      for (int nt = 0; nt < COLS / 8; ++nt) {
        acc[nt][0] *= alpha[0];
        acc[nt][1] *= alpha[0];
        acc[nt][2] *= alpha[1];
        acc[nt][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < NC / 16; ++j) {
        uint32_t a[3][4];
        score_frag3(a, s, j);
        mma_cols3<DH, COLS>(acc, a, vs_t, ch + 16 * j, lane, n0);
      }
    }
    __syncthreads();  // the stage's readers are done before it is refilled
    kt = nxt;
  }
  cp_async_wait<0>();  // Q was never waited on if no tile was needed

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  store_rows<DH, COLS>(o + (size_t)bh * S * DH, acc, q0 + r0, S, lane, l0, l1,
                       n0);
  if (warp < 4 && c == 0) {  // both warpgroups hold the same m and l
    if (q0 + r0 + g < S) lse[(size_t)bh * S + q0 + r0 + g] = m[0] + logf(l0);
    if (q0 + r0 + g + 8 < S)
      lse[(size_t)bh * S + q0 + r0 + g + 8] = m[1] + logf(l1);
  }
}

// backward dq: one block per (bh, q tile); Q and dO resident, K, V tiles
// through the ring; kChunk keys per pass keep s and dp to 16 registers each
// (two warpgroups: s and dp take the pair exchange in turn).  No min-blocks
// bound here or on dk/dv: with one, ptxas gave the one-warpgroup instances
// more registers, and dk/dv at dh 64 ran 18% slower.
template <int DH>
__global__ void __launch_bounds__(Split<DH>::kThreads) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S,
    int Skv, float scale, int causal, int window, bf16* __restrict__ dq) {
  using W = Split<DH>;
  constexpr int E = Geom<DH>::kElems, KS = W::kSteps, COLS = W::kCols;
  constexpr int NT = kChunk / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* gs = qs + E;    // do
  bf16* ring = gs + E;  // stage s: K at 2 s E, V at (2 s + 1) E
  float4* xb = reinterpret_cast<float4*>(ring + 4 * E);  // the pair exchange

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int q1 = min(q0 + kTile, S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = W::row0(warp);
  const int n0 = W::col0(warp);
  const bf16* kb = k + (size_t)bh * Skv * DH;
  const bf16* vb = v + (size_t)bh * Skv * DH;
  const int nkt = (Skv + kTile - 1) / kTile;
  auto next = [&](int t) {
    while (t < nkt && !tile_needed(q0, q1, t * kTile,
                                   min(t * kTile + kTile, Skv), Skv, causal,
                                   window))
      ++t;
    return t;
  };
  auto fill = [&](int stage, int t) {
    load_tile_async<DH, W::kThreads>(ring + 2 * stage * E, kb, t * kTile, Skv);
    load_tile_async<DH, W::kThreads>(ring + (2 * stage + 1) * E, vb, t * kTile,
                                     Skv);
  };

  load_tile_async<DH, W::kThreads>(qs, q + (size_t)bh * S * DH, q0, S);
  load_tile_async<DH, W::kThreads>(gs, dout + (size_t)bh * S * DH, q0, S);
  int kt = next(0);
  if (kt < nkt) fill(0, kt);
  cp_async_commit();
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + 8 * h;
    lse_r[h] = r < S ? lse[(size_t)bh * S + r] : 0.f;
    delta_r[h] = r < S ? delta[(size_t)bh * S + r] : 0.f;
  }
  const bool split = degenerate_rows(q1, Skv, causal, window);
  float acc[COLS / 8][4];
  zero(acc);
  for (int stage = 0; kt < nkt; stage ^= 1) {
    const int nxt = next(kt + 1);
    if (nxt < nkt) fill(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks_t = ring + 2 * stage * E;
    const bf16* vs_t = ks_t + E;
    const bool full = tile_full(q0, kt * kTile, S, Skv, causal, window);
#pragma unroll
    for (int ch = 0; ch < kTile; ch += kChunk) {
      float s[NT][4], dp[NT][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        a_frag<DH>(a, qs, r0, n0 + 16 * ks, lane);
        mma_rows<DH, NT / 2>(s, a, ks_t, ch, n0 + 16 * ks, lane);
        a_frag<DH>(a, gs, r0, n0 + 16 * ks, lane);
        mma_rows<DH, NT / 2>(dp, a, vs_t, ch, n0 + 16 * ks, lane);
      }
      if constexpr (W::kGroups > 1) {
        pair_sum(s, xb, warp, lane);
        pair_sum(dp, xb, warp, lane);
      }
      if (full)
        dq_pass<Full>(s, dp, lse_r, delta_r, scale, q0 + r0 + g,
                      kt * kTile + ch + 2 * c, Skv, causal, window);
      else
        dq_pass<Edge>(s, dp, lse_r, delta_r, scale, q0 + r0 + g,
                      kt * kTile + ch + 2 * c, Skv, causal, window);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t a[4];
        score_frag(a, s, j);
        mma_cols<DH, COLS>(acc, a, ks_t, ch + 16 * j, lane, n0);
        if (split) {
          score_frag_lo(a, s, j);
          mma_cols<DH, COLS>(acc, a, ks_t, ch + 16 * j, lane, n0);
        }
      }
    }
    __syncthreads();
    kt = nxt;
  }
  cp_async_wait<0>();  // Q and dO were never waited on if no tile was needed
  store_rows<DH, COLS>(dq + (size_t)bh * S * DH, acc, q0 + r0, S, lane, 1.f,
                       1.f, n0);
}

// backward dk, dv: one block per (bh, kv tile); K and V resident, Q, dO,
// lse and delta tiles through the ring; the scores are transposed (kv rows
// x q columns), kDkvChunk q columns per pass (two warpgroups: s^T and dp^T
// take the pair exchange in turn)
template <int DH>
__global__ void __launch_bounds__(Split<DH>::kThreads) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int S,
    int Skv, float scale, int causal, int window, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  using W = Split<DH>;
  constexpr int E = Geom<DH>::kElems, KS = W::kSteps, COLS = W::kCols,
                CH = W::kDkvChunk, NT = CH / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + E;
  bf16* ring = vs + E;  // stage s: Q at 2 s E, dO at (2 s + 1) E
  float* rows_s = reinterpret_cast<float*>(ring + 4 * E);  // stage s: lse at
                                                           // 2 s kTile, delta after
  float4* xb = reinterpret_cast<float4*>(rows_s + 4 * kTile);  // the pair exchange

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;  // causal: low kv tiles are the heavy ones
  const int k1 = min(k0 + kTile, Skv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, r0 = W::row0(warp);
  const int n0 = W::col0(warp);
  const bf16* qb = q + (size_t)bh * S * DH;
  const bf16* gb = dout + (size_t)bh * S * DH;
  const int nqt = (S + kTile - 1) / kTile;
  auto next = [&](int t) {
    while (t < nqt && !tile_needed(t * kTile, min(t * kTile + kTile, S), k0, k1,
                                   Skv, causal, window))
      ++t;
    return t;
  };
  auto fill = [&](int stage, int t) {
    load_tile_async<DH, W::kThreads>(ring + 2 * stage * E, qb, t * kTile, S);
    load_tile_async<DH, W::kThreads>(ring + (2 * stage + 1) * E, gb, t * kTile,
                                     S);
    if (W::kGroups == 1 || threadIdx.x < 2 * kTile) {  // lse by the first 64
                                                       // threads, delta next
      const int i = threadIdx.x & (kTile - 1), r = t * kTile + i;
      const float* src = (threadIdx.x < kTile ? lse : delta) + (size_t)bh * S;
      cp_async4(rows_s + 2 * stage * kTile + threadIdx.x, src + (r < S ? r : 0),
                r < S ? 4 : 0);
    }
  };

  load_tile_async<DH, W::kThreads>(ks, k + (size_t)bh * Skv * DH, k0, Skv);
  load_tile_async<DH, W::kThreads>(vs, v + (size_t)bh * Skv * DH, k0, Skv);
  int qt = next(0);
  if (qt < nqt) fill(0, qt);
  cp_async_commit();
  float acck[COLS / 8][4], accv[COLS / 8][4];
  zero(acck);
  zero(accv);
  for (int stage = 0; qt < nqt; stage ^= 1) {
    const int nxt = next(qt + 1);
    if (nxt < nqt) fill(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs_t = ring + 2 * stage * E;
    const bf16* gs_t = qs_t + E;
    const float* lse_t = rows_s + 2 * stage * kTile;
    const float* delta_t = lse_t + kTile;
    const int q0 = qt * kTile;
    const bool split = degenerate_rows(min(q0 + kTile, S), Skv, causal, window);
    const bool full = tile_full(q0, k0, S, Skv, causal, window);
#pragma unroll
    for (int ch = 0; ch < kTile; ch += CH) {
      float st[NT][4], dpt[NT][4];  // s^T, then p^T; dp^T, then ds^T
      zero(st);
      zero(dpt);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        a_frag<DH>(a, ks, r0, n0 + 16 * kk, lane);
        mma_rows<DH, NT / 2>(st, a, qs_t, ch, n0 + 16 * kk, lane);
        a_frag<DH>(a, vs, r0, n0 + 16 * kk, lane);
        mma_rows<DH, NT / 2>(dpt, a, gs_t, ch, n0 + 16 * kk, lane);
      }
      if constexpr (W::kGroups > 1) {
        pair_sum(st, xb, warp, lane);
        pair_sum(dpt, xb, warp, lane);
      }
      if (full)
        dkv_pass<Full>(st, dpt, lse_t, delta_t, scale, q0, ch + 2 * c,
                       k0 + r0 + g, S, Skv, causal, window);
      else
        dkv_pass<Edge>(st, dpt, lse_t, delta_t, scale, q0, ch + 2 * c,
                       k0 + r0 + g, S, Skv, causal, window);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t a[4];
        score_frag(a, st, j);
        mma_cols<DH, COLS>(accv, a, gs_t, ch + 16 * j, lane, n0);
        score_frag(a, dpt, j);
        mma_cols<DH, COLS>(acck, a, qs_t, ch + 16 * j, lane, n0);
        if (split) {
          score_frag_lo(a, dpt, j);
          mma_cols<DH, COLS>(acck, a, qs_t, ch + 16 * j, lane, n0);
        }
      }
    }
    __syncthreads();
    qt = nxt;
  }
  cp_async_wait<0>();  // K and V were never waited on if no tile was needed
  store_rows<DH, COLS>(dk + (size_t)bh * Skv * DH, acck, k0 + r0, Skv, lane,
                       1.f, 1.f, n0);
  store_rows<DH, COLS>(dv + (size_t)bh * Skv * DH, accv, k0 + r0, Skv, lane,
                       1.f, 1.f, n0);
}

}  // namespace tc

// SIMT shared memory: an f32 tile of the instance's rows at stride DH + 1,
// and its (rows x rows + 1) score tile
template <int DH>
constexpr size_t tile_bytes() { return (size_t)Simt<DH>::kRows * (DH + 1) * 4; }
template <int DH>
constexpr size_t score_bytes() {
  return (size_t)Simt<DH>::kRows * Simt<DH>::kLdP * 4;
}
template <int DH>
constexpr int simt_tiles(int rows) {
  return (rows + Simt<DH>::kRows - 1) / Simt<DH>::kRows;
}

// Dispatch over (instance, dtype, dh): F<T, DH>::run(args...) launches a
// SIMT instance, G<DH>::run(args...) the tensor-core one (bf16 only).
template <template <typename, int> class F, template <int> class G,
          typename... Args>
int dispatch(int tc, int bf16, int dh, Args... args) {
  if (tc) {
    if (!bf16) return (int)cudaErrorInvalidValue;
    if (dh == 32) return G<32>::run(args...);
    if (dh == 64) return G<64>::run(args...);
    if (dh == 128) return G<128>::run(args...);
    if (dh == 192) return G<192>::run(args...);
    if (dh == 256) return G<256>::run(args...);
  } else if (bf16) {
    if (dh == 32) return F<__nv_bfloat16, 32>::run(args...);
    if (dh == 64) return F<__nv_bfloat16, 64>::run(args...);
    if (dh == 128) return F<__nv_bfloat16, 128>::run(args...);
    if (dh == 192) return F<__nv_bfloat16, 192>::run(args...);
    if (dh == 256) return F<__nv_bfloat16, 256>::run(args...);
  } else {
    if (dh == 32) return F<float, 32>::run(args...);
    if (dh == 64) return F<float, 64>::run(args...);
    if (dh == 128) return F<float, 128>::run(args...);
    if (dh == 192) return F<float, 192>::run(args...);
    if (dh == 256) return F<float, 256>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

// Clears an earlier sticky-free error (so the launch reports its own) and
// allows the instance its dynamic shared memory (> 48 KB at dh = 128).
template <typename K>
int start(K kernel, size_t smem) {
  (void)cudaGetLastError();
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DH>
struct Fwd {
  static int run(const void* q, const void* k, const void* v, int BH, int S,
                 int Skv, float scale, int causal, int window, void* o,
                 void* lse, cudaStream_t s) {
    const size_t smem = 3 * tile_bytes<DH>() + score_bytes<DH>();
    int rc = start(flash_fwd_kernel<T, DH>, smem);
    if (rc) return rc;
    dim3 grid(BH, simt_tiles<DH>(S));
    flash_fwd_kernel<T, DH><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), S, Skv, scale, causal, window,
        static_cast<T*>(o), static_cast<float*>(lse));
    return (int)cudaGetLastError();
  }
};

template <typename T, int DH>
struct BwdDq {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, int BH,
                 int S, int Skv, float scale, int causal, int window,
                 void* dq, cudaStream_t s) {
    const size_t smem = 4 * tile_bytes<DH>() + score_bytes<DH>();
    int rc = start(flash_bwd_dq_kernel<T, DH>, smem);
    if (rc) return rc;
    dim3 grid(BH, simt_tiles<DH>(S));
    flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), S,
        Skv, scale, causal, window, static_cast<T*>(dq));
    return (int)cudaGetLastError();
  }
};

template <typename T, int DH>
struct BwdDkv {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, int BH,
                 int S, int Skv, float scale, int causal, int window,
                 void* dk, void* dv, cudaStream_t s) {
    const size_t smem =
        4 * tile_bytes<DH>() + 2 * score_bytes<DH>() + 2 * Simt<DH>::kRows * 4;
    int rc = start(flash_bwd_dkv_kernel<T, DH>, smem);
    if (rc) return rc;
    dim3 grid(BH, simt_tiles<DH>(Skv));
    flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), S,
        Skv, scale, causal, window, static_cast<T*>(dk), static_cast<T*>(dv));
    return (int)cudaGetLastError();
  }
};

constexpr size_t tc_tile_bytes(int dh) { return (size_t)kTile * (dh + 8) * 2; }

// Launches a tc kernel with its block (one warpgroup up to dh 128, two at
// dh 192 / 256) and its dynamic shared memory.
template <int DH, typename K, typename... A>
int launch_tc(K kernel, size_t smem, dim3 grid, cudaStream_t s, A... args) {
  int rc = start(kernel, smem);
  if (rc) return rc;
  kernel<<<grid, tc::Split<DH>::kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int DH>
struct FwdTc {
  static int run(const void* q, const void* k, const void* v, int BH, int S,
                 int Skv, float scale, int causal, int window, void* o,
                 void* lse, cudaStream_t s) {
    // 2 stages of K and V, Q, the pair exchange
    const size_t smem = 5 * tc_tile_bytes(DH) +
                        tc::Split<DH>::xchg_bytes(tc::kFwdChunk / 8);
    return launch_tc<DH>(tc::flash_fwd_tc_kernel<DH>, smem,
                         dim3(BH, (S + kTile - 1) / kTile), s,
                         static_cast<const tc::bf16*>(q),
                         static_cast<const tc::bf16*>(k),
                         static_cast<const tc::bf16*>(v), S, Skv, scale, causal,
                         window, static_cast<tc::bf16*>(o),
                         static_cast<float*>(lse));
  }
};

template <int DH>
struct BwdDqTc {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, int BH,
                 int S, int Skv, float scale, int causal, int window,
                 void* dq, cudaStream_t s) {
    // Q, dO + 2 stages of K, V, the pair exchange
    const size_t smem =
        6 * tc_tile_bytes(DH) + tc::Split<DH>::xchg_bytes(tc::kChunk / 8);
    return launch_tc<DH>(tc::flash_bwd_dq_tc_kernel<DH>, smem,
                         dim3(BH, (S + kTile - 1) / kTile), s,
                         static_cast<const tc::bf16*>(q),
                         static_cast<const tc::bf16*>(k),
                         static_cast<const tc::bf16*>(v),
                         static_cast<const tc::bf16*>(dout),
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta), S, Skv, scale,
                         causal, window, static_cast<tc::bf16*>(dq));
  }
};

template <int DH>
struct BwdDkvTc {
  static int run(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, int BH,
                 int S, int Skv, float scale, int causal, int window,
                 void* dk, void* dv, cudaStream_t s) {
    // K, V + 2 stages of Q, dO, and of lse, delta, the pair exchange
    const size_t smem =
        6 * tc_tile_bytes(DH) + 2 * 2 * kTile * 4 +
        tc::Split<DH>::xchg_bytes(tc::Split<DH>::kDkvChunk / 8);
    return launch_tc<DH>(tc::flash_bwd_dkv_tc_kernel<DH>, smem,
                         dim3(BH, (Skv + kTile - 1) / kTile), s,
                         static_cast<const tc::bf16*>(q),
                         static_cast<const tc::bf16*>(k),
                         static_cast<const tc::bf16*>(v),
                         static_cast<const tc::bf16*>(dout),
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta), S, Skv, scale,
                         causal, window, static_cast<tc::bf16*>(dk),
                         static_cast<tc::bf16*>(dv));
  }
};

}  // namespace

extern "C" {

// q: (BH, S, dh), k, v: (BH, Skv, dh), all contiguous, bf16 (bf16 = 1) or
// f32 (0); dh in {32, 64, 128, 192, 256}; tc = 1 launches the tensor-core
// instance (bf16 only, 16-byte aligned bases, dh <= 256: two warpgroups a
// block at 192 and 256), 0 the SIMT one.  o: (BH, S, dh) in
// q's dtype, lse: (BH, S) f32.  Returns cudaGetLastError() after the launch
// (or the error that refused it).
int flash_fwd_launch(const void* q, const void* k, const void* v, int BH,
                     int S, int Skv, int dh, int bf16, float scale,
                     int causal, int window, int tc, void* o, void* lse,
                     void* stream) {
  return dispatch<Fwd, FwdTc>(tc, bf16, dh, q, k, v, BH, S, Skv, scale,
                              causal, window, o, lse,
                              static_cast<cudaStream_t>(stream));
}

// + dout: (BH, S, dh) in q's dtype, lse, delta: (BH, S) f32 -> dq (BH, S, dh).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        int BH, int S, int Skv, int dh, int bf16, float scale,
                        int causal, int window, int tc, void* dq,
                        void* stream) {
  return dispatch<BwdDq, BwdDqTc>(tc, bf16, dh, q, k, v, dout, lse, delta,
                                  BH, S, Skv, scale, causal, window, dq,
                                  static_cast<cudaStream_t>(stream));
}

// Same inputs -> dk, dv (BH, Skv, dh).
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, int BH, int S, int Skv, int dh,
                         int bf16, float scale, int causal, int window, int tc,
                         void* dk, void* dv, void* stream) {
  return dispatch<BwdDkv, BwdDkvTc>(tc, bf16, dh, q, k, v, dout, lse, delta,
                                    BH, S, Skv, scale, causal, window, dk, dv,
                                    static_cast<cudaStream_t>(stream));
}

const char* flash_mha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
