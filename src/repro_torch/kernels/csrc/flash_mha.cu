// Flash attention, forward and backward, for Hopper (sm_90a): SIMT f32 with
// a plain C interface loaded through ctypes.
//
// Replaces: src/repro/kernels/flash_mha.py::_fwd_kernel (entered through
// flash_mha_fwd: online-softmax attention that saves the row logsumexp),
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel (entered through flash_mha_bwd:
// p recomputed from the saved lse, dq per q tile, dk/dv per kv tile).  The
// custom_vjp over them (flash_mha) is the torch.autograd.Function in
// kernels/flash_mha.py; delta = rowsum(o * do) stays plain torch there, as it
// stays plain jnp outside the Pallas kernels in the reference.
//
// What it computes, per (bh, row), all in f32 from inputs upcast on load:
//   s = (q . k) * scale, scale = dh^-0.5, applied after the dot;
//   masked s = -1e30 (causal: jk > iq; window: jk <= iq - window, absolute
//   indices, no offset; none: nothing masked);
//   forward: m, l, acc by the online softmax over kv tiles, starting from
//   m = -1e30; l = max(l, 1e-30); o = acc / l (rounded to q's dtype);
//   lse = m + log(l);
//   backward: p = exp(s - lse); dp = do . v; ds = p * (dp - delta) * scale;
//   dq = ds k, dk = ds^T q, dv = p^T do (rounded to the inputs' dtypes).
// The -1e30 sentinel, not -inf, is the reference's: a row whose keys are all
// masked within a tile gets p = exp(0) = 1 there, and alpha = exp(-1e30 -
// m_real) = 0 clears that junk when its first visible key arrives, where
// -inf would give exp(-inf + inf) = NaN.
//
// What bounds it on the H100: the score tiles never leave the chip, so the
// bytes are q, k, v, o, lse (and do, dq, dk, dv backward), read or written
// once: attention at the train step's S = 128 is bytes-bound, at S = 4096 it
// is bound by 4 S^2 dh BH (forward) and 10 S^2 dh BH (backward) operations
// over the unmasked tiles, which the bf16 tensor cores would do at 989
// TFLOP/s.  This first version is SIMT f32 FMA (67 TFLOP/s peak at best):
// right before fast; mma/wgmma, TMA and warp specialisation are later work.
//
// What the design does: the TPU kernels carried their accumulators across
// a sequential grid axis in VMEM.  Here one thread block owns one 64-row
// tile and walks the other axis in a device-side loop: forward and dq one
// block per (bh, q tile) over kv tiles, dk/dv one block per (bh, kv tile)
// over q tiles.  Nothing is reduced across blocks, so there are no atomics:
// both backward kernels are deterministic, and each (bh) row of the outputs
// is independent of the batch.  Tiles live in shared memory as f32, rows
// padded to dh + 1 floats (conflict-free column reads); 256 threads as
// 16 x 16, each owning a 4 x 4 block of the 64 x 64 score tile (rows
// ty + 16 i, columns tx + 16 j) and 4 rows x dh / 16 columns of the output
// tile; row max and row sums reduce over the 16 lanes of a row group with
// warp shuffles.  A kv tile in which every (q row, key) pair of the block is
// masked is skipped: there it adds exactly nothing (p = 0 once a row has a
// visible key; the junk of a row without one is cleared later).  The one
// exception keeps the reference's degenerate rows exact: a causal window row
// with no visible key at all (iq >= Skv + window - 1) averages v over every
// key, so a q tile holding such a row walks every kv tile.  Ragged S and Skv
// are masked on the device; the host pads nothing.  dh is a template
// parameter (32, 64, 128); shared memory is sized for dh = 128 with f32
// tiles (forward 116 KB, dq 149 KB, dk/dv 165 KB, dynamic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // q rows and kv rows per tile
constexpr int kThreads = 256;        // 16 x 16
constexpr int kSub = kTile / 16;     // rows (and score columns) per thread
constexpr int kLdP = kTile + 1;      // padded row of a 64 x 64 score tile
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

// Rows [row0, row0 + kTile) of a (rows, DH) matrix into shared memory as
// f32 with row stride DH + 1; rows past ``rows`` are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, c = idx % DH, gr = row0 + r;
    dst[r * (DH + 1) + c] = gr < rows ? to_f32(src[(size_t)gr * DH + c]) : 0.f;
  }
}

// a[r] . b[c] for this thread's rows r = ty + 16 i and columns c = tx + 16 j
// of two shared tiles (stride DH + 1).
template <int DH>
__device__ __forceinline__ void dots(const float* a, const float* b, int ty,
                                     int tx, float (&s)[kSub][kSub]) {
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
                                      int tx, float (&s)[kSub][kSub],
                                      float (&dp)[kSub][kSub]) {
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

constexpr size_t tile_bytes(int dh) { return (size_t)kTile * (dh + 1) * 4; }
constexpr size_t score_bytes() { return (size_t)kTile * kLdP * 4; }

// Dispatch over (dtype, dh); F<T, DH>::run(args...) launches one instance.
template <template <typename, int> class F, typename... Args>
int dispatch(int bf16, int dh, Args... args) {
  if (bf16) {
    if (dh == 32) return F<__nv_bfloat16, 32>::run(args...);
    if (dh == 64) return F<__nv_bfloat16, 64>::run(args...);
    if (dh == 128) return F<__nv_bfloat16, 128>::run(args...);
  } else {
    if (dh == 32) return F<float, 32>::run(args...);
    if (dh == 64) return F<float, 64>::run(args...);
    if (dh == 128) return F<float, 128>::run(args...);
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
    const size_t smem = 3 * tile_bytes(DH) + score_bytes();
    int rc = start(flash_fwd_kernel<T, DH>, smem);
    if (rc) return rc;
    dim3 grid(BH, (S + kTile - 1) / kTile);
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
    const size_t smem = 4 * tile_bytes(DH) + score_bytes();
    int rc = start(flash_bwd_dq_kernel<T, DH>, smem);
    if (rc) return rc;
    dim3 grid(BH, (S + kTile - 1) / kTile);
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
    const size_t smem = 4 * tile_bytes(DH) + 2 * score_bytes() + 2 * kTile * 4;
    int rc = start(flash_bwd_dkv_kernel<T, DH>, smem);
    if (rc) return rc;
    dim3 grid(BH, (Skv + kTile - 1) / kTile);
    flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), S,
        Skv, scale, causal, window, static_cast<T*>(dk), static_cast<T*>(dv));
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// q: (BH, S, dh), k, v: (BH, Skv, dh), all contiguous, bf16 (bf16 = 1) or
// f32 (0); dh in {32, 64, 128}.  o: (BH, S, dh) in q's dtype, lse: (BH, S)
// f32.  Returns cudaGetLastError() after the launch (or the error that
// refused it).
int flash_fwd_launch(const void* q, const void* k, const void* v, int BH,
                     int S, int Skv, int dh, int bf16, float scale,
                     int causal, int window, void* o, void* lse,
                     void* stream) {
  return dispatch<Fwd>(bf16, dh, q, k, v, BH, S, Skv, scale, causal, window,
                       o, lse, static_cast<cudaStream_t>(stream));
}

// + dout: (BH, S, dh) in q's dtype, lse, delta: (BH, S) f32 -> dq (BH, S, dh).
int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        int BH, int S, int Skv, int dh, int bf16, float scale,
                        int causal, int window, void* dq, void* stream) {
  return dispatch<BwdDq>(bf16, dh, q, k, v, dout, lse, delta, BH, S, Skv,
                         scale, causal, window, dq,
                         static_cast<cudaStream_t>(stream));
}

// Same inputs -> dk, dv (BH, Skv, dh).
int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, int BH, int S, int Skv, int dh,
                         int bf16, float scale, int causal, int window,
                         void* dk, void* dv, void* stream) {
  return dispatch<BwdDkv>(bf16, dh, q, k, v, dout, lse, delta, BH, S, Skv,
                          scale, causal, window, dk, dv,
                          static_cast<cudaStream_t>(stream));
}

const char* flash_mha_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
