// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Layout.  q/o/do are (B, H, Nq, d), k/v are (B, G, Nk, d), contiguous,
// f32 or bf16; lse and delta are (B, H, Nq) f32; q_lens and kv_lens are
// (B,) int32, already clamped to [0, Nq] and [0, Nk] by the wrapper.  GQA:
// query head h reads kv head h / (H / G).  Packed rows: q_seg (B, Nq) and
// kv_seg (B, Nk) int32 segment ids, or both null; each kernel is
// instantiated for SEG true and false, and a null pointer runs the SEG =
// false code, which reads no id.
//
// SIMT tiles (B3, B4 and B5 for f32; the bf16 tensor-core kernels lay
// out theirs as hopper_mma.cuh says).  Every block runs 256 threads as a
// 16 x 16 grid (ty, tx).  A score tile of ROWS x COLS gives thread (ty, tx)
// rows ty*RI + i (RI = ROWS/16) and columns tx + 16*j (CJ = COLS/16): the
// 16 threads of a row sit in one half-warp, so a row's max and sum are
// four __shfl_xor_sync steps.  An
// output accumulator of ROWS x d gives the same thread the same rows and
// columns tx + 16*k, k < NK (16*NK >= d).  Tiles are staged in shared memory
// as f32 with a row stride LD = 16*NK + 4: columns past d are zero, a row
// starts 16-byte aligned, and LD/4 is odd, so the float4 reads of the score
// products (rows tx, tx+1, ... of one quarter-warp) fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "launch.cuh"

#define FLASH_THREADS 256
// -0.7 * FLT_MAX, the JAX package's finite "minus infinity".
#define FLASH_NEG_INF (-0.7f * 3.402823466e38f)
#define FLASH_LOG2E 1.4426950408889634f
#define FLASH_LN2 0.6931471805599453f

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// rows [r0, r0 + ROWS) of a (n_rows, d) matrix -> dst (ROWS, LD) f32; rows
// past n_rows and columns past d read 0.
template <typename T, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n_rows, int d) {
  for (int idx = threadIdx.x; idx < ROWS * LD; idx += FLASH_THREADS) {
    const int r = idx / LD;
    const int c = idx - r * LD;
    const int gr = r0 + r;
    dst[idx] = (c < d && gr < n_rows) ? to_f32(src[(long long)gr * d + c])
                                      : 0.f;
  }
}

// s[i][j] = sum_c A[ty*RI + i][c] * B[tx + 16*j][c] over c < d4 (a multiple
// of 4; the zero columns past d add exact zeros).  A and B have stride LD.
template <int RI, int CJ, int LD>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int d4, int ty, int tx,
                                         float (&s)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
  for (int c = 0; c < d4; c += 4) {
    float4 a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * RI + i) * LD + c);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + c);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][k] += sum_{t < n} W[t][ty*RI + i] * X[t][tx + 16*k]: W is a
// transposed weight tile with stride WS, X a staged tile with stride LD.
template <int RI, int NK, int WS, int LD>
__device__ __forceinline__ void tile_acc(const float* W, const float* X,
                                         int n, int ty, int tx,
                                         float (&acc)[RI][NK]) {
  for (int t = 0; t < n; ++t) {
    float w[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) w[i] = W[t * WS + ty * RI + i];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float x = X[t * LD + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < RI; ++i) acc[i][k] = fmaf(w[i], x, acc[i][k]);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The validity of a (query, key) pair: the Pallas kernels' _tile_mask.
// window < 0 means no window.  With SEG, sq and sk are the pair's segment
// ids, and the pair is live only when they are equal and not padding (0).
template <bool SEG>
__device__ __forceinline__ bool pair_valid(int qp, int kp, int q_len,
                                           int kv_len, int causal, int window,
                                           int sq, int sk) {
  bool ok = qp < q_len && kp < kv_len;
  if (causal) ok = ok && kp <= qp;
  if (window >= 0) ok = ok && kp > qp - window;
  if (SEG) ok = ok && sq == sk && sq != 0;
  return ok;
}

// The segment id at position p of a row of n ids, 0 (padding) past n.
__device__ __forceinline__ int seg_at(const int* row, int p, int n) {
  return p < n ? row[p] : 0;
}

// The range [lo, hi] of the nonzero ids at positions [p0, p0 + N) of a row
// of n ids, computed by every warp on its own (no shared memory, no
// barrier); lo > hi when the span is all padding.  The Pallas kernels'
// _block_relevant takes the range over every id of the tile; leaving the
// padding id out only narrows the range, and id 0 matches nothing.
template <int N>
__device__ __forceinline__ void seg_range(const int* row, int p0, int n,
                                          int* lo, int* hi) {
  const int lane = threadIdx.x & 31;
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int t = lane; t < N; t += 32) {
    const int id = seg_at(row, p0 + t, n);
    if (id != 0) {
      mn = min(mn, id);
      mx = max(mx, id);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  *lo = mn;
  *hi = mx;
}

// The id that every position [p0, p0 + N) of a row of n ids carries, when
// all carry the same nonzero id (positions past n count as padding), else
// 0; computed by every warp on its own.  A tile pair whose rows and
// columns all carry one id needs no segment test per pair.
template <int N>
__device__ __forceinline__ int seg_uniform(const int* row, int p0, int n) {
  const int lane = threadIdx.x & 31;
  const int first = seg_at(row, p0, n);
  bool same = true;
#pragma unroll
  for (int t = lane; t < N; t += 32)
    same = same && seg_at(row, p0 + t, n) == first;
  return __all_sync(0xffffffffu, same) && first != 0 ? first : 0;
}

// _block_relevant's segment test: can two tiles with these id ranges hold
// an equal nonzero pair?  Exact for monotone ids, conservative otherwise:
// it only drops tiles that the per-pair mask would mask in full.
__device__ __forceinline__ bool seg_overlap(int lo_a, int hi_a, int lo_b,
                                            int hi_b) {
  return lo_a <= hi_a && lo_b <= hi_b && hi_a >= lo_b && hi_b >= lo_a;
}

// Keys [*kbeg, *kend) that queries [q0, q0 + rows) can see by length,
// causality and window; empty when no query of the tile is live.  kbeg is
// rounded down to a multiple of `bk`.  Tiles outside the range are fully
// masked, so skipping them changes no output: a masked tile leaves (m, l,
// acc) as they were.  With segment ids each tile inside the range is
// tested again (seg_overlap).
__device__ __forceinline__ void key_range(int q0, int rows, int nq, int nk,
                                          int q_len, int kv_len, int causal,
                                          int window, int bk, int* kbeg,
                                          int* kend) {
  const int qhi = min(min(q0 + rows, nq), q_len);
  int hi = min(nk, kv_len);
  if (causal) hi = min(hi, qhi);
  int lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  if (qhi <= q0) hi = 0;
  *kbeg = (lo / bk) * bk;
  *kend = hi;
}

// True when every (query, key) pair of [q0, q0 + qr) x [k0, k0 + kr) is
// live by length, causality and window (segment ids aside): such a tile
// needs no per-pair mask.
__device__ __forceinline__ bool tile_full(int q0, int qr, int k0, int kr,
                                          int q_len, int kv_len, int causal,
                                          int window) {
  bool ok = q0 + qr <= q_len && k0 + kr <= kv_len;
  if (causal) ok = ok && k0 + kr - 1 <= q0;
  if (window >= 0) ok = ok && k0 > q0 + qr - 1 - window;
  return ok;
}

// The largest d a kernel instantiation takes, for NK = ceil(d/16) rounded up
// to the instantiated set {2, 4, 6, 8, 16}.
inline int flash_nk(int d) {
  const int nk = (d + 15) / 16;
  if (nk <= 2) return 2;
  if (nk <= 4) return 4;
  if (nk <= 6) return 6;
  if (nk <= 8) return 8;
  return 16;
}

#define FLASH_MAX_D 256

// Expands to a switch over flash_nk(d) that returns CALL(NK).
#define FLASH_NK_SWITCH(CALL) \
  switch (flash_nk(d)) {      \
    case 2:                   \
      return CALL(2);         \
    case 4:                   \
      return CALL(4);         \
    case 6:                   \
      return CALL(6);         \
    case 8:                   \
      return CALL(8);         \
    default:                  \
      return CALL(16);        \
  }
