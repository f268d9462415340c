// Aaren prefix-scan attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `aaren_scan_bwd` in
// src/repro/kernels/aaren_scan_bwd.py (wrapper at :183, pallas_call at :264,
// body `_aaren_scan_bwd_kernel`, within-block `_block_suffix_scan`), plain
// and segmented: the analytic VJP of the forward scan from the forward's
// residuals (o, m_i, u_i) and the output cotangent g, for every row r of R
//
//   G_j = sum_{i>=j} g_i / U_i,   B_j = sum_{i>=j} (g_i . o_i) / U_i
//   ds_j = exp(s_j - M_j) (v_j . G_j - B_j),   dv_j = exp(s_j - M_j) G_j
//
// stabilised as a right-to-left scan of the paper's operator (+) on tuples
// (n, G^, B^) with n = -m as the running max, seeded with the reverse carry
// (n0, g0, b0) = (-m_f, g_{w_f}, -g_{u_f}).  The final reverse carry
// (n1, g1, b1) is the full-suffix state the epilogue in kernels/ops.py turns
// into the incoming-carry cotangents.
//
// The recurrence.  One token is one fold with its leaf, right to left:
//
//   leaf = (-m_j, g_j / u_j, (g_j . o_j) / u_j)     (1/u := 0 where u == 0)
//   n' = max(n, -m_j);  a = exp(n - n');  b = exp(-m_j - n')
//   G^ = G^ a + b g_j/u_j;  B^ = B^ a + b (g_j . o_j)/u_j;  n = n'
//   e = exp(s_j + n);  ds_j = e (v_j . G^ - B^);  dv_j = e G^
//
// One of a and b is exp(0) = 1, so a step takes one expf for them and one
// for e (expf, not __expf, keeps the kernel within 1e-4 of the f32 oracle).
// n is the suffix max of -m, which is -m_j because m is non-decreasing, so
// e <= 1 and nothing overflows.  Packed rows pass `ends` ((R, N) uint8, 1 at
// the last token of each segment that has a successor: the forward's start
// flags shifted left one).  At a flagged token the running state is dropped
// and the leaf becomes the state (n' = -m_j, a = 0, b = 1), as
// `_block_suffix_scan`'s segmented branch drops the later half of a window
// that holds an end.  The seed (-m_f, g_w, -g_u) thus reaches only the
// tokens after a row's last end, and (n1, g1, b1) covers only the first
// segment, the only span the carry-in reached.  A null `ends` runs the same
// code with no flag set, so its outputs are bit-identical to all-zero ends.
//
// Design: a chunked parallel suffix scan, the mirror of aaren_scan.cu.  B1
// cuts a row into 32-column slices because its scalar chain (m, u) does not
// depend on d; here two per-token quantities span all d columns of a row
// (g_j . o_j, which feeds B^, and v_j . G_j, which ds_j needs), so one block
// owns one row.  Each lane owns KPL = ceil(d/32) columns of G^ (d <= 256),
// and every lane keeps the scalars (n, B^) redundantly.  Each warp of a
// block owns a chunk of AAREN_BWD_CHUNK = 32 tokens; windows of as many
// chunks as warps walk the row from its end to its start.  Per window:
//
//   1. each warp stages its chunk's g and v in shared memory by coalesced
//      16-byte cp.async, in two groups (v stays in flight through steps
//      2-3), and its s, m, u and flags in registers (one token a lane; the
//      flags as a ballot mask); its o was staged during the window before;
//   2. it forms the chunk's aggregate from the identity (NEG_INF, 0, 0) in
//      closed form, which the recurrence reaches by rescaling: tokens 0 up
//      to the chunk's first end (all of them without one) weighted by
//      w_j = exp(-m_j - n) under their maximum n, G^ = sum_j (w_j/u_j) g_j
//      and B^ = sum_j w_j (g_j . o_j)/u_j, plus a "holds an end" flag.  In
//      the same pass over g it forms g_j . o_j: 8 tokens at a time each
//      lane sums its columns, then one transposing butterfly (10 shuffles
//      for 8 tokens) leaves token j's sum in lane j, which stores the
//      token's scalars (s_j, -m_j, 1/u_j, (g_j . o_j)/u_j) in shared memory
//      once.  Its o buffer is then free, and the next window's o is staged
//      into it while steps 3-4 run;
//   3. after one barrier every warp folds the window's carry with the
//      aggregates of the chunks to its right, right to left, by the
//      segmented operator (an aggregate that holds an end replaces the
//      carry); folding all of them gives the next window's carry, identical
//      in every warp;
//   4. each warp runs the recurrence over its chunk from its exclusive
//      carry, reading g and v from shared memory and the scalars by one
//      broadcast 16-byte load a token; it writes dv in contiguous 128-byte
//      rows and keeps each token's partial v_j . G^ per lane, 8 tokens at a
//      time, which the same butterfly turns into ds, one token a lane,
//      stored 32 at a time.  The warp that holds token 0 writes (n1, g1,
//      b1).
//
// A row of one chunk (N <= 32) skips step 3.  The shared memory a chunk
// needs grows with d (12 d bytes a token: g, o, v), so the launch takes as
// many warps (at most AAREN_BWD_MAX_WARPS) as fit in the 227 KB of a block:
// 6 at d = 96 (windows of 192 tokens), 4 at d = 128, 2 at d = 256.  The
// aggregates are double-buffered by window parity, so one barrier a window
// suffices.  kernels/ref.py::aaren_scan_bwd_chunked_reference is this
// algebra in plain torch.  n and n1 are maxima, so they equal the plain
// version's bit for bit; ds, dv, g1 and b1 round in another order.
//
// Why these choices, from alternatives built and timed on an H100.
// The chunk's aggregate first ran the recurrence from the identity, as
// step 4 does; in closed form it shares step 2's pass over g and adds no
// dependent chain.  Fully unrolled 32-token loops made the kernel several
// times larger than the instruction cache and fetch-bound; 8-token groups
// keep it small.  A bulk L2 prefetch of the next window's g and v made the
// kernel slower; staging them 8 rows at a time as step 4 frees the rows
// gained a few per cent on unpacked rows and nothing on packed ones.
// Neither is used.
//
// Bound.  The kernel reads s, m, u, v, o, g and the seed once and writes ds,
// dv and the final carry once: 4*R*N*(4d+4) + 8*R*(d+2) bytes, plus R*N
// with the flags.  At the training shape of phi3-mini-3.8b (R = 4 * 32 =
// 128, N = 1024, d = 96) that is 203,524,096 bytes, 60.753 us at 3.35 TB/s;
// the arithmetic is ~10*R*N*d flops, far below the f32 rate.  The walk of
// one warp per row (1024 dependent steps, each waiting on its own DRAM load)
// became 128 blocks of 6 warps, about one a SM; a window's g and v are one
// load of 147 KB a block, and the dependent chain is one 32-token pass a
// window, from shared memory and registers.  What is left above the bound
// is mostly arithmetic: most of a row's time remains when few rows share
// the card's bandwidth.

#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "launch.cuh"

#define AAREN_BWD_MAX_PER_LANE 8
#define AAREN_BWD_CHUNK 32     // tokens a warp owns in a window
#define AAREN_BWD_MAX_WARPS 8  // chunks of a window: the most warps of a block
#define AAREN_BWD_SMEM 232448  // bytes of shared memory a block may take
// -0.7 * FLT_MAX, the JAX package's finite "minus infinity".
#define AAREN_NEG_INF (-0.7f * 3.402823466e38f)
#define FULL_MASK 0xffffffffu
static_assert(AAREN_BWD_CHUNK == 32, "a chunk's scalars sit one token a lane");

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// Lane l's column k is c = l + 32 k; only the last of the KPL columns can
// lie past d.
template <int KPL>
__device__ __forceinline__ bool has_col(int k, int c, int d) {
  return k < KPL - 1 || c < d;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

// Copies `count` floats (a multiple of 4 with `vec`) from global `src` to
// shared `dst`: with `vec` by 16-byte cp.async, left in flight for the
// caller's commit and wait, else by plain loads and stores.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count, int lane, int vec) {
  if (vec) {
    for (int i = 4 * lane; i < count; i += 128)
      cp_async16(smem_addr(dst + i), src + i, 16);
  } else {
    for (int i = lane; i < count; i += 32) dst[i] = src[i];
  }
}

// One halving step of sum8: lanes that differ in bit OFF each keep one half
// of x[0, 2 HALF) and add the partner's partial sums of that half.
template <int OFF, int HALF>
__device__ __forceinline__ void sum8_step(float (&x)[8], int lane) {
  const bool hi = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? x[i] : x[i + HALF];
    const float keep = hi ? x[i + HALF] : x[i];
    x[i] = keep + __shfl_xor_sync(FULL_MASK, send, OFF);
  }
}

// x[i] holds lane's partial sum for token i of a group of 8.  Returns, in
// lane l, the sum over the warp for token l & 7 of the group (10 shuffles
// for 8 tokens, where a butterfly a token takes 40).
__device__ __forceinline__ float sum8(float (&x)[8], int lane) {
  sum8_step<16, 4>(x, lane);
  sum8_step<8, 2>(x, lane);
  sum8_step<4, 1>(x, lane);
  float y = x[0];  // token (lane >> 2) & 7, summed over lanes of one quad
  y += __shfl_xor_sync(FULL_MASK, y, 2);
  y += __shfl_xor_sync(FULL_MASK, y, 1);
  return __shfl_sync(FULL_MASK, y, 4 * (lane & 7));
}

// Tokens 8 q .. 8 q + 7 of a chunk (those below nv; all of them with
// kFull): each one's lane-partial g_t . o_t into x, and g_t with the weight
// ct = cw (from lane t) into the aggregate's aG.
template <int KPL, bool kFull>
__device__ __forceinline__ void dot_group(float (&x)[8], float (&aG)[KPL],
                                          const float* sg, const float* so,
                                          float cw, int q, int nv, int lane,
                                          int d) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = 8 * q + i;
    x[i] = 0.f;
    if (!kFull && t >= nv) continue;  // uniform across the warp
    const float ct = __shfl_sync(FULL_MASK, cw, t);
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int c = lane + 32 * k;
      if (has_col<KPL>(k, c, d)) {
        const float gk = sg[t * d + c];
        x[i] += gk * so[t * d + c];
        aG[k] += ct * gk;
      }
    }
  }
}

// Tokens 8 q + 7 down to 8 q of a chunk (those below nv; all of them with
// kFull) through the recurrence from the state (n, b, G): dv_t to
// dv_c[t * d], the lane-partial v_t . G^ into x, and (e_t, B^_t) kept in
// lane t.  `sc` holds each token's (s, -m, 1/u, (g.o)/u), `sg` and `sv` the
// chunk's g and v; bit t of `fl` flags token t as a segment end.
template <int KPL, bool kFull>
__device__ __forceinline__ void scan_group(float& n, float& b,
                                           float (&G)[KPL], float (&x)[8],
                                           float& e_keep, float& b_keep,
                                           const float4* sc, const float* sg,
                                           const float* sv, unsigned fl,
                                           int q, int nv, int lane, int d,
                                           float* dv_c) {
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    const int t = 8 * q + i;
    x[i] = 0.f;
    if (!kFull && t >= nv) continue;  // uniform across the warp
    const float4 p = sc[t];  // s, -m, 1/u, (g.o)/u
    const bool reset = (fl >> t) & 1u;
    const float ln = p.y;
    const float nn = reset ? ln : fmaxf(n, ln);
    const float ex = expf(fminf(n, ln) - nn);
    const bool up = ln > n;
    const float a = reset ? 0.f : (up ? ex : 1.f);   // weight of later tokens
    const float bl = reset ? 1.f : (up ? 1.f : ex);  // weight of the leaf
    const float cg = p.z * bl;                       // of g_t: bl / u_t
    b = b * a + p.w * bl;
    n = nn;
    const float e = expf(p.x + n);
#pragma unroll
    for (int k = 0; k < KPL; ++k) {
      const int c = lane + 32 * k;
      if (has_col<KPL>(k, c, d)) {
        G[k] = G[k] * a + sg[t * d + c] * cg;
        dv_c[(long long)t * d + c] = e * G[k];
        x[i] += sv[t * d + c] * G[k];
      }
    }
    if (t == lane) {
      e_keep = e;
      b_keep = b;
    }
  }
}

template <int KPL>
__global__ void __launch_bounds__(32 * AAREN_BWD_MAX_WARPS, 1)
    aaren_scan_bwd_kernel(
        const float* __restrict__ s, const float* __restrict__ v,
        const float* __restrict__ o, const float* __restrict__ m,
        const float* __restrict__ u, const float* __restrict__ g,
        const float* __restrict__ n0, const float* __restrict__ g0,
        const float* __restrict__ b0, const unsigned char* __restrict__ ends,
        float* __restrict__ ds, float* __restrict__ dv,
        float* __restrict__ n1, float* __restrict__ g1,
        float* __restrict__ b1, int N, int d, int vec) {
  constexpr int C = AAREN_BWD_CHUNK;
  extern __shared__ float4 smem4[];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk_floats = C * d;
  float4* sc = smem4 + warp * C;
  float* sg = reinterpret_cast<float*>(smem4 + n_warps * C) +
              warp * 3 * chunk_floats;
  float* so = sg + chunk_floats;
  float* sv = so + chunk_floats;
  float* agg = reinterpret_cast<float*>(smem4 + n_warps * C) +
               n_warps * 3 * chunk_floats;  // 2 buffers of n_warps (d + 3)
  const int agg_floats = n_warps * (d + 3);

  const long long r = blockIdx.x;
  const float* s_row = s + r * N;
  const float* m_row = m + r * N;
  const float* u_row = u + r * N;
  const unsigned char* f_row = ends == nullptr ? nullptr : ends + r * N;
  const long long row = r * (long long)N * d;
  const float* v_row = v + row;
  const float* o_row = o + row;
  const float* g_row = g + row;
  const int n_chunks = (N + C - 1) / C;
  const int n_windows = (n_chunks + n_warps - 1) / n_warps;
  // Tokens of this warp's chunk in window `w` (0 past the row's end).
  auto chunk_len = [&](int w) {
    return max(0, min(C, N - (w * n_warps + warp) * C));
  };

  // The carry into the current window, from the tokens to its right.
  float cn = n0[r], cb = b0[r], cG[KPL];
#pragma unroll
  for (int k = 0; k < KPL; ++k) {
    const int c = lane + 32 * k;
    cG[k] = c < d ? g0[r * d + c] : 0.f;
  }

  // o of the first window; each window prefetches the next one's.
  {
    const int t0 = ((n_windows - 1) * n_warps + warp) * C;
    stage(so, o_row + (long long)t0 * d, chunk_len(n_windows - 1) * d, lane,
          vec);
    if (vec) cp_async_commit();
  }
  for (int win = n_windows - 1, parity = 0; win >= 0; --win, parity ^= 1) {
    const int t0 = (win * n_warps + warp) * C;
    const int nv = chunk_len(win);

    // 1. Stage g and v (two cp.async groups) after every lane's reads of
    // the previous window; the scalars into registers.
    __syncwarp();
    stage(sg, g_row + (long long)t0 * d, nv * d, lane, vec);
    if (vec) cp_async_commit();
    stage(sv, v_row + (long long)t0 * d, nv * d, lane, vec);
    if (vec) cp_async_commit();
    const bool live = lane < nv;
    const float s_t = live ? s_row[t0 + lane] : 0.f;
    const float ln_t = live ? -m_row[t0 + lane] : 0.f;
    const float u_t = live ? u_row[t0 + lane] : 1.f;
    const unsigned fl = __ballot_sync(
        FULL_MASK, live && f_row != nullptr && f_row[t0 + lane] != 0);
    const float inv_u = u_t == 0.f ? 0.f : 1.f / u_t;

    // 2. The chunk's aggregate from the identity, in closed form: tokens 0
    // up to the first end (all of them without one) with the weights
    // exp(-m_j - n) under their maximum n; and g_j . o_j of every token.
    const int last = fl != 0u ? __ffs(fl) - 1 : C - 1;
    const bool in_agg = live && lane <= last;
    const float an =
        fmaxf(AAREN_NEG_INF, warp_max(in_agg ? ln_t : AAREN_NEG_INF));
    const float w_t = in_agg ? expf(ln_t - an) : 0.f;
    const float cw_t = w_t * inv_u;  // weight of g_t in the aggregate
    if (vec) cp_async_wait<1>();     // o and g have landed
    __syncwarp();
    float go = 0.f, aG[KPL];
#pragma unroll
    for (int k = 0; k < KPL; ++k) aG[k] = 0.f;
    for (int q = 0; 8 * q < nv; ++q) {
      float x[8];
      if (8 * q + 8 <= nv)
        dot_group<KPL, true>(x, aG, sg, so, cw_t, q, nv, lane, d);
      else
        dot_group<KPL, false>(x, aG, sg, so, cw_t, q, nv, lane, d);
      const float y = sum8(x, lane);
      if ((lane >> 3) == q) go = y;
    }
    const float gob = go * inv_u;
    const float ab = warp_sum(w_t * gob);
    sc[lane] = make_float4(s_t, ln_t, inv_u, gob);
    __syncwarp();  // sc written; every lane done reading so
    if (win > 0) {
      stage(so, o_row + (long long)(t0 - n_warps * C) * d,
            chunk_len(win - 1) * d, lane, vec);
    }
    if (vec) cp_async_commit();

    // 3. The carry of this warp's chunk: the window's carry folded with
    // the aggregates of the chunks to its right.
    float xn = cn, xb = cb, xG[KPL];
#pragma unroll
    for (int k = 0; k < KPL; ++k) xG[k] = cG[k];
    if (n_warps > 1) {
      float* buf = agg + parity * agg_floats;
      float* buf_n = buf + n_warps * d;
      float* buf_b = buf_n + n_warps;
      float* buf_f = buf_b + n_warps;
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        const int c = lane + 32 * k;
        if (c < d) buf[warp * d + c] = aG[k];
      }
      if (lane == 0) {
        buf_n[warp] = an;
        buf_b[warp] = ab;
        buf_f[warp] = fl != 0u ? 1.f : 0.f;
      }
      __syncthreads();
      for (int j = n_warps - 1; j >= 0; --j) {
        if ((win * n_warps + j) * C >= N) continue;  // past the row's end
        if (j == warp) {
          xn = cn;
          xb = cb;
#pragma unroll
          for (int k = 0; k < KPL; ++k) xG[k] = cG[k];
        }
        const float bn = buf_n[j], bb = buf_b[j];
        if (buf_f[j] != 0.f) {  // the aggregate holds an end
          cn = bn;
          cb = bb;
#pragma unroll
          for (int k = 0; k < KPL; ++k) {
            const int c = lane + 32 * k;
            cG[k] = c < d ? buf[j * d + c] : 0.f;
          }
        } else {
          const float nn = fmaxf(cn, bn);
          const float ex = expf(fminf(cn, bn) - nn);
          const bool up = bn > cn;
          const float al = up ? ex : 1.f, be = up ? 1.f : ex;
          cb = cb * al + bb * be;
#pragma unroll
          for (int k = 0; k < KPL; ++k) {
            const int c = lane + 32 * k;
            cG[k] = cG[k] * al + (c < d ? buf[j * d + c] : 0.f) * be;
          }
          cn = nn;
        }
      }
    }

    // 4. The chunk again from its carry: dv, ds and the final carry.
    if (vec) cp_async_wait<1>();  // v has landed
    __syncwarp();
    if (nv > 0) {
      float* dv_c = dv + row + (long long)t0 * d;
      float e_keep = 0.f, b_keep = 0.f, vg = 0.f;
      for (int q = (nv - 1) / 8; q >= 0; --q) {
        float x[8];
        if (8 * q + 8 <= nv)
          scan_group<KPL, true>(xn, xb, xG, x, e_keep, b_keep, sc, sg, sv, fl,
                                q, nv, lane, d, dv_c);
        else
          scan_group<KPL, false>(xn, xb, xG, x, e_keep, b_keep, sc, sg, sv,
                                 fl, q, nv, lane, d, dv_c);
        const float y = sum8(x, lane);
        if ((lane >> 3) == q) vg = y;
      }
      if (live) ds[r * N + t0 + lane] = e_keep * (vg - b_keep);
      if (t0 == 0) {
        if (lane == 0) {
          n1[r] = xn;
          b1[r] = xb;
        }
#pragma unroll
        for (int k = 0; k < KPL; ++k) {
          const int c = lane + 32 * k;
          if (c < d) g1[r * d + c] = xG[k];
        }
      }
    }
    if (n_warps == 1) {  // no fold: the chunk's own walk is the carry
      cn = xn;
      cb = xb;
#pragma unroll
      for (int k = 0; k < KPL; ++k) cG[k] = xG[k];
    }
  }
}

template <int KPL>
static int launch_bwd(const float* s, const float* v, const float* o,
                      const float* m, const float* u, const float* g,
                      const float* n0, const float* g0, const float* b0,
                      const unsigned char* ends, float* ds, float* dv,
                      float* n1, float* g1, float* b1, int R, int N, int d,
                      cudaStream_t stream) {
  auto kernel = aaren_scan_bwd_kernel<KPL>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, AAREN_BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  // A warp's scalars, g, o and v, and its two aggregates.
  const size_t per_warp = sizeof(float) * (4 * AAREN_BWD_CHUNK +
                                           3 * AAREN_BWD_CHUNK * d +
                                           2 * (d + 3));
  const int chunks = (N + AAREN_BWD_CHUNK - 1) / AAREN_BWD_CHUNK;
  int n_warps = (int)(AAREN_BWD_SMEM / per_warp);
  n_warps = n_warps < AAREN_BWD_MAX_WARPS ? n_warps : AAREN_BWD_MAX_WARPS;
  n_warps = n_warps < chunks ? n_warps : chunks;
  const int vec = d % 4 == 0 && (uintptr_t)v % 16 == 0 &&
                  (uintptr_t)o % 16 == 0 && (uintptr_t)g % 16 == 0;
  kernel<<<R, 32 * n_warps, n_warps * per_warp, stream>>>(
      s, v, o, m, u, g, n0, g0, b0, ends, ds, dv, n1, g1, b1, N, d, vec);
  return (int)cudaGetLastError();
}

extern "C" {

int aaren_scan_bwd_max_d() { return 32 * AAREN_BWD_MAX_PER_LANE; }

// Launches on `stream`; does not synchronise and allocates nothing.
// `ends` is null (unpacked rows) or (R, N) uint8 segment-end flags.
// Returns cudaGetLastError() after the launch (0 on success).
int aaren_scan_bwd(const float* s, const float* v, const float* o,
                   const float* m, const float* u, const float* g,
                   const float* n0, const float* g0, const float* b0,
                   const unsigned char* ends, float* ds, float* dv,
                   float* n1, float* g1, float* b1,
                   int R, int N, int d, void* stream) {
  if (R <= 0 || N <= 0 || d <= 0 || d > 32 * AAREN_BWD_MAX_PER_LANE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define AAREN_BWD_CASE(K)                                                  \
  case K:                                                                  \
    return launch_bwd<K>(s, v, o, m, u, g, n0, g0, b0, ends, ds, dv, n1,   \
                         g1, b1, R, N, d, st);
  switch ((d + 31) / 32) {
    AAREN_BWD_CASE(1)
    AAREN_BWD_CASE(2)
    AAREN_BWD_CASE(3)
    AAREN_BWD_CASE(4)
    AAREN_BWD_CASE(5)
    AAREN_BWD_CASE(6)
    AAREN_BWD_CASE(7)
    AAREN_BWD_CASE(8)
  }
#undef AAREN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

const char* aaren_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
