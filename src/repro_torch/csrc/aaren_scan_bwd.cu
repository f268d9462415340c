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
// Design.  The mirror of aaren_scan.cu.  The Pallas kernel walks a
// right-to-left sequential grid over N with the carry in VMEM scratch and a
// Hillis-Steele suffix scan inside each block; Hopper runs blocks in no
// order, so the walk over N moves inside the block: one warp owns one row,
// each lane owns ceil(d/32) entries of G^ (at most AAREN_BWD_MAX_PER_LANE,
// so d <= 256), and every lane keeps the scalars (n, B^) redundantly.  For
// j = N-1 down to 0 each token is one fold with a leaf:
//
//   leaf = (-m_j, g_j / u_j, (g_j . o_j) / u_j)     (1/u := 0 where u == 0)
//   n' = max(n, -m_j);  a = exp(n - n');  b = exp(-m_j - n')
//   G^ = G^ a + b g_j/u_j;  B^ = B^ a + b (g_j . o_j)/u_j;  n = n'
//   e = exp(s_j + n);  ds_j = e (v_j . G^ - B^);  dv_j = e G^
//
// n is the suffix max of -m, which is -m_j because m is non-decreasing, so
// e <= 1 and nothing overflows.
//
// Segments.  Packed rows pass `ends` ((R, N) uint8, 1 at the last token of
// each segment that has a successor: the forward's start flags shifted left
// one).  The fold restarts at every end flag, as `_block_suffix_scan`'s
// segmented branch drops the later half of a window that holds an end: at a
// flagged token the running state is dropped and the leaf becomes the state
// (n' = -m_j, a = 0, bl = 1), a select on the same expressions, so a null
// `ends` computes bit-identical outputs.  The seed (-m_f, g_w, -g_u) thus
// reaches only the last segment and the trailing padding, and (n1, g1, b1)
// covers only the first segment, the only span the carry-in reached.  Within
// a segment m is non-decreasing, so e <= 1 still holds.  The flag travels
// with the token's other loads, so the one-token lookahead is unchanged.  The two dot products per token are warp
// reductions (__shfl_xor_sync).  The next token's loads are issued before
// the current token's arithmetic, so one token's load latency overlaps the
// previous token's work; ds is staged one token per lane and written 32 at
// a time.  expf (not __expf) keeps the kernel within 1e-4 of the f32 oracle.
//
// Bound.  The kernel reads s, m, u, v, o, g and the seed once and writes ds,
// dv and the final carry once: 4*R*N*(4d+4) + 8*R*(d+2) bytes, plus R*N
// with the flags.  At the
// training shape of phi3-mini-3.8b (R = 4 * 32 = 128, N = 1024, d = 96)
// that is 203 MB, about 61 us at 3.35 TB/s; the arithmetic is ~10*R*N*d
// flops, far below the f32 rate.  The walk over N is sequential per warp and
// 128 rows fill only 32 blocks of 4 warps, so the kernel is latency-bound,
// well above the byte bound; tiling over N and more rows per SM are later
// work.

#include <cuda_runtime.h>

#define AAREN_BWD_MAX_PER_LANE 8
#define AAREN_BWD_ROWS_PER_BLOCK 4
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

struct Token {
  float s, m, u;
  bool end;
  float g[AAREN_BWD_MAX_PER_LANE];
  float o[AAREN_BWD_MAX_PER_LANE];
  float v[AAREN_BWD_MAX_PER_LANE];
};

__device__ __forceinline__ void load_token(
    Token& t, const float* s_row, const float* m_row, const float* u_row,
    const float* v_row, const float* o_row, const float* g_row,
    const unsigned char* f_row, int j, int d, int lane) {
  t.s = s_row[j];
  t.end = f_row != nullptr && f_row[j] != 0;
  t.m = m_row[j];
  t.u = u_row[j];
#pragma unroll
  for (int k = 0; k < AAREN_BWD_MAX_PER_LANE; ++k) {
    const int c = lane + 32 * k;
    const long long at = (long long)j * d + c;
    t.g[k] = c < d ? g_row[at] : 0.f;
    t.o[k] = c < d ? o_row[at] : 0.f;
    t.v[k] = c < d ? v_row[at] : 0.f;
  }
}

__global__ void aaren_scan_bwd_kernel(
    const float* __restrict__ s, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ m,
    const float* __restrict__ u, const float* __restrict__ g,
    const float* __restrict__ n0, const float* __restrict__ g0,
    const float* __restrict__ b0, const unsigned char* __restrict__ ends,
    float* __restrict__ ds,
    float* __restrict__ dv, float* __restrict__ n1, float* __restrict__ g1,
    float* __restrict__ b1, int R, int N, int d) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * AAREN_BWD_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= R) return;

  float n = n0[r];
  float b = b0[r];
  float G[AAREN_BWD_MAX_PER_LANE];
#pragma unroll
  for (int k = 0; k < AAREN_BWD_MAX_PER_LANE; ++k) {
    const int c = lane + 32 * k;
    G[k] = c < d ? g0[r * d + c] : 0.f;
  }

  const float* s_row = s + r * N;
  const float* m_row = m + r * N;
  const float* u_row = u + r * N;
  const long long row = r * (long long)N * d;
  const float* v_row = v + row;
  const float* o_row = o + row;
  const float* g_row = g + row;
  const unsigned char* f_row = ends == nullptr ? nullptr : ends + r * N;
  float* ds_row = ds + r * N;
  float* dv_row = dv + row;

  Token cur, nxt;
  load_token(cur, s_row, m_row, u_row, v_row, o_row, g_row, f_row, N - 1, d,
             lane);
  float ds_keep = 0.f;  // ds of token (j & ~31) + lane
  for (int j = N - 1; j >= 0; --j) {
    if (j > 0)
      load_token(nxt, s_row, m_row, u_row, v_row, o_row, g_row, f_row, j - 1,
                 d, lane);

    const float inv_u = cur.u == 0.f ? 0.f : 1.f / cur.u;
    float go = 0.f;
#pragma unroll
    for (int k = 0; k < AAREN_BWD_MAX_PER_LANE; ++k) go += cur.g[k] * cur.o[k];
    go = warp_sum(go);

    const float ln = -cur.m;
    const float nn = cur.end ? ln : fmaxf(n, ln);
    const float a = cur.end ? 0.f : expf(n - nn);  // weight of later tokens
    const float bl = expf(ln - nn);                // weight of the leaf
    b = b * a + (go * inv_u) * bl;
    float vg = 0.f;
#pragma unroll
    for (int k = 0; k < AAREN_BWD_MAX_PER_LANE; ++k) {
      G[k] = G[k] * a + (cur.g[k] * inv_u) * bl;
      vg += cur.v[k] * G[k];
    }
    n = nn;
    vg = warp_sum(vg);

    const float e = expf(cur.s + n);
#pragma unroll
    for (int k = 0; k < AAREN_BWD_MAX_PER_LANE; ++k) {
      const int c = lane + 32 * k;
      if (c < d) dv_row[(long long)j * d + c] = e * G[k];
    }
    if ((j & 31) == lane) ds_keep = e * (vg - b);
    if ((j & 31) == 0) {
      const int t = j + lane;
      if (t < N) ds_row[t] = ds_keep;
    }
    if (j > 0) cur = nxt;
  }

  if (lane == 0) {
    n1[r] = n;
    b1[r] = b;
  }
#pragma unroll
  for (int k = 0; k < AAREN_BWD_MAX_PER_LANE; ++k) {
    const int c = lane + 32 * k;
    if (c < d) g1[r * d + c] = G[k];
  }
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
  const int blocks =
      (R + AAREN_BWD_ROWS_PER_BLOCK - 1) / AAREN_BWD_ROWS_PER_BLOCK;
  aaren_scan_bwd_kernel<<<blocks, 32 * AAREN_BWD_ROWS_PER_BLOCK, 0,
                          (cudaStream_t)stream>>>(s, v, o, m, u, g, n0, g0,
                                                  b0, ends, ds, dv, n1, g1,
                                                  b1, R, N, d);
  return (int)cudaGetLastError();
}

const char* aaren_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
