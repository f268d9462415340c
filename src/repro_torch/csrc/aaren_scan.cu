// Aaren prefix-scan attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `aaren_scan` in
// src/repro/kernels/aaren_scan.py (wrapper at :190, pallas_call at :275,
// body `_aaren_scan_kernel`, within-block `_block_prefix_scan`), carry-in
// and segmented forms: for every row r of R
//
//   o_i = sum_{j<=i} exp(s_j - m_i) v_j / sum_{j<=i} exp(s_j - m_i)
//
// with the carry (m0, u0, w0) folded in before token 0, plus the final carry.
// With `return_residuals` (non-null m_all, u_all) it also writes the running
// max and denominator (m_i, u_i) after every token, which the backward
// kernel (aaren_scan_bwd.cu) reads instead of re-running the scan.
// Packed rows (non-null `starts`, (R, N) uint8 flags, 1 at the first token of
// each segment) restart the scan at every flag: the Pallas kernel's
// `has_segments` branch, whose segmented Hillis-Steele scan drops the older
// half of a window that holds a start.
//
// Design.  The Pallas kernel runs a sequential grid over N with the carry in
// VMEM scratch and a Hillis-Steele scan inside each 256-token block.  Hopper
// runs blocks in no order, so the walk over N moves inside the block: one
// warp owns one row, each lane owns ceil(d/32) entries of w (at most
// AAREN_MAX_PER_LANE, so d <= 256), and every lane keeps the scalars (m, u)
// redundantly.  Each token is one step of the paper's App. A recurrence with
// block size 1:
//
//   m' = max(m, s_i);  a = exp(m - m');  b = exp(s_i - m')
//   u  = u a + b;      w = w a + b v_i;  o_i = w / (u == 0 ? 1 : u)
//
// Leaves are (s_i, 1, v_i) exactly: masked positions arrive as s = NEG_INF,
// v = 0 and are not special-cased, so a masked leaf folded into an empty
// carry gives u = 1, as the JAX package's scan does.  expf (not __expf)
// keeps the kernel within 1e-4 of the f32 oracle.
//
// Segments.  At a flagged token the running state is dropped and the token's
// leaf becomes the state: m' = s_i, a = 0, b = 1, so u = 1 and w = v_i,
// exactly what the segmented operator gives when the later operand holds a
// start.  The carry-in therefore reaches only the tokens before a row's
// first flag, the final carry is the last segment's state, and padding
// (never flagged) folds in as identity leaves.  The residuals are the
// segmented prefix's (m_i, u_i), staged and stored as before: a reset
// changes what is staged, not where.  The kernel is instantiated twice:
// with kSegmented false (a null `starts`: serving, unpacked training) the
// reset folds away and the code is the unsegmented kernel's, bit for bit
// and at its speed.
//
// Bound.  The kernel reads s, v and the carry once and writes o and the
// final carry once: 4*R*N*(2d+1) + 8*R*(d+2) bytes, plus 8*R*N with the
// residuals and R*N with the flags.  At the serving tick of
// phi3-mini-3.8b (R = 8 slots * 32 heads = 256, N = 16, d = 96) that is
// 3.36 MB, about 1 us at 3.35 TB/s; the arithmetic is ~5*R*N*d flops, far
// below the f32 rate.  A launch costs more than that at serving shapes.
// Loads are coalesced across the lanes of a warp (v_i is d contiguous
// floats).  The residuals are staged one token per lane and written 32 at a
// time, so their stores are coalesced too.  Tiling over N, 16-byte vector
// loads and fusing the score product and the (S, C, H, d) transposes are
// later work.  At the training shape of phi3-mini-3.8b (R = 4 * 32 = 128,
// N = 1024, d = 96) the bound is 4*R*N*(2d+3) = 102 MB, about 30 us; the
// kernel walks 1024 dependent token steps per warp, so it is latency-bound.

#include <cuda_runtime.h>

#define AAREN_MAX_PER_LANE 8
#define AAREN_ROWS_PER_BLOCK 4

template <bool kSegmented>
__global__ void aaren_scan_fwd_kernel(
    const float* __restrict__ s, const float* __restrict__ v,
    const float* __restrict__ m0, const float* __restrict__ u0,
    const float* __restrict__ w0, const unsigned char* __restrict__ starts,
    float* __restrict__ o, float* __restrict__ m_f, float* __restrict__ u_f,
    float* __restrict__ w_f, float* __restrict__ m_all,
    float* __restrict__ u_all, int R, int N, int d) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * AAREN_ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= R) return;

  float m = m0[r];
  float u = u0[r];
  float w[AAREN_MAX_PER_LANE];
#pragma unroll
  for (int k = 0; k < AAREN_MAX_PER_LANE; ++k) {
    const int c = lane + 32 * k;
    w[k] = c < d ? w0[r * d + c] : 0.f;
  }

  const float* s_row = s + r * N;
  const unsigned char* f_row = kSegmented ? starts + r * N : nullptr;
  const float* v_row = v + r * (long long)N * d;
  float* o_row = o + r * (long long)N * d;
  float m_keep = 0.f, u_keep = 0.f;  // residuals of token (i & ~31) + lane
  for (int i = 0; i < N; ++i) {
    const float si = s_row[i];
    const bool reset = kSegmented && f_row[i] != 0;
    const float mn = reset ? si : fmaxf(m, si);
    const float a = reset ? 0.f : expf(m - mn);
    const float b = expf(si - mn);  // 1 at a reset
    u = u * a + b;
    const float den = u == 0.f ? 1.f : u;
#pragma unroll
    for (int k = 0; k < AAREN_MAX_PER_LANE; ++k) {
      const int c = lane + 32 * k;
      if (c < d) {
        w[k] = w[k] * a + b * v_row[(long long)i * d + c];
        o_row[(long long)i * d + c] = w[k] / den;
      }
    }
    m = mn;
    if (m_all != nullptr) {
      if ((i & 31) == lane) {
        m_keep = m;
        u_keep = u;
      }
      if ((i & 31) == 31 || i == N - 1) {
        const int t = (i & ~31) + lane;
        if (t <= i) {
          m_all[r * N + t] = m_keep;
          u_all[r * N + t] = u_keep;
        }
      }
    }
  }

  if (lane == 0) {
    m_f[r] = m;
    u_f[r] = u;
  }
#pragma unroll
  for (int k = 0; k < AAREN_MAX_PER_LANE; ++k) {
    const int c = lane + 32 * k;
    if (c < d) w_f[r * d + c] = w[k];
  }
}

extern "C" {

int aaren_scan_max_d() { return 32 * AAREN_MAX_PER_LANE; }

// Launches on `stream`; does not synchronise and allocates nothing.
// `m_all` and `u_all` are both null (serving: no residuals) or both (R, N).
// `starts` is null (unpacked rows) or (R, N) uint8 segment-start flags.
// Returns cudaGetLastError() after the launch (0 on success).
int aaren_scan_fwd(const float* s, const float* v, const float* m0,
                   const float* u0, const float* w0,
                   const unsigned char* starts, float* o, float* m_f,
                   float* u_f, float* w_f, float* m_all, float* u_all, int R,
                   int N, int d, void* stream) {
  if (R <= 0 || N <= 0 || d <= 0 || d > 32 * AAREN_MAX_PER_LANE)
    return (int)cudaErrorInvalidValue;
  if ((m_all == nullptr) != (u_all == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + AAREN_ROWS_PER_BLOCK - 1) / AAREN_ROWS_PER_BLOCK;
  const int threads = 32 * AAREN_ROWS_PER_BLOCK;
  if (starts != nullptr)
    aaren_scan_fwd_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        s, v, m0, u0, w0, starts, o, m_f, u_f, w_f, m_all, u_all, R, N, d);
  else
    aaren_scan_fwd_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        s, v, m0, u0, w0, starts, o, m_f, u_f, w_f, m_all, u_all, R, N, d);
  return (int)cudaGetLastError();
}

const char* aaren_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
