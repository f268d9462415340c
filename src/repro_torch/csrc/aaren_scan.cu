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
// The recurrence.  One token is one step of the paper's App. A recurrence
// with block size 1:
//
//   m' = max(m, s_i);  a = exp(m - m');  b = exp(s_i - m')
//   u  = u a + b;      w = w a + b v_i;  o_i = w / (u == 0 ? 1 : u)
//
// One of a and b is exp(0) = 1, so a step takes one expf (not __expf, which
// would leave the 1e-4 bar of the f32 oracle).  Leaves are (s_i, 1, v_i)
// exactly: masked positions arrive as s = NEG_INF, v = 0 and are not
// special-cased, so a masked leaf folded into an empty carry gives u = 1,
// and an all-padding row counts u up token by token, as the JAX package's
// scan does.  At a flagged token the running state is dropped and the
// token's leaf becomes the state (m' = s_i, a = 0, b = 1), exactly what the
// segmented operator gives when the later operand holds a start: the carry
// reaches only the tokens before a row's first flag, the final carry is the
// last segment's state, and padding (never flagged) folds in as identity
// leaves.  kSegmented false (a null `starts`) folds the flag logic away.
//
// Design: a chunked parallel scan (the paper's section 3.2: the operator
// (+) on (m, u, w) is associative, so chunks of a row reduce on their own
// and combine).  One block per (row, slice of 32 columns of w), so a row of
// d = 96 is three blocks; the scalar chain (m, u) does not depend on d, and
// every slice recomputes it with the same operations in the same order, so
// all slices agree bit for bit and slice 0 alone writes m_f, u_f, m_all and
// u_all.  Each warp of a block owns a chunk of AAREN_CHUNK tokens, one
// column a lane; a block of up to AAREN_WARPS warps walks the row in
// windows of that many chunks.  Per window:
//
//   1. each warp stages its chunk's slice of v in shared memory by
//      coalesced 16-byte cp.async (the only read of v), and its scores and
//      flags in registers (one token a lane; flags as a ballot mask);
//   2. it reduces the chunk from the identity (NEG_INF, 0, 0) with the
//      token recurrence to its aggregate, plus a "holds a start" flag, and
//      publishes it in shared memory;
//   3. after one barrier every warp folds the window's carry with the
//      aggregates before its own chunk, left to right, by the segmented
//      operator (core/scan_attention.py::combine_segmented: an aggregate
//      that holds a start replaces the carry); folding all of them gives
//      the next window's carry, identical in every warp;
//   4. each warp re-runs the token recurrence over its chunk from its
//      carry, reading v from shared memory, and writes o (128 contiguous
//      bytes a token) and the residuals (one token a lane, stored 32 at a
//      time); the warp that holds the row's last token writes the final
//      carry.
//
// A row of one chunk (N <= AAREN_CHUNK, the serving tick) skips steps 2-3.
// The aggregates are double-buffered by window parity, so one barrier a
// window suffices.  kernels/ref.py::aaren_scan_chunked_reference is this
// algebra in plain torch.  m, m_f and m_all are maxima, so they equal the
// plain version's bit for bit; u, w and o round in another order (within
// rtol = atol = 1e-4 of the plain version).
//
// Bound.  The kernel reads s, v and the carry once and writes o and the
// final carry once: 4*R*N*(2d+1) + 8*R*(d+2) bytes, plus 8*R*N with the
// residuals and R*N with the flags (s and the flags are read once a slice,
// a few per cent more).  At the training shape of phi3-mini-3.8b (R = 4 *
// 32 = 128, N = 1024, d = 96) that is 102 MB with the residuals, about 31 us
// at 3.35 TB/s; the arithmetic is ~15 f32 operations a token and column, far
// below the f32 rate.  The sequential walk of one warp per row (1024
// dependent steps, each with its own DRAM load, ~1.5 ms) became 384 blocks
// of 8 warps, whose dependent chains are 2 x 64 token steps a window read
// from shared memory and registers.  At the serving tick (R = 256, N = 16)
// the bound is ~1 us and a launch costs more.

#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "launch.cuh"

#define AAREN_SLICE 32  // columns of w a block owns, one a lane
#define AAREN_CHUNK 64  // tokens a warp owns in a window
#define AAREN_WARPS 8   // chunks of a window: the most warps of a block
#define AAREN_MAX_D 256
// -0.7 * FLT_MAX, the JAX package's finite "minus infinity".
#define AAREN_NEG_INF (-0.7f * 3.402823466e38f)

constexpr int kWords = AAREN_CHUNK / 32;  // score registers a lane holds
// Floats of one buffer of aggregates: w (warps x 32), then m, u and flag.
constexpr int kAggFloats = AAREN_WARPS * (AAREN_SLICE + 3);

// Runs the token recurrence over tokens [0, nv) of a warp's chunk from the
// state (m, u, w), ORing the chunk's flags into `started`.  Scores and flags
// sit in registers, one token a lane (s_reg[h] holds token 32 h + lane);
// `sv` is the chunk's slice of v, (AAREN_CHUNK, 32).  With kOut it writes
// o_i to o_col[i * d] and, when m_res is not null, (m_i, u_i) to m_res[i],
// u_res[i], staged one token a lane and stored 32 at a time.
template <bool kSegmented, bool kOut>
__device__ __forceinline__ void scan_chunk(float& m, float& u, float& w,
                                           bool& started,
                                           const float (&s_reg)[kWords],
                                           const unsigned (&f_reg)[kWords],
                                           const float* sv, int nv, int lane,
                                           bool has_c, float* o_col, int d,
                                           float* m_res, float* u_res) {
#pragma unroll
  for (int h = 0; h < kWords; ++h) {
    if (32 * h >= nv) break;  // uniform across the warp
    float m_keep = 0.f, u_keep = 0.f;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const int t = 32 * h + l;
      if (t >= nv) break;
      const float si = __shfl_sync(0xffffffffu, s_reg[h], l);
      const bool reset = kSegmented && ((f_reg[h] >> l) & 1u);
      const float mn = reset ? si : fmaxf(m, si);
      const float e = expf(fminf(m, si) - mn);
      const bool up = si > m;
      const float a = reset ? 0.f : (up ? e : 1.f);  // exp(m - m')
      const float b = reset ? 1.f : (up ? 1.f : e);  // exp(s_i - m')
      u = u * a + b;
      if (has_c) w = w * a + b * sv[t * AAREN_SLICE + lane];
      m = mn;
      if (kSegmented) started = started || reset;
      if constexpr (kOut) {
        if (has_c) o_col[(long long)t * d] = w / (u == 0.f ? 1.f : u);
        if (l == lane) {
          m_keep = m;
          u_keep = u;
        }
      }
    }
    if (kOut && m_res != nullptr && 32 * h + lane < nv) {
      m_res[32 * h + lane] = m_keep;
      u_res[32 * h + lane] = u_keep;
    }
  }
}

template <bool kSegmented>
__global__ void __launch_bounds__(32 * AAREN_WARPS)
    aaren_scan_fwd_kernel(const float* __restrict__ s,
                          const float* __restrict__ v,
                          const float* __restrict__ m0,
                          const float* __restrict__ u0,
                          const float* __restrict__ w0,
                          const unsigned char* __restrict__ starts,
                          float* __restrict__ o, float* __restrict__ m_f,
                          float* __restrict__ u_f, float* __restrict__ w_f,
                          float* __restrict__ m_all,
                          float* __restrict__ u_all, int N, int d,
                          int n_slices, int vec) {
  extern __shared__ float4 smem4[];
  const int n_warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* base = reinterpret_cast<float*>(smem4);
  float* sv = base + warp * (AAREN_CHUNK * AAREN_SLICE);
  float* agg = base + n_warps * (AAREN_CHUNK * AAREN_SLICE);  // 2 buffers

  const long long r = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x % n_slices) * AAREN_SLICE;
  const int c = c0 + lane, cols = min(AAREN_SLICE, d - c0);
  const bool has_c = c < d;
  const bool lead = c0 == 0;  // slice 0 writes the scalar outputs
  const float* s_row = s + r * N;
  const unsigned char* f_row = kSegmented ? starts + r * N : nullptr;
  const float* v_row = v + r * (long long)N * d;

  // The carry into the current window.
  float cm = m0[r], cu = u0[r], cw = has_c ? w0[r * d + c] : 0.f;
  const int window = n_warps * AAREN_CHUNK;
  int parity = 0;
  for (int tw = 0; tw < N; tw += window, parity ^= 1) {
    const int t0 = tw + warp * AAREN_CHUNK;
    const int nv = max(0, min(AAREN_CHUNK, N - t0));

    // 1. Stage: v's slice by cp.async (after every lane's reads of the
    // previous window), scores and flags into registers.
    __syncwarp();
    if (vec) {
      constexpr int Q = AAREN_SLICE / 4;  // 16-byte pieces of a token's slice
      for (int idx = lane; idx < nv * Q; idx += 32) {
        const int t = idx / Q, q = idx % Q;
        if (4 * q < cols)
          cp_async16(smem_addr(sv + t * AAREN_SLICE + 4 * q),
                     v_row + (long long)(t0 + t) * d + c0 + 4 * q, 16);
      }
      cp_async_commit();
    } else if (has_c) {
      for (int t = 0; t < nv; ++t)
        sv[t * AAREN_SLICE + lane] = v_row[(long long)(t0 + t) * d + c];
    }
    float s_reg[kWords];
    unsigned f_reg[kWords];
#pragma unroll
    for (int h = 0; h < kWords; ++h) {
      const int t = 32 * h + lane;
      s_reg[h] = t < nv ? s_row[t0 + t] : 0.f;
      f_reg[h] = kSegmented
                     ? __ballot_sync(0xffffffffu, t < nv && f_row[t0 + t] != 0)
                     : 0u;
    }
    if (vec) cp_async_wait<0>();
    __syncwarp();

    // The carry of this warp's chunk.
    float xm = cm, xu = cu, xw = cw;
    bool flag = false;
    if (n_warps > 1) {
      // 2. The chunk's aggregate from the identity.
      float am = AAREN_NEG_INF, au = 0.f, aw = 0.f;
      scan_chunk<kSegmented, false>(am, au, aw, flag, s_reg, f_reg, sv, nv,
                                    lane, has_c, nullptr, d, nullptr,
                                    nullptr);
      float* ab = agg + parity * kAggFloats;
      float* ab_m = ab + n_warps * AAREN_SLICE;
      float* ab_u = ab_m + n_warps;
      float* ab_f = ab_u + n_warps;
      ab[warp * AAREN_SLICE + lane] = aw;
      if (lane == 0) {
        ab_m[warp] = am;
        ab_u[warp] = au;
        ab_f[warp] = flag ? 1.f : 0.f;
      }
      __syncthreads();
      // 3. Fold the window's carry with the aggregates, left to right.
      for (int j = 0; j < n_warps && tw + j * AAREN_CHUNK < N; ++j) {
        if (j == warp) {
          xm = cm;
          xu = cu;
          xw = cw;
        }
        const float bm = ab_m[j], bu = ab_u[j], bw = ab[j * AAREN_SLICE + lane];
        if (kSegmented && ab_f[j] != 0.f) {  // the aggregate holds a start
          cm = bm;
          cu = bu;
          cw = bw;
        } else {
          const float mn = fmaxf(cm, bm);
          const float e = expf(fminf(cm, bm) - mn);
          const bool up = bm > cm;
          const float al = up ? e : 1.f, be = up ? 1.f : e;
          cu = cu * al + bu * be;
          cw = cw * al + bw * be;
          cm = mn;
        }
      }
    }

    // 4. The chunk again from its carry: o, the residuals, the final carry.
    if (nv > 0) {
      const bool res = lead && m_all != nullptr;
      scan_chunk<kSegmented, true>(
          xm, xu, xw, flag, s_reg, f_reg, sv, nv, lane, has_c,
          o + (r * N + t0) * (long long)d + c, d,
          res ? m_all + r * N + t0 : nullptr,
          res ? u_all + r * N + t0 : nullptr);
      if (t0 + nv == N) {
        if (lead && lane == 0) {
          m_f[r] = xm;
          u_f[r] = xu;
        }
        if (has_c) w_f[r * d + c] = xw;
      }
    }
  }
}

template <bool kSegmented>
static int launch_fwd(const float* s, const float* v, const float* m0,
                      const float* u0, const float* w0,
                      const unsigned char* starts, float* o, float* m_f,
                      float* u_f, float* w_f, float* m_all, float* u_all,
                      int R, int N, int d, cudaStream_t stream) {
  constexpr size_t chunk_bytes = sizeof(float) * AAREN_CHUNK * AAREN_SLICE;
  constexpr size_t max_smem =
      AAREN_WARPS * chunk_bytes + 2 * sizeof(float) * kAggFloats;
  auto kernel = aaren_scan_fwd_kernel<kSegmented>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, max_smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (N + AAREN_CHUNK - 1) / AAREN_CHUNK;
  const int n_warps = chunks < AAREN_WARPS ? chunks : AAREN_WARPS;
  const int n_slices = (d + AAREN_SLICE - 1) / AAREN_SLICE;
  const size_t smem = n_warps * chunk_bytes + 2 * sizeof(float) * kAggFloats;
  const int vec = d % 4 == 0 && (uintptr_t)v % 16 == 0;
  kernel<<<(unsigned)(R * (long long)n_slices), 32 * n_warps, smem,
           stream>>>(s, v, m0, u0, w0, starts, o, m_f, u_f, w_f, m_all,
                     u_all, N, d, n_slices, vec);
  return (int)cudaGetLastError();
}

extern "C" {

int aaren_scan_max_d() { return AAREN_MAX_D; }

// Launches on `stream`; does not synchronise and allocates nothing.
// `m_all` and `u_all` are both null (serving: no residuals) or both (R, N).
// `starts` is null (unpacked rows) or (R, N) uint8 segment-start flags.
// Returns cudaGetLastError() after the launch (0 on success).
int aaren_scan_fwd(const float* s, const float* v, const float* m0,
                   const float* u0, const float* w0,
                   const unsigned char* starts, float* o, float* m_f,
                   float* u_f, float* w_f, float* m_all, float* u_all, int R,
                   int N, int d, void* stream) {
  if (R <= 0 || N <= 0 || d <= 0 || d > AAREN_MAX_D)
    return (int)cudaErrorInvalidValue;
  if ((m_all == nullptr) != (u_all == nullptr))
    return (int)cudaErrorInvalidValue;
  if (starts != nullptr)
    return launch_fwd<true>(s, v, m0, u0, w0, starts, o, m_f, u_f, w_f, m_all,
                            u_all, R, N, d, (cudaStream_t)stream);
  return launch_fwd<false>(s, v, m0, u0, w0, starts, o, m_f, u_f, w_f, m_all,
                           u_all, R, N, d, (cudaStream_t)stream);
}

const char* aaren_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
