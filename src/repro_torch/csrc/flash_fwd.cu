// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (wrapper at :244, pallas_call at :320,
// body `_flash_kernel`, masks `_tile_mask`, skip test `_block_relevant`),
// both branches: with and without packed-segment ids.  Per query row i of
// head h:
//
//   o_i = sum_j p_ij v_j,  p_ij = exp(s_ij - lse_i) on the mask, 0 off it,
//   s_ij = scale * q_i . k_j,  lse_i = m_i + log l_i
//
// under causal / sliding-window / per-row (q_len, kv_len) masking and, for
// packed rows, segment masking (a pair is live only when both ids are equal
// and nonzero), with GQA (head h reads kv head h / (H/G)).  A row with no
// live key reads o = 0 and lse = NEG_INF, the JAX package's empty-set
// convention.
//
// Design.  The Pallas kernel walks a sequential minor grid axis over kv
// blocks with (m, l, acc) in VMEM scratch.  Here one block owns one
// (b, h, 64-row q-tile) and walks the kv tiles it can see inside the block:
// it starts at the window's edge, stops at the causal diagonal and at
// kv_len (skipped tiles are fully masked and change no output).  With
// segment ids (SEG) it also skips, before loading K and V, a kv tile whose
// nonzero-id range is disjoint from the q-tile's or that is all padding
// (`_block_relevant`), and walks nothing for an all-padding q-tile; each
// thread keeps the ids of its rows and columns in registers for the
// per-pair mask.  The q-tile stays in shared memory for the whole walk; each kv
// tile of K and V is converted to f32 on load.  Per tile: S = Q K^T as a
// register-tiled f32 product (4 x CJ scores a thread, float4 operands from
// shared memory), the mask applied as NEG_INF before the row max and again
// as p = 0 after the exp (so an empty row stays at l = 0 instead of getting
// exp(NEG_INF - NEG_INF) = 1 of phantom mass), the online-softmax update of
// (m, l, acc), P^T to shared memory, then acc += P V.  IEEE f32 throughout:
// fmaf products and sums, expf and logf (no TF32, no __expf).
//
// Bound.  On phi3-mini-3.8b's training shape (B = 4, H = G = 32, N = 1024,
// d = 96, causal, bf16 in) the work is 4 * B*H * N^2/2 * d = 25.8 GFLOP of
// products (26 us at the 989 TFLOP/s bf16 tensor-core peak) and ~101 MB of
// traffic (30 us at 3.35 TB/s): the function is bound by bytes at ~30 us.
// This design computes in IEEE f32 on the SIMT cores, which caps it at
// 385 us (67 TFLOP/s): the tensor cores' f32 accumulation of bf16-rounded
// products would break the parity bars against the f32 reference, so that
// redesign (wgmma, TMA) is later work.

#include "flash_common.cuh"

template <typename T, int NK, int BQ, int BK, bool SEG>
__global__ void __launch_bounds__(FLASH_THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_lens,
                     const int* __restrict__ kv_lens,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, T* __restrict__ o,
                     float* __restrict__ lse, int H, int G, int Nq, int Nk,
                     int d, float scale, int causal, int window) {
  constexpr int RI = BQ / 16, CJ = BK / 16, LD = 16 * NK + 4, PS = BQ + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;  // P^T: (BK, PS)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q_len = q_lens[b], kv_len = kv_lens[b];
  const long long qo_base = ((long long)b * H + h) * Nq * d;
  const long long kv_base = ((long long)b * G + g) * Nk * d;
  const int d4 = (d + 3) & ~3;

  load_tile<T, BQ, LD>(sQ, q + qo_base, q0, Nq, d);

  float m[RI], l[RI], acc[RI][NK];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = FLASH_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) acc[i][kk] = 0.f;
  }

  // Segment ids of this thread's rows, and the q-tile's id range.
  const int* qs_row = SEG ? q_seg + (long long)b * Nq : nullptr;
  const int* ks_row = SEG ? kv_seg + (long long)b * Nk : nullptr;
  int sq[RI], q_lo = 0, q_hi = 0;
#pragma unroll
  for (int i = 0; i < RI; ++i) sq[i] = 0;
  if constexpr (SEG) {
#pragma unroll
    for (int i = 0; i < RI; ++i) sq[i] = seg_at(qs_row, q0 + ty * RI + i, Nq);
    seg_range<BQ>(qs_row, q0, Nq, &q_lo, &q_hi);
  }

  int kbeg, kend;
  key_range(q0, BQ, Nq, Nk, q_len, kv_len, causal, window, BK, &kbeg, &kend);
  if (SEG && q_lo > q_hi) kend = kbeg;  // an all-padding q-tile sees nothing
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    int sk[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) sk[j] = 0;
    if constexpr (SEG) {
      int k_lo, k_hi;
      seg_range<BK>(ks_row, k0, Nk, &k_lo, &k_hi);
      // The same answer in every thread: the skip is uniform.
      if (!seg_overlap(q_lo, q_hi, k_lo, k_hi)) continue;
#pragma unroll
      for (int j = 0; j < CJ; ++j) sk[j] = seg_at(ks_row, k0 + tx + 16 * j, Nk);
    }
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, BK, LD>(sK, k + kv_base, k0, Nk, d);
    load_tile<T, BK, LD>(sV, v + kv_base, k0, Nk, d);
    __syncthreads();

    float s[RI][CJ];
    tile_dot<RI, CJ, LD>(sQ, sK, d4, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty * RI + i;
      float mx = FLASH_NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool ok = pair_valid<SEG>(qp, k0 + tx + 16 * j, q_len, kv_len,
                                        causal, window, sq[i], sk[j]);
        s[i][j] = ok ? s[i][j] * scale : FLASH_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool ok = pair_valid<SEG>(qp, k0 + tx + 16 * j, q_len, kv_len,
                                        causal, window, sq[i], sk[j]);
        s[i][j] = ok ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) acc[i][kk] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j)
#pragma unroll
      for (int i = 0; i < RI; ++i)
        sP[(tx + 16 * j) * PS + ty * RI + i] = s[i][j];
    __syncthreads();
    tile_acc<RI, NK, PS, LD>(sP, sV, BK, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= Nq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = tx + 16 * kk;
      if (c < d)
        o[qo_base + (long long)row * d + c] = from_f32<T>(acc[i][kk] / l_safe);
    }
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Nq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int NK, bool SEG>
static int launch_fwd(const void* q, const void* k, const void* v,
                      const int* q_lens, const int* kv_lens, const int* q_seg,
                      const int* kv_seg, void* o, float* lse, int B, int H,
                      int G, int Nq, int Nk, int d, float scale, int causal,
                      int window, cudaStream_t stream) {
  constexpr int BQ = 64, BK = NK > 8 ? 32 : 64, LD = 16 * NK + 4;
  constexpr size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BK * (BQ + 4));
  auto kernel = flash_fwd_kernel<T, NK, BQ, BK, SEG>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  kernel<<<grid, FLASH_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, q_lens, kv_lens, q_seg, kv_seg,
      (T*)o, lse, H, G, Nq, Nk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

#define FWD_CALL(T, NK)                                                      \
  (q_seg ? launch_fwd<T, NK, true>(q, k, v, q_lens, kv_lens, q_seg, kv_seg, \
                                   o, lse, B, H, G, Nq, Nk, d, scale,       \
                                   causal, window, s)                       \
         : launch_fwd<T, NK, false>(q, k, v, q_lens, kv_lens, q_seg,        \
                                    kv_seg, o, lse, B, H, G, Nq, Nk, d,     \
                                    scale, causal, window, s))

template <typename T>
static int dispatch_fwd(const void* q, const void* k, const void* v,
                        const int* q_lens, const int* kv_lens,
                        const int* q_seg, const int* kv_seg, void* o,
                        float* lse, int B, int H, int G, int Nq, int Nk,
                        int d, float scale, int causal, int window,
                        cudaStream_t s) {
  switch (flash_nk(d)) {
    case 2:
      return FWD_CALL(T, 2);
    case 4:
      return FWD_CALL(T, 4);
    case 6:
      return FWD_CALL(T, 6);
    case 8:
      return FWD_CALL(T, 8);
    default:
      return FWD_CALL(T, 16);
  }
}

#undef FWD_CALL

extern "C" {

int flash_fwd_max_d() { return FLASH_MAX_D; }

// q (B, H, Nq, d), k/v (B, G, Nk, d), o like q: f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), contiguous; q_lens/kv_lens (B,) int32 clamped to [0, N];
// q_seg (B, Nq) and kv_seg (B, Nk) int32 segment ids, both or neither
// (null); lse (B, H, Nq) f32, or null when the caller needs no residual.
// window < 0 means no window.  Launches on `stream`; does not synchronise
// and allocates nothing.  Returns cudaGetLastError() after the launch.
int flash_fwd(const void* q, const void* k, const void* v, const int* q_lens,
              const int* kv_lens, const int* q_seg, const int* kv_seg,
              void* o, float* lse, int B, int H, int G, int Nq, int Nk, int d,
              float scale, int causal, int window, int is_bf16,
              void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || Nq <= 0 || Nk <= 0 ||
      d <= 0 || d > FLASH_MAX_D || (q_seg == nullptr) != (kv_seg == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch_fwd<__nv_bfloat16>(q, k, v, q_lens, kv_lens, q_seg,
                                       kv_seg, o, lse, B, H, G, Nq, Nk, d,
                                       scale, causal, window, s);
  return dispatch_fwd<float>(q, k, v, q_lens, kv_lens, q_seg, kv_seg, o, lse,
                             B, H, G, Nq, Nk, d, scale, causal, window, s);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
