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
// Two kernels, picked by dtype in flash_fwd().  Both walk the kv tiles a
// q-tile can see, as the Pallas kernel's sequential minor grid axis does
// with (m, l, acc) in VMEM scratch: from the window's edge to the causal
// diagonal and kv_len (skipped tiles are fully masked and change no
// output) and, with segment ids (SEG), past every kv tile whose nonzero-id
// range is disjoint from the q-tile's or that is all padding
// (`_block_relevant`); an all-padding q-tile walks nothing.  Every warp
// computes the id ranges on its own (no shared state), so all threads of a
// block take the same branch before its barriers.  Masked scores are
// NEG_INF before the row max and p = 0 after the exp, so an empty row stays
// at l = 0 instead of getting exp(NEG_INF - NEG_INF) = 1 of phantom mass.
//
// bf16: the tensor cores (flash_fwd_wgmma_kernel).  One block of two
// warpgroups per (b, h, 128-row q-tile), 64 query rows a warpgroup; the
// q-tiles with the most kv tiles launch first.  Q is staged once, K and V
// through a ring of two stages, as bf16 core-matrix tiles
// (hopper_mma.cuh) by 16-byte cp.async, coalesced and zero-filled past N
// and past d: the next kept kv tile loads while this one computes.  (Rows
// whose d is not a multiple of 8, such as d = 130, or an unaligned base
// are gathered element by element into the same tiles.)  Per 64-key tile
// and warpgroup: S = Q K^T by wgmma m64n64k16 from shared memory (both
// operands K-major, d padded to a multiple of 16 with zero columns); the
// online softmax on the accumulator fragments in registers, in the log2
// domain with one FMA and one MUFU.EX2 a score (row max and sum over the
// quad that holds a row), the per-pair mask only on tiles that a warp's
// rows do not see in full (by length, causality, window and, with SEG, one
// document for all rows and keys); then O += P V by wgmma with P rounded
// to bf16 in registers as the A operand and V read MN-major from the same
// tile layout (d > 128: two products of 128 columns).  No P tile goes
// through shared memory.  The epilogue stages o through shared memory and
// writes 16-byte rows.
//
// f32: the SIMT cores (flash_fwd_kernel), IEEE f32 throughout (fmaf, expf,
// logf; no TF32).  One block per (b, h, 64-row q-tile); the q-tile stays
// in shared memory, each kv tile is converted to f32 on load; S = Q K^T as
// a register-tiled product (4 x CJ scores a thread, float4 operands), the
// online-softmax update of (m, l, acc), P^T through shared memory, then
// acc += P V.
//
// Parity.  The Pallas reference computes every product in f32.  A product
// of two bf16 values is exact in f32, so the tensor cores' S, and lse,
// differ from it only in the order of f32 sums; p is rounded to bf16
// before P V (as SDPA and Hopper flash kernels do) and the f32 sum of the
// unrounded p divides the result, which is bf16 anyway.
// kernels/ref.py::flash_attention_tc_oracle computes B3 with these
// rounding points (p rounded against the running max of each 64-key
// tile); chip_smoke.py holds the kernel to it within 2 bf16 spacings of
// each row's max, and to the f32 plain version at the bf16 bar.
//
// Bound.  On phi3-mini-3.8b's training shape (B = 4, H = G = 32, N = 1024,
// d = 96, causal, bf16 in) the work is 4 * B*H * N^2/2 * d = 25.8 GFLOP of
// products (26 us at the 989 TFLOP/s bf16 tensor-core peak) and ~101 MB of
// traffic (30 us at 3.35 TB/s): the function is bound by bytes at ~30 us.
// This design runs each tile's products and its softmax one after the
// other in a warpgroup (122 registers a thread at d = 96, 139 with SEG),
// so the tensor cores idle through the softmax unless another block of
// the multiprocessor fills the gap; it reaches about a sixth of the bf16
// peak on an H100 (PERF.md).  The f32 kernel is capped at 385 us there by
// the 67 TFLOP/s SIMT rate.

#include "flash_common.cuh"
#include "hopper_mma.cuh"

// Warpgroups (64 query rows each) of a bf16 block, and its kv tile.
#define FWD_TC_WG 2
#define FWD_TC_BK 64

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

// The bf16 kernel: tensor-core products (see the note at the top).
template <int NK, bool SEG>
__global__ void __launch_bounds__(128 * FWD_TC_WG, 1)
    flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ q_lens,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ q_seg,
                           const int* __restrict__ kv_seg,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int G, int Nq,
                           int Nk, int d, float scale, int causal, int window,
                           int vec) {
  constexpr int DP = 16 * NK, BQ = 64 * FWD_TC_WG, BK = FWD_TC_BK;
  constexpr int NT = 128 * FWD_TC_WG;
  constexpr int NH = DP > 128 ? 2 : 1;  // P V as NH products of DN columns
  constexpr int DN = DP / NH;
  constexpr uint32_t KV_BYTES = tile_bytes<BK, DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + tile_bytes<BQ, DP>();  // two stages
  const uint32_t sV = sK + 2 * KV_BYTES;          // two stages

  // The q-tiles with the most kv tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = wg * 64 + warp * 16;      // the warp's 16 rows
  const int rl = row0 + (lane >> 2);         // rows rl and rl + 8
  const int cl = 2 * (lane & 3);             // columns 8 j + cl + {0, 1}
  const int q_len = q_lens[b], kv_len = kv_lens[b];
  const long long qo_base = ((long long)b * H + h) * Nq * d;
  const long long kv_base = ((long long)b * G + g) * Nk * d;
  const bool vec_ok = vec != 0;

  const int* qs_row = SEG ? q_seg + (long long)b * Nq : nullptr;
  const int* ks_row = SEG ? kv_seg + (long long)b * Nk : nullptr;
  int sq[2] = {0, 0}, q_lo = 0, q_hi = 0;
  if constexpr (SEG) {
    sq[0] = seg_at(qs_row, q0 + rl, Nq);
    sq[1] = seg_at(qs_row, q0 + rl + 8, Nq);
    seg_range<BQ>(qs_row, q0, Nq, &q_lo, &q_hi);
  }
  int kbeg, kend;
  key_range(q0, BQ, Nq, Nk, q_len, kv_len, causal, window, BK, &kbeg, &kend);
  if (SEG && q_lo > q_hi) kend = kbeg;  // an all-padding q-tile sees nothing
  // The first kept kv tile at or after k0; every warp computes the same
  // answer on its own, so the walk is uniform.
  auto next_kept = [&](int k0) {
    if constexpr (SEG) {
      for (; k0 < kend; k0 += BK) {
        int k_lo, k_hi;
        seg_range<BK>(ks_row, k0, Nk, &k_lo, &k_hi);
        if (seg_overlap(q_lo, q_hi, k_lo, k_hi)) break;
      }
    }
    return k0;
  };

  float acc[NH][DN / 2];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int r = 0; r < DN / 2; ++r) acc[hh][r] = 0.f;
  // Running max (already times scale log2 e) and sum of each of the
  // thread's two rows; the sum is this thread's part, summed over the quad
  // at the end.
  float m[2] = {FLASH_NEG_INF, FLASH_NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = scale * FLASH_LOG2E;

  int kt = next_kept(kbeg);
  if (kt < kend) {
    stage_tile<BQ, DP>(sQ, q + qo_base, q0, Nq, d, vec_ok, tid, NT);
    stage_tile<BK, DP>(sK, k + kv_base, kt, Nk, d, vec_ok, tid, NT);
    stage_tile<BK, DP>(sV, v + kv_base, kt, Nk, d, vec_ok, tid, NT);
    cp_async_commit();
  }
  int buf = 0;
  while (kt < kend) {
    // Prefetch the next kept tile into the other stage, then wait for this
    // one.  The other stage was last read in the previous iteration, which
    // ended with a barrier.
    const int kn = next_kept(kt + BK);
    if (kn < kend) {
      stage_tile<BK, DP>(sK + (buf ^ 1) * KV_BYTES, k + kv_base, kn, Nk, d,
                         vec_ok, tid, NT);
      stage_tile<BK, DP>(sV + (buf ^ 1) * KV_BYTES, v + kv_base, kn, Nk, d,
                         vec_ok, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t kb = sK + buf * KV_BYTES, vb = sV + buf * KV_BYTES;

    // S = Q K^T for this warpgroup's 64 rows: 64 x 64, f32.
    float s[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma_ss_n64(s, desc_k_major<BQ>(sQ, wg * 64, 16 * ks),
                   desc_k_major<BK>(kb, 0, 16 * ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax in the log2 domain: p = 2^(s scale log2 e - m).  A
    // tile that is live throughout for this warp's rows (by length,
    // causality and window, and with SEG every row and key in one
    // document) takes no mask; otherwise masked scores are NEG_INF before
    // the row max and p = 0 after the exp, so an empty row keeps l = 0.
    // Both paths round alike (explicit intrinsics), so SEG and plain forms
    // agree bit for bit.
    bool full = tile_full(q0 + row0, 16, kt, BK, q_len, kv_len, causal,
                          window);
    if constexpr (SEG) {
      const int kid = seg_uniform<BK>(ks_row, kt, Nk);
      full = __all_sync(0xffffffffu,
                        full && kid != 0 && sq[0] == kid && sq[1] == kid);
    }
    float alpha[2];
    if (full) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = FLASH_NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) mx = fmaxf(mx, s[4 * j + 2 * i + c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], __fmul_rn(mx, sl2));
        alpha[i] = ex2_ftz(__fsub_rn(m[i], m_new));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            s[r] = ex2_ftz(__fmaf_rn(s[r], sl2, -m_new));
            ps = __fadd_rn(ps, s[r]);
          }
        l[i] = __fmaf_rn(l[i], alpha[i], ps);
        m[i] = m_new;
      }
    } else {
      uint32_t live = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = kt + 8 * j + cl + c;
          const int sk = SEG ? seg_at(ks_row, kp, Nk) : 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool ok = pair_valid<SEG>(q0 + rl + 8 * i, kp, q_len,
                                            kv_len, causal, window, sq[i],
                                            sk);
            live |= (uint32_t)ok << (4 * j + 2 * i + c);
          }
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = FLASH_NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            if ((live >> r) & 1u) mx = fmaxf(mx, s[r]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // A row with no live key yet keeps m = NEG_INF.
        const float m_new = fmaxf(
            m[i], mx == FLASH_NEG_INF ? FLASH_NEG_INF : __fmul_rn(mx, sl2));
        alpha[i] = ex2_ftz(__fsub_rn(m[i], m_new));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * i + c;
            s[r] = (live >> r) & 1u ? ex2_ftz(__fmaf_rn(s[r], sl2, -m_new))
                                    : 0.f;
            ps = __fadd_rn(ps, s[r]);
          }
        l[i] = __fmaf_rn(l[i], alpha[i], ps);
        m[i] = m_new;
      }
    }
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int r = 0; r < DN / 2; ++r)
        acc[hh][r] = __fmul_rn(acc[hh][r], alpha[(r >> 1) & 1]);

    // O += P V: P rounded to bf16 in registers as the A operand.
    uint32_t a[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) acc_to_a(s, st, a[st]);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st)
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        wgmma_rs<DN>(acc[hh], a[st], desc_mn_major<BK>(vb, 16 * st, hh * DN));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
    __syncthreads();  // every warpgroup is done with this stage
    buf ^= 1;
    kt = kn;
  }

  // o = acc / l through shared memory (the K and V stages are free after
  // the walk's last barrier), then 16-byte rows to global memory.
  constexpr int OS = DP + 8;  // row stride of the o tile, in elements
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem +
                                                       tile_bytes<BQ, DP>());
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = __fdiv_rn(1.f, lt == 0.f ? 1.f : lt);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < DN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(so + (rl + 8 * i) * OS + hh * DN +
                                           8 * j + cl) =
            __floats2bfloat162_rn(__fmul_rn(acc[hh][4 * j + 2 * i], inv),
                                  __fmul_rn(acc[hh][4 * j + 2 * i + 1], inv));
    const int row = q0 + rl + 8 * i;
    if (lse != nullptr && (lane & 3) == 0 && row < Nq)
      lse[((long long)b * H + h) * Nq + row] =
          lt == 0.f ? FLASH_NEG_INF : __fmaf_rn(m[i], FLASH_LN2, logf(lt));
  }
  __syncthreads();
  const int rows = min(BQ, Nq - q0);
  for (int idx = tid; idx < rows * (DP / 8); idx += NT) {
    const int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    if (c >= d) continue;
    __nv_bfloat16* dst = o + qo_base + (long long)(q0 + r) * d + c;
    const __nv_bfloat16* src = so + r * OS + c;
    if (vec_ok) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < d; ++e) dst[e] = src[e];
    }
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

template <int NK, bool SEG>
static int launch_fwd_wgmma(const void* q, const void* k, const void* v,
                            const int* q_lens, const int* kv_lens,
                            const int* q_seg, const int* kv_seg, void* o,
                            float* lse, int B, int H, int G, int Nq, int Nk,
                            int d, float scale, int causal, int window,
                            cudaStream_t stream) {
  constexpr int DP = 16 * NK, BQ = 64 * FWD_TC_WG;
  constexpr size_t smem =
      tile_bytes<BQ, DP>() + 4 * tile_bytes<FWD_TC_BK, DP>();
  static_assert(4 * tile_bytes<FWD_TC_BK, DP>() >= BQ * (DP + 8) * 2,
                "the o tile fits in the K and V stages");
  auto kernel = flash_fwd_wgmma_kernel<NK, SEG>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = bf16_rows_vec(d, q, k, v, o);
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  kernel<<<grid, 128 * FWD_TC_WG, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, q_lens, kv_lens, q_seg, kv_seg,
      (__nv_bfloat16*)o, lse, H, G, Nq, Nk, d, scale, causal, window, vec);
  return (int)cudaGetLastError();
}

#define FWD_ARGS                                                             \
  q, k, v, q_lens, kv_lens, q_seg, kv_seg, o, lse, B, H, G, Nq, Nk, d, scale, \
      causal, window, s
#define FWD_SIMT(NK)                                                         \
  (q_seg ? launch_fwd<float, NK, true>(FWD_ARGS)                             \
         : launch_fwd<float, NK, false>(FWD_ARGS))
#define FWD_WGMMA(NK)                                                        \
  (q_seg ? launch_fwd_wgmma<NK, true>(FWD_ARGS)                              \
         : launch_fwd_wgmma<NK, false>(FWD_ARGS))

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
  // bf16 runs on the tensor cores, f32 on the SIMT cores.
  if (is_bf16) FLASH_NK_SWITCH(FWD_WGMMA)
  FLASH_NK_SWITCH(FWD_SIMT)
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#undef FWD_WGMMA
#undef FWD_SIMT
#undef FWD_ARGS
