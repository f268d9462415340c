// Flash attention, backward, for Hopper (sm_90a): the dq pass (B4) and the
// dk/dv pass (B5), two kernels.
//
// Replaces the Pallas TPU kernel `flash_attention_bwd` in
// src/repro/kernels/flash_attention.py (wrapper at :472; dq pallas_call at
// :548, body `_flash_bwd_dq_kernel`; dk/dv pallas_call at :581, body
// `_flash_bwd_dkv_kernel`; both through `_recompute_p_ds`), both branches:
// with and without packed-segment ids.  From the forward's residual lse and
// delta_i = do_i . o_i (computed by the wrapper):
//
//   p_ij  = exp(s_ij - lse_i) on the mask, 0 off it
//   ds_ij = p_ij (do_i . v_j - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j                               (B4)
//   dk_j  = scale * sum_{h in group, i} ds_ij q_i                 (B5)
//   dv_j  =         sum_{h in group, i} p_ij do_i                 (B5)
//
// Re-applying the mask after the exp keeps the rows of empty queries (lse =
// NEG_INF, where exp(s - lse) would be 1) at p = 0, so masked queries get
// dq = 0 and masked keys dk = dv = 0.  The mask is the forward's: length,
// causal, window and, for packed rows (SEG), equal nonzero segment ids.
//
// Design.  B4 walks the kv tiles a q-tile can see, with Q and dO staged for
// the whole walk; per kv tile it forms S = Q K^T and dP = dO V^T, then dS,
// then dq += dS K.  B5 turns the walk around: one block per (b, g,
// kv-tile) holds K and V, loops over the group's query heads and over the
// q-tiles that can see this kv-tile (from the causal diagonal to the
// window's far edge and q_len), and accumulates dv += P^T dO and dk +=
// dS^T Q in f32 registers.  The Pallas kernel accumulates per query head
// and the wrapper group-sums; summing over the group inside the block
// writes kv-head outputs once.  With segment ids both kernels skip, before
// loading it, a tile whose nonzero-id range is disjoint from the block's
// own tile or that is all padding (`_block_relevant`, as in flash_fwd.cu),
// and hold the ids of each thread's rows and columns in registers for the
// per-pair mask.
//
// Each pass has two kernels, picked by dtype in flash_bwd_dq() and
// flash_bwd_dkv().  bf16 runs on the tensor cores, with hopper_mma.cuh's
// tiles and products:
//
// B4, bf16 (flash_bwd_dq_wgmma_kernel).  One block per (b, h, q-tile) of
// DQ_TC_WG warpgroups of 64 query rows (one warpgroup for d > 128, whose
// dq columns split into blocks of 128); the q-tiles with the most kv tiles
// launch first.  Q and dO are staged once, K and V of each kept 64-key
// tile through a ring of two stages, the next tile loading by coalesced
// 16-byte cp.async while this one computes; lse and delta sit in
// registers.  Every accumulator has query rows: S = Q K^T and dP = dO V^T
// by wgmma from shared memory (K-major); P = exp(S scale - lse) (one FMA
// and one MUFU.EX2) and dS = P (dP - delta) in registers, masked as the
// forward on tiles that a warp's rows do not see in full; then dQ += dS K
// by wgmma with dS rounded to bf16 in registers as the A operand and K read
// MN-major from the tile S read K-major.  dQ stays in f32 registers over
// the whole walk; the epilogue scales it, rounds it to bf16 and writes each
// query row once, through shared memory in 16-byte rows.  Masked queries
// read exactly 0.
//
// B5, bf16 (flash_bwd_dkv_wgmma_kernel).  Two warpgroups of 64 keys each
// (128-key kv tiles; one warpgroup of 64 keys for d > 128, whose output
// columns split into blocks of 128).  K and V are staged once; Q, dO, lse
// and delta of each kept (head, 64-query tile) item go through a ring of
// two stages.  Every accumulator has key rows: S^T = K Q^T and dP^T = V
// dO^T by wgmma from shared memory (K-major); P^T and dS^T in registers,
// masked as the forward, with lse and delta broadcast along the query
// columns; then dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T
// rounded to bf16 in registers as the A operand and dO, Q read MN-major
// from the tiles the first two products read K-major.  The epilogue
// scales dk, rounds both to bf16 and writes each key row once; masked keys
// read exactly 0.
//
// f32: the SIMT cores (flash_bwd_dq_kernel, flash_bwd_dkv_kernel), 64-row
// tiles, the score products register-tiled, dS^T (and P^T) through shared
// memory, IEEE f32 throughout (fmaf, expf; no TF32).
//
// Parity.  The products of two bf16 inputs (S, dP and their transposes)
// are exact f32 sums in another order than the Pallas reference's f32
// products; P and dS are rounded to bf16 before the products that read
// them (as SDPA and Hopper flash kernels do), whose sums stay f32, and dq,
// dk, dv are bf16 anyway.  kernels/ref.py::flash_bwd_dq_tc_oracle and
// flash_bwd_dkv_tc_oracle compute B4 and B5 with these rounding points;
// chip_smoke.py holds the kernels to them within 2 bf16 spacings of each
// row's max (+1e-6), and to the f32 plain version at the bf16 bar.  The
// SEG and plain instantiations round with explicit intrinsics (__fmaf_rn,
// __fmul_rn) on both the masked and the unmasked path, so all-ones ids
// give the outputs of no ids bit for bit.
//
// Bound.  On phi3-mini-3.8b's training shape (B = 4, H = G = 32, N = 1024,
// d = 96, causal, bf16 in) B4 does three products (S, dP, dS K), 38.7 GFLOP,
// 39 us at the 989 TFLOP/s bf16 tensor-core peak, against ~127 MB (38 us);
// B5 four (S, dP, P^T dO, dS^T Q), 51.5 GFLOP, 52 us, against ~151 MB
// (45 us).  Both functions are bound by operations.  Each warpgroup runs
// its products and the elementwise step one after the other, so the tensor
// cores idle through the exps unless another block of the multiprocessor
// fills the gap.  The f32 kernels are capped by the 67 TFLOP/s SIMT rate
// (B4 at 577 us).

#include "flash_common.cuh"
#include "hopper_mma.cuh"

// Warpgroups (64 keys each) of a bf16 B5 block at d <= 128.
#define DKV_TC_WG 2
// Warpgroups (64 query rows each) of a bf16 B4 block at d <= 128, and its
// kv tile.
#define DQ_TC_WG 2
#define DQ_TC_BK 64

// B4: dq.
template <typename T, int NK, int BQ, int BK, bool SEG>
__global__ void __launch_bounds__(FLASH_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ q_lens,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg, T* __restrict__ dq,
                        int H, int G, int Nq, int Nk, int d, float scale,
                        int causal, int window) {
  constexpr int RI = BQ / 16, CJ = BK / 16, LD = 16 * NK + 4, PS = BQ + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BQ * LD;  // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // dS^T: (BK, PS)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q_len = q_lens[b], kv_len = kv_lens[b];
  const long long row_base = ((long long)b * H + h) * Nq;
  const long long qo_base = row_base * d;
  const long long kv_base = ((long long)b * G + g) * Nk * d;
  const int d4 = (d + 3) & ~3;

  load_tile<T, BQ, LD>(sQ, q + qo_base, q0, Nq, d);
  load_tile<T, BQ, LD>(sO, dout + qo_base, q0, Nq, d);
  float L[RI], D[RI], acc[RI][NK];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    L[i] = row < Nq ? lse[row_base + row] : FLASH_NEG_INF;
    D[i] = row < Nq ? delta[row_base + row] : 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) acc[i][kk] = 0.f;
  }

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
  if (SEG && q_lo > q_hi) kend = kbeg;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    int sk[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) sk[j] = 0;
    if constexpr (SEG) {
      int k_lo, k_hi;
      seg_range<BK>(ks_row, k0, Nk, &k_lo, &k_hi);
      if (!seg_overlap(q_lo, q_hi, k_lo, k_hi)) continue;  // uniform
#pragma unroll
      for (int j = 0; j < CJ; ++j) sk[j] = seg_at(ks_row, k0 + tx + 16 * j, Nk);
    }
    __syncthreads();
    load_tile<T, BK, LD>(sK, k + kv_base, k0, Nk, d);
    load_tile<T, BK, LD>(sV, v + kv_base, k0, Nk, d);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    tile_dot<RI, CJ, LD>(sQ, sK, d4, ty, tx, s);
    tile_dot<RI, CJ, LD>(sO, sV, d4, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty * RI + i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const bool ok = pair_valid<SEG>(qp, k0 + tx + 16 * j, q_len, kv_len,
                                        causal, window, sq[i], sk[j]);
        const float p = ok ? expf(s[i][j] * scale - L[i]) : 0.f;
        sS[(tx + 16 * j) * PS + ty * RI + i] = p * (dp[i][j] - D[i]);
      }
    }
    __syncthreads();
    tile_acc<RI, NK, PS, LD>(sS, sK, BK, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty * RI + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = tx + 16 * kk;
      if (c < d)
        dq[qo_base + (long long)row * d + c] = from_f32<T>(scale * acc[i][kk]);
    }
  }
}

// B5: dk and dv.  Rows of the score tile are keys, columns queries.
template <typename T, int NK, int KT, int QT, bool SEG>
__global__ void __launch_bounds__(FLASH_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_lens,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ kv_seg, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int G, int Nq, int Nk,
                         int d, float scale, int causal, int window) {
  constexpr int RJ = KT / 16, CI = QT / 16, LD = 16 * NK + 4, PS = KT + 4;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + KT * LD;
  float* sQ = sV + KT * LD;
  float* sO = sQ + QT * LD;   // dO
  float* sP = sO + QT * LD;   // P^T as (query, key): (QT, PS)
  float* sS = sP + QT * PS;   // dS^T: (QT, PS)
  float* sL = sS + QT * PS;   // lse of the q-tile: (QT,)
  float* sD = sL + QT;        // delta of the q-tile: (QT,)

  const int k0 = blockIdx.x * KT, g = blockIdx.y, b = blockIdx.z;
  const int group = H / G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q_len = q_lens[b], kv_len = kv_lens[b];
  const long long kv_base = ((long long)b * G + g) * Nk * d;
  const int d4 = (d + 3) & ~3;

  load_tile<T, KT, LD>(sK, k + kv_base, k0, Nk, d);
  load_tile<T, KT, LD>(sV, v + kv_base, k0, Nk, d);
  float adk[RJ][NK], adv[RJ][NK];
#pragma unroll
  for (int r = 0; r < RJ; ++r)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) adk[r][kk] = adv[r][kk] = 0.f;

  // Queries [qbeg, qend) that keys [k0, min(k0 + KT, Nk, kv_len)) can see.
  const int khi = min(min(k0 + KT, Nk), kv_len);
  int qbeg = causal ? k0 : 0;
  int qend = min(Nq, q_len);
  if (window >= 0) qend = min(qend, khi - 1 + window);
  if (khi <= k0) qend = 0;
  qbeg = (qbeg / QT) * QT;

  // Segment ids of this thread's key rows, and the kv-tile's id range.
  const int* qs_row = SEG ? q_seg + (long long)b * Nq : nullptr;
  const int* ks_row = SEG ? kv_seg + (long long)b * Nk : nullptr;
  int sk[RJ], k_lo = 0, k_hi = 0;
#pragma unroll
  for (int r = 0; r < RJ; ++r) sk[r] = 0;
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < RJ; ++r) sk[r] = seg_at(ks_row, k0 + ty * RJ + r, Nk);
    seg_range<KT>(ks_row, k0, Nk, &k_lo, &k_hi);
    if (k_lo > k_hi) qend = qbeg;  // an all-padding kv-tile is seen by none
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = g * group + hh;
    const long long row_base = ((long long)b * H + h) * Nq;
    for (int q0 = qbeg; q0 < qend; q0 += QT) {
      int sq[CI];
#pragma unroll
      for (int c = 0; c < CI; ++c) sq[c] = 0;
      if constexpr (SEG) {
        int q_lo, q_hi;
        seg_range<QT>(qs_row, q0, Nq, &q_lo, &q_hi);
        if (!seg_overlap(q_lo, q_hi, k_lo, k_hi)) continue;  // uniform
#pragma unroll
        for (int c = 0; c < CI; ++c) sq[c] = seg_at(qs_row, q0 + tx + 16 * c, Nq);
      }
      __syncthreads();
      load_tile<T, QT, LD>(sQ, q + row_base * d, q0, Nq, d);
      load_tile<T, QT, LD>(sO, dout + row_base * d, q0, Nq, d);
      for (int t = threadIdx.x; t < QT; t += FLASH_THREADS) {
        const int row = q0 + t;
        sL[t] = row < Nq ? lse[row_base + row] : FLASH_NEG_INF;
        sD[t] = row < Nq ? delta[row_base + row] : 0.f;
      }
      __syncthreads();

      float s[RJ][CI], dp[RJ][CI];
      tile_dot<RJ, CI, LD>(sK, sQ, d4, ty, tx, s);
      tile_dot<RJ, CI, LD>(sV, sO, d4, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < RJ; ++r) {
        const int kp = k0 + ty * RJ + r;
#pragma unroll
        for (int c = 0; c < CI; ++c) {
          const int ql = tx + 16 * c;
          const bool ok = pair_valid<SEG>(q0 + ql, kp, q_len, kv_len, causal,
                                          window, sq[c], sk[r]);
          const float p = ok ? expf(s[r][c] * scale - sL[ql]) : 0.f;
          sP[ql * PS + ty * RJ + r] = p;
          sS[ql * PS + ty * RJ + r] = p * (dp[r][c] - sD[ql]);
        }
      }
      __syncthreads();
      tile_acc<RJ, NK, PS, LD>(sP, sO, QT, ty, tx, adv);
      tile_acc<RJ, NK, PS, LD>(sS, sQ, QT, ty, tx, adk);
    }
  }

#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    const int row = k0 + ty * RJ + r;
    if (row >= Nk) continue;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const int c = tx + 16 * kk;
      if (c < d) {
        dk[kv_base + (long long)row * d + c] = from_f32<T>(scale * adk[r][kk]);
        dv[kv_base + (long long)row * d + c] = from_f32<T>(adv[r][kk]);
      }
    }
  }
}

// B5 for bf16: tensor-core products (see the note at the top).  Rows of
// every accumulator are keys; NWG warpgroups of 64 keys each.
template <int NK, bool SEG, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ q_lens,
                               const int* __restrict__ kv_lens,
                               const int* __restrict__ q_seg,
                               const int* __restrict__ kv_seg,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int H, int G,
                               int Nq, int Nk, int d, float scale, int causal,
                               int window, int vec) {
  constexpr int DP = 16 * NK, KT = 64 * NWG, QT = 64, NT = 128 * NWG;
  constexpr int DN = DP > 128 ? 128 : DP;  // output columns of one block
  constexpr int NSPLIT = DP / DN;
  constexpr uint32_t KV_BYTES = tile_bytes<KT, DP>();
  constexpr uint32_t QO_BYTES = tile_bytes<QT, DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = smem_addr(smem);
  const uint32_t sV = sK + KV_BYTES;
  const uint32_t sQ = sV + KV_BYTES;      // two stages
  const uint32_t sO = sQ + 2 * QO_BYTES;  // dO, two stages
  float* sL = reinterpret_cast<float*>(smem + 2 * KV_BYTES +
                                       4 * QO_BYTES);  // lse * log2 e
  float* sD = sL + 2 * QT;                             // delta

  const int k0 = (blockIdx.x / NSPLIT) * KT, n0 = (blockIdx.x % NSPLIT) * DN;
  const int g = blockIdx.y, b = blockIdx.z, group = H / G;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = wg * 64 + warp * 16;  // the warp's 16 keys
  const int rl = row0 + (lane >> 2);     // keys k0 + rl and k0 + rl + 8
  const int cl = 2 * (lane & 3);         // queries q0 + 8 j + cl + {0, 1}
  const int q_len = q_lens[b], kv_len = kv_lens[b];
  const long long kv_base = ((long long)b * G + g) * Nk * d;
  const bool vec_ok = vec != 0;

  // Queries [qbeg, qend) that keys [k0, min(k0 + KT, Nk, kv_len)) can see.
  const int khi = min(min(k0 + KT, Nk), kv_len);
  int qbeg = causal ? k0 : 0;
  int qend = min(Nq, q_len);
  if (window >= 0) qend = min(qend, khi - 1 + window);
  if (khi <= k0) qend = 0;
  qbeg = (qbeg / QT) * QT;
  const int nq = qend > qbeg ? (qend - qbeg + QT - 1) / QT : 0;

  const int* qs_row = SEG ? q_seg + (long long)b * Nq : nullptr;
  const int* ks_row = SEG ? kv_seg + (long long)b * Nk : nullptr;
  int sk[2] = {0, 0}, k_lo = 0, k_hi = 0;
  int total = group * nq;  // (head, q-tile) items, head-major
  if constexpr (SEG) {
    sk[0] = seg_at(ks_row, k0 + rl, Nk);
    sk[1] = seg_at(ks_row, k0 + rl + 8, Nk);
    seg_range<KT>(ks_row, k0, Nk, &k_lo, &k_hi);
    if (k_lo > k_hi) total = 0;  // an all-padding kv-tile is seen by none
  }
  // The first kept item at or after `it`, computed by every warp alike.
  auto next_kept = [&](int it) {
    if constexpr (SEG) {
      for (; it < total; ++it) {
        int q_lo, q_hi;
        seg_range<QT>(qs_row, qbeg + (it % nq) * QT, Nq, &q_lo, &q_hi);
        if (seg_overlap(q_lo, q_hi, k_lo, k_hi)) break;
      }
    }
    return it;
  };
  // Q, dO, lse and delta of item `it` into stage `st`.
  auto stage_item = [&](int it, int st) {
    const int h = g * group + it / nq, q0 = qbeg + (it % nq) * QT;
    const long long row_base = ((long long)b * H + h) * Nq;
    stage_tile<QT, DP>(sQ + st * QO_BYTES, q + row_base * d, q0, Nq, d,
                       vec_ok, tid, NT);
    stage_tile<QT, DP>(sO + st * QO_BYTES, dout + row_base * d, q0, Nq, d,
                       vec_ok, tid, NT);
    for (int t = tid; t < QT; t += NT) {
      const int row = q0 + t;
      const float L = row < Nq ? lse[row_base + row] : FLASH_NEG_INF;
      sL[st * QT + t] = L <= FLASH_NEG_INF ? FLASH_NEG_INF : L * FLASH_LOG2E;
      sD[st * QT + t] = row < Nq ? delta[row_base + row] : 0.f;
    }
  };

  float adk[DN / 2], adv[DN / 2];
#pragma unroll
  for (int r = 0; r < DN / 2; ++r) adk[r] = adv[r] = 0.f;
  const float sl2 = scale * FLASH_LOG2E;

  stage_tile<KT, DP>(sK, k + kv_base, k0, Nk, d, vec_ok, tid, NT);
  stage_tile<KT, DP>(sV, v + kv_base, k0, Nk, d, vec_ok, tid, NT);
  int it = next_kept(0);
  if (it < total) stage_item(it, 0);
  cp_async_commit();
  int buf = 0;
  while (it < total) {
    // Prefetch the next kept item into the other stage, then wait for this
    // one (the other stage was last read before the previous barrier).
    const int nx = next_kept(it + 1);
    if (nx < total) {
      stage_item(nx, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int q0 = qbeg + (it % nq) * QT;
    const uint32_t qb = sQ + buf * QO_BYTES, ob = sO + buf * QO_BYTES;
    const float* Lb = sL + buf * QT;
    const float* Db = sD + buf * QT;

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys.
    float st[32], dpt[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) st[r] = dpt[r] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma_ss_n64(st, desc_k_major<KT>(sK, wg * 64, 16 * ks),
                   desc_k_major<QT>(qb, 0, 16 * ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma_ss_n64(dpt, desc_k_major<KT>(sV, wg * 64, 16 * ks),
                   desc_k_major<QT>(ob, 0, 16 * ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
    // delta).  A tile that is live throughout for this warp's keys (and
    // with SEG all in one document) takes no mask; otherwise p is 0 off
    // the forward's mask, so empty queries (lse = NEG_INF) stay 0.  Both
    // paths round alike.
    bool full = tile_full(q0, QT, k0 + row0, 16, q_len, kv_len, causal,
                          window);
    if constexpr (SEG) {
      const int qid = seg_uniform<QT>(qs_row, q0, Nq);
      full = __all_sync(0xffffffffu,
                        full && qid != 0 && sk[0] == qid && sk[1] == qid);
    }
    if (full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float L = Lb[8 * j + cl + c], D = Db[8 * j + cl + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * j + 2 * i + c;
            const float p = ex2_ftz(__fmaf_rn(st[r], sl2, -L));
            st[r] = p;
            dpt[r] = __fmul_rn(p, __fsub_rn(dpt[r], D));
          }
        }
    } else {
      uint32_t live = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qp = q0 + 8 * j + cl + c;
          const int sq = SEG ? seg_at(qs_row, qp, Nq) : 0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool ok = pair_valid<SEG>(qp, k0 + rl + 8 * i, q_len,
                                            kv_len, causal, window, sq,
                                            sk[i]);
            live |= (uint32_t)ok << (4 * j + 2 * i + c);
          }
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float L = Lb[8 * j + cl + c], D = Db[8 * j + cl + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 4 * j + 2 * i + c;
            const float p = (live >> r) & 1u
                                ? ex2_ftz(__fmaf_rn(st[r], sl2, -L))
                                : 0.f;
            st[r] = p;
            dpt[r] = __fmul_rn(p, __fsub_rn(dpt[r], D));
          }
        }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
    // registers as the A operand; dO and Q MN-major, output columns
    // [n0, n0 + DN).
    uint32_t ap[4][4], as[4][4];
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4) {
      acc_to_a(st, s4, ap[s4]);
      acc_to_a(dpt, s4, as[s4]);
    }
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4)
      wgmma_rs<DN>(adv, ap[s4], desc_mn_major<QT>(ob, 16 * s4, n0));
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4)
      wgmma_rs<DN>(adk, as[s4], desc_mn_major<QT>(qb, 16 * s4, n0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
    __syncthreads();  // every warpgroup is done with this stage
    buf ^= 1;
    it = nx;
  }
  cp_async_wait<0>();  // K and V were staged even when no item is kept

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + rl + 8 * i;
    if (row >= Nk) continue;
    __nv_bfloat16* dk_row = dk + kv_base + (long long)row * d;
    __nv_bfloat16* dv_row = dv + kv_base + (long long)row * d;
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      const int col = n0 + 8 * j + cl, r = 4 * j + 2 * i;
      store_bf16_pair(dk_row, col, d, __fmul_rn(scale, adk[r]),
                      __fmul_rn(scale, adk[r + 1]));
      store_bf16_pair(dv_row, col, d, adv[r], adv[r + 1]);
    }
  }
}

// B4 for bf16: tensor-core products (see the note at the top).  Rows of
// every accumulator are queries; NWG warpgroups of 64 query rows each.
template <int NK, bool SEG, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
    flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ q_lens,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ q_seg,
                              const int* __restrict__ kv_seg,
                              __nv_bfloat16* __restrict__ dq, int H, int G,
                              int Nq, int Nk, int d, float scale, int causal,
                              int window, int vec) {
  constexpr int DP = 16 * NK, BQ = 64 * NWG, BK = DQ_TC_BK, NT = 128 * NWG;
  constexpr int DN = DP > 128 ? 128 : DP;  // output columns of one block
  constexpr int NSPLIT = DP / DN;
  constexpr uint32_t QO_BYTES = tile_bytes<BQ, DP>();
  constexpr uint32_t KV_BYTES = tile_bytes<BK, DP>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sO = sQ + QO_BYTES;      // dO
  const uint32_t sK = sO + QO_BYTES;      // two stages
  const uint32_t sV = sK + 2 * KV_BYTES;  // two stages

  // The q-tiles with the most kv tiles first.
  const int n_qt = gridDim.x / NSPLIT;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / NSPLIT) * BQ;
  const int n0 = (blockIdx.x % NSPLIT) * DN;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int row0 = wg * 64 + warp * 16;  // the warp's 16 query rows
  const int rl = row0 + (lane >> 2);     // rows q0 + rl and q0 + rl + 8
  const int cl = 2 * (lane & 3);         // keys kt + 8 j + cl + {0, 1}
  const int q_len = q_lens[b], kv_len = kv_lens[b];
  const long long row_base = ((long long)b * H + h) * Nq;
  const long long qo_base = row_base * d;
  const long long kv_base = ((long long)b * G + g) * Nk * d;
  const bool vec_ok = vec != 0;

  // lse * log2 e and delta of the thread's two rows.
  float L[2], D[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl + 8 * i;
    const float l = row < Nq ? lse[row_base + row] : FLASH_NEG_INF;
    L[i] = l <= FLASH_NEG_INF ? FLASH_NEG_INF : l * FLASH_LOG2E;
    D[i] = row < Nq ? delta[row_base + row] : 0.f;
  }

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
  // The first kept kv tile at or after k0, computed by every warp alike.
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

  float acc[DN / 2];
#pragma unroll
  for (int r = 0; r < DN / 2; ++r) acc[r] = 0.f;
  const float sl2 = scale * FLASH_LOG2E;

  int kt = next_kept(kbeg);
  if (kt < kend) {
    stage_tile<BQ, DP>(sQ, q + qo_base, q0, Nq, d, vec_ok, tid, NT);
    stage_tile<BQ, DP>(sO, dout + qo_base, q0, Nq, d, vec_ok, tid, NT);
    stage_tile<BK, DP>(sK, k + kv_base, kt, Nk, d, vec_ok, tid, NT);
    stage_tile<BK, DP>(sV, v + kv_base, kt, Nk, d, vec_ok, tid, NT);
    cp_async_commit();
  }
  int buf = 0;
  while (kt < kend) {
    // Prefetch the next kept kv tile into the other stage, then wait for
    // this one (the other stage was last read before the previous barrier).
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

    // S = Q K^T and dP = dO V^T for this warpgroup's 64 query rows.
    float s[32], dp[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma_ss_n64(s, desc_k_major<BQ>(sQ, wg * 64, 16 * ks),
                   desc_k_major<BK>(kb, 0, 16 * ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
      wgmma_ss_n64(dp, desc_k_major<BQ>(sO, wg * 64, 16 * ks),
                   desc_k_major<BK>(vb, 0, 16 * ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = 2^(S scale log2 e - lse log2 e) and dS = P (dP - delta), dS in
    // place of dP.  A tile that is live throughout for this warp's rows
    // (and with SEG all in one document) takes no mask; otherwise p is 0
    // off the forward's mask, so empty queries (lse = NEG_INF) get dq = 0.
    // Both paths round alike.
    bool full = tile_full(q0 + row0, 16, kt, BK, q_len, kv_len, causal,
                          window);
    if constexpr (SEG) {
      const int kid = seg_uniform<BK>(ks_row, kt, Nk);
      full = __all_sync(0xffffffffu,
                        full && kid != 0 && sq[0] == kid && sq[1] == kid);
    }
    if (full) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = (r >> 1) & 1;
        const float p = ex2_ftz(__fmaf_rn(s[r], sl2, -L[i]));
        dp[r] = __fmul_rn(p, __fsub_rn(dp[r], D[i]));
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
      for (int r = 0; r < 32; ++r) {
        const int i = (r >> 1) & 1;
        const float p = (live >> r) & 1u
                            ? ex2_ftz(__fmaf_rn(s[r], sl2, -L[i]))
                            : 0.f;
        dp[r] = __fmul_rn(p, __fsub_rn(dp[r], D[i]));
      }
    }

    // dQ += dS K: dS rounded to bf16 in registers as the A operand, K read
    // MN-major (its rows index the keys) from the tile S read K-major;
    // output columns [n0, n0 + DN).
    uint32_t as[4][4];
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4) acc_to_a(dp, s4, as[s4]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4)
      wgmma_rs<DN>(acc, as[s4], desc_mn_major<BK>(kb, 16 * s4, n0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warpgroup is done with this stage
    buf ^= 1;
    kt = kn;
  }

  // dq = scale acc, rounded to bf16, through shared memory (the K and V
  // stages are free after the walk's last barrier), then 16-byte rows.
  constexpr int OS = DN + 8;  // row stride of the dq tile, in elements
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem + 2 * QO_BYTES);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(so + (rl + 8 * i) * OS + 8 * j +
                                         cl) =
          __floats2bfloat162_rn(__fmul_rn(scale, acc[4 * j + 2 * i]),
                                __fmul_rn(scale, acc[4 * j + 2 * i + 1]));
  __syncthreads();
  const int rows = min(BQ, Nq - q0);
  for (int idx = tid; idx < rows * (DN / 8); idx += NT) {
    const int r = idx / (DN / 8), c = (idx % (DN / 8)) * 8;
    if (n0 + c >= d) continue;
    __nv_bfloat16* dst = dq + qo_base + (long long)(q0 + r) * d + n0 + c;
    const __nv_bfloat16* src = so + r * OS + c;
    if (vec_ok) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && n0 + c + e < d; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, int NK, bool SEG>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* q_lens, const int* kv_lens, const int* q_seg,
                     const int* kv_seg, void* dq, int B, int H, int G, int Nq,
                     int Nk, int d, float scale, int causal, int window,
                     cudaStream_t stream) {
  constexpr int BQ = 64, BK = NK > 8 ? 32 : 64, LD = 16 * NK + 4;
  constexpr size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * LD +
                                           (size_t)BK * (BQ + 4));
  auto kernel = flash_bwd_dq_kernel<T, NK, BQ, BK, SEG>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nq + BQ - 1) / BQ, H, B);
  kernel<<<grid, FLASH_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      q_lens, kv_lens, q_seg, kv_seg, (T*)dq, H, G, Nq, Nk, d, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int NK, bool SEG>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* q_lens, const int* kv_lens, const int* q_seg,
                      const int* kv_seg, void* dk, void* dv, int B, int H,
                      int G, int Nq, int Nk, int d, float scale, int causal,
                      int window, cudaStream_t stream) {
  constexpr int KT = NK > 8 ? 32 : 64, QT = KT, LD = 16 * NK + 4;
  constexpr size_t smem =
      sizeof(float) * ((size_t)(2 * KT + 2 * QT) * LD +
                       2 * (size_t)QT * (KT + 4) + 2 * (size_t)QT);
  auto kernel = flash_bwd_dkv_kernel<T, NK, KT, QT, SEG>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nk + KT - 1) / KT, G, B);
  kernel<<<grid, FLASH_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      q_lens, kv_lens, q_seg, kv_seg, (T*)dk, (T*)dv, H, G, Nq, Nk, d, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <int NK, bool SEG>
static int launch_dq_wgmma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const int* q_lens,
                           const int* kv_lens, const int* q_seg,
                           const int* kv_seg, void* dq, int B, int H, int G,
                           int Nq, int Nk, int d, float scale, int causal,
                           int window, cudaStream_t stream) {
  // DQ_TC_WG warpgroups share the staged K and V; at d > 128 one, for
  // shared memory and registers, with dq's columns split over blocks.
  constexpr int DP = 16 * NK, NWG = NK > 8 ? 1 : DQ_TC_WG, BQ = 64 * NWG;
  constexpr int NSPLIT = DP > 128 ? DP / 128 : 1;
  constexpr size_t smem =
      2 * tile_bytes<BQ, DP>() + 4 * tile_bytes<DQ_TC_BK, DP>();
  static_assert(4 * tile_bytes<DQ_TC_BK, DP>() >=
                    BQ * ((DP > 128 ? 128 : DP) + 8) * 2,
                "the dq tile fits in the K and V stages");
  auto kernel = flash_bwd_dq_wgmma_kernel<NK, SEG, NWG>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = bf16_rows_vec(d, q, k, v, dout) && (uintptr_t)dq % 16 == 0;
  dim3 grid((Nq + BQ - 1) / BQ * NSPLIT, H, B);
  kernel<<<grid, 128 * NWG, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, delta,
      q_lens, kv_lens, q_seg, kv_seg, (__nv_bfloat16*)dq, H, G, Nq, Nk, d,
      scale, causal, window, vec);
  return (int)cudaGetLastError();
}

template <int NK, bool SEG>
static int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* q_lens,
                            const int* kv_lens, const int* q_seg,
                            const int* kv_seg, void* dk, void* dv, int B,
                            int H, int G, int Nq, int Nk, int d, float scale,
                            int causal, int window, cudaStream_t stream) {
  // Two warpgroups share the staged Q and dO; at d > 128 one, for shared
  // memory and registers.
  constexpr int DP = 16 * NK, NWG = NK > 8 ? 1 : DKV_TC_WG, KT = 64 * NWG;
  constexpr int QT = 64, NSPLIT = DP > 128 ? DP / 128 : 1;
  constexpr size_t smem =
      2 * tile_bytes<KT, DP>() + 4 * tile_bytes<QT, DP>() + 4 * QT * 4;
  auto kernel = flash_bwd_dkv_wgmma_kernel<NK, SEG, NWG>;
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = bf16_rows_vec(d, q, k, v, dout);
  dim3 grid((Nk + KT - 1) / KT * NSPLIT, G, B);
  kernel<<<grid, 128 * NWG, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, delta,
      q_lens, kv_lens, q_seg, kv_seg, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      H, G, Nq, Nk, d, scale, causal, window, vec);
  return (int)cudaGetLastError();
}

static bool bad_args(int B, int H, int G, int Nq, int Nk, int d,
                     const int* q_seg, const int* kv_seg) {
  return B <= 0 || H <= 0 || G <= 0 || H % G != 0 || Nq <= 0 || Nk <= 0 ||
         d <= 0 || d > FLASH_MAX_D || (q_seg == nullptr) != (kv_seg == nullptr);
}

extern "C" {

int flash_bwd_max_d() { return FLASH_MAX_D; }

// Shapes and dtypes as flash_fwd, segment ids included; dout like q; lse
// and delta (B, H, Nq) f32; dq like q.  Launches on `stream`; does not
// synchronise and allocates nothing.  Returns cudaGetLastError() after the
// launch.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* q_lens, const int* kv_lens, const int* q_seg,
                 const int* kv_seg, void* dq, int B, int H, int G, int Nq,
                 int Nk, int d, float scale, int causal, int window,
                 int is_bf16, void* stream) {
  if (bad_args(B, H, G, Nq, Nk, d, q_seg, kv_seg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DQ_ARGS                                                             \
  q, k, v, dout, lse, delta, q_lens, kv_lens, q_seg, kv_seg, dq, B, H, G,   \
      Nq, Nk, d, scale, causal, window, s
#define DQ_CALL(NK)                                                         \
  (is_bf16 ? (q_seg ? launch_dq_wgmma<NK, true>(DQ_ARGS)                   \
                    : launch_dq_wgmma<NK, false>(DQ_ARGS))                 \
           : (q_seg ? launch_dq<float, NK, true>(DQ_ARGS)                  \
                    : launch_dq<float, NK, false>(DQ_ARGS)))
  FLASH_NK_SWITCH(DQ_CALL)
#undef DQ_CALL
#undef DQ_ARGS
}

// dk/dv like k/v, written for every kv head (group-summed in the block).
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const int* q_lens, const int* kv_lens, const int* q_seg,
                  const int* kv_seg, void* dk, void* dv, int B, int H, int G,
                  int Nq, int Nk, int d, float scale, int causal, int window,
                  int is_bf16, void* stream) {
  if (bad_args(B, H, G, Nq, Nk, d, q_seg, kv_seg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DKV_ARGS                                                            \
  q, k, v, dout, lse, delta, q_lens, kv_lens, q_seg, kv_seg, dk, dv, B, H,  \
      G, Nq, Nk, d, scale, causal, window, s
#define DKV_CALL(NK)                                                        \
  (is_bf16 ? (q_seg ? launch_dkv_wgmma<NK, true>(DKV_ARGS)                 \
                    : launch_dkv_wgmma<NK, false>(DKV_ARGS))               \
           : (q_seg ? launch_dkv<float, NK, true>(DKV_ARGS)                \
                    : launch_dkv<float, NK, false>(DKV_ARGS)))
  FLASH_NK_SWITCH(DKV_CALL)
#undef DKV_CALL
#undef DKV_ARGS
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
