// Hopper tensor-core building blocks for the flash kernels: warpgroup
// matrix products (wgmma) on bf16 tiles with f32 accumulators, their
// shared-memory descriptors, and the 16-byte cp.async staging that fills
// those tiles.  sm_90a only.
//
// Tile layout.  A bf16 tile of R rows (a multiple of 8) by DP columns (a
// multiple of 16) is stored as 8 x 8 "core matrices", 128 contiguous bytes
// each (8 rows of 16 bytes), in wgmma's canonical layout without swizzle,
// column chunk by column chunk:
//
//   byte(r, c) = (c / 8) * CS + r * 16 + (c % 8) * 2,   CS = 16 R + 16,
//
// so the 8-row groups of one 8-column chunk follow each other (128 bytes
// apart) and the chunks sit CS bytes apart.  The same tile serves as a
// K-major operand (rows index M or N, columns index K: leading byte offset
// CS between K-adjacent core matrices, stride byte offset 128 between
// 8-row groups) and as an MN-major B operand (rows index K, columns index
// N: leading byte offset 128 between K-adjacent groups, stride byte offset
// CS between N-adjacent ones), so a tile staged once feeds both products
// that read it.  Each core matrix is 128 contiguous bytes of shared
// memory, so the tensor cores read it without bank conflicts.  Staging
// walks a row's 16-byte chunks with consecutive threads, so a warp reads
// 512 contiguous bytes of global memory; the 16 bytes of padding in CS
// put the chunks of one row in distinct bank groups, so those writes do
// not conflict either.
//
// Accumulator layout (m64nN, f32).  Thread t of the warpgroup (warp w =
// t / 32, lane l) holds N / 2 floats; float r sits at row 16 w + l / 4 +
// 8 ((r >> 1) & 1) and column 8 (r >> 2) + 2 (l % 4) + (r & 1).  The four
// threads of a quad hold one row pair, so a row's max and sum are two
// shuffles.  Packed to bf16 pairs, the floats of columns [16 s, 16 s + 16)
// are exactly the register A operand of the k-step s of a following
// product (acc_to_a), so P and dS never go through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor without swizzle (layout type 0).
// Offsets in bytes, multiples of 16.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Bytes of a tile of R rows by DP columns.
template <int R, int DP>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (DP / 8) * (16 * R + 16);
}

// Rows [row0, row0 + 8 m) by K columns [k0, k0 + 16) of a tile of R rows,
// K-major.
template <int R>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int row0,
                                                 int k0) {
  return wgmma_desc(tile + (k0 / 8) * (16 * R + 16) + row0 * 16,
                    16 * R + 16, 128);
}

// K rows [k0, k0 + 16) by N columns [n0, ...) of a tile of R rows,
// MN-major (the tile's rows index K).
template <int R>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int k0,
                                                  int n0) {
  return wgmma_desc(tile + (n0 / 8) * (16 * R + 16) + k0 * 16, 128,
                    16 * R + 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes shared-memory writes of the generic proxy (thread stores, cp.async)
// visible to the tensor cores' async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages rows [r0, r0 + R) of a row-major (n_rows, d) bf16 matrix into the
// tile `dst` (R x DP); rows past n_rows and columns past d read 0.  With
// `vec` (d % 8 == 0 and a 16-byte aligned base) each 16-byte chunk is one
// cp.async, left in flight for the caller's commit and wait; otherwise the
// chunk is gathered element by element and stored at once.  Thread `tid`
// of `nthreads` takes chunks tid, tid + nthreads, ... in row-major order.
template <int R, int DP>
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const __nv_bfloat16* src, int r0,
                                           int n_rows, int d, bool vec,
                                           int tid, int nthreads) {
  for (int idx = tid; idx < R * (DP / 8); idx += nthreads) {
    const int r = idx / (DP / 8), c = idx % (DP / 8);
    const uint32_t off = c * (16 * R + 16) + r * 16;
    const int gr = r0 + r;
    const bool row_ok = gr < n_rows;
    if (vec) {
      const bool ok = row_ok && c * 8 < d;
      cp_async16(dst + off, ok ? src + (long long)gr * d + c * 8 : src,
                 ok ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = c * 8 + 2 * e;
        unsigned short lo = 0, hi = 0;
        if (row_ok && c0 < d)
          lo = __bfloat16_as_ushort(src[(long long)gr * d + c0]);
        if (row_ok && c0 + 1 < d)
          hi = __bfloat16_as_ushort(src[(long long)gr * d + c0 + 1]);
        w[e] = (uint32_t)lo | ((uint32_t)hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + off),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// 2^x, flushing results below 2^-126 to 0 (MUFU.EX2 alone).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Can rows of d bf16 values at these bases be staged 16 bytes at a time?
inline int bf16_rows_vec(int d, const void* a, const void* b, const void* c,
                         const void* e = nullptr) {
  const uintptr_t bases = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                          (uintptr_t)e;
  return d % 8 == 0 && bases % 16 == 0;
}

// Columns col and col + 1 (col even) of a row of d bf16 values, rounded
// from f32; columns at or past d are not written.
__device__ __forceinline__ void store_bf16_pair(__nv_bfloat16* row, int col,
                                                int d, float x0, float x1) {
  if (col + 1 < d && (d & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < d) row[col] = __float2bfloat16(x0);
    if (col + 1 < d) row[col + 1] = __float2bfloat16(x1);
  }
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The k-step s (columns [16 s, 16 s + 16)) of an m64nN accumulator as the
// register A operand of a following m64 product.
template <int NR>
__device__ __forceinline__ void acc_to_a(const float (&acc)[NR], int s,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * s + 0], acc[8 * s + 1]);
  a[1] = pack_bf16(acc[8 * s + 2], acc[8 * s + 3]);
  a[2] = pack_bf16(acc[8 * s + 4], acc[8 * s + 5]);
  a[3] = pack_bf16(acc[8 * s + 6], acc[8 * s + 7]);
}

// D (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers) * B (16 x 32, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, f32) += A (64 x 16, bf16 in registers) * B (16 x 96, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N) += A (registers) * B (shared, MN-major), N in {32, 64, 96, 128}.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else {
    static_assert(N == 128, "wgmma_rs takes N in {32, 64, 96, 128}");
    wgmma_rs_n128(d, a, db);
  }
}
