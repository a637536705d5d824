// Tensor-core building blocks shared by the hand-written Hopper kernels
// (flash_fwd.cu, flash_bwd.cu, qgemm.cu): shared-memory addressing with an
// XOR swizzle, cp.async copies, ldmatrix loads, the bf16 mma.sync
// m16n8k16 product with f32 sums, and the fragment moves between them.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l holds rows
// l/4 and l/4 + 8 and columns 2 (l % 4) and + 1 of each 8-column piece of
// the A operand (16 x 16) and of the f32 accumulator (16 x 8); the B
// operand (16 x 8) is read down its columns.  So the accumulators of two
// neighbouring n-tiles are, once packed to bf16, exactly one A fragment of
// a product over those 16 columns (`to_a`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte chunk index of (row r, chunk c) in a bf16 tile of W columns.
// Chunks are XOR-swizzled so that the eight rows an ldmatrix phase reads
// at one logical chunk fall in eight different bank groups; with W = 32
// two rows share a 128-byte line and the line index does the XOR.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = W / 8;              // chunks per row
  static_assert(CPR == 4 || CPR % 8 == 0, "rows of 32 or 64k columns");
  if constexpr (CPR >= 8) {
    return r * CPR + (c ^ (r & 7));
  } else {
    const int line = r >> 1, pos = ((r & 1) << 2) | c;
    return line * 8 + (pos ^ (line & 7));
  }
}

// src_bytes < 16 copies that many bytes and zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, round to nearest even (as
// `.astype(bfloat16)`), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Rows [row0, row0 + NROWS) of one (s, d) slice, row stride `ss`
// elements, into a swizzled bf16 tile of D columns, by THREADS threads;
// rows past `s` and columns past `d` are zero.  ASYNC: one cp.async of 16
// bytes a chunk (needs d % 8 == 0 and 16-byte aligned rows), zero-filled
// by a source size of 0; else ordinary loads into the same layout, one
// chunk at a time (this route is for odd shapes, and holding every
// chunk's loads in flight would spill the D = 128 kernels).
template <int D, bool ASYNC, int NROWS, int THREADS>
__device__ __forceinline__ void load_tile_tc(bf16* tile, const bf16* src,
                                             int row0, int s, int d,
                                             long long ss, int tid) {
  constexpr int CPR = D / 8;
  constexpr int RSTEP = THREADS / CPR;    // rows between a thread's chunks
  static_assert(THREADS % CPR == 0 && NROWS % RSTEP == 0,
                "whole rows a pass");
  // a thread's chunks sit at one column c, rows r, r + RSTEP, ...: RSTEP
  // is a multiple of 8 rows, so they share one swizzle and lie a fixed
  // stride apart in the tile
  const int r = tid / CPR, c = tid % CPR;
  const uint32_t dst = smem_addr(tile) + swz<D>(r, c) * 16;
  const bf16* g = src + (long long)(row0 + r) * ss + c * 8;
  if constexpr (ASYNC) {
#pragma unroll
    for (int i = 0; i < NROWS / RSTEP; ++i) {
      const bool in = row0 + r + i * RSTEP < s && c * 8 < d;
      cp_async16(dst + i * RSTEP * CPR * 16,
                 in ? g + (long long)i * RSTEP * ss : src, in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < NROWS / RSTEP; ++i) {
      const bool in = row0 + r + i * RSTEP < s;
      const bf16* p = g + (long long)i * RSTEP * ss;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * 8 + 2 * j;
        const float lo = in && col < d ? __bfloat162float(p[2 * j]) : 0.f;
        const float hi =
            in && col + 1 < d ? __bfloat162float(p[2 * j + 1]) : 0.f;
        w[j] = pack_bf16(lo, hi);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dst + i * RSTEP * CPR * 16), "r"(w[0]), "r"(w[1]),
                      "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// acc (16 x D) += a (16 x 16 KS) . t[k0 : k0 + 16 KS], where t is a
// swizzled tile of D columns read along its rows (ldmatrix.trans)
template <int D, int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[KS][4],
                                       uint32_t tile, int k0, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile + swz<D>(k0 + kk * 16 + (lane & 7) +
                                         ((mi & 1) << 3),
                                     2 * dp + (mi >> 1)) * 16);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// A 16 x 8 NT f32 accumulator as the bf16 A fragments of a product over
// its columns: n-tiles 2kk and 2kk+1 make k-slice kk
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4],
                                     const float (&x)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Store a 16 x D f32 accumulator (rows row0 + lane/4 and + 8 of a
// contiguous (b, s, h, d) bf16 output) as bf16; rows past s and columns
// past d are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[D / 8][4],
                                           int b, int hh, int h, int s,
                                           int d, int row0, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= s) continue;
    bf16* o = out + (((long long)b * s + row) * h + hh) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      const float lo = acc[j][2 * half], hi = acc[j][2 * half + 1];
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < d) o[col] = __float2bfloat16(lo);
        if (col + 1 < d) o[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

}  // namespace
