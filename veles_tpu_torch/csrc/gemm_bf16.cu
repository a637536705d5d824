// The bf16 body of `_matmul_kernel` for Hopper (sm_90a), written by hand:
// act(a @ w + bias) with a (M, K) and w (K, N) bf16 read through any
// strides, a bf16 bias, f32 sums and epilogue, and the result rounded once
// to bf16 (round to nearest even).
//
// Replaces the bf16 refs of veles_tpu/ops/gemm.py `_matmul_kernel` (via
// `_matmul_pallas` given bf16 operands: the fused trainer's
// precision_type="bfloat16" steps, the MNIST MLP's layer 1 and AlexNet's
// fc6 / fc7)                                         -> veles_matmul_bf16.
//
// What bounds it on the H100.  MNIST's products (100 x 784 x 100 and its
// weight gradient 784 x 100 x 100) move 0.33 MB: latency, how many SMs a
// launch reaches and how many dependent round trips each block makes.
// AlexNet's fully-connected products at batch 128 (128 x 9216 x 4096 and
// its gradients; fc7's 4096-wide ones) sit below the card's ~295 FLOP a
// byte: bytes, streaming W (or writing dW) at the card's rate over all
// SMs.  4096^3 is operations: 137 GFLOP over 989 TFLOP/s of bf16 is
// 0.139 ms, reached only through wgmma.  So ops/gemm.py `plan_bf16` picks
// one of two bodies before each launch, from the shape, the strides and
// the base addresses; both split K over a thread block cluster of `split`
// blocks (grid z, up to 8).  Rank r sums K tiles [r T / split, (r + 1) T /
// split) of the T = ceil(K / 64), a contiguous chunk; after a cluster
// barrier each rank reduces its slice of the tile's rows over all ranks'
// shared memory (distributed shared memory) in rank order, then runs the
// epilogue.  Every output is written once, by one block, with no atomics:
// a launch gives the same bits every time (ops/gemm.py
// `_matmul_bf16_split_ref` is the plain model of the order).
//
// * Body W (`veles_gemm_bf16_tma<BN, TA, TB>`), where TMA can describe
//   both operands (base 16-byte aligned, one unit stride, the other a
//   multiple of 16 bytes): a 128 x BN output tile (BN 128, or 256 where
//   the 128 x 128 tile keeps more than twice as many SMs busy), K in
//   steps of 64 (one 128-byte row of bf16) through a ring of dynamic
//   shared memory (6 stages at BN 128, 3 at 256), 128-byte swizzled.  One
//   producer warp keeps the ring's `cp.async.bulk.tensor.2d` loads in
//   flight against full / empty mbarriers; two consumer warpgroups of 64
//   rows each run `wgmma.mma_async m64nBNk16` on each arrived stage, keep
//   one stage's products in flight (wait_group 1) and release the stage
//   before it.  An operand's major-ness is the descriptor's transpose
//   bit (TA: a is M-major, as the weight gradient's x^T view; TB: w is
//   N-major, the weights' storage; K-major w is the input gradient's W^T
//   view), so every view is read in place.  TMA's zero fill makes the
//   ragged M, N and K edges.  The block is 288 threads at one block an
//   SM.  Its 9 warps leave 3 on one SM sub-partition, which caps every
//   thread at 168 registers: BN 256's 128 accumulators fit with 48 bytes
//   spilled.  No `setmaxnreg` moves the producer warp's registers to the
//   consumers: with the producer a warpgroup of one warp, it stalled the
//   launch until the mbarrier wait's watchdog trapped.  An unsplit grid
//   is one block an SM walking the tiles: the producer loads the next
//   tile while the consumers store this one, through a staged bf16 tile
//   in shared memory that TMA stores while the consumers go on to the
//   next tile's products (the weight gradients' K of 128 is two K steps
//   a tile, so their 75.5 MB of stores set the time).
// * Body S (`veles_gemm_bf16_ldsm<A_K, B_K>`), where TMA cannot (MNIST's
//   w (784, 100) and delta (100, 100) have a 200-byte row pitch; a sliced
//   view's base may be unaligned): a 64 x 64 tile, four warps of 32 x 32,
//   `mma.sync m16n8k16` fed by `ldmatrix` (`.trans` for an operand whose
//   unit stride runs along m or n) from XOR-swizzled tiles, staged by
//   `cp.async` in the widest chunk that the pitch and base allow (16, 8
//   or 4 bytes; element loads for an odd base or no unit stride) through
//   a three-stage ring.  MNIST's layer 1 is 4 tiles split 8: 32 blocks of
//   1-2 K steps.
//
// What was hard.  The wgmma descriptors: for a 128-byte swizzle the
// K-major operand's 8-row groups are 1024 bytes apart (SBO) and a
// 16-deep K step advances the start address 32 bytes inside the swizzled
// row; the MN-major operand's K step advances 16 rows (2048 bytes), its
// 64-wide MN boxes are 8192 bytes apart (LBO); a wrong field gives wrong
// numbers without a fault, so the card checks hold all four layout pairs
// at a ragged shape.  The accumulator layout of m64nNk16 (row 16 warp +
// lane / 4, + 8; column 8 j + 2 (lane % 4)) feeds both epilogues.  The
// tensor map is a driver call (cuTensorMapEncodeTiled), reached through
// cudaGetDriverEntryPoint, as the library links no libcuda; each map
// goes to the kernel as a __grid_constant__ parameter, so a CUDA graph
// that captured the launch holds it by value.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "act.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BODY_S = 0, BODY_W = 1;   // ops/gemm.py BF16_BODIES
constexpr int MAX_SPLIT = 8;            // a portable cluster
constexpr int BK = 64;                  // the K tile of both bodies

// -- the epilogue ------------------------------------------------------------

template <int ACT>
__device__ __forceinline__ float finish(const bf16* bias, int col, float x) {
  if (bias != nullptr) x += __bfloat162float(bias[col]);
  return activate<ACT>(x);
}

// outputs (row, col) and (row, col + 1) of the contiguous (M, N) result
template <int ACT>
__device__ __forceinline__ void put2(bf16* out, const bf16* bias, int M,
                                     int N, int row, int col, float x0,
                                     float x1) {
  if (row >= M || col >= N) return;
  bf16* o = out + (long long)row * N + col;
  const float y0 = finish<ACT>(bias, col, x0);
  if (col + 1 < N) {
    const float y1 = finish<ACT>(bias, col + 1, x1);
    if ((N & 1) == 0) {   // (row N + col) even: a 4-byte aligned pair
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
      return;
    }
    o[1] = __float2bfloat16_rn(y1);
  }
  o[0] = __float2bfloat16_rn(y0);
}

// outputs (row, col ... col + 3), col a multiple of 4
template <int ACT>
__device__ __forceinline__ void put4(bf16* out, const bf16* bias, int M,
                                     int N, int row, int col, float4 v) {
  if (row >= M || col >= N) return;
  bf16* o = out + (long long)row * N + col;
  const float x[4] = {v.x, v.y, v.z, v.w};
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    y[e] = col + e < N ? finish<ACT>(bias, col + e, x[e]) : 0.0f;
  if ((N & 3) == 0) {     // col + 4 <= N and an 8-byte aligned quad
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < N) o[e] = __float2bfloat16_rn(y[e]);
}

// Each rank's (BM_ x BN_) f32 partial tile sits in its shared memory at P
// (row pitch LD); rank `rank` sums rows [rank BM_ / split, (rank + 1) BM_ /
// split) over the ranks in rank order (0 + p_0 + p_1 + ...), then the
// epilogue.  Between two cluster barriers.
template <int ACT, int BM_, int BN_, int LD>
__device__ __forceinline__ void reduce_rows(cg::cluster_group& cluster,
                                            float* P, int split, int rank,
                                            int tid, int nthreads,
                                            const bf16* bias, bf16* out,
                                            int M, int N, int m0, int n0) {
  const int rows = BM_ / split, r0 = rank * rows;
  for (int idx = tid; idx < rows * (BN_ / 4); idx += nthreads) {
    const int lr = r0 + idx / (BN_ / 4), lc = idx % (BN_ / 4) * 4;
    if (m0 + lr >= M || n0 + lc >= N) continue;
    // every rank's read in flight at once, then the sum in rank order
    float4 p[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      p[r] = r < split ? *reinterpret_cast<const float4*>(
                             cluster.map_shared_rank(P, r) + lr * LD + lc)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < split) {
        s.x += p[r].x;
        s.y += p[r].y;
        s.z += p[r].z;
        s.w += p[r].w;
      }
    }
    put4<ACT>(out, bias, M, N, m0 + lr, n0 + lc, s);
  }
}

template <int BM_, int BN_, int LD>
__device__ __forceinline__ void reduce_any(cg::cluster_group& cluster,
                                           float* P, int split, int rank,
                                           int tid, int nthreads,
                                           const bf16* bias, bf16* out,
                                           int M, int N, int m0, int n0,
                                           int act) {
  switch (act) {
    case TANH:
      reduce_rows<TANH, BM_, BN_, LD>(cluster, P, split, rank, tid, nthreads,
                                      bias, out, M, N, m0, n0);
      break;
    case SIGMOID:
      reduce_rows<SIGMOID, BM_, BN_, LD>(cluster, P, split, rank, tid,
                                         nthreads, bias, out, M, N, m0, n0);
      break;
    case RELU:
      reduce_rows<RELU, BM_, BN_, LD>(cluster, P, split, rank, tid, nthreads,
                                      bias, out, M, N, m0, n0);
      break;
    case STRICT_RELU:
      reduce_rows<STRICT_RELU, BM_, BN_, LD>(cluster, P, split, rank, tid,
                                             nthreads, bias, out, M, N, m0,
                                             n0);
      break;
    default:
      reduce_rows<LINEAR, BM_, BN_, LD>(cluster, P, split, rank, tid,
                                        nthreads, bias, out, M, N, m0, n0);
  }
}

// -- body W: TMA + wgmma -----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed; a
// wait that outlasts 2^24 tries (a second or more) traps, so that a lost
// arrival fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1 << 24)) __trap();
  }
}

// the box of `map` at (c0 inner, c1 outer) elements into shared memory at
// dst, its bytes counted on the mbarrier at bar; zeros past the edges
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A wgmma shared-memory descriptor of a 128-byte swizzled tile (PTX ISA,
// matrix descriptor format): the start address, the leading and stride
// byte offsets in 16-byte units, layout 1 (128-byte swizzle).  K-major:
// SBO the 1024 bytes between 8-row groups (LBO unused); MN-major: LBO the
// bytes between 64-wide MN boxes, SBO the 1024 bytes between 8-deep K
// groups.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// acc (64 x 128, f32, this warpgroup's rows) += A (64 x 16) . B (16 x 128),
// both bf16 in shared memory, read through the descriptors; TA / TB: A
// MN-major (m contiguous) / B MN-major (n contiguous), else K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc (64 x 256, f32, this warpgroup's rows) += A (64 x 16) . B (16 x 256),
// both bf16 in shared memory, read through the descriptors; TA / TB: A
// MN-major (m contiguous) / B MN-major (n contiguous), else K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128<TA, TB>(d, da, db);
  } else {
    wgmma_n256<TA, TB>(d, da, db);
  }
}

namespace tma {

constexpr int BM = 128;                  // two consumer warpgroups
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS + 32;   // + the producer warp
constexpr int BOX = 64;                  // a box row: 64 bf16, 128 bytes
constexpr int BOX_BYTES = BOX * BK * 2;  // a 64 x 64 box: 8 KB
// the ring and the staged output tile together (of the 227 KB a block may
// use, less the ring's alignment slack and the barriers)
constexpr int SMEM_BUDGET = 224 * 1024;

template <int BN>
struct Cfg {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the staged bf16 output tile: 64-column boxes of 64 rows a warpgroup
  static constexpr int OUT_BYTES = BM * BN * 2;
  // 6 stages at BN 128, 3 at 256
  static constexpr int STAGES = (SMEM_BUDGET - OUT_BYTES) / STAGE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LD = BN + 4;      // the f32 partial tile's pitch
  // 1024 of slack to align the ring, the ring, the staged output tile,
  // full and empty barriers
  static constexpr int SMEM = 1024 + RING + OUT_BYTES + 2 * STAGES * 8;
  static_assert(BM * LD * 4 <= RING, "the partial tile fits the ring");
  static_assert(STAGES >= 3, "a ring");
  static_assert(SMEM <= 232448, "the 227 KB a block may use");
};

}  // namespace tma

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the box of `map` at (c0 inner, c1 outer) from shared memory at src;
// the parts past the tensor's edges are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Byte offset of element (r, c) of a warpgroup's staged (64 x BN) bf16
// rows: 64-column boxes of 64 rows of 128 bytes, each row's 16-byte
// chunks XOR-swizzled by the row (the TMA map's 128-byte swizzle), so that
// the 8 rows a warp writes at once fall in 8 bank groups.
__device__ __forceinline__ uint32_t staged_at(int r, int c) {
  return (c >> 6) * (64 * 128) + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// One consumer warpgroup's 64 rows of a tile through the epilogue: the
// accumulators (thread rows lrow, lrow + 8 of the 64, columns lcol + 8 j
// and + 1) act(x + bias)'d, rounded and staged at `stage`, then stored by
// TMA (tma_out: one thread issues the boxes and goes on to the next
// tile while they drain, so the weight gradients' stores, most of a
// tile's time at K = 128, overlap the next tile's products) or, where the
// output's pitch is no multiple of 16 bytes, copied out 16 bytes a thread
// along a row.  Named barrier 2 + wg fences the staged rows.
template <int ACT, int BN>
__device__ __forceinline__ void store_rows(
    const float (&acc)[BN / 2], uint32_t stage, const CUtensorMap* map_out,
    int tma_out, const bf16* bias, bf16* out, int M, int N, int row0,
    int n0, int wg, int tw, int lrow, int lcol) {
  // the staged rows' last store has read them
  if (tma_out && tw == 0) bulk_wait_read();
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lcol + 8 * j, col = n0 + c, e = 4 * j + 2 * half;
      const float y0 = col < N ? finish<ACT>(bias, col, acc[e]) : 0.0f;
      const float y1 =
          col + 1 < N ? finish<ACT>(bias, col + 1, acc[e + 1]) : 0.0f;
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(stage + staged_at(lrow + 8 * half, c)),
                      "r"(pack_bf16(y0, y1))
                   : "memory");
    }
  }
  // the writes are seen by the bulk copies (the async proxy)
  if (tma_out) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
  if (tma_out) {
    if (tw == 0) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        tma_store(map_out, stage + b * 64 * 128, n0 + 64 * b, row0);
      bulk_commit();
    }
    return;
  }
  for (int idx = tw; idx < 64 * (BN / 8); idx += 128) {
    const int r = idx / (BN / 8), c = idx % (BN / 8) * 8;
    const int row = row0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(stage + staged_at(r, c)));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* o = out + (long long)row * N + col;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < N) o[i] = e[i];
  }
}

// BN: the tile's columns (128 or 256); TA: a is M-major (else K-major);
// TB: w is N-major (else K-major).  Split: the grid is (tiles, 1, split),
// launched as clusters of (1, 1, split), blockIdx.z the block's rank and
// blockIdx.x its tile (row-major over the (M, N) tiles).  Unsplit: one
// block an SM, each walking tiles blockIdx.x, + gridDim.x, ..., so that
// the producer loads the next tile while the consumers store this one
// (the weight gradients' K of 128 is two K steps a tile: the stores would
// otherwise leave the loads idle).
template <int BN, int TA, int TB>
__global__ void __launch_bounds__(tma::THREADS, 1)
veles_gemm_bf16_tma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_out,
                    const int tma_out, const bf16* __restrict__ bias,
                    bf16* __restrict__ out, const int M, const int N,
                    const int K, const int act) {
  using namespace tma;
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts on a
  // multiple of 1024, as TMA and the descriptors both assume
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t staged = base + C::RING;
  const uint32_t full0 = base + C::RING + C::OUT_BYTES;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int split = gridDim.z, rank = blockIdx.z;
  const int k_tiles = (K + BK - 1) / BK;
  const int t0 = rank * k_tiles / split;
  const int steps = (rank + 1) * k_tiles / split - t0;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // the producer: one thread keeps the ring's loads in flight, running
    // ahead into the block's next tile while the consumers store this one
    if ((tid & 31) == 0) {
      int g = 0;   // the ring's position over all of the block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
        for (int t = 0; t < steps; ++t, ++g) {
          const int s = g % C::STAGES;
          const uint32_t full = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((g / C::STAGES) & 1) ^ 1);
          mbar_expect_tx(full, C::STAGE);
          const uint32_t sa = base + s * C::STAGE, sb = sa + C::A_BYTES;
          const int k0 = (t0 + t) * BK;
          if (TA) {
            tma_load(sa, &map_a, full, m0, k0);
            tma_load(sa + BOX_BYTES, &map_a, full, m0 + BOX, k0);
          } else {
            tma_load(sa, &map_a, full, k0, m0);
          }
          if (TB) {
#pragma unroll
            for (int j = 0; j < BN / BOX; ++j)
              tma_load(sb + j * BOX_BYTES, &map_b, full, n0 + j * BOX, k0);
          } else {
            tma_load(sb, &map_b, full, k0, n0);
          }
        }
      }
    }
    __syncwarp();
    if (split > 1) {   // the partial tiles' exchange
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // the consumers: warpgroup wg holds rows [64 wg, 64 wg + 64) of a tile
  const int wg = warp >> 2, tw = tid & 127;
  const int wrow = 16 * (tw >> 5) + ((tw & 31) >> 2);   // of wg's 64
  const int lrow = 64 * wg + wrow;
  const int lcol = 2 * (tw & 3);
  float acc[BN / 2];
  int g = 0;
  // one tile a block when K is split (grid x = the tiles), else a
  // persistent walk over the tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int t = 0; t < steps; ++t, ++g) {
      const int s = g % C::STAGES;
      mbar_wait(full0 + 8 * s, (g / C::STAGES) & 1);
      __syncwarp();
      // a: K-major rows of 128 bytes (wg's 64 rows start 8 KB in), or
      // M-major box wg; w: K-major BN rows, or BN / 64 N-major boxes
      const uint32_t sa = base + s * C::STAGE + wg * BOX_BYTES;
      const uint32_t sb = base + s * C::STAGE + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = TA ? desc128(sa + kk * 2048, BOX_BYTES, 1024)
                               : desc128(sa + kk * 32, 16, 1024);
        const uint64_t db = TB ? desc128(sb + kk * 2048, BOX_BYTES, 1024)
                               : desc128(sb + kk * 32, 16, 1024);
        wgmma_bn<BN, TA, TB>(acc, da, db);
      }
      wgmma_commit();
      // the stage before is read: hand it back to the producer
      wgmma_wait<1>();
      if (t > 0 && tw == 0)
        mbar_arrive(empty0 + 8 * ((g - 1) % C::STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // the tile's last stage is read too: the producer may refill it
    if (steps > 0 && tw == 0) mbar_arrive(empty0 + 8 * ((g - 1) % C::STAGES));
    if (split > 1) {
      // both warpgroups' products have read the ring before it holds the
      // partial tile (named barrier 1: the consumers only)
      asm volatile("bar.sync 1, %0;\n" :: "n"(128 * CONSUMERS) : "memory");
      float* P = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(P + lrow * C::LD + lcol + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(P + (lrow + 8) * C::LD + lcol + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      reduce_any<BM, BN, C::LD>(cluster, P, split, rank, tid,
                                128 * CONSUMERS, bias, out, M, N, m0, n0,
                                act);
      // no block leaves while another may still read its shared memory
      cluster.sync();
      return;
    }
    const uint32_t stage = staged + wg * 64 * BN * 2;
    const int row0 = m0 + 64 * wg;
    switch (act) {
      case TANH:
        store_rows<TANH, BN>(acc, stage, &map_out, tma_out, bias, out, M, N,
                             row0, n0, wg, tw, wrow, lcol);
        break;
      case SIGMOID:
        store_rows<SIGMOID, BN>(acc, stage, &map_out, tma_out, bias, out, M,
                                N, row0, n0, wg, tw, wrow, lcol);
        break;
      case RELU:
        store_rows<RELU, BN>(acc, stage, &map_out, tma_out, bias, out, M, N,
                             row0, n0, wg, tw, wrow, lcol);
        break;
      case STRICT_RELU:
        store_rows<STRICT_RELU, BN>(acc, stage, &map_out, tma_out, bias, out,
                                    M, N, row0, n0, wg, tw, wrow, lcol);
        break;
      default:
        store_rows<LINEAR, BN>(acc, stage, &map_out, tma_out, bias, out, M,
                               N, row0, n0, wg, tw, wrow, lcol);
    }
  }
  // the block's last stores are written before its shared memory goes
  if (tma_out && tw == 0) bulk_wait();
}

// -- body S: cp.async + ldmatrix + mma.sync ----------------------------------

namespace ldsm {

constexpr int BM = 64, BN = 64, THREADS = 128, STAGES = 3;
constexpr int TILE = 64 * BK;            // bf16 of one operand's stage
constexpr int LD = BN + 4;               // the f32 partial tile's pitch

}  // namespace ldsm

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// One operand's stage: a (64 lines x 64 positions) bf16 tile at `tile`,
// 16-byte chunks XOR-swizzled by line (swz<64>); element (l, q) is
// p[(l0 + l) s_line + (q0 + q) s_pos], zero where l0 + l >= n_line or
// q0 + q >= n_pos.  `chunk` elements a copy along the positions (s_pos ==
// 1, the base and s_line aligned to it): cp.async of 16, 8 or 4 bytes,
// zero-filled past the edge; chunk 1: element loads through both strides.
__device__ __forceinline__ void stage_tile(uint32_t tile,
                                           const bf16* __restrict__ p,
                                           long long s_line, long long s_pos,
                                           int l0, int n_line, int q0,
                                           int n_pos, int chunk, int tid) {
  if (chunk == 1) {
    const unsigned short* __restrict__ e16 =
        reinterpret_cast<const unsigned short*>(p);
#pragma unroll 4
    for (int e = tid; e < 64 * 64; e += ldsm::THREADS) {
      const int l = e >> 6, q = e & 63;
      const int gl = l0 + l, gq = q0 + q;
      unsigned short v = 0;
      if (gl < n_line && gq < n_pos)
        v = __ldg(e16 + (long long)gl * s_line + (long long)gq * s_pos);
      asm volatile("st.shared.u16 [%0], %1;\n"
                   :: "r"(tile + swz<64>(l, q >> 3) * 16 + (q & 7) * 2),
                      "h"(v)
                   : "memory");
    }
    return;
  }
  // chunk is 2, 4 or 8: shifts, not divisions, place a chunk
  const int shift = chunk == 8 ? 3 : chunk == 4 ? 2 : 1;
  const int line_shift = 6 - shift;         // chunks a line: 64 / chunk
  for (int c = tid; c < 64 << line_shift; c += ldsm::THREADS) {
    const int l = c >> line_shift;
    const int q = (c & ((1 << line_shift) - 1)) << shift;
    const int gl = l0 + l, gq = q0 + q;
    const int valid = gl < n_line ? min(max(n_pos - gq, 0), chunk) : 0;
    const bf16* src = valid > 0 ? p + (long long)gl * s_line + gq : p;
    const uint32_t dst = tile + swz<64>(l, q >> 3) * 16 + (q & 7) * 2;
    if (chunk == 8) {
      cp_async16(dst, src, valid * 2);
    } else if (chunk == 4) {
      cp_async8(dst, src, valid * 2);
    } else {
      cp_async4(dst, src, valid * 2);
    }
  }
}

// A_K: a's tile is staged (m, k), read by ldmatrix, else (k, m), read by
// ldmatrix.trans; B_K: w's is staged (n, k), read by ldmatrix, else (k, n),
// read by ldmatrix.trans.  a_chunk, b_chunk: stage_tile's chunks.  The grid
// is (N tiles, M tiles, split), launched as clusters of (1, 1, split).
template <bool A_K, bool B_K>
__global__ void __launch_bounds__(ldsm::THREADS)
veles_gemm_bf16_ldsm(const bf16* __restrict__ a, const long long sam,
                     const long long sak, const bf16* __restrict__ w,
                     const long long swk, const long long swn,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     const int M, const int N, const int K, const int act,
                     const int a_chunk, const int b_chunk) {
  using namespace ldsm;
  __shared__ __align__(128) bf16 sm[STAGES][2][TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = gridDim.z, rank = blockIdx.z;
  const int k_tiles = (K + BK - 1) / BK;
  const int t0 = rank * k_tiles / split;
  const int steps = (rank + 1) * k_tiles / split - t0;

  auto load = [&](int stage, int t) {
    const int k0 = (t0 + t) * BK;
    const uint32_t ta = smem_addr(sm[stage][0]), tb = smem_addr(sm[stage][1]);
    if (A_K) {
      stage_tile(ta, a, sam, sak, m0, M, k0, K, a_chunk, tid);
    } else {
      stage_tile(ta, a, sak, sam, k0, K, m0, M, a_chunk, tid);
    }
    if (B_K) {
      stage_tile(tb, w, swn, swk, n0, N, k0, K, b_chunk, tid);
    } else {
      stage_tile(tb, w, swk, swn, k0, K, n0, N, b_chunk, tid);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  const int j8 = lane >> 3, i8 = lane & 7;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage read at t - 1 is free: step t + STAGES - 1's loads into it
    if (t + STAGES - 1 < steps) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    cp_async_commit();
    const int s = t % STAGES;
    const uint32_t ta = smem_addr(sm[s][0]), tb = smem_addr(sm[s][1]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mr = wm + 16 * i;
        if (A_K) {
          ldsm_x4(af[i], ta + swz<64>(mr + i8 + (j8 & 1) * 8,
                                      2 * kk + (j8 >> 1)) * 16);
        } else {
          ldsm_x4_trans(af[i], ta + swz<64>(16 * kk + i8 + (j8 >> 1) * 8,
                                            mr / 8 + (j8 & 1)) * 16);
        }
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int nc = wn + 16 * jp;
        uint32_t r[4];
        if (B_K) {
          ldsm_x4(r, tb + swz<64>(nc + i8 + (j8 >> 1) * 8,
                                  2 * kk + (j8 & 1)) * 16);
        } else {
          ldsm_x4_trans(r, tb + swz<64>(16 * kk + i8 + (j8 & 1) * 8,
                                        nc / 8 + (j8 >> 1)) * 16);
        }
        bfr[2 * jp][0] = r[0];
        bfr[2 * jp][1] = r[1];
        bfr[2 * jp + 1][0] = r[2];
        bfr[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, tg = lane & 3;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = m0 + wm + 16 * i + g;
        const int col = n0 + wn + 8 * j + 2 * tg;
        switch (act) {
          case TANH:
            put2<TANH>(out, bias, M, N, row, col, acc[i][j][0], acc[i][j][1]);
            put2<TANH>(out, bias, M, N, row + 8, col, acc[i][j][2],
                       acc[i][j][3]);
            break;
          case SIGMOID:
            put2<SIGMOID>(out, bias, M, N, row, col, acc[i][j][0],
                          acc[i][j][1]);
            put2<SIGMOID>(out, bias, M, N, row + 8, col, acc[i][j][2],
                          acc[i][j][3]);
            break;
          case RELU:
            put2<RELU>(out, bias, M, N, row, col, acc[i][j][0], acc[i][j][1]);
            put2<RELU>(out, bias, M, N, row + 8, col, acc[i][j][2],
                       acc[i][j][3]);
            break;
          case STRICT_RELU:
            put2<STRICT_RELU>(out, bias, M, N, row, col, acc[i][j][0],
                              acc[i][j][1]);
            put2<STRICT_RELU>(out, bias, M, N, row + 8, col, acc[i][j][2],
                              acc[i][j][3]);
            break;
          default:
            put2<LINEAR>(out, bias, M, N, row, col, acc[i][j][0],
                         acc[i][j][1]);
            put2<LINEAR>(out, bias, M, N, row + 8, col, acc[i][j][2],
                         acc[i][j][3]);
        }
      }
    return;
  }
  // the ring is read (the barrier above): it holds the partial tile
  float* P = reinterpret_cast<float*>(&sm[0][0][0]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + 16 * i + g, c = wn + 8 * j + 2 * tg;
      *reinterpret_cast<float2*>(P + r * LD + c) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(P + (r + 8) * LD + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  reduce_any<BM, BN, LD>(cluster, P, split, rank, tid, THREADS, bias, out, M,
                         N, m0, n0, act);
  cluster.sync();
}

// -- the launches ------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// How TMA reads a 2-D operand with strides (s0, s1) in elements: 1 along
// index 1 (s1 == 1), 0 along index 0 (s0 == 1), the other stride a
// positive multiple of 16 bytes and the base 16-byte aligned; -1 where it
// cannot (ops/gemm.py `tma_major` is the same rule).
int tma_major(const void* p, long long s0, long long s1) {
  if (!aligned16(p)) return -1;
  if (s1 == 1 && s0 > 0 && s0 % 8 == 0) return 1;
  if (s0 == 1 && s1 > 0 && s1 % 8 == 0) return 0;
  return -1;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map: `inner` elements of unit stride, `outer` rows
// `stride` elements apart, boxes of (64 inner, box_outer), 128-byte
// swizzle, zeros past the edges.
int encode(CUtensorMap* map, const void* p, long long inner, long long outer,
           long long stride, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 2};
  const cuuint32_t box[2] = {(cuuint32_t)tma::BOX, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the card's SMs (the first call's device)
int sm_count() {
  static const int sms = [] {
    int device = 0, count = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return 132;
    return count;
  }();
  return sms;
}

cudaLaunchAttribute cluster_of(int split) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = split;
  return attr;
}

template <int BN, int TA, int TB>
int launch_tma(const CUtensorMap& ma, const CUtensorMap& mb,
               const CUtensorMap& mo, int tma_out, const void* bias,
               void* out, int m, int n, int k, int act, int split,
               cudaStream_t stream) {
  using C = tma::Cfg<BN>;
  auto kernel = veles_gemm_bf16_tma<BN, TA, TB>;
  static const cudaError_t sized = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (sized != cudaSuccess) return (int)sized;
  const int tiles = (n + BN - 1) / BN * ((m + tma::BM - 1) / tma::BM);
  cudaLaunchConfig_t config = {};
  // split: a block a tile; else one block an SM walks the tiles
  config.gridDim = dim3(split > 1 ? tiles : std::min(tiles, sm_count()), 1,
                        split);
  config.blockDim = dim3(tma::THREADS);
  config.dynamicSmemBytes = C::SMEM;
  config.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_of(split)};
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, ma, mb, mo, tma_out, static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), m, n, k, act);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int BN>
int launch_tma_major(const CUtensorMap& ma, const CUtensorMap& mb,
                     const CUtensorMap& mo, int tma_out, int ta, int tb,
                     const void* bias, void* out, int m, int n, int k,
                     int act, int split, cudaStream_t s) {
  if (ta && tb)
    return launch_tma<BN, 1, 1>(ma, mb, mo, tma_out, bias, out, m, n, k, act,
                                split, s);
  if (ta)
    return launch_tma<BN, 1, 0>(ma, mb, mo, tma_out, bias, out, m, n, k, act,
                                split, s);
  if (tb)
    return launch_tma<BN, 0, 1>(ma, mb, mo, tma_out, bias, out, m, n, k, act,
                                split, s);
  return launch_tma<BN, 0, 0>(ma, mb, mo, tma_out, bias, out, m, n, k, act,
                              split, s);
}

int body_w(const void* a, const void* w, const void* bias, void* out, int m,
           int n, int k, long long sam, long long sak, long long swk,
           long long swn, int act, int tile, int split, cudaStream_t s) {
  const int a_major = tma_major(a, sam, sak);   // 1: K-major
  const int w_major = tma_major(w, swk, swn);   // 1: N-major
  if (a_major < 0 || w_major < 0 || (tile != 128 && tile != 256))
    return (int)cudaErrorInvalidValue;
  const int ta = a_major == 0, tb = w_major == 1;
  const long long kk = k > 0 ? k : 1;
  CUtensorMap ma, mb, mo;
  int e = ta ? encode(&ma, a, m, kk, sak, BK)
             : encode(&ma, a, kk, m, sam, tma::BM);
  if (e == 0)
    e = tb ? encode(&mb, w, n, kk, swk, BK) : encode(&mb, w, kk, n, swn, tile);
  // the (m, n) output through TMA where its pitch allows (else the
  // epilogue copies the staged rows out itself; mo is then unused)
  const int tma_out = tma_major(out, n, 1) == 1;
  mo = ma;
  if (e == 0 && tma_out) e = encode(&mo, out, n, m, n, 64);
  if (e != 0) return e;
  return tile == 128
             ? launch_tma_major<128>(ma, mb, mo, tma_out, ta, tb, bias, out, m,
                                     n, k, act, split, s)
             : launch_tma_major<256>(ma, mb, mo, tma_out, ta, tb, bias, out, m,
                                     n, k, act, split, s);
}

// the widest copy (elements) stage_tile may take: the unit stride along
// the positions, the base and the line stride aligned to it
int chunk_of(const void* p, long long s_line, long long s_pos) {
  if (s_pos != 1) return 1;
  for (int c = 8; c >= 2; c /= 2)
    if (reinterpret_cast<uintptr_t>(p) % (2 * c) == 0 && s_line % c == 0)
      return c;
  return 1;
}

template <bool A_K, bool B_K>
int launch_ldsm(const void* a, long long sam, long long sak, const void* w,
                long long swk, long long swn, const void* bias, void* out,
                int m, int n, int k, int act, int split, cudaStream_t stream) {
  const int a_chunk = A_K ? chunk_of(a, sam, sak) : chunk_of(a, sak, sam);
  const int b_chunk = B_K ? chunk_of(w, swn, swk) : chunk_of(w, swk, swn);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + ldsm::BN - 1) / ldsm::BN,
                        (m + ldsm::BM - 1) / ldsm::BM, split);
  config.blockDim = dim3(ldsm::THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_of(split)};
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, veles_gemm_bf16_ldsm<A_K, B_K>, static_cast<const bf16*>(a),
      sam, sak, static_cast<const bf16*>(w), swk, swn,
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), m, n, k, act,
      a_chunk, b_chunk);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

long long magnitude(long long x) { return x < 0 ? -x : x; }

int body_s(const void* a, const void* w, const void* bias, void* out, int m,
           int n, int k, long long sam, long long sak, long long swk,
           long long swn, int act, int tile, int split, cudaStream_t s) {
  if (tile != ldsm::BM) return (int)cudaErrorInvalidValue;
  // stage along whichever index has the unit (else the smaller) stride
  const bool a_k = sak == 1 || (sam != 1 && magnitude(sak) <= magnitude(sam));
  const bool b_k = swk == 1 || (swn != 1 && magnitude(swk) <= magnitude(swn));
  if (a_k && b_k)
    return launch_ldsm<true, true>(a, sam, sak, w, swk, swn, bias, out, m, n,
                                   k, act, split, s);
  if (a_k)
    return launch_ldsm<true, false>(a, sam, sak, w, swk, swn, bias, out, m, n,
                                    k, act, split, s);
  if (b_k)
    return launch_ldsm<false, true>(a, sam, sak, w, swk, swn, bias, out, m, n,
                                    k, act, split, s);
  return launch_ldsm<false, false>(a, sam, sak, w, swk, swn, bias, out, m, n,
                                   k, act, split, s);
}

}  // namespace

// out (m, n) bf16 = act(a @ w + bias); a (m, k) and w (k, n) bf16 through
// strides; bias (n,) bf16 or null; f32 sums and epilogue.  body, tile and
// split as ops/gemm.py `plan_bf16` gives them: body 1 (W, TMA + wgmma,
// tile 128 or 256 columns) or 0 (S, ldmatrix + mma.sync, tile 64); split
// the cluster size, a power of two up to 8.
extern "C" int veles_matmul_bf16(const void* a, const void* w,
                                 const void* bias, void* out, int m, int n,
                                 int k, long long sam, long long sak,
                                 long long swk, long long swn, int act,
                                 int body, int tile, int split,
                                 void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k < 0 || split < 1 || split > MAX_SPLIT || (split & (split - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (body == BODY_W)
    return body_w(a, w, bias, out, m, n, k, sam, sak, swk, swn, act, tile,
                  split, s);
  if (body == BODY_S)
    return body_s(a, w, bias, out, m, n, k, sam, sak, swk, swn, act, tile,
                  split, s);
  return (int)cudaErrorInvalidValue;
}
