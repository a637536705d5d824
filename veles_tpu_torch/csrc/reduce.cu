// Matrix reduction for Hopper (sm_90a), written by hand: the sum, max or
// min of an (m, n) matrix along axis 0 (result (n,)) or axis 1 (result
// (m,)), in f32, the result cast to the input dtype (f32 or bf16).
//
// Replaces the TPU kernel `_reduce_kernel` of veles_tpu/ops/reduce.py (via
// `_reduce_pallas`).  On the TPU the grid runs in order and carries the
// running sum from block to block in a scratch row; here blocks run in
// parallel and in no order, so no block carries anything to another: each
// output is reduced by ONE block.
// - axis 1: one warp a row (8 rows a block); each lane folds its columns
//   (lane, lane + 32, ...) in order, four loads in flight, then a fixed
//   butterfly of warp shuffles combines the lanes.
// - axis 0: one block a strip of 32 columns; 16 row groups of 32 lanes
//   each fold their rows (g, g + 16, ...) in order, four loads in flight,
//   and the 16 partials are combined in shared memory in group order.
// No atomics and a fixed order: a launch gives the same bits every time.
// max and min propagate NaN, as jnp.max / jnp.min and torch.amax / amin
// do (fmaxf and fminf would drop it); their identities are -inf and +inf,
// the sum's 0, as the Pallas kernel pads with them.
//
// What bounds it on the H100: the bytes.  Every input element is read
// once and each output written once, one add or compare an element:
// (4096, 4096) f32 is 64 MiB, >= 20 us at 3.35 TB/s, against 16.8 M
// operations that the CUDA cores do in a quarter of a microsecond.  The
// loads are coalesced along rows (axis 1: a warp reads 128 contiguous
// bytes; axis 0: 32 lanes read one row of a column strip), and each lane
// keeps four loads in flight to cover the memory latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Op { SUM = 0, MAX = 1, MIN = 2 };

template <int OP>
__device__ __forceinline__ float identity() {
  return OP == SUM ? 0.0f : (OP == MAX ? -INFINITY : INFINITY);
}

// acc (op) x, with NaN winning either way round for max and min
template <int OP>
__device__ __forceinline__ float fold(float acc, float x) {
  if (OP == SUM) return acc + x;
  if (OP == MAX) return (x > acc || x != x) ? x : acc;
  return (x < acc || x != x) ? x : acc;
}

template <bool BF16>
__device__ __forceinline__ float load(const void* a, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i]);
  return static_cast<const float*>(a)[i];
}

template <bool BF16>
__device__ __forceinline__ void store(void* out, size_t i, float v) {
  if (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

constexpr int ROW_WARPS = 8;     // axis 1: rows a block
constexpr int COLS = 32;         // axis 0: columns a block
constexpr int GROUPS = 16;       // axis 0: row groups a block

template <int OP, bool BF16>
__global__ void __launch_bounds__(ROW_WARPS * 32)
reduce_rows_kernel(const void* __restrict__ a, void* __restrict__ out, int m,
                   int n, int lda) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (row >= m) return;
  const size_t base = static_cast<size_t>(row) * lda;
  float acc = identity<OP>();
  int j = lane;
  for (; j + 96 < n; j += 128) {
    const float v0 = load<BF16>(a, base + j);
    const float v1 = load<BF16>(a, base + j + 32);
    const float v2 = load<BF16>(a, base + j + 64);
    const float v3 = load<BF16>(a, base + j + 96);
    acc = fold<OP>(fold<OP>(fold<OP>(fold<OP>(acc, v0), v1), v2), v3);
  }
  for (; j < n; j += 32) acc = fold<OP>(acc, load<BF16>(a, base + j));
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2)
    acc = fold<OP>(acc, __shfl_xor_sync(0xffffffffu, acc, offset));
  if (lane == 0) store<BF16>(out, row, acc);
}

template <int OP, bool BF16>
__global__ void __launch_bounds__(COLS * GROUPS)
reduce_cols_kernel(const void* __restrict__ a, void* __restrict__ out, int m,
                   int n, int lda) {
  __shared__ float part[GROUPS][COLS + 1];
  const int cx = threadIdx.x % COLS, g = threadIdx.x / COLS;
  const int col = blockIdx.x * COLS + cx;
  float acc = identity<OP>();
  if (col < n) {
    int i = g;
    for (; i + 3 * GROUPS < m; i += 4 * GROUPS) {
      const float v0 = load<BF16>(a, static_cast<size_t>(i) * lda + col);
      const float v1 =
          load<BF16>(a, static_cast<size_t>(i + GROUPS) * lda + col);
      const float v2 =
          load<BF16>(a, static_cast<size_t>(i + 2 * GROUPS) * lda + col);
      const float v3 =
          load<BF16>(a, static_cast<size_t>(i + 3 * GROUPS) * lda + col);
      acc = fold<OP>(fold<OP>(fold<OP>(fold<OP>(acc, v0), v1), v2), v3);
    }
    for (; i < m; i += GROUPS)
      acc = fold<OP>(acc, load<BF16>(a, static_cast<size_t>(i) * lda + col));
  }
  part[g][cx] = acc;
  __syncthreads();
  if (g == 0 && col < n) {
    float total = part[0][cx];
    for (int r = 1; r < GROUPS; ++r) total = fold<OP>(total, part[r][cx]);
    store<BF16>(out, col, total);
  }
}

template <int OP, bool BF16>
cudaError_t launch(const void* a, void* out, int m, int n, int lda, int axis,
                   cudaStream_t stream) {
  if (axis == 1) {
    const int blocks = (m + ROW_WARPS - 1) / ROW_WARPS;
    reduce_rows_kernel<OP, BF16><<<blocks, ROW_WARPS * 32, 0, stream>>>(
        a, out, m, n, lda);
  } else {
    const int blocks = (n + COLS - 1) / COLS;
    reduce_cols_kernel<OP, BF16><<<blocks, COLS * GROUPS, 0, stream>>>(
        a, out, m, n, lda);
  }
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_op(const void* a, void* out, int m, int n, int lda,
                      int axis, int op, cudaStream_t stream) {
  switch (op) {
    case SUM: return launch<SUM, BF16>(a, out, m, n, lda, axis, stream);
    case MAX: return launch<MAX, BF16>(a, out, m, n, lda, axis, stream);
    case MIN: return launch<MIN, BF16>(a, out, m, n, lda, axis, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out = reduce(a, axis) with op 0 sum, 1 max, 2 min; a (m, n) with row
// stride lda and unit column stride, f32 or bf16 (bf16); out (n,) for
// axis 0 and (m,) for axis 1, in a's dtype.  m, n >= 1.  Launches on
// `stream`, does not synchronise; returns the launch's CUDA error.
extern "C" int veles_reduce(const void* a, void* out, int m, int n, int lda,
                            int axis, int op, int bf16, void* stream) {
  if (m < 1 || n < 1 || (axis != 0 && axis != 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_op<true>(a, out, m, n, lda, axis, op, s)
           : launch_op<false>(a, out, m, n, lda, axis, op, s);
  return static_cast<int>(err);
}
