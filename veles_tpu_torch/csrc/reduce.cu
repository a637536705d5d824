// Matrix reduction for Hopper (sm_90a), written by hand: the sum, max or
// min of an (m, n) matrix along axis 0 (result (n,)) or axis 1 (result
// (m,)), in f32, the result cast to the input dtype (f32 or bf16).
//
// Replaces the TPU kernel `_reduce_kernel` of veles_tpu/ops/reduce.py (via
// `_reduce_pallas`).  On the TPU the grid runs in order and carries the
// running result from block to block in a scratch row; here blocks run in
// parallel and in no order, so nothing is carried between blocks: axis 1
// reduces each row inside one block, and axis 0 splits a column strip's
// rows over a thread block cluster whose ranks merge over distributed
// shared memory.
//
// What bounds it on the H100: the bytes.  Every input element is read
// once and each output written once, one add or compare an element:
// (4096, 4096) f32 is 64 MiB, >= 20 us at 3.35 TB/s, against 16.8 M
// operations that the CUDA cores do in a quarter of a microsecond.  To
// reach the memory's rate the card needs some 25 KB of loads in flight on
// every SM (3.35 TB/s times about 1 us of latency, over 132 SMs), on
// every SM at once.
//
// Design (ops/reduce.py `plan` picks the vector width and the split):
// * 16-byte loads (`ld.global.cs`, read once): 4 f32 or 8 bf16 values a
//   lane, where every row starts 16-byte aligned (the pointer and the row
//   stride); otherwise the same code with one value a load.  A vector
//   that crosses the row's end is loaded value by value, masked.
// * Several independent loads a lane are issued before any of them is
//   folded: 8 along axis 1 (128 bytes a lane), 4 along axis 0.  A timed
//   probe on the card (scripts/ops_probe.py) found axis 0 slower with 8
//   at its 256 blocks: some 32 KB of loads in flight an SM did best for
//   its column strips, while axis 1's contiguous rows took more.
// * Each lane keeps one accumulator a value of its vector (4 or 8
//   independent chains).  max and min fold with fmaxf / fminf (one
//   instruction, NaN dropped) and keep a NaN flag a value on the side
//   (`nan |= x != x`); the flag turns the lane's result into NaN before
//   anything is merged, and every merge after that lets NaN win.  So the
//   result is NaN wherever an input was, as jnp.max / torch.amax give.
//   Identities: 0 for the sum, -inf for max, +inf for min.
// * axis 1: a block of 8 warps takes 8 / W rows, W warps a row (W from
//   the plan: 1 at (4096, 4096), more for few long rows).  The row's 32W
//   lanes take its vectors round robin (lane g: vectors g, g + 32W, ...),
//   a lane's values are folded in order, a fixed butterfly of shuffles
//   folds a warp's lanes and the W warps are folded in warp order.
// * axis 0: a block of 8 warps owns a strip of 32 vectors of columns
//   (128 f32, 256 bf16 or 32 scalar columns) and one rank's rows of it:
//   the rows are cut into `split` contiguous chunks (1..8 from the plan,
//   8 at (4096, 4096): 256 blocks for 132 SMs), one for each block of a
//   cluster.  Warp w folds the chunk's rows w, w + 8, ... in order, the
//   8 warps are folded in warp order in shared memory, and each rank
//   pushes its strip partial into the shared memory of the rank that owns
//   each column (rank x owns the x-th of `split` equal slices of the
//   strip).  After one cluster barrier each rank folds its slice in rank
//   order and writes it.  No atomics and no second launch: a relaunch
//   gives the same bits.  ops/reduce.py `_reduce_plan_ref` models this
//   order of the sum on the CPU.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

// a test build may plant a fault (1: the last rank's partial dropped from
// axis 0's merge; 2: the NaN flag ignored), which the card checks must
// report; 0 in every other build
#ifndef VELES_PLANTED_FAULT
#define VELES_PLANTED_FAULT 0
#endif
// independent loads a lane keeps in flight, along axis 0 and axis 1
// (scripts/ops_probe.py builds other values; see the design notes)
#ifndef VELES_REDUCE_AXIS0_LOADS
#define VELES_REDUCE_AXIS0_LOADS 4
#endif
#ifndef VELES_REDUCE_AXIS1_LOADS
#define VELES_REDUCE_AXIS1_LOADS 8
#endif

namespace {

enum Op { SUM = 0, MAX = 1, MIN = 2 };

constexpr int WARPS = 8;             // a block
constexpr int THREADS = WARPS * 32;
constexpr int AXIS0_LOADS = VELES_REDUCE_AXIS0_LOADS;
constexpr int AXIS1_LOADS = VELES_REDUCE_AXIS1_LOADS;
constexpr int MAX_SPLIT = 8;         // the portable cluster size

template <int OP>
__device__ __forceinline__ float identity() {
  return OP == SUM ? 0.0f : (OP == MAX ? -INFINITY : INFINITY);
}

// the lanes' fold: fmaxf / fminf drop a NaN, which the flag keeps
template <int OP>
__device__ __forceinline__ float fold(float acc, float x) {
  if (OP == SUM) return acc + x;
  if (OP == MAX) return fmaxf(acc, x);
  return fminf(acc, x);
}

// the merges' fold: NaN wins either way round
template <int OP>
__device__ __forceinline__ float merge(float acc, float x) {
  if (OP == SUM) return acc + x;
  if (OP == MAX) return (x > acc || x != x) ? x : acc;
  return (x < acc || x != x) ? x : acc;
}

// values a load: one 16-byte vector, or one value
template <bool BF16, bool VECTOR>
struct Load {
  static constexpr int V = VECTOR ? (BF16 ? 8 : 4) : 1;
  static constexpr int ESIZE = BF16 ? 2 : 4;
  typedef typename std::conditional<
      VECTOR, uint4,
      typename std::conditional<BF16, unsigned short, float>::type>::type
      Raw;

  static __device__ __forceinline__ Raw load(const char* p) {
    if constexpr (VECTOR) {
      return __ldcs(reinterpret_cast<const uint4*>(p));
    } else if constexpr (BF16) {
      return __bfloat16_as_ushort(
          __ldcs(reinterpret_cast<const __nv_bfloat16*>(p)));
    } else {
      return __ldcs(reinterpret_cast<const float*>(p));
    }
  }

  // the vector at p value by value: the first `valid`, identity after
  template <int OP>
  static __device__ __forceinline__ void load_masked(const char* p,
                                                     int valid,
                                                     float (&x)[V]) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if (c >= valid) {
        x[c] = identity<OP>();
      } else if (BF16) {
        x[c] = __bfloat162float(
            __ldcs(reinterpret_cast<const __nv_bfloat16*>(p) + c));
      } else {
        x[c] = __ldcs(reinterpret_cast<const float*>(p) + c);
      }
    }
  }

  static __device__ __forceinline__ void unpack(const Raw& r, float (&x)[V]) {
    if constexpr (VECTOR && BF16) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 f = __bfloat1622float2(h[c]);
        x[2 * c] = f.x;
        x[2 * c + 1] = f.y;
      }
    } else if constexpr (VECTOR) {
      const float4 f = *reinterpret_cast<const float4*>(&r);
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    } else if constexpr (BF16) {
      x[0] = __bfloat162float(__ushort_as_bfloat16(r));
    } else {
      x[0] = r;
    }
  }
};

// a lane's N accumulators, one a value of its vector, and their NaN
// flags (bit c for value c)
template <int OP, int N>
struct Lane {
  float acc[N];
  unsigned nan;

  __device__ __forceinline__ Lane() : nan(0u) {
#pragma unroll
    for (int c = 0; c < N; ++c) acc[c] = identity<OP>();
  }

  __device__ __forceinline__ void add(const float (&x)[N]) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      acc[c] = fold<OP>(acc[c], x[c]);
      if (OP != SUM) nan |= static_cast<unsigned>(x[c] != x[c]) << c;
    }
  }

  // NaN where a flag is set (the planted fault 2 forgets to)
  __device__ __forceinline__ void settle() {
    if (OP == SUM || VELES_PLANTED_FAULT == 2) return;
#pragma unroll
    for (int c = 0; c < N; ++c)
      if ((nan >> c) & 1u) acc[c] = NAN;
  }
};

// COUNT loads at p, p + stride, ... (bytes), all issued before the
// first is folded, so each accumulator takes its loads in order
template <int OP, bool BF16, bool VECTOR, int COUNT, int N>
__device__ __forceinline__ void fold_loads(Lane<OP, N>& lane, const char* p,
                                           long long stride) {
  typedef Load<BF16, VECTOR> LD;
  typename LD::Raw raw[COUNT];
#pragma unroll
  for (int u = 0; u < COUNT; ++u) raw[u] = LD::load(p + u * stride);
#pragma unroll
  for (int u = 0; u < COUNT; ++u) {
    float x[LD::V];
    LD::unpack(raw[u], x);
    lane.add(x);
  }
}

template <bool BF16>
__device__ __forceinline__ void store(void* out, long long i, float v) {
  if (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(out)[i] = v;
}

// axis 1: rows (8 / wpr a block) of wpr warps each
template <int OP, bool BF16, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 4)
reduce_axis1_kernel(const void* __restrict__ a, void* __restrict__ out,
                    int m, int n, int lda, int wpr) {
  typedef Load<BF16, VECTOR> LD;
  constexpr int V = LD::V;
  __shared__ float w_total[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (WARPS / wpr) + warp / wpr;
  const int part = warp % wpr;
  const int lanes = 32 * wpr;
  float total = identity<OP>();
  if (row < m) {
    const char* base = static_cast<const char*>(a) +
                       static_cast<long long>(row) * lda * LD::ESIZE;
    const long long vbytes = V * LD::ESIZE;
    const int whole = n / V;              // vectors wholly inside the row
    const int all = (n + V - 1) / V;
    Lane<OP, V> acc;
    int v = part * 32 + lane;
    for (; v + (AXIS1_LOADS - 1) * lanes < whole; v += AXIS1_LOADS * lanes)
      fold_loads<OP, BF16, VECTOR, AXIS1_LOADS>(acc, base + v * vbytes,
                                                lanes * vbytes);
    for (; v < whole; v += lanes)
      fold_loads<OP, BF16, VECTOR, 1>(acc, base + v * vbytes, 0);
    if (v < all) {                        // the row's last, partial vector
      float x[V];
      LD::template load_masked<OP>(base + v * vbytes, n - v * V, x);
      acc.add(x);
    }
    acc.settle();
    total = acc.acc[0];
#pragma unroll
    for (int c = 1; c < V; ++c) total = merge<OP>(total, acc.acc[c]);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2)
    total = merge<OP>(total, __shfl_xor_sync(0xffffffffu, total, offset));
  if (lane == 0) w_total[warp] = total;
  __syncthreads();
  if (part == 0 && lane == 0 && row < m) {
    for (int w = 1; w < wpr; ++w) total = merge<OP>(total, w_total[warp + w]);
    store<BF16>(out, row, total);
  }
}

// A cluster barrier in two halves: every block arrives at its start and
// waits before its first push into a peer's shared memory, so the peer is
// known to be running by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// axis 0: blockIdx.x = strip * split + rank, one cluster of `split` a
// strip of 32 vectors of columns
template <int OP, bool BF16, bool VECTOR>
__global__ void __launch_bounds__(THREADS, 4)
reduce_axis0_kernel(const void* __restrict__ a, void* __restrict__ out,
                    int m, int n, int lda) {
  typedef Load<BF16, VECTOR> LD;
  constexpr int V = LD::V;
  constexpr int STRIP = 32 * V;           // columns a strip
  __shared__ float w_part[WARPS][STRIP];
  __shared__ float r_part[STRIP];         // [split][STRIP / split]

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long strip0 = static_cast<long long>(blockIdx.x / split) * STRIP;
  const long long col = strip0 + lane * V;       // this lane's first column
  // this rank's rows [r0, r1): the rank-th of `split` contiguous chunks
  const int chunk = (m + split - 1) / split;
  const int r0 = min(m, rank * chunk), r1 = min(m, r0 + chunk);

  Lane<OP, V> acc;
  if (col < n) {
    const long long rbytes = static_cast<long long>(lda) * LD::ESIZE;
    const char* p = static_cast<const char*>(a) + col * LD::ESIZE;
    int r = r0 + warp;
    if (col + V <= n) {
      for (; r + (AXIS0_LOADS - 1) * WARPS < r1; r += AXIS0_LOADS * WARPS)
        fold_loads<OP, BF16, VECTOR, AXIS0_LOADS>(acc, p + r * rbytes,
                                                  WARPS * rbytes);
      for (; r < r1; r += WARPS)
        fold_loads<OP, BF16, VECTOR, 1>(acc, p + r * rbytes, 0);
    } else {                              // the matrix's last, partial vector
      for (; r < r1; r += WARPS) {
        float x[V];
        LD::template load_masked<OP>(p + r * rbytes,
                                     static_cast<int>(n - col), x);
        acc.add(x);
      }
    }
  }
  acc.settle();
#pragma unroll
  for (int c = 0; c < V; ++c) w_part[warp][lane * V + c] = acc.acc[c];
  __syncthreads();

  // the block's strip partial, warps in order, pushed to each column's
  // owner: rank x owns columns [x * cap, (x + 1) * cap) of the strip
  const int cap = STRIP / split;
  cluster_wait();
  for (int t = threadIdx.x; t < STRIP; t += THREADS) {
    float p = w_part[0][t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) p = merge<OP>(p, w_part[w][t]);
    const int owner = t / cap;
    cluster.map_shared_rank(r_part, owner)[rank * cap + t - owner * cap] = p;
  }
  // every push has landed; nothing reads another block's memory after
  // this barrier, so no block waits for the others before it leaves
  cluster.sync();

  // this rank's columns: the ranks' partials in rank order
  for (int t = threadIdx.x; t < cap; t += THREADS) {
    const long long c = strip0 + rank * cap + t;
    if (c >= n) continue;
    float p = r_part[t];
    for (int x = 1; x < split; ++x) {
      if (VELES_PLANTED_FAULT == 1 && x == split - 1) continue;
      p = merge<OP>(p, r_part[x * cap + t]);
    }
    store<BF16>(out, c, p);
  }
}

template <int OP, bool BF16, bool VECTOR>
cudaError_t launch(const void* a, void* out, int m, int n, int lda, int axis,
                   int split, cudaStream_t stream) {
  if (axis == 1) {
    const int rows = WARPS / split;
    reduce_axis1_kernel<OP, BF16, VECTOR>
        <<<(m + rows - 1) / rows, THREADS, 0, stream>>>(a, out, m, n, lda,
                                                        split);
    return cudaGetLastError();
  }
  constexpr int STRIP = 32 * Load<BF16, VECTOR>::V;
  const long long blocks =
      static_cast<long long>((n + STRIP - 1) / STRIP) * split;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  config.blockDim = dim3(THREADS, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, reduce_axis0_kernel<OP, BF16, VECTOR>, a, out, m, n, lda);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool BF16, bool VECTOR>
cudaError_t launch_op(const void* a, void* out, int m, int n, int lda,
                      int axis, int op, int split, cudaStream_t stream) {
  switch (op) {
    case SUM:
      return launch<SUM, BF16, VECTOR>(a, out, m, n, lda, axis, split,
                                       stream);
    case MAX:
      return launch<MAX, BF16, VECTOR>(a, out, m, n, lda, axis, split,
                                       stream);
    case MIN:
      return launch<MIN, BF16, VECTOR>(a, out, m, n, lda, axis, split,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out = reduce(a, axis) with op 0 sum, 1 max, 2 min; a (m, n) with row
// stride lda and unit column stride, f32 or bf16 (bf16); out (n,) for
// axis 0 and (m,) for axis 1, in a's dtype.  m, n >= 1.  The plan
// (ops/reduce.py `plan`): vec, the values a load (1, or 16 bytes' worth:
// 4 f32 or 8 bf16, which needs every row 16-byte aligned); split, the
// blocks of a cluster that share a column strip's rows (axis 0) or the
// warps that share a row (axis 1), 1, 2, 4 or 8.  Launches on `stream`,
// does not synchronise; returns the launch's CUDA error.
extern "C" int veles_reduce(const void* a, void* out, int m, int n, int lda,
                            int axis, int op, int bf16, int vec, int split,
                            void* stream) {
  if (m < 1 || n < 1 || (axis != 0 && axis != 1)) return cudaErrorInvalidValue;
  if (split < 1 || split > MAX_SPLIT || (split & (split - 1)))
    return cudaErrorInvalidValue;
  const bool vector = vec != 1;
  if (vector && vec != (bf16 ? 8 : 4)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = vector ? launch_op<true, true>(a, out, m, n, lda, axis, op, split, s)
                 : launch_op<true, false>(a, out, m, n, lda, axis, op, split,
                                          s);
  else
    err = vector ? launch_op<false, true>(a, out, m, n, lda, axis, op, split,
                                          s)
                 : launch_op<false, false>(a, out, m, n, lda, axis, op,
                                           split, s);
  return static_cast<int>(err);
}
