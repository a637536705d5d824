// Row gather of up to four tables in one launch, each table moved raw or
// (one of them) fused with an affine normalize, for Hopper (sm_90a),
// written by hand; either over an index vector or over the rows a loader
// serves, computed in the launch.
//
// Replaces two TPU kernels of veles_tpu/ops/gather.py:
// - `_gather_kernel` (via `_gather_pallas`): out[i] = data[idx[i]] along
//   axis 0, a pad row where idx[i] is negative (the empty slots of a
//   short minibatch)              -> a raw table of either entry;
// - `_gather_norm_kernel` (via `_gather_norm_pallas`): out[i] =
//   f32(data[idx[i]]) * scale + shift, per feature or one scalar pair,
//   and a ZERO row (not `shift`) where idx[i] is negative
//                                 -> the normalized table of either entry.
// The Pallas kernels run one grid point per output row, with the index
// as a scalar-prefetch index map that DMAs the source row into the
// output block, one pallas_call a table.  Here one block serves one
// output row of every table of the group: each table has warps of its
// own, which stride over its row, neighbouring threads on neighbouring
// addresses, so every table's loads are in flight at once (a thread that
// walked the tables in turn would wait for one table's load before it
// issued the next's: another round trip, 0.5 us on the MNIST minibatch).
// A raw table's row moves as raw bytes (any element type) in 16-byte
// words where the row width and both base addresses allow it, else in
// 4-byte words, else bytes; its pad value arrives as an 8-byte pattern of
// its element repeated.  The normalized table's u8, int32 or f32 rows are
// read four elements at a time where the width and alignment allow it,
// converted to f32 and written as float4s; the multiply and the add are
// rounded one after the other (__fmul_rn, __fadd_rn), as the plain
// version and the JAX reference compute them, so no fused multiply-add
// changes a bit.  An index outside [0, n_rows) gives the pad (zero) row:
// no read ever leaves a table.  Both entries move a row through one
// device function (`move_rows`), given the row's source index r:
// - veles_gather_group takes r = idx[i] from an index vector the host
//   uploaded (the eager fill, `take_rows_group`);
// - veles_gather_served computes r itself, as the stitched loader head
//   serves it: r = shuffled[offset + i] where i < size and offset + i
//   lies in the shuffled-index buffer, else -1 (`take_rows_served`).
//   `offset` and `size` are read on the device, at run time, from the
//   segment's scalar block, so one captured graph serves every
//   minibatch, short tails included.  This replaces the JAX head's
//   `where`/`take` over `arange(count)` (veles_tpu/loader/fullbatch.py
//   `stitch_stage`): five small int32 ops ahead of the gather, seven
//   launches on the card (each `where` against a scalar first fills a
//   tensor with it), now one launch with the gather.
// The kernels neither synchronise nor allocate, and launch on the
// caller's stream, so a CUDA graph captures them.
//
// What bounds it on the H100: bytes, and below them the launch and its
// dependent round trips (~0.5 us each).  The MNIST minibatch gathers 100
// rows of 784 (f32 on the eager route, u8 normalized to f32 in the
// stitched head) and 100 int32 labels: at most 0.63 MB (0.40 MB in the
// head: 0.12 us at 3.35 TB/s), far below one launch's ~2.5 us floor.  So
// each route serves a minibatch's tables in one launch, one block a row.
// The group pays two dependent round trips (the index, then every
// table's row); the served launch three: the two scalars (both loads in
// flight together), then the served index (one thread loads it into
// shared memory for the block), then every table's row.  At 4096 rows of
// real MNIST's (70 000, 784) u8 table the bound is 4.8 us; a block per
// row keeps 4096 blocks in flight over 132 SMs, and each row is read and
// written once, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

// a test build may plant a fault (1: the second table's rows taken at
// index + 1; 2: a raw table's pad rows left unwritten; 3: the served
// launch serves row `size`, one past the tail, as valid), which the card
// checks must report; 0 in every other build
#ifndef VELES_PLANTED_FAULT
#define VELES_PLANTED_FAULT 0
#endif

namespace {

constexpr int MAX_THREADS = 256;   // a table's threads
constexpr int MAX_TABLES = 4;
constexpr int MAX_BLOCK = MAX_THREADS * MAX_TABLES;

// how a table's rows move: raw words of 16, 4 or 1 bytes, or normalized
// from u8, int32 or f32 four features a thread step (VEC 4) or one
enum Move {
  RAW16 = 0, RAW4 = 1, RAW1 = 2,
  NORM_U8_4 = 3, NORM_U8_1 = 4, NORM_I32_4 = 5, NORM_I32_1 = 6,
  NORM_F32_4 = 7, NORM_F32_1 = 8
};

// one table of a launch: `words` words of its move a row (features for a
// normalized table), moved by the block's threads [first, first + threads)
struct Table {
  const void* data;
  void* out;
  long long n_rows;
  long long words;
  unsigned long long pad;
  const float* scale;
  const float* shift;
  int stride;   // 1: per-feature scale and shift, 0: one pair
  int move;
  int first;
  int threads;
};

struct Group {
  Table t[MAX_TABLES];
  int count;
};

// threads of a table that moves `chunks` words a row: whole warps, at
// most MAX_THREADS
int threads_for(long long chunks) {
  long long t = (chunks + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > MAX_THREADS) t = MAX_THREADS;
  return (int)t;
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// the pad word at word `w` of a row, from the 8-byte element pattern
// (little-endian: byte k of the pattern is byte k % 8 of the row)
template <typename W>
__device__ __forceinline__ W pad_of(unsigned long long p, long long w);
template <>
__device__ __forceinline__ uint4 pad_of<uint4>(unsigned long long p,
                                               long long) {
  const unsigned lo = (unsigned)p, hi = (unsigned)(p >> 32);
  return make_uint4(lo, hi, lo, hi);
}
template <>
__device__ __forceinline__ unsigned pad_of<unsigned>(unsigned long long p,
                                                     long long w) {
  return (w & 1) ? (unsigned)(p >> 32) : (unsigned)p;
}
template <>
__device__ __forceinline__ unsigned char pad_of<unsigned char>(
    unsigned long long p, long long w) {
  return (unsigned char)(p >> (8 * (w & 7)));
}

// output row i of a raw table from source row r (a pad row outside it),
// by the table's thread `lane`
template <typename W>
__device__ __forceinline__ void raw_row(const Table& t, long long i, int r,
                                        int lane) {
  const W* __restrict__ data = static_cast<const W*>(t.data);
  W* __restrict__ dst = static_cast<W*>(t.out) + i * t.words;
  if (r >= 0 && r < t.n_rows) {
    const W* src = data + (long long)r * t.words;
    for (long long w = lane; w < t.words; w += t.threads) dst[w] = src[w];
    return;
  }
  if (VELES_PLANTED_FAULT == 2) return;   // planted: the pad row unwritten
  for (long long w = lane; w < t.words; w += t.threads)
    dst[w] = pad_of<W>(t.pad, w);
}

// four elements of a row as f32
__device__ __forceinline__ float4 load4(const unsigned char* p) {
  const uchar4 v = *reinterpret_cast<const uchar4*>(p);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 load4(const int* p) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float affine(float x, float s, float h) {
  return __fadd_rn(__fmul_rn(x, s), h);
}

// output row i of the normalized table (f = t.words features) from source
// row r (a zero row outside it), by the table's thread `lane`; VEC = 4
// moves four features a thread step (f % 4 == 0, aligned bases), VEC = 1
// one
template <typename T, int VEC>
__device__ __forceinline__ void norm_row(const Table& t, long long i, int r,
                                         int lane) {
  const long long f = t.words;
  float* __restrict__ dst = static_cast<float*>(t.out) + i * f;
  const float* __restrict__ scale = t.scale;
  const float* __restrict__ shift = t.shift;
  const long long steps = f / VEC;
  if (r < 0 || r >= t.n_rows) {
    for (long long c = lane; c < steps; c += t.threads) {
      if (VEC == 4)
        reinterpret_cast<float4*>(dst)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        dst[c] = 0.0f;
    }
    return;
  }
  const T* src = static_cast<const T*>(t.data) + (long long)r * f;
  for (long long c = lane; c < steps; c += t.threads) {
    if (VEC == 4) {
      const float4 x = load4(src + 4 * c);
      float4 s, h;
      if (t.stride) {
        s = reinterpret_cast<const float4*>(scale)[c];
        h = reinterpret_cast<const float4*>(shift)[c];
      } else {
        s = make_float4(scale[0], scale[0], scale[0], scale[0]);
        h = make_float4(shift[0], shift[0], shift[0], shift[0]);
      }
      reinterpret_cast<float4*>(dst)[c] = make_float4(
          affine(x.x, s.x, h.x), affine(x.y, s.y, h.y),
          affine(x.z, s.z, h.z), affine(x.w, s.w, h.w));
    } else {
      dst[c] = affine((float)src[c], scale[c * t.stride],
                      shift[c * t.stride]);
    }
  }
}

// output row i of every table of the group from source row r (a pad row
// outside a table), each table by its own warps
__device__ __forceinline__ void move_rows(const Group& g, long long i,
                                          int r) {
#pragma unroll
  for (int j = 0; j < MAX_TABLES; ++j) {
    if (j >= g.count) break;
    const Table& t = g.t[j];
    const int lane = (int)threadIdx.x - t.first;
    if (lane < 0 || lane >= t.threads) continue;   // another table's warps
    // planted: the second table's rows taken at index + 1
    const int rj = VELES_PLANTED_FAULT == 1 && j == 1 ? r + 1 : r;
    switch (t.move) {
      case RAW16: raw_row<uint4>(t, i, rj, lane); break;
      case RAW4: raw_row<unsigned>(t, i, rj, lane); break;
      case RAW1: raw_row<unsigned char>(t, i, rj, lane); break;
      case NORM_U8_4: norm_row<unsigned char, 4>(t, i, rj, lane); break;
      case NORM_U8_1: norm_row<unsigned char, 1>(t, i, rj, lane); break;
      case NORM_I32_4: norm_row<int, 4>(t, i, rj, lane); break;
      case NORM_I32_1: norm_row<int, 1>(t, i, rj, lane); break;
      case NORM_F32_4: norm_row<float, 4>(t, i, rj, lane); break;
      default: norm_row<float, 1>(t, i, rj, lane); break;
    }
  }
}

// one block per output row: row blockIdx.x of every table, from idx
__global__ void __launch_bounds__(MAX_BLOCK)
veles_gather_group_kernel(const int* __restrict__ idx,
                          const __grid_constant__ Group g) {
  const long long i = blockIdx.x;
  move_rows(g, i, idx[i]);
}

// one block per output row i of a served minibatch: its source row is
// shuffled[*offset + i] where i < *size and *offset + i lies in the
// buffer, else -1 (the pad row).  Thread 0 issues the two scalar loads
// together, then the served index's, and leaves it in shared memory for
// the block's table warps: three dependent round trips in all.
__global__ void __launch_bounds__(MAX_BLOCK)
veles_gather_served_kernel(const int* __restrict__ shuffled,
                           long long n_shuffled,
                           const int* __restrict__ offset,
                           const int* __restrict__ size,
                           const __grid_constant__ Group g) {
  __shared__ int served;
  const int i = blockIdx.x;
  if (threadIdx.x == 0) {
    const int at = *offset;
    const int n = *size;
    const long long p = (long long)at + i;
    // planted: row `size`, one past the tail, served as valid
    const bool in_tail = VELES_PLANTED_FAULT == 3 ? i <= n : i < n;
    served = in_tail && p >= 0 && p < n_shuffled ? shuffled[p] : -1;
  }
  __syncthreads();
  move_rows(g, i, served);
}

}  // namespace

// One table of a launch of either entry, as the host gives it
// (ops/gather.py `_Table`): data (n_rows, ...) and out contiguous; kind -1 moves rows of
// `width` bytes raw, `pad` an 8-byte pattern of the pad element; kind 0
// (u8), 1 (int32) or 2 (f32) normalizes rows of `width` features into f32
// with scale and shift, per feature (stride 1) or one value each (stride
// 0), zero rows for an index out of range.
struct GatherTableArg {
  const void* data;
  void* out;
  long long n_rows;
  long long width;
  int kind;
  int stride;
  unsigned long long pad;
  const float* scale;
  const float* shift;
};

// The launch's Group from the host's tables and the block's threads
// (each table's warps after the last's); cudaErrorInvalidValue for a
// table count or kind it does not take.
static int make_group(const GatherTableArg* tables, int n_tables, Group* g,
                      int* threads) {
  if (n_tables < 1 || n_tables > MAX_TABLES) return (int)cudaErrorInvalidValue;
  *g = Group{};
  g->count = n_tables;
  *threads = 0;
  for (int j = 0; j < n_tables; ++j) {
    const GatherTableArg& a = tables[j];
    Table& t = g->t[j];
    t.data = a.data;
    t.out = a.out;
    t.n_rows = a.n_rows;
    t.pad = a.pad;
    t.scale = a.scale;
    t.shift = a.shift;
    t.stride = a.stride;
    long long chunks;
    if (a.kind < 0) {
      const int word = a.width % 16 == 0 && aligned(a.data, 16) &&
                               aligned(a.out, 16) ? 16
                       : a.width % 4 == 0 && aligned(a.data, 4) &&
                               aligned(a.out, 4) ? 4 : 1;
      t.move = word == 16 ? RAW16 : word == 4 ? RAW4 : RAW1;
      t.words = a.width / word;
      chunks = t.words;
    } else {
      if (a.kind > 2) return (int)cudaErrorInvalidValue;
      const int size = a.kind == 0 ? 1 : 4;
      const bool vec = a.width % 4 == 0 && aligned(a.data, 4 * size) &&
                       aligned(a.out, 16) &&
                       (!a.stride || (aligned(a.scale, 16) &&
                                      aligned(a.shift, 16)));
      t.move = NORM_U8_4 + 2 * a.kind + (vec ? 0 : 1);
      t.words = a.width;
      chunks = vec ? a.width / 4 : a.width;
    }
    t.first = *threads;
    t.threads = threads_for(chunks);
    *threads += t.threads;
  }
  return 0;
}

// out_t (n_idx, ...) = table t's rows idx, for each of the n_tables (1 to
// 4) tables, in one launch; idx int32.  Returns cudaErrorInvalidValue for
// a table count or kind it does not take.
extern "C" int veles_gather_group(const GatherTableArg* tables, int n_tables,
                                  const int* idx, int n_idx, void* stream) {
  Group g;
  int threads;
  const int status = make_group(tables, n_tables, &g, &threads);
  if (status) return status;
  if (n_idx <= 0) return (int)cudaGetLastError();
  veles_gather_group_kernel<<<n_idx, threads, 0, (cudaStream_t)stream>>>(
      idx, g);
  return (int)cudaGetLastError();
}

// out_t (count, ...) = table t's rows of the served minibatch, for each of
// the n_tables (1 to 4) tables, in one launch: row i is taken at
// shuffled[*offset + i] where i < *size and 0 <= *offset + i <
// n_shuffled, and is the pad row otherwise.  shuffled (n_shuffled int32),
// offset and size (one int32 each) live on the device and are read when
// the kernel runs, never by the host.
extern "C" int veles_gather_served(const GatherTableArg* tables, int n_tables,
                                   const int* shuffled, long long n_shuffled,
                                   const int* offset, const int* size,
                                   int count, void* stream) {
  Group g;
  int threads;
  const int status = make_group(tables, n_tables, &g, &threads);
  if (status) return status;
  if (count <= 0) return (int)cudaGetLastError();
  veles_gather_served_kernel<<<count, threads, 0, (cudaStream_t)stream>>>(
      shuffled, n_shuffled, offset, size, g);
  return (int)cudaGetLastError();
}
