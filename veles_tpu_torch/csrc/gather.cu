// Row gather, and row gather fused with an affine normalize, for Hopper
// (sm_90a), written by hand.
//
// Replaces two TPU kernels of veles_tpu/ops/gather.py:
// - `_gather_kernel` (via `_gather_pallas`): out[i] = data[idx[i]] along
//   axis 0, a pad row where idx[i] is negative (the empty slots of a
//   short minibatch)                                 -> veles_gather_rows;
// - `_gather_norm_kernel` (via `_gather_norm_pallas`): out[i] =
//   f32(data[idx[i]]) * scale + shift, per feature or one scalar pair,
//   and a ZERO row (not `shift`) where idx[i] is negative
//                                                    -> veles_gather_norm.
// The Pallas kernels run one grid point per output row, with the index
// as a scalar-prefetch index map that DMAs the source row into the
// output block.  Here one block copies one output row: it loads its own
// index, and its threads stride over the row, neighbouring threads on
// neighbouring addresses.  veles_gather_rows moves the row as raw bytes
// (any element type) in 16-byte words where the row width and both
// base addresses allow it, else in 4-byte words, else bytes; the pad
// value arrives as an 8-byte pattern of its element repeated.
// veles_gather_norm reads u8, int32 or f32 rows four elements at a time
// where the width and alignment allow it, converts them to f32 and
// writes float4s; the multiply and the add are rounded one after the
// other (__fmul_rn, __fadd_rn), as the plain version and the JAX
// reference compute them, so no fused multiply-add changes a bit.  An
// index outside [0, n_rows) gives the pad (zero) row: no read ever
// leaves the table.  Neither kernel synchronises or allocates; both
// launch on the caller's stream, so a CUDA graph captures them.
//
// What bounds it on the H100: bytes.  The MNIST head gathers 100 rows
// of 784 u8 (78 400 B read, 313 600 B of f32 written, 400 B of
// indices): 0.117 us at 3.35 TB/s, far below one launch, so at the
// main path's shape the launch and the graph around it are the cost.
// At 4096 rows of real MNIST's (70 000, 784) u8 table the bound is
// 4.8 us; a block per row keeps 4096 blocks in flight over 132 SMs, and
// each row is read and written once, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

// threads of a block that copies `chunks` words a row: whole warps, at
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

// one block per output row; a row is `row_words` words of type W
template <typename W>
__global__ void __launch_bounds__(MAX_THREADS)
veles_gather_rows_kernel(const W* __restrict__ data,
                         const int* __restrict__ idx, W* __restrict__ out,
                         long long n_rows, long long row_words,
                         unsigned long long pad) {
  const long long i = blockIdx.x;
  const int r = idx[i];
  W* dst = out + i * row_words;
  if (r >= 0 && r < n_rows) {
    const W* src = data + (long long)r * row_words;
    for (long long w = threadIdx.x; w < row_words; w += blockDim.x)
      dst[w] = src[w];
  } else {
    for (long long w = threadIdx.x; w < row_words; w += blockDim.x)
      dst[w] = pad_of<W>(pad, w);
  }
}

template <typename W>
int launch_rows(const void* data, const int* idx, void* out,
                long long n_rows, int n_idx, long long row_bytes,
                unsigned long long pad, void* stream) {
  const long long words = row_bytes / (long long)sizeof(W);
  veles_gather_rows_kernel<W>
      <<<n_idx, threads_for(words), 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const W*>(data), idx, reinterpret_cast<W*>(out),
          n_rows, words, pad);
  return (int)cudaGetLastError();
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

// one block per output row of f features; VEC = 4 moves four features a
// thread step (f % 4 == 0, aligned bases), VEC = 1 one.  `stride` is 1
// for per-feature scale/shift, 0 for one scalar pair.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
veles_gather_norm_kernel(const T* __restrict__ data,
                         const int* __restrict__ idx,
                         float* __restrict__ out, long long n_rows,
                         long long f, const float* __restrict__ scale,
                         const float* __restrict__ shift, int stride) {
  const long long i = blockIdx.x;
  const int r = idx[i];
  float* dst = out + i * f;
  const long long steps = f / VEC;
  if (r < 0 || r >= n_rows) {
    for (long long c = threadIdx.x; c < steps; c += blockDim.x) {
      if (VEC == 4)
        reinterpret_cast<float4*>(dst)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        dst[c] = 0.0f;
    }
    return;
  }
  const T* src = data + (long long)r * f;
  for (long long c = threadIdx.x; c < steps; c += blockDim.x) {
    if (VEC == 4) {
      const float4 x = load4(src + 4 * c);
      float4 s, h;
      if (stride) {
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
      dst[c] = affine((float)src[c], scale[c * stride], shift[c * stride]);
    }
  }
}

template <typename T>
int launch_norm(const void* data, const int* idx, float* out,
                long long n_rows, int n_idx, long long f,
                const float* scale, const float* shift, int stride,
                void* stream) {
  const T* d = reinterpret_cast<const T*>(data);
  const bool vec = f % 4 == 0 && aligned(data, 4 * (int)sizeof(T)) &&
                   aligned(out, 16) &&
                   (!stride || (aligned(scale, 16) && aligned(shift, 16)));
  if (vec)
    veles_gather_norm_kernel<T, 4>
        <<<n_idx, threads_for(f / 4), 0, (cudaStream_t)stream>>>(
            d, idx, out, n_rows, f, scale, shift, stride);
  else
    veles_gather_norm_kernel<T, 1>
        <<<n_idx, threads_for(f), 0, (cudaStream_t)stream>>>(
            d, idx, out, n_rows, f, scale, shift, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n_idx, row_bytes) = data[idx] row by row, `pad` (an 8-byte
// pattern of the pad element) where idx is out of [0, n_rows); data
// (n_rows, row_bytes) and out contiguous, idx int32.
extern "C" int veles_gather_rows(const void* data, const int* idx, void* out,
                                 long long n_rows, int n_idx,
                                 long long row_bytes,
                                 unsigned long long pad, void* stream) {
  if (n_idx <= 0 || row_bytes <= 0) return (int)cudaGetLastError();
  if (row_bytes % 16 == 0 && aligned(data, 16) && aligned(out, 16))
    return launch_rows<uint4>(data, idx, out, n_rows, n_idx, row_bytes,
                              pad, stream);
  if (row_bytes % 4 == 0 && aligned(data, 4) && aligned(out, 4))
    return launch_rows<unsigned>(data, idx, out, n_rows, n_idx, row_bytes,
                                 pad, stream);
  return launch_rows<unsigned char>(data, idx, out, n_rows, n_idx,
                                    row_bytes, pad, stream);
}

// out (n_idx, f) f32 = f32(data[idx]) * scale + shift, a zero row where
// idx is out of [0, n_rows); dtype 0 = u8, 1 = int32, 2 = f32; scale and
// shift f32, per feature (stride 1) or one value each (stride 0).
// Returns cudaErrorInvalidValue for an unknown dtype.
extern "C" int veles_gather_norm(const void* data, int dtype, const int* idx,
                                 float* out, long long n_rows, int n_idx,
                                 long long f, const float* scale,
                                 const float* shift, int stride,
                                 void* stream) {
  if (n_idx <= 0 || f <= 0) return (int)cudaGetLastError();
  switch (dtype) {
    case 0:
      return launch_norm<unsigned char>(data, idx, out, n_rows, n_idx, f,
                                        scale, shift, stride, stream);
    case 1:
      return launch_norm<int>(data, idx, out, n_rows, n_idx, f, scale,
                              shift, stride, stream);
    case 2:
      return launch_norm<float>(data, idx, out, n_rows, n_idx, f, scale,
                                shift, stride, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
