// Uniform fill for Hopper (sm_90a), written by hand: a counter-based
// Philox4x32-10 stream mapped to [low, high) in f32 or bf16.
//
// Replaces the TPU kernel `_uniform_kernel` of veles_tpu/ops/random.py
// (via `_uniform_pallas_tpu`), which seeds the TPU core's hardware PRNG
// per grid row.  The card has no such generator, so the kernel carries
// its own: Philox4x32-10 (Salmon et al., SC 2011) with the 64-bit seed as
// its key and the flat element index divided by 4 as its counter; each
// counter gives four 32-bit words, one an element.  The top 24 bits of a
// word map to u in [0, 1) (as the Pallas kernel maps its words), then
// u * (high - low) + low with two roundings (no FMA contraction), the
// cast to the output dtype rounding to nearest even, and a value that
// rounded up to `high` is replaced by the largest value of the dtype
// below it, so every output lies in [low, high).  The plain version
// (`_uniform_ref`, torch int64) computes the same Philox, so the kernel
// and the CPU give the same bits for the same (seed, shape): more than the
// reference promises, whose TPU bits and off-TPU fallback differ.
//
// What bounds it on the H100: the bytes written.  (4096, 4096) f32 is
// 64 MiB, >= 20 us at 3.35 TB/s; Philox costs 10 rounds of two 32-bit
// multiplies a counter, some 40 integer operations an element, which the
// card's integer units do in a few microseconds.  Each thread makes one
// counter's four outputs and writes them as one 16-byte (f32) or 8-byte
// (bf16) store where the row of four lies inside the tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// a test build may plant a fault (1: a counter's second word written over
// its first; 2: every counter offset by one block), which the card checks
// must report; 0 in every other build
#ifndef VELES_PLANTED_FAULT
#define VELES_PLANTED_FAULT 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox(uint64_t counter, uint32_t k0,
                                        uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(counter);
  uint32_t c1 = static_cast<uint32_t>(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float to_unit(uint32_t word, float span, float lo) {
  const float u = static_cast<float>(word >> 8) * (1.0f / 16777216.0f);
  return __fadd_rn(__fmul_rn(u, span), lo);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
uniform_kernel(void* __restrict__ out, long long numel, uint32_t k0,
               uint32_t k1, float span, float lo, float cap) {
  const long long counter =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long first = counter * 4;
  if (first >= numel) return;
  const uint4 w = philox(
      static_cast<uint64_t>(counter + (VELES_PLANTED_FAULT == 2 ? THREADS : 0)),
      k0, k1);
  const uint32_t words[4] = {VELES_PLANTED_FAULT == 1 ? w.y : w.x, w.y, w.z,
                             w.w};
  if (BF16) {
    union { uint2 u; unsigned short h[4]; } v;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat16 b = __float2bfloat16_rn(to_unit(words[i], span, lo));
      if (__bfloat162float(b) > cap) b = __float2bfloat16_rn(cap);
      v.h[i] = __bfloat16_as_ushort(b);
    }
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + first;
    if (first + 4 <= numel) {
      *reinterpret_cast<uint2*>(o) = v.u;
    } else {
      for (int i = 0; first + i < numel; ++i)
        o[i] = __ushort_as_bfloat16(v.h[i]);
    }
  } else {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = fminf(to_unit(words[i], span, lo), cap);
    float* o = static_cast<float*>(out) + first;
    if (first + 4 <= numel) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; first + i < numel; ++i) o[i] = v[i];
    }
  }
}

}  // namespace

// out (numel,) contiguous, f32 or bf16 (bf16), 16-byte aligned: element i
// is word i % 4 of Philox4x32-10(counter = i / 4, key = (k0, k1)), mapped
// to u * span + lo and capped at `cap` (the largest value of the dtype
// below high, exact in f32).  Launches on `stream`, does not synchronise;
// returns the launch's CUDA error.
extern "C" int veles_uniform(void* out, long long numel, unsigned int k0,
                             unsigned int k1, float span, float lo, float cap,
                             int bf16, void* stream) {
  if (numel < 1) return cudaErrorInvalidValue;
  const long long counters = (numel + 3) / 4;
  const long long blocks = (counters + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    uniform_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        out, numel, k0, k1, span, lo, cap);
  else
    uniform_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        out, numel, k0, k1, span, lo, cap);
  return static_cast<int>(cudaGetLastError());
}
