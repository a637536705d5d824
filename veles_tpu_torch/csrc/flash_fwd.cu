// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel veles_tpu/ops/attention.py `_attn_kernel`
// (and its scalar-prefetch twin `_attn_kernel_dyn`), reached through
// `_flash_fwd`.  It computes softmax(q k^T / sqrt(d)) v over (b, s, h, d)
// tensors with an online softmax over K tiles, so the (sq, sk) score
// matrix never reaches device memory, and returns (o, lse).  Masks are
// the reference's: key padding (k_pos < sk) and the START-aligned
// causal mask k_off + j <= q_off + i, with the offsets as runtime ints,
// so one kernel serves both Pallas variants.  Masked scores are -1e30
// (not -inf) and the final l is clamped at 1e-30, as in the TPU kernel.
//
// What bounds it on the H100: at the serving shapes (s up to 2048,
// head_dim 64) attention is operation-bound in principle (about 4 s^2 d h
// / 2 operations against 4 s h d elements moved), but this first kernel
// runs its products on the CUDA cores in f32 FMA, not on the tensor
// cores, so it is bound by FMA issue and shared-memory reads, far above
// the tensor-core roofline.  Design: one block of 8 warps per
// (b*h, 64-row Q tile); Q, K and V tiles are staged in shared memory as
// f32 (rows padded by one word so lanes that read different key rows hit
// different banks); each warp owns 8 query rows, each lane two key
// columns of the 64-wide score tile and head_dim/32 output columns; m, l
// and the accumulator stay in registers.  K tiles wholly above the causal
// diagonal are never loaded.  wgmma, TMA and a bf16 tensor-core path are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 8;
constexpr int ROWS = BLOCK_Q / WARPS;   // query rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles with a one-word row pad, V unpadded, P with a pad
  return sizeof(float) * (BLOCK_Q * (D + 1) + BLOCK_K * (D + 1) +
                          BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1));
}

// D is the head dim rounded up to 32, 64 or 128; d <= D is the real one.
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int h, int sq, int sk, int d,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, int q_off, int k_off, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = BLOCK_K + 1;
  constexpr int NC = D / 32;            // output columns per lane
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + BLOCK_Q * LD;
  float* s_v = s_k + BLOCK_K * LD;
  float* s_p = s_v + BLOCK_K * D;

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * ROWS;

  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + hh * ksh;
  const T* vb = v + b * vsb + hh * vsh;

  // q is scaled after the cast to f32, as the TPU kernel does
  for (int e = tid; e < BLOCK_Q * D; e += WARPS * 32) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = to_float(qb[(q0 + r) * qss + c]) * scale;
    s_q[r * LD + c] = x;
  }

  // causal block skip: tiles whose first key lies past the last valid
  // query row of this tile are never visited
  const int n_k = (sk + BLOCK_K - 1) / BLOCK_K;
  int kt_end = n_k;
  if (causal) {
    const long long last =
        (long long)q_off + min(q0 + BLOCK_Q, sq) - 1 - k_off;
    const long long lim = last < 0 ? 0 : last / BLOCK_K + 1;
    kt_end = (int)min((long long)n_k, lim);
  }

  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < BLOCK_K * D; e += WARPS * 32) {
      const int r = e / D, c = e % D;
      float xk = 0.f, xv = 0.f;
      if (k0 + r < sk && c < d) {
        xk = to_float(kb[(k0 + r) * kss + c]);
        xv = to_float(vb[(k0 + r) * vss + c]);
      }
      s_k[r * LD + c] = xk;
      s_v[r * D + c] = xv;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float ka = s_k[lane * LD + c];
      const float kc = s_k[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = s_q[(r0 + r) * LD + c];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kc, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && ((long long)k_off + kpos <=
                                (long long)q_off + qpos);
        if (!ok) s[r][j] = NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      s_p[(r0 + r) * PLD + lane] = p0;
      s_p[(r0 + r) * PLD + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < BLOCK_K; ++j) {
      float vj[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) vj[i] = s_v[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = s_p[(r0 + r) * PLD + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(p, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + (((long long)b * sq + row) * h + hh) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store(orow + c, acc[r][i] / lc);
    }
    if (lane == 0) lse[(long long)bh * sq + row] = m[r] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int h, int sq, int sk, int d,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh,
           int causal, int q_off, int k_off, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(b * h, (sq + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<T, D><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, h, sq, sk,
      d, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, q_off, k_off,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int b, int h, int sq, int sk, int d,
               long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh,
               int causal, int q_off, int k_off, float scale,
               cudaStream_t stream) {
#define VELES_FLASH_ARGS                                                  \
  q, k, v, o, lse, b, h, sq, sk, d, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, \
      vsh, causal, q_off, k_off, scale, stream
  if (d <= 32) return launch<T, 32>(VELES_FLASH_ARGS);
  if (d <= 64) return launch<T, 64>(VELES_FLASH_ARGS);
  if (d <= 128) return launch<T, 128>(VELES_FLASH_ARGS);
#undef VELES_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v are (b, s, h, d) with a unit
// stride on d and the given element strides on b, s and h; o is a
// contiguous (b, sq, h, d) of q's type, lse a contiguous (b, h, sq) f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int veles_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int b, int h, int sq, int sk, int d,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, int q_off, int k_off, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, b, h, sq, sk, d, qsb, qss, qsh,
                             ksb, kss, ksh, vsb, vss, vsh, causal, q_off,
                             k_off, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, b, h, sq, sk, d, qsb,
                                     qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                                     causal, q_off, k_off, scale, st);
  return (int)cudaErrorInvalidValue;
}
