// Decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel veles_tpu/ops/attention.py `_decode_kernel`,
// reached through `_decode_pallas` from `decode_attention` (and, with
// row_step = 1, from `verify_attention`).  Up to 8 query rows of each
// (batch, head) attend to a (b, S, h, d) KV cache of which only the
// first lengths[b] keys are valid; row r may read keys
// < lengths[b] + row_step * r.  Masked scores are -1e30 and the final l
// is clamped at 1e-30, as in the TPU kernel.
//
// What bounds it on the H100: bytes.  A decode step reads every valid
// K and V row once and does 4 d operations per key and query row, about
// one operation per byte in bf16, far below the ~295 operations a byte
// at which the tensor cores would become the limit.  Design: one block
// per (b*h); keys past the longest row's limit are never read (the
// TPU kernel's block skip).  Its warps take interleaved chunks of 32
// keys, stage each chunk in shared memory with 16-byte loads (eight
// outstanding per lane, so each SM keeps enough bytes in flight), and run
// their own online softmax in registers; the warps' (m, l, acc) are
// merged through shared memory at the end.  The grid is only b*h blocks
// (64 at the serving shape, for 132 SMs): a split-K pass over the keys
// (flash-decoding) is the later optimisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;       // keys per warp iteration (one per lane)
constexpr int MAXQ = 8;         // query rows (decode 1, verify <= 8)
constexpr int GROUP = 4;        // 16-byte loads a lane issues per tensor
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// unpack one 16-byte vector of T into floats
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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
struct Shape {
  static constexpr int WARPS = D <= 64 ? 8 : 4;
  static constexpr int LDK = D + 1;                 // bank-conflict pad
  static constexpr int PER_WARP = CHUNK * LDK + CHUNK * D + MAXQ * CHUNK;
  static constexpr size_t SMEM =
      sizeof(float) * (MAXQ * D + WARPS * PER_WARP);
};

// Stage keys [k0, k0 + CHUNK) of one (b, h) row into s_k / s_v as f32;
// keys at or past kend and columns past d read as zero.  `vec` says that
// rows are 16-byte aligned with d a multiple of the vector width.
template <typename T, int D>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ kb, const T* __restrict__ vb, long long kss,
    long long vss, int k0, int kend, int d, bool vec, int lane, float* s_k,
    float* s_v) {
  constexpr int LDK = Shape<D>::LDK;
  if (vec) {
    constexpr int VEC = 16 / sizeof(T);
    const int dv = d / VEC;                 // vectors per row
    const int total = CHUNK * dv;
    for (int base = lane; base < total; base += 32 * GROUP) {
      uint4 uk[GROUP], uv[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int e = base + 32 * g;
        const int r = e / dv, cv = e % dv;
        uk[g] = uv[g] = make_uint4(0u, 0u, 0u, 0u);
        if (e < total && k0 + r < kend) {
          uk[g] = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kss +
                                                  cv * VEC);
          uv[g] = *reinterpret_cast<const uint4*>(vb + (k0 + r) * vss +
                                                  cv * VEC);
        }
      }
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const int e = base + 32 * g;
        if (e >= total) break;
        const int r = e / dv, c = (e % dv) * VEC;
        float fk[VEC], fv[VEC];
        unpack(uk[g], fk, T());
        unpack(uv[g], fv, T());
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s_k[r * LDK + c + i] = fk[i];
          s_v[r * D + c + i] = fv[i];
        }
      }
    }
    // zero the padded columns d..D once per chunk (read by the products)
    for (int e = lane; e < CHUNK * (D - d); e += 32) {
      const int r = e / (D - d), c = d + e % (D - d);
      s_k[r * LDK + c] = 0.f;
      s_v[r * D + c] = 0.f;
    }
  } else {
    for (int e = lane; e < CHUNK * D; e += 32) {
      const int r = e / D, c = e % D;
      float xk = 0.f, xv = 0.f;
      if (k0 + r < kend && c < d) {
        xk = to_float(kb[(k0 + r) * kss + c]);
        xv = to_float(vb[(k0 + r) * vss + c]);
      }
      s_k[r * LDK + c] = xk;
      s_v[r * D + c] = xv;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int h, int nq, int S, int d,
              long long qsb, long long qss, long long qsh,
              long long ksb, long long kss, long long ksh,
              long long vsb, long long vss, long long vsh,
              int row_step, int vec, float scale) {
  constexpr int WARPS = Shape<D>::WARPS;
  constexpr int LDK = Shape<D>::LDK;
  constexpr int NC = D / 32;
  extern __shared__ float smem[];
  float* s_q = smem;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* s_k = s_q + MAXQ * D + warp * Shape<D>::PER_WARP;
  float* s_v = s_k + CHUNK * LDK;
  float* s_p = s_v + CHUNK * D;

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int len = lengths[b];
  // the block skip: no key past the longest row's limit is read
  const int kend = min(S, len + row_step * (nq - 1));

  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + hh * ksh;
  const T* vb = v + b * vsb + hh * vsh;
  for (int e = tid; e < MAXQ * D; e += WARPS * 32) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (r < nq && c < d) x = to_float(qb[r * qss + c]) * scale;
    s_q[r * D + c] = x;
  }
  __syncthreads();

  float m[MAXQ], l[MAXQ], acc[MAXQ][NC];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = warp * CHUNK; k0 < kend; k0 += WARPS * CHUNK) {
    stage_chunk<T, D>(kb, vb, kss, vss, k0, kend, d, vec != 0, lane, s_k,
                      s_v);
    __syncwarp();

    const int kpos = k0 + lane;
    float s[MAXQ];
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = s_k[lane * LDK + c];
#pragma unroll
      for (int r = 0; r < MAXQ; ++r)
        if (r < nq) s[r] = fmaf(s_q[r * D + c], kc, s[r]);
    }
#pragma unroll
    for (int r = 0; r < MAXQ; ++r) {
      if (r >= nq) break;
      if (!(kpos < kend && kpos < len + row_step * r)) s[r] = NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float p = expf(s[r] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      s_p[r * CHUNK + lane] = p;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < CHUNK; ++j) {
      float vj[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) vj[i] = s_v[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r >= nq) break;
        const float p = s_p[r * CHUNK + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(p, vj[i], acc[r][i]);
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states (reusing the staging area)
  __syncthreads();
  float* s_m = s_q + MAXQ * D;
  float* s_l = s_m + WARPS * MAXQ;
  float* s_acc = s_l + WARPS * MAXQ;
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) {
    if (r >= nq) break;
    if (lane == 0) {
      s_m[warp * MAXQ + r] = m[r];
      s_l[warp * MAXQ + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
      s_acc[(warp * MAXQ + r) * D + lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  for (int e = tid; e < nq * D; e += WARPS * 32) {
    const int r = e / D, c = e % D;
    if (c >= d) continue;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w * MAXQ + r]);
    float lsum = 0.f, out = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(s_m[w * MAXQ + r] - mx);
      lsum += s_l[w * MAXQ + r] * f;
      out += s_acc[(w * MAXQ + r) * D + c] * f;
    }
    store(o + (((long long)b * nq + r) * h + hh) * d + c,
          out / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, int b, int h, int nq, int S, int d,
           long long qsb, long long qss, long long qsh,
           long long ksb, long long kss, long long ksh,
           long long vsb, long long vss, long long vsh,
           int row_step, int vec, float scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  decode_kernel<T, D><<<b * h, Shape<D>::WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lengths, (T*)o, h, nq, S, d,
      qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, row_step, vec, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const int* lengths, void* o, int b, int h, int nq, int S,
               int d, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh,
               int row_step, int vec, float scale, cudaStream_t stream) {
#define VELES_DECODE_ARGS                                                \
  q, k, v, lengths, o, b, h, nq, S, d, qsb, qss, qsh, ksb, kss, ksh, vsb, \
      vss, vsh, row_step, vec, scale, stream
  if (d <= 32) return launch<T, 32>(VELES_DECODE_ARGS);
  if (d <= 64) return launch<T, 64>(VELES_DECODE_ARGS);
  if (d <= 128) return launch<T, 128>(VELES_DECODE_ARGS);
#undef VELES_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q is (b, nq, h, d), k and v are
// (b, S, h, d), each with a unit stride on d and the given element strides
// on b, s and h; lengths is (b,) int32 on the device; o is a contiguous
// (b, nq, h, d) of q's type.  vec = 1 promises 16-byte aligned K/V rows
// and d a multiple of 16 / sizeof(T).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int veles_decode_attn(
    const void* q, const void* k, const void* v, const void* lengths,
    void* o, int dtype, int b, int h, int nq, int S, int d,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int row_step, int vec, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  if (nq < 1 || nq > MAXQ) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, lens, o, b, h, nq, S, d, qsb, qss,
                             qsh, ksb, kss, ksh, vsb, vss, vsh, row_step,
                             vec, scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, lens, o, b, h, nq, S, d, qsb,
                                     qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
                                     row_step, vec, scale, st);
  return (int)cudaErrorInvalidValue;
}
