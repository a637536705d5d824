// Decode attention for Hopper (sm_90a), written by hand: one body, two
// entry points that differ only in where key `pos` of a row lies.
//
// `veles_decode_attn` replaces the TPU kernel veles_tpu/ops/attention.py
// `_decode_kernel`, reached through `_decode_pallas` from
// `decode_attention` (and, with row_step = 1, from `verify_attention`):
// the keys of (b, h) lie in a (b, S, h, d) cache at
// k + b*ksb + pos*kss + h*ksh.
//
// `veles_paged_decode_attn` replaces `_paged_decode_kernel`, reached
// through `_paged_decode_pallas` from `paged_decode_attention`
// (row_step = 0) and `paged_verify_attention` (row_step = 1): the keys
// lie in a shared (num_blocks, BS, h, d) page pool, found through the
// row's block table, at
// pool + tables[b, pos / BS]*block_stride + (pos % BS)*row_stride
//      + h*head_stride.
// Each key is translated on its own, so a 32-key chunk may straddle
// pages and any BS >= 1 works; a 16-byte load stays inside one key row.
// Table entries past a row's allocation point at the trash block 0,
// whose keys lie past the row's limit and are masked.
//
// Up to 8 query rows of each (batch, head) attend to the first
// lengths[b] keys; row r may read keys < lengths[b] + row_step * r.
// Masked scores are -1e30 and the final l is clamped at 1e-30, as in the
// TPU kernels.  Both entries share the warp/chunk partition, the order of
// keys and the merge, so a paged read of a pool that mirrors a contiguous
// cache gives the contiguous kernel's output bit for bit.
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
// (flash-decoding) is the later optimisation.  The paged entry adds one
// 4-byte table read a key (the row's table stays in L1) and loads each
// page where its table entry points; cp.async or TMA page loads are later
// work too.

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

// Where the keys of one (b, h) row lie in a contiguous (b, S, h, d) cache.
template <typename T>
struct ContiguousRow {
  const T* k;
  const T* v;
  long long kss, vss;
  __device__ __forceinline__ void at(int pos, const T*& kp,
                                     const T*& vp) const {
    kp = k + pos * kss;
    vp = v + pos * vss;
  }
};

template <typename T>
struct ContiguousKeys {
  typedef ContiguousRow<T> Row;
  const T* k;
  const T* v;
  long long ksb, kss, ksh, vsb, vss, vsh;
  __device__ __forceinline__ Row row(int b, int hh) const {
    return Row{k + b * ksb + hh * ksh, v + b * vsb + hh * vsh, kss, vss};
  }
};

// Where the keys of one (b, h) row lie in a (num_blocks, BS, h, d) page
// pool: through the row's block table.
template <typename T>
struct PagedRow {
  const T* k;
  const T* v;
  const int* table;
  int bs;
  long long kbs, krs, vbs, vrs;
  __device__ __forceinline__ void at(int pos, const T*& kp,
                                     const T*& vp) const {
    const long long page = table[pos / bs];
    const int off = pos % bs;
    kp = k + page * kbs + off * krs;
    vp = v + page * vbs + off * vrs;
  }
};

template <typename T>
struct PagedKeys {
  typedef PagedRow<T> Row;
  const T* k;
  const T* v;
  const int* tables;
  long long tsb;
  int bs;
  long long kbs, krs, khs, vbs, vrs, vhs;
  __device__ __forceinline__ Row row(int b, int hh) const {
    return Row{k + hh * khs, v + hh * vhs, tables + b * tsb, bs,
               kbs, krs, vbs, vrs};
  }
};

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
template <typename T, int D, typename Row>
__device__ __forceinline__ void stage_chunk(
    const Row& keys, int k0, int kend, int d, bool vec, int lane,
    float* s_k, float* s_v) {
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
          const T *kp, *vp;
          keys.at(k0 + r, kp, vp);
          uk[g] = *reinterpret_cast<const uint4*>(kp + cv * VEC);
          uv[g] = *reinterpret_cast<const uint4*>(vp + cv * VEC);
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
        const T *kp, *vp;
        keys.at(k0 + r, kp, vp);
        xk = to_float(kp[c]);
        xv = to_float(vp[c]);
      }
      s_k[r * LDK + c] = xk;
      s_v[r * D + c] = xv;
    }
  }
}

// kmax: the keys a row can hold (S, or max_blocks * BS for a pool).
template <typename T, int D, typename Keys>
__global__ void __launch_bounds__(Shape<D>::WARPS * 32)
decode_kernel(const T* __restrict__ q, const Keys keys,
              const int* __restrict__ lengths, T* __restrict__ o, int h,
              int nq, int kmax, int d, long long qsb, long long qss,
              long long qsh, int row_step, int vec, float scale) {
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
  // the block skip: no key past the longest row's limit is read, nor
  // past the row's end (a pool's last table entry)
  const int kend = min(kmax, len + row_step * (nq - 1));

  const T* qb = q + b * qsb + hh * qsh;
  const typename Keys::Row row = keys.row(b, hh);
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
    stage_chunk<T, D>(row, k0, kend, d, vec != 0, lane, s_k, s_v);
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

template <typename T, int D, typename Keys>
int launch(const void* q, const Keys& keys, const int* lengths, void* o,
           int b, int h, int nq, int kmax, int d, long long qsb,
           long long qss, long long qsh, int row_step, int vec, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Shape<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D, Keys>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  decode_kernel<T, D, Keys><<<b * h, Shape<D>::WARPS * 32, smem, stream>>>(
      (const T*)q, keys, lengths, (T*)o, h, nq, kmax, d, qsb, qss, qsh,
      row_step, vec, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename Keys>
int dispatch_d(const void* q, const Keys& keys, const int* lengths,
               void* o, int b, int h, int nq, int kmax, int d,
               long long qsb, long long qss, long long qsh, int row_step,
               int vec, float scale, cudaStream_t stream) {
  if (nq < 1 || nq > MAXQ) return (int)cudaErrorInvalidValue;
#define VELES_DECODE_ARGS                                                  \
  q, keys, lengths, o, b, h, nq, kmax, d, qsb, qss, qsh, row_step, vec,   \
      scale, stream
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
  if (dtype == 0) {
    const ContiguousKeys<float> keys{(const float*)k, (const float*)v,
                                     ksb, kss, ksh, vsb, vss, vsh};
    return dispatch_d<float>(q, keys, lens, o, b, h, nq, S, d, qsb, qss,
                             qsh, row_step, vec, scale, st);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 bf16;
    const ContiguousKeys<bf16> keys{(const bf16*)k, (const bf16*)v,
                                    ksb, kss, ksh, vsb, vss, vsh};
    return dispatch_d<bf16>(q, keys, lens, o, b, h, nq, S, d, qsb, qss,
                            qsh, row_step, vec, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The paged entry: k_pool and v_pool are (num_blocks, BS, h, d) with a
// unit stride on d and the given element strides on the block, the row
// in the block and the head; tables is (b, max_blocks) int32 on the
// device with a unit stride on its last axis and row stride tsb, every
// entry a block id of the pool.  A row reads no key at or past
// max_blocks * BS.  The rest as veles_decode_attn.
extern "C" int veles_paged_decode_attn(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* o, int dtype, int b,
    int h, int nq, int max_blocks, int block_size, int d,
    long long qsb, long long qss, long long qsh,
    long long kbs, long long krs, long long khs,
    long long vbs, long long vrs, long long vhs, long long tsb,
    int row_step, int vec, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* lens = (const int*)lengths;
  const int* tabs = (const int*)tables;
  if (block_size < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const int kmax = max_blocks * block_size;
  if (dtype == 0) {
    const PagedKeys<float> keys{(const float*)k_pool, (const float*)v_pool,
                                tabs, tsb, block_size, kbs, krs, khs,
                                vbs, vrs, vhs};
    return dispatch_d<float>(q, keys, lens, o, b, h, nq, kmax, d, qsb, qss,
                             qsh, row_step, vec, scale, st);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 bf16;
    const PagedKeys<bf16> keys{(const bf16*)k_pool, (const bf16*)v_pool,
                               tabs, tsb, block_size, kbs, krs, khs,
                               vbs, vrs, vhs};
    return dispatch_d<bf16>(q, keys, lens, o, b, h, nq, kmax, d, qsb, qss,
                            qsh, row_step, vec, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
