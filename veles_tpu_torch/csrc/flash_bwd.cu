// Flash-attention backward for Hopper (sm_90a), written by hand: the dq
// kernel and the dk/dv kernel.
//
// Replaces the TPU kernels veles_tpu/ops/attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (both in their static and scalar-prefetch
// `_attn_kernel_dyn` variants), reached through `_flash_bwd`.  From the
// forward's saved (q, k, v, lse), the output gradient do and
// delta = rowsum(do * o), both kernels recompute the probabilities tile by
// tile, p = exp(q k^T * scale - lse), so the (sq, sk) matrices never reach
// device memory:
//   dq = ds k,  dk = ds^T q,  dv = p^T do,  ds = p * (do v^T - delta) * scale.
// Masks are the forward's: key padding (k_pos < sk) and the START-aligned
// causal mask k_off + j <= q_off + i, offsets as runtime ints; a masked p
// is exactly 0.  The matmul-dtype rules of the TPU kernels are kept: the
// products read q, k, v and do as given (bf16 values are exact in f32), p
// is rounded to the operand type before p^T do and ds before ds k and
// ds^T q; everything else, and every sum, is f32.
//
// What bounds it on the H100: at the training shapes (s = 2048, head_dim
// 64) both kernels are operation-bound in principle (3 and 4 products of
// 2 s^2 d h / 2 operations each against 6 to 7 s h d elements moved), but
// this first version runs its products as f32 FMA on the CUDA cores, not
// on the tensor cores, so it is bound by FMA issue and shared-memory
// reads, far above the tensor-core roofline.  Design: one block of 8 warps
// per (b*h, 64-row tile); the dq kernel owns a Q tile and loops over K
// tiles (skipping those wholly above the causal diagonal), the dk/dv
// kernel owns a K tile and loops over Q tiles (skipping those wholly below
// the causal reach).  Tiles are staged in shared memory as f32 with a
// one-word row pad, so lanes that read different rows hit different
// banks; each warp owns 8 rows of the block's tile and each lane two
// columns of the 64-wide score tile and head_dim/32 output columns; the
// accumulators stay in registers.  Every output element is summed by one
// thread in a fixed order: no atomics, so two runs give the same bits.
// mma.sync / wgmma, TMA and a bf16 tensor-core path are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int WARPS = 8;
constexpr int ROWS = 64 / WARPS;   // tile rows per warp

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rounding of a product operand to the matmul type, as `.astype(q.dtype)`
template <typename T>
struct MatmulType;
template <>
struct MatmulType<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <>
struct MatmulType<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Stage rows [row0, row0 + NROWS) of one (s, d) slice, row stride `ss`,
// into shared memory as f32 rows of LD words; rows past `s` and columns
// past `d` are zero.
template <typename T, int NROWS, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int s, int d, long long ss,
                                          int tid) {
  for (int e = tid; e < NROWS * D; e += WARPS * 32) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (row0 + r < s && c < d) x = to_float(src[(long long)(row0 + r) * ss + c]);
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal, int q_off, int k_off) {
  bool ok = qpos < sq && kpos < sk;
  if (causal)
    ok = ok && ((long long)k_off + kpos <= (long long)q_off + qpos);
  return ok;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, do, k and v tiles with a one-word row pad, the ds tile with a pad
  return sizeof(float) * (2 * BLOCK_Q * (D + 1) + 2 * BLOCK_K * (D + 1) +
                          BLOCK_Q * (BLOCK_K + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q and do tiles with a pad, the p^T and ds^T tiles with a pad,
  // and the Q tile's lse and delta
  return sizeof(float) * (2 * BLOCK_K * (D + 1) + 2 * BLOCK_Q * (D + 1) +
                          2 * BLOCK_K * (BLOCK_Q + 1) + 2 * BLOCK_Q);
}

// D is the head dim rounded up to 32, 64 or 128; d <= D is the real one.
template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int h, int sq, int sk, int d,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    long long dsb, long long dss, long long dsh,
                    int causal, int q_off, int k_off, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = BLOCK_K + 1;
  constexpr int NC = D / 32;            // output columns per lane
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + BLOCK_Q * LD;
  float* s_k = s_do + BLOCK_Q * LD;
  float* s_v = s_k + BLOCK_K * LD;
  float* s_ds = s_v + BLOCK_K * LD;

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * ROWS;

  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + hh * ksh;
  const T* vb = v + b * vsb + hh * vsh;
  const T* dob = dout + b * dsb + hh * dsh;

  load_tile<T, BLOCK_Q, D, LD>(s_q, qb, q0, sq, d, qss, tid);
  load_tile<T, BLOCK_Q, D, LD>(s_do, dob, q0, sq, d, dss, tid);

  float lse_r[ROWS], delta_r[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    const bool in = row < sq;
    lse_r[r] = in ? lse[(long long)bh * sq + row] : 0.f;
    delta_r[r] = in ? delta[(long long)bh * sq + row] : 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  // causal block skip: K tiles whose first key lies past the last valid
  // query row of this tile are never visited
  const int n_k = (sk + BLOCK_K - 1) / BLOCK_K;
  int kt_end = n_k;
  if (causal) {
    const long long last =
        (long long)q_off + min(q0 + BLOCK_Q, sq) - 1 - k_off;
    const long long lim = last < 0 ? 0 : last / BLOCK_K + 1;
    kt_end = (int)min((long long)n_k, lim);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BLOCK_K;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, BLOCK_K, D, LD>(s_k, kb, k0, sk, d, kss, tid);
    load_tile<T, BLOCK_K, D, LD>(s_v, vb, k0, sk, d, vss, tid);
    __syncthreads();

    // s = q k^T and dp = do v^T for this warp's 8 rows and the lane's
    // two key columns
    float s[ROWS][2], dp[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float ka = s_k[lane * LD + c];
      const float kc = s_k[(lane + 32) * LD + c];
      const float va = s_v[lane * LD + c];
      const float vc = s_v[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = s_q[(r0 + r) * LD + c];
        const float dv = s_do[(r0 + r) * LD + c];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kc, s[r][1]);
        dp[r][0] = fmaf(dv, va, dp[r][0]);
        dp[r][1] = fmaf(dv, vc, dp[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const float p =
            visible(qpos, kpos, sq, sk, causal, q_off, k_off)
                ? expf(s[r][j] * scale - lse_r[r])
                : 0.f;
        const float ds = p * (dp[r][j] - delta_r[r]) * scale;
        s_ds[(r0 + r) * PLD + lane + 32 * j] = MatmulType<T>::round(ds);
      }
    }
    __syncwarp();   // each warp reads back only its own rows of ds

    // dq += ds k
#pragma unroll 4
    for (int j = 0; j < BLOCK_K; ++j) {
      float kj[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) kj[i] = s_k[j * LD + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float ds = s_ds[(r0 + r) * PLD + j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(ds, kj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    T* out = dq + (((long long)b * sq + row) * h + hh) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store(out + c, acc[r][i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int sq, int sk, int d,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh,
                     long long dsb, long long dss, long long dsh,
                     int causal, int q_off, int k_off, float scale) {
  constexpr int LD = D + 1;
  constexpr int PLD = BLOCK_Q + 1;
  constexpr int NC = D / 32;
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + BLOCK_K * LD;
  float* s_q = s_v + BLOCK_K * LD;
  float* s_do = s_q + BLOCK_Q * LD;
  float* s_p = s_do + BLOCK_Q * LD;      // p^T: key rows, query columns
  float* s_ds = s_p + BLOCK_K * PLD;     // ds^T likewise
  float* s_lse = s_ds + BLOCK_K * PLD;
  float* s_delta = s_lse + BLOCK_Q;

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int k0 = blockIdx.y * BLOCK_K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * ROWS;            // this warp's key rows

  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + hh * ksh;
  const T* vb = v + b * vsb + hh * vsh;
  const T* dob = dout + b * dsb + hh * dsh;

  load_tile<T, BLOCK_K, D, LD>(s_k, kb, k0, sk, d, kss, tid);
  load_tile<T, BLOCK_K, D, LD>(s_v, vb, k0, sk, d, vss, tid);

  float acc_k[ROWS][NC], acc_v[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int i = 0; i < NC; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;
  }

  // causal block skip: Q tiles whose last row lies before this tile's
  // first key (global positions) are never visited
  const int n_q = (sq + BLOCK_Q - 1) / BLOCK_Q;
  int qt_begin = 0;
  if (causal) {
    const long long first = (long long)k_off + k0 - q_off;
    qt_begin = first <= 0 ? 0 : (int)min((long long)n_q, first / BLOCK_Q);
  }

  for (int qt = qt_begin; qt < n_q; ++qt) {
    const int q0 = qt * BLOCK_Q;
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, BLOCK_Q, D, LD>(s_q, qb, q0, sq, d, qss, tid);
    load_tile<T, BLOCK_Q, D, LD>(s_do, dob, q0, sq, d, dss, tid);
    for (int e = tid; e < BLOCK_Q; e += WARPS * 32) {
      const int row = q0 + e;
      const bool in = row < sq;
      s_lse[e] = in ? lse[(long long)bh * sq + row] : 0.f;
      s_delta[e] = in ? delta[(long long)bh * sq + row] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T for this warp's 8 key rows and the
    // lane's two query columns
    float s[ROWS][2], dp[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qa = s_q[lane * LD + c];
      const float qc = s_q[(lane + 32) * LD + c];
      const float da = s_do[lane * LD + c];
      const float dc = s_do[(lane + 32) * LD + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float kv = s_k[(r0 + r) * LD + c];
        const float vv = s_v[(r0 + r) * LD + c];
        s[r][0] = fmaf(qa, kv, s[r][0]);
        s[r][1] = fmaf(qc, kv, s[r][1]);
        dp[r][0] = fmaf(da, vv, dp[r][0]);
        dp[r][1] = fmaf(dc, vv, dp[r][1]);
      }
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = lane + 32 * j;
      const float lse_j = s_lse[qi];
      const float delta_j = s_delta[qi];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = visible(q0 + qi, k0 + r0 + r, sq, sk, causal, q_off,
                                k_off)
                            ? expf(s[r][j] * scale - lse_j)
                            : 0.f;
        const float ds = p * (dp[r][j] - delta_j) * scale;
        s_p[(r0 + r) * PLD + qi] = MatmulType<T>::round(p);
        s_ds[(r0 + r) * PLD + qi] = MatmulType<T>::round(ds);
      }
    }
    __syncwarp();   // each warp reads back only its own key rows

    // dv += p^T do and dk += ds^T q
#pragma unroll 4
    for (int i = 0; i < BLOCK_Q; ++i) {
      float doi[NC], qi[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        doi[c] = s_do[i * LD + lane + 32 * c];
        qi[c] = s_q[i * LD + lane + 32 * c];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = s_p[(r0 + r) * PLD + i];
        const float ds = s_ds[(r0 + r) * PLD + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[r][c] = fmaf(p, doi[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(ds, qi[c], acc_k[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = k0 + r0 + r;
    if (row >= sk) continue;
    const long long off = (((long long)b * sk + row) * h + hh) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        store(dk + off + col, acc_k[r][c]);
        store(dv + off + col, acc_v[r][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;   // dq; or dk and dv
  int b, h, sq, sk, d;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int causal, q_off, k_off;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(a.b * a.h, (a.sq + BLOCK_Q - 1) / BLOCK_Q);
  flash_bwd_dq_kernel<T, D><<<grid, WARPS * 32, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.out0, a.h, a.sq, a.sk,
      a.d, a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh,
      a.dsb, a.dss, a.dsh, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(a.b * a.h, (a.sk + BLOCK_K - 1) / BLOCK_K);
  flash_bwd_dkv_kernel<T, D><<<grid, WARPS * 32, smem, a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout,
      (const float*)a.lse, (const float*)a.delta, (T*)a.out0, (T*)a.out1,
      a.h, a.sq, a.sk, a.d, a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb,
      a.vss, a.vsh, a.dsb, a.dss, a.dsh, a.causal, a.q_off, a.k_off,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, bool dkv) {
  if (a.d <= 32) return dkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (a.d <= 64) return dkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.d <= 128) return dkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  return (int)cudaErrorInvalidValue;
}

int run(int dtype, const Args& a, bool dkv) {
  if (a.b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(a, dkv);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, dkv);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v and dout are (b, s, h, d) of
// that type with a unit stride on d and the given element strides on b, s
// and h; lse and delta are contiguous (b, h, sq) f32.  dq is a contiguous
// (b, sq, h, d) of q's type.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int veles_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int b, int h,
    int sq, int sk, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, int causal,
    int q_off, int k_off, float scale, void* stream) {
  const Args a{q,   k,   v,   dout, lse, delta, dq,  nullptr, b,
               h,   sq,  sk,  d,    qsb, qss,   qsh, ksb,     kss,
               ksh, vsb, vss, vsh,  dsb, dss,   dsh, causal,  q_off,
               k_off, scale, (cudaStream_t)stream};
  return run(dtype, a, false);
}

// The same operands; dk and dv are contiguous (b, sk, h, d) of k's type.
extern "C" int veles_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int b,
    int h, int sq, int sk, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, int causal,
    int q_off, int k_off, float scale, void* stream) {
  const Args a{q,   k,   v,   dout, lse, delta, dk,  dv,     b,
               h,   sq,  sk,  d,    qsb, qss,   qsh, ksb,    kss,
               ksh, vsb, vss, vsh,  dsb, dss,   dsh, causal, q_off,
               k_off, scale, (cudaStream_t)stream};
  return run(dtype, a, true);
}
