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
// products read q, k, v and do in their own type, p is rounded to that
// type before p^T do and ds before ds k and ds^T q; everything else, and
// every sum, is f32.  Each output element is summed by one thread in a
// fixed order: no atomics, so two runs give the same bits.
//
// Two bodies, chosen by the dtype (`run`):
//
// * bfloat16: the tensor-core body (`*_kernel_tc`).
//   What bounds it on the H100: at the training shape (b 8, s 2048, h 16, d
//   64, causal) the dq kernel does 3 and the dk/dv kernel 4 products of 2 d
//   operations per unmasked (q, k) pair, 103 and 137 GFLOP against 170 and
//   203 MB moved, so both are bound by tensor-core operations (0.104 and
//   0.139 ms at 989 TFLOP/s; the bytes take 0.051 and 0.061 ms).  So every
//   product is a bf16 `mma.sync.m16n8k16` with an f32 accumulator, fed by
//   `ldmatrix` from bf16 tiles whose 16-byte chunks are XOR-swizzled by row
//   (no bank conflicts, no pad).  One block of 4 warps per (b*h, 64-row
//   tile), each warp owning 16 rows.  The f32 accumulator of s = q k^T (s^T
//   = k q^T in dk/dv) is the exact register layout of the next product's A
//   operand: p and ds are computed and rounded to bf16 in registers and
//   never touch shared memory.  The streamed tiles (K and V for dq; Q, dO,
//   lse and delta for dk/dv) go through a two-stage ring filled by
//   `cp.async` (16 B a thread; rows past s zero-filled), so tile t+1 loads
//   while tile t's products run.  Operands whose rows or strides are not
//   16-byte aligned fill the same tiles with ordinary loads (the ASYNC=false
//   instantiation).  Only the tiles that cross the causal diagonal or a
//   ragged edge evaluate the mask.  dq walks the last Q tiles first and
//   dk/dv the first K tiles first: under the causal mask those have the most
//   work.  Head dims d <= D in {32, 64, 128} are zero-padded in shared
//   memory.  A warp takes its 16 x 64 score tile in two stripes of 32
//   columns, which holds a thread to 168 registers at D <= 64 (3 blocks, 12
//   warps an SM; the A operands q and do, or k and v, stay in registers) and
//   keeps D = 128 unspilled (its A operands are read from shared memory for
//   each tile).  Left for later: `wgmma` with TMA and warp specialisation (a
//   producer warp, 64-row warpgroup products with B from shared memory),
//   which the card needs for its full tensor-core rate.
// * float32: the first version's FMA body (`flash_bwd_dq_kernel`,
//   `flash_bwd_dkv_kernel`), products as f32 FMA on the CUDA cores.  It
//   keeps full f32 products, which TF32 tensor cores would not: the f32
//   training parity holds parameters within 1e-5.  8 warps per (b*h,
//   64-row tile), tiles staged as f32 with a one-word row pad.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk,
                                        int causal, int q_off, int k_off) {
  bool ok = qpos < sq && kpos < sk;
  if (causal)
    ok = ok && ((long long)k_off + kpos <= (long long)q_off + qpos);
  return ok;
}

// ---------------------------------------------------------------------------
// float32: the FMA body
// ---------------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int ROWS = 64 / WARPS;   // tile rows per warp

// Stage rows [row0, row0 + NROWS) of one (s, d) slice, row stride `ss`,
// into shared memory as f32 rows of LD words; rows past `s` and columns
// past `d` are zero.
template <int NROWS, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int s, int d,
                                          long long ss, int tid) {
  for (int e = tid; e < NROWS * D; e += WARPS * 32) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (row0 + r < s && c < d) x = src[(long long)(row0 + r) * ss + c];
    dst[r * LD + c] = x;
  }
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
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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

  const float* qb = q + b * qsb + hh * qsh;
  const float* kb = k + b * ksb + hh * ksh;
  const float* vb = v + b * vsb + hh * vsh;
  const float* dob = dout + b * dsb + hh * dsh;

  load_tile<BLOCK_Q, D, LD>(s_q, qb, q0, sq, d, qss, tid);
  load_tile<BLOCK_Q, D, LD>(s_do, dob, q0, sq, d, dss, tid);

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
    load_tile<BLOCK_K, D, LD>(s_k, kb, k0, sk, d, kss, tid);
    load_tile<BLOCK_K, D, LD>(s_v, vb, k0, sk, d, vss, tid);
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
        s_ds[(r0 + r) * PLD + lane + 32 * j] =
            p * (dp[r][j] - delta_r[r]) * scale;
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
    float* out = dq + (((long long)b * sq + row) * h + hh) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) out[c] = acc[r][i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int h, int sq, int sk, int d,
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

  const float* qb = q + b * qsb + hh * qsh;
  const float* kb = k + b * ksb + hh * ksh;
  const float* vb = v + b * vsb + hh * vsh;
  const float* dob = dout + b * dsb + hh * dsh;

  load_tile<BLOCK_K, D, LD>(s_k, kb, k0, sk, d, kss, tid);
  load_tile<BLOCK_K, D, LD>(s_v, vb, k0, sk, d, vss, tid);

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
    load_tile<BLOCK_Q, D, LD>(s_q, qb, q0, sq, d, qss, tid);
    load_tile<BLOCK_Q, D, LD>(s_do, dob, q0, sq, d, dss, tid);
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
        s_p[(r0 + r) * PLD + qi] = p;
        s_ds[(r0 + r) * PLD + qi] = p * (dp[r][j] - delta_j) * scale;
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
        dk[off + col] = acc_k[r][c];
        dv[off + col] = acc_v[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int STAGES = 2;                 // the streamed tiles' ring
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte chunk index of (row r, chunk c) in a bf16 tile of D columns.
// Chunks are XOR-swizzled so that the eight rows an ldmatrix phase reads
// at one logical chunk fall in eight different bank groups; with D = 32
// two rows share a 128-byte line and the line index does the XOR.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = D / 8;              // chunks per row
  if constexpr (CPR >= 8) {
    return r * CPR + (c ^ (r & 7));
  } else {
    const int line = r >> 1, pos = ((r & 1) << 2) | c;
    return line * 8 + (pos ^ (line & 7));
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, round to nearest even (as
// `.astype(bfloat16)`), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Rows [row0, row0 + NROWS) of one (s, d) slice, row stride `ss`
// elements, into a swizzled bf16 tile of D columns; rows past `s` and
// columns past `d` are zero.  ASYNC: one cp.async of 16 bytes a chunk
// (needs d % 8 == 0 and 16-byte aligned rows), zero-filled by a source
// size of 0; else ordinary loads into the same layout, one chunk at a
// time (this route is for odd shapes, and holding every chunk's loads in
// flight would spill the D = 128 kernels).
template <int D, bool ASYNC, int NROWS>
__device__ __forceinline__ void load_tile_tc(bf16* tile, const bf16* src,
                                             int row0, int s, int d,
                                             long long ss, int tid) {
  constexpr int CPR = D / 8;
  constexpr int RSTEP = TC_THREADS / CPR;  // rows between a thread's chunks
  static_assert(TC_THREADS % CPR == 0 && NROWS % RSTEP == 0,
                "whole rows a pass");
  // a thread's chunks sit at one column c, rows r, r + RSTEP, ...: RSTEP
  // is a multiple of 8 rows, so they share one swizzle and lie a fixed
  // stride apart in the tile
  const int r = tid / CPR, c = tid % CPR;
  const uint32_t dst = smem_addr(tile) + swz<D>(r, c) * 16;
  const bf16* g = src + (long long)(row0 + r) * ss + c * 8;
  if constexpr (ASYNC) {
#pragma unroll
    for (int i = 0; i < NROWS / RSTEP; ++i) {
      const bool in = row0 + r + i * RSTEP < s && c * 8 < d;
      cp_async16(dst + i * RSTEP * CPR * 16,
                 in ? g + (long long)i * RSTEP * ss : src, in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < NROWS / RSTEP; ++i) {
      const bool in = row0 + r + i * RSTEP < s;
      const bf16* p = g + (long long)i * RSTEP * ss;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * 8 + 2 * j;
        const float lo = in && col < d ? __bfloat162float(p[2 * j]) : 0.f;
        const float hi =
            in && col + 1 < d ? __bfloat162float(p[2 * j + 1]) : 0.f;
        w[j] = pack_bf16(lo, hi);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dst + i * RSTEP * CPR * 16), "r"(w[0]), "r"(w[1]),
                      "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// 64 f32 of one (b*h) row of lse or delta from position row0, zero past
// `s`: the first 64 threads copy lse, the next 64 delta
__device__ __forceinline__ void load_rows_f32(float* s_lse, float* s_delta,
                                              const float* lse,
                                              const float* delta, int row0,
                                              int s, int tid) {
  const int i = tid & 63;
  const bool in = row0 + i < s;
  const float* src = tid < 64 ? lse : delta;
  float* dst = tid < 64 ? s_lse : s_delta;
  cp_async4(smem_addr(dst + i), in ? src + row0 + i : src, in ? 4 : 0);
}

// The A operands that stay in registers across the streamed tiles when
// D <= 64 (q and do in dq; k and v in dk/dv); at D = 128 they are read
// from shared memory one 16-column slice at a time, for each tile.
template <int D>
constexpr bool A_RESIDENT = D <= 64;
// Columns of the 64-wide score tile (keys in dq, queries in dk/dv) that a
// warp holds at once: two stripes of 32 keep the scores, the f32
// accumulators (16 x D, two of them in dk/dv) and the A fragments in
// few enough registers for 3 blocks an SM at D <= 64 (168 registers a
// thread) and for no spill at D = 128 (one block an SM).
constexpr int STRIPE = 32;
constexpr int NT = STRIPE / 8;            // n-tiles of a stripe
template <int D>
constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;

// The A fragment (16 x 16, bf16) of rows [row0, row0 + 16) and columns
// [16 ks, 16 ks + 16) of a swizzled tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile,
                                       int row0, int ks, int lane) {
  ldsm_x4(a, tile + swz<D>(row0 + (lane & 15), 2 * ks + (lane >> 4)) * 16);
}

// The fragments of rows [row0, row0 + 16) of a tile that mma_abt reads
// when A_RESIDENT (and nothing otherwise)
template <int D>
__device__ __forceinline__ void hold_a(uint32_t (&held)[D / 16][4],
                                       uint32_t tile, int row0, int lane) {
  if constexpr (A_RESIDENT<D>) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      load_a<D>(held[ks], tile, row0, ks, lane);
  }
}

// acc (16 x STRIPE) = a (16 x D) . t[n0 : n0 + STRIPE]^T, where t is a 64 x D
// tile (t's rows are acc's columns): s = q k^T, dp = do v^T, s^T = k q^T,
// dp^T = v do^T.  a is rows [row0, row0 + 16) of the tile at a_tile, or,
// when A_RESIDENT, the fragments `held` loaded from there once.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint32_t (&held)[D / 16][4],
                                        uint32_t a_tile, int row0,
                                        uint32_t tile, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    if constexpr (A_RESIDENT<D>) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = held[ks][i];
    } else {
      load_a<D>(a, a_tile, row0, ks, lane);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile + swz<D>(n0 + np * 16 + (lane & 7) + ((mi >> 1) << 3),
                               2 * ks + (mi & 1)) * 16);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += a (16 x 16 KS) . t[k0 : k0 + 16 KS], where t is a 64 x D
// tile read along its rows (ldmatrix.trans): dq += ds k, dv += p^T do,
// dk += ds^T q
template <int D, int KS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[KS][4],
                                       uint32_t tile, int k0, int lane) {
  const int mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile + swz<D>(k0 + kk * 16 + (lane & 7) +
                                         ((mi & 1) << 3),
                                     2 * dp + (mi >> 1)) * 16);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// A 16 x STRIPE f32 accumulator as the bf16 A fragments of a product over
// its columns: n-tiles 2kk and 2kk+1 make k-slice kk
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4],
                                     const float (&x)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Store a 16 x D f32 accumulator (rows row0 + lane/4 and + 8 of a
// contiguous (b, s, h, d) bf16 output) as bf16; rows past s and columns
// past d are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[D / 8][4],
                                           int b, int hh, int h, int s,
                                           int d, int row0, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + (lane >> 2) + 8 * half;
    if (row >= s) continue;
    bf16* o = out + (((long long)b * s + row) * h + hh) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      const float lo = acc[j][2 * half], hi = acc[j][2 * half + 1];
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < d) o[col] = __float2bfloat16(lo);
        if (col + 1 < d) o[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  // q and do tiles, then STAGES x (k tile, v tile), all bf16
  return sizeof(bf16) * (2 * BLOCK_Q * D + STAGES * 2 * BLOCK_K * D);
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // k and v tiles, STAGES x (q tile, do tile), bf16; STAGES x (lse, delta)
  return sizeof(bf16) * (2 * BLOCK_K * D + STAGES * 2 * BLOCK_Q * D) +
         sizeof(float) * STAGES * 2 * BLOCK_Q;
}

template <int D, bool ASYNC>
__global__ void __launch_bounds__(TC_THREADS, MIN_BLOCKS<D>)
flash_bwd_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int h, int sq, int sk, int d,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       long long dsb, long long dss, long long dsh,
                       int causal, int q_off, int k_off, float scale) {
  constexpr int TILE = BLOCK_K * D;       // elements of one tile
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);
  bf16* s_do = s_q + TILE;
  bf16* s_kv = s_do + TILE;               // stage i: k at 2i, v at 2i + 1

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  // the last Q tiles see the most keys under the causal mask: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16;               // this warp's query rows

  const bf16* qb = q + b * qsb + hh * qsh;
  const bf16* kb = k + b * ksb + hh * ksh;
  const bf16* vb = v + b * vsb + hh * vsh;
  const bf16* dob = dout + b * dsb + hh * dsh;

  const int n_k = (sk + BLOCK_K - 1) / BLOCK_K;
  int kt_end = n_k;
  if (causal) {
    const long long last =
        (long long)q_off + min(q0 + BLOCK_Q, sq) - 1 - k_off;
    const long long lim = last < 0 ? 0 : last / BLOCK_K + 1;
    kt_end = (int)min((long long)n_k, lim);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (kt_end > 0) {
    load_tile_tc<D, ASYNC, BLOCK_Q>(s_q, qb, q0, sq, d, qss, tid);
    load_tile_tc<D, ASYNC, BLOCK_Q>(s_do, dob, q0, sq, d, dss, tid);
    load_tile_tc<D, ASYNC, BLOCK_K>(s_kv, kb, 0, sk, d, kss, tid);
    load_tile_tc<D, ASYNC, BLOCK_K>(s_kv + TILE, vb, 0, sk, d, vss, tid);
    cp_async_commit();

    // lse (pre-scaled by log2 e) and delta of rows lane/4 and + 8
    float lse2[2], delta_r[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + (lane >> 2) + 8 * half;
      const bool in = row < sq;
      lse2[half] = in ? lse[(long long)bh * sq + row] * LOG2E : 0.f;
      delta_r[half] = in ? delta[(long long)bh * sq + row] : 0.f;
    }
    const float scale2 = scale * LOG2E;
    const uint32_t a_q = smem_addr(s_q), a_do = smem_addr(s_do);
    uint32_t qf[D / 16][4], dof[D / 16][4];

    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * BLOCK_K;
      if (kt + 1 < kt_end) {              // prefetch tile kt + 1
        bf16* st = s_kv + ((kt + 1) % STAGES) * 2 * TILE;
        load_tile_tc<D, ASYNC, BLOCK_K>(st, kb, k0 + BLOCK_K, sk, d, kss,
                                        tid);
        load_tile_tc<D, ASYNC, BLOCK_K>(st + TILE, vb, k0 + BLOCK_K, sk, d,
                                        vss, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();                 // all but tile kt + 1 landed
      __syncthreads();

      if (kt == 0) {
        hold_a<D>(qf, a_q, r0, lane);
        hold_a<D>(dof, a_do, r0, lane);
      }
      const uint32_t a_k = smem_addr(s_kv + (kt % STAGES) * 2 * TILE);
      const uint32_t a_v = a_k + TILE * sizeof(bf16);
      const bool edge =
          k0 + BLOCK_K > sk ||
          (causal && (long long)k_off + k0 + BLOCK_K - 1 >
                         (long long)q_off + q0);

#pragma unroll 1
      for (int c0 = 0; c0 < BLOCK_K; c0 += STRIPE) {   // keys c0 ...
        float s[NT][4], dp[NT][4];
        mma_abt<D>(s, qf, a_q, r0, a_k, c0, lane);      // s = q k^T
        mma_abt<D>(dp, dof, a_do, r0, a_v, c0, lane);   // dp = do v^T

        // ds = p (dp - delta) scale, p = exp(s scale - lse), in place in
        // dp; only the tiles on the diagonal or a ragged edge mask
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[j][e], scale2, -lse2[e >> 1]));
            if (edge) {
              const int qpos = q0 + r0 + (lane >> 2) + 8 * (e >> 1);
              const int kpos = k0 + c0 + j * 8 + 2 * (lane & 3) + (e & 1);
              if (!visible(qpos, kpos, sq, sk, causal, q_off, k_off))
                p = 0.f;
            }
            dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
          }
        }
        uint32_t dsf[NT / 2][4];
        to_a(dsf, dp);
        mma_ab<D, NT / 2>(acc, dsf, a_k, c0, lane);          // dq += ds k
      }
      __syncthreads();                    // before this stage is refilled
    }
  }
  cp_async_wait<0>();
  store_rows<D>(dq, acc, b, hh, h, sq, d, q0 + r0, lane);
}

template <int D, bool ASYNC>
__global__ void __launch_bounds__(TC_THREADS, MIN_BLOCKS<D>)
flash_bwd_dkv_kernel_tc(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int h,
                        int sq, int sk, int d,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        long long dsb, long long dss, long long dsh,
                        int causal, int q_off, int k_off, float scale) {
  constexpr int TILE = BLOCK_Q * D;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_tc);
  bf16* s_v = s_k + TILE;
  bf16* s_qdo = s_v + TILE;               // stage i: q at 2i, do at 2i + 1
  float* s_rows = reinterpret_cast<float*>(s_qdo + STAGES * 2 * TILE);
  // stage i: lse at s_rows + 2i * BLOCK_Q, delta at (2i + 1) * BLOCK_Q

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  // the first K tiles see the most queries under the causal mask: first
  const int k0 = blockIdx.y * BLOCK_K;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16;               // this warp's key rows

  const bf16* qb = q + b * qsb + hh * qsh;
  const bf16* kb = k + b * ksb + hh * ksh;
  const bf16* vb = v + b * vsb + hh * vsh;
  const bf16* dob = dout + b * dsb + hh * dsh;
  const float* lse_b = lse + (long long)bh * sq;
  const float* delta_b = delta + (long long)bh * sq;

  const int n_q = (sq + BLOCK_Q - 1) / BLOCK_Q;
  int qt_begin = 0;
  if (causal) {
    const long long first = (long long)k_off + k0 - q_off;
    qt_begin = first <= 0 ? 0 : (int)min((long long)n_q, first / BLOCK_Q);
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }

  if (qt_begin < n_q) {
    load_tile_tc<D, ASYNC, BLOCK_K>(s_k, kb, k0, sk, d, kss, tid);
    load_tile_tc<D, ASYNC, BLOCK_K>(s_v, vb, k0, sk, d, vss, tid);
    const int first_q0 = qt_begin * BLOCK_Q;
    load_tile_tc<D, ASYNC, BLOCK_Q>(s_qdo, qb, first_q0, sq, d, qss, tid);
    load_tile_tc<D, ASYNC, BLOCK_Q>(s_qdo + TILE, dob, first_q0, sq, d, dss,
                                    tid);
    load_rows_f32(s_rows, s_rows + BLOCK_Q, lse_b, delta_b, first_q0, sq,
                  tid);
    cp_async_commit();

    const float scale2 = scale * LOG2E;
    const uint32_t a_kt = smem_addr(s_k), a_vt = smem_addr(s_v);
    uint32_t kf[D / 16][4], vf[D / 16][4];

    for (int qt = qt_begin; qt < n_q; ++qt) {
      const int q0 = qt * BLOCK_Q;
      const int stage = (qt - qt_begin) % STAGES;
      if (qt + 1 < n_q) {                 // prefetch tile qt + 1
        const int nxt = (qt + 1 - qt_begin) % STAGES;
        bf16* st = s_qdo + nxt * 2 * TILE;
        load_tile_tc<D, ASYNC, BLOCK_Q>(st, qb, q0 + BLOCK_Q, sq, d, qss,
                                        tid);
        load_tile_tc<D, ASYNC, BLOCK_Q>(st + TILE, dob, q0 + BLOCK_Q, sq, d,
                                        dss, tid);
        load_rows_f32(s_rows + nxt * 2 * BLOCK_Q,
                      s_rows + (nxt * 2 + 1) * BLOCK_Q, lse_b, delta_b,
                      q0 + BLOCK_Q, sq, tid);
      }
      cp_async_commit();
      cp_async_wait<1>();                 // all but tile qt + 1 landed
      __syncthreads();

      if (qt == qt_begin) {
        hold_a<D>(kf, a_kt, r0, lane);
        hold_a<D>(vf, a_vt, r0, lane);
      }
      const uint32_t a_q = smem_addr(s_qdo + stage * 2 * TILE);
      const uint32_t a_do = a_q + TILE * sizeof(bf16);
      const float* s_lse = s_rows + stage * 2 * BLOCK_Q;
      const float* s_delta = s_lse + BLOCK_Q;

      const bool edge =
          q0 + BLOCK_Q > sq || k0 + BLOCK_K > sk ||
          (causal && (long long)k_off + k0 + BLOCK_K - 1 >
                         (long long)q_off + q0);

#pragma unroll 1
      for (int c0 = 0; c0 < BLOCK_Q; c0 += STRIPE) {   // queries c0 ...
        float s[NT][4], dp[NT][4];
        mma_abt<D>(s, kf, a_kt, r0, a_q, c0, lane);     // s^T = k q^T
        mma_abt<D>(dp, vf, a_vt, r0, a_do, c0, lane);   // dp^T = v do^T

        // p^T in place in s; ds^T = p^T (dp^T - delta) scale in place in
        // dp; lse and delta belong to the columns (queries)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = c0 + j * 8 + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(s_lse + col);
          const float2 dl = *reinterpret_cast<const float2*>(s_delta + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lse_c = (e & 1) ? l2.y : l2.x;
            const float delta_c = (e & 1) ? dl.y : dl.x;
            float p = exp2f(fmaf(s[j][e], scale2, -lse_c * LOG2E));
            if (edge) {
              const int kpos = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
              const int qpos = q0 + col + (e & 1);
              if (!visible(qpos, kpos, sq, sk, causal, q_off, k_off))
                p = 0.f;
            }
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta_c) * scale;
          }
        }
        uint32_t pf[NT / 2][4], dsf[NT / 2][4];
        to_a(pf, s);
        to_a(dsf, dp);
        mma_ab<D, NT / 2>(acc_v, pf, a_do, c0, lane);   // dv += p^T do
        mma_ab<D, NT / 2>(acc_k, dsf, a_q, c0, lane);   // dk += ds^T q
      }
      __syncthreads();                    // before this stage is refilled
    }
  }
  cp_async_wait<0>();
  store_rows<D>(dk, acc_k, b, hh, h, sk, d, k0 + r0, lane);
  store_rows<D>(dv, acc_v, b, hh, h, sk, d, k0 + r0, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;   // dq; or dk and dv
  int b, h, sq, sk, d;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int causal, q_off, k_off;
  float scale;
  cudaStream_t stream;
};

// Raise a kernel's dynamic shared memory limit once, before its first
// launch (needed above 48 KB).
template <typename Kernel>
int configure(Kernel kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  if (int err = configure(flash_bwd_dq_kernel<D>, smem, configured))
    return err;
  dim3 grid(a.b * a.h, (a.sq + BLOCK_Q - 1) / BLOCK_Q);
  flash_bwd_dq_kernel<D><<<grid, WARPS * 32, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.out0, a.h, a.sq, a.sk, a.d, a.qsb, a.qss, a.qsh, a.ksb,
      a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.dsb, a.dss, a.dsh, a.causal,
      a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  if (int err = configure(flash_bwd_dkv_kernel<D>, smem, configured))
    return err;
  dim3 grid(a.b * a.h, (a.sk + BLOCK_K - 1) / BLOCK_K);
  flash_bwd_dkv_kernel<D><<<grid, WARPS * 32, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (float*)a.out0, (float*)a.out1, a.h, a.sq, a.sk, a.d, a.qsb, a.qss,
      a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.dsb, a.dss, a.dsh,
      a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D, bool ASYNC>
int launch_dq_tc(const Args& a) {
  constexpr size_t smem = dq_tc_smem_bytes<D>();
  static bool configured = false;
  if (int err = configure(flash_bwd_dq_kernel_tc<D, ASYNC>, smem, configured))
    return err;
  dim3 grid(a.b * a.h, (a.sq + BLOCK_Q - 1) / BLOCK_Q);
  flash_bwd_dq_kernel_tc<D, ASYNC><<<grid, TC_THREADS, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.out0, a.h, a.sq, a.sk, a.d, a.qsb, a.qss, a.qsh, a.ksb, a.kss,
      a.ksh, a.vsb, a.vss, a.vsh, a.dsb, a.dss, a.dsh, a.causal, a.q_off,
      a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D, bool ASYNC>
int launch_dkv_tc(const Args& a) {
  constexpr size_t smem = dkv_tc_smem_bytes<D>();
  static bool configured = false;
  if (int err =
          configure(flash_bwd_dkv_kernel_tc<D, ASYNC>, smem, configured))
    return err;
  dim3 grid(a.b * a.h, (a.sk + BLOCK_K - 1) / BLOCK_K);
  flash_bwd_dkv_kernel_tc<D, ASYNC><<<grid, TC_THREADS, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dout, (const float*)a.lse, (const float*)a.delta,
      (bf16*)a.out0, (bf16*)a.out1, a.h, a.sq, a.sk, a.d, a.qsb, a.qss,
      a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.dsb, a.dss, a.dsh,
      a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D, bool ASYNC>
int tc(const Args& a, bool dkv) {
  return dkv ? launch_dkv_tc<D, ASYNC>(a) : launch_dq_tc<D, ASYNC>(a);
}

template <int D>
int tc_route(const Args& a, bool dkv) {
  // cp.async moves 16-byte chunks: every row of q, k, v and do must start
  // on 16 bytes (8 bf16) and end on a chunk or at d
  bool aligned = a.d % 8 == 0;
  for (const void* p : {a.q, a.k, a.v, a.dout})
    aligned = aligned && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  for (long long s : {a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss,
                      a.vsh, a.dsb, a.dss, a.dsh})
    aligned = aligned && s % 8 == 0;
  return aligned ? tc<D, true>(a, dkv) : tc<D, false>(a, dkv);
}

int run(int dtype, const Args& a, bool dkv) {
  if (a.b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {            // float32: the FMA body
    if (a.d <= 32) return dkv ? launch_dkv<32>(a) : launch_dq<32>(a);
    if (a.d <= 64) return dkv ? launch_dkv<64>(a) : launch_dq<64>(a);
    if (a.d <= 128) return dkv ? launch_dkv<128>(a) : launch_dq<128>(a);
  } else if (dtype == 1) {     // bfloat16: the tensor-core body
    if (a.d <= 32) return tc_route<32>(a, dkv);
    if (a.d <= 64) return tc_route<64>(a, dkv);
    if (a.d <= 128) return tc_route<128>(a, dkv);
  }
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
