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
// (not -inf) and the final l is clamped at 1e-30, as in the TPU kernel;
// lse is a natural log in f32, and o is cast to q's type after the
// division by l.
//
// Two bodies, chosen by the dtype (`run`):
//
// * bfloat16: the tensor-core body (`flash_fwd_kernel_tc<D, ASYNC>`).
//   What bounds it on the H100: at the training shape (b 8, s 2048, h 16,
//   d 64, causal) the two products take 2 d operations each per unmasked
//   (q, k) pair, 68.7 GFLOP against 135 MB moved: 0.0695 ms at 989
//   TFLOP/s against 0.040 ms for the bytes at 3.35 TB/s, so tensor-core
//   operations bound it (at b 1 the same: 0.0087 against 0.0050 ms).  So
//   both products are bf16 `mma.sync.m16n8k16` with f32 sums, fed by
//   `ldmatrix` from bf16 tiles whose 16-byte chunks are XOR-swizzled by
//   row (mma.cuh).  One block of 4 warps per (b*h, 64-row Q tile), each
//   warp owning 16 query rows, at most 128 registers a thread and 40 KB of
//   shared memory: 4 blocks (16 warps) an SM at D <= 64.  A timed probe
//   on the card (scripts/tc_probe.py) chose this over 8 warps on 128-row
//   tiles, which share each K and V tile among twice the rows and halve
//   its copies into shared memory, but were 5 % slower at the training
//   shape and 9 % at one sequence: every warp still reads each K and V
//   fragment from shared memory, and those reads, not the copies, cost
//   the tile; smaller blocks balance better under the causal mask.  A
//   3-stage ring gained nothing and spilled.  The ordinary-load
//   instantiation at D = 64 asks for 3 blocks an SM (at 4 it spilled 28
//   bytes), and D = 128 for 1.  A warp loads its Q fragments once with
//   `ldmatrix` and keeps them in registers.  K
//   and V tiles stream through a two-stage ring filled by `cp.async` (16 B
//   a thread, rows past sk zero-filled), so tile t+1 loads while tile t's
//   products run; rows or strides that are not 16-byte aligned fill the
//   same tiles with ordinary loads (ASYNC=false).  s = q k^T reads K rows
//   as they lie; the scale is applied in f32 after the product, folded
//   with log2 e into one multiply before `exp2f`, as the backward does, so
//   the backward's recomputed p matches this lse.  The online softmax
//   runs on the accumulator fragment, where a row lives in the 4 lanes of
//   a quad: its max and sum are two `__shfl_xor`s.  p is rounded to bf16
//   in registers and becomes the A fragment of p v (V read with
//   `ldmatrix.trans`); it never reaches shared memory.  l sums the f32 p,
//   before the rounding.  Only the tiles that cross the causal diagonal or
//   the key edge evaluate the mask; tiles wholly above the diagonal are
//   never loaded, and a warp whose 16 rows all lie above a tile skips its
//   products.  The heaviest Q tiles (the last, under the causal mask) are
//   walked first.  Head dims d <= D in {32, 64, 128} are zero-padded in
//   shared memory.  Left for later: `wgmma` with TMA and a producer warp.
// * float32: the first version's FMA body (`flash_fwd_kernel<D>`), products
//   as f32 FMA on the CUDA cores, which keeps full f32 products for the
//   f32 parity bounds.  One block of 8 warps per (b*h, 64-row Q tile); Q,
//   K and V staged in shared memory as f32 with a one-word row pad; each
//   warp owns 8 query rows, each lane two key columns of the 64-wide score
//   tile and head_dim/32 output columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "mma.cuh"

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int b, h, sq, sk, d;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
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

// ---------------------------------------------------------------------------
// float32: the FMA body
// ---------------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int ROWS = BLOCK_Q / WARPS;   // query rows per warp

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
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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

  const float* qb = q + b * qsb + hh * qsh;
  const float* kb = k + b * ksb + hh * ksh;
  const float* vb = v + b * vsb + hh * vsh;

  // q is scaled after it is staged, as the TPU kernel does
  for (int e = tid; e < BLOCK_Q * D; e += WARPS * 32) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (q0 + r < sq && c < d) x = qb[(q0 + r) * qss + c] * scale;
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
        xk = kb[(k0 + r) * kss + c];
        xv = vb[(k0 + r) * vss + c];
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
    float* orow = o + (((long long)b * sq + row) * h + hh) * d;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = acc[r][i] / lc;
    }
    if (lane == 0) lse[(long long)bh * sq + row] = m[r] + logf(lc);
  }
}

template <int D>
int launch(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (int err = configure(flash_fwd_kernel<D>, smem, configured)) return err;
  dim3 grid(a.b * a.h, (a.sq + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<D><<<grid, WARPS * 32, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      (float*)a.lse, a.h, a.sq, a.sk, a.d, a.qsb, a.qss, a.qsh, a.ksb, a.kss,
      a.ksh, a.vsb, a.vss, a.vsh, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body (building blocks in mma.cuh)
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;               // each owns 16 query rows
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BLOCK_Q = 16 * TC_WARPS;
constexpr int TC_BLOCK_K = 64;
constexpr int STAGES = 2;                 // the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF2 = NEG_INF * LOG2E;   // a masked score, log2 units
constexpr int TC_MIN_BLOCKS_64 = 4;      // blocks an SM at D <= 64
// ordinary loads hold more in flight: fewer blocks, or they spill
template <int D, bool ASYNC>
constexpr int TC_MIN_BLOCKS =
    D <= 64 ? (ASYNC ? TC_MIN_BLOCKS_64 : TC_MIN_BLOCKS_64 - 1) : 1;

template <int D>
constexpr size_t tc_smem_bytes() {
  // the Q tile, then STAGES x (K tile, V tile), all bf16
  return sizeof(bf16) * (TC_BLOCK_Q * D + STAGES * 2 * TC_BLOCK_K * D);
}

template <int D, bool ASYNC>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS<D, ASYNC>)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int h, int sq, int sk, int d,
                    long long qsb, long long qss, long long qsh,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    int causal, int q_off, int k_off, float scale) {
  constexpr int KT = TC_BLOCK_K * D;      // elements of a K or V tile
  constexpr int NT = TC_BLOCK_K / 8;      // n-tiles of a warp's scores
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);
  bf16* s_kv = s_q + TC_BLOCK_Q * D;      // stage i: k at 2i, v at 2i + 1

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  // the last Q tiles see the most keys under the causal mask: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BLOCK_Q;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16;               // this warp's query rows

  const bf16* qb = q + b * qsb + hh * qsh;
  const bf16* kb = k + b * ksb + hh * ksh;
  const bf16* vb = v + b * vsb + hh * vsh;

  const int n_k = (sk + TC_BLOCK_K - 1) / TC_BLOCK_K;
  int kt_end = n_k;
  if (causal) {
    const long long last =
        (long long)q_off + min(q0 + TC_BLOCK_Q, sq) - 1 - k_off;
    const long long lim = last < 0 ? 0 : last / TC_BLOCK_K + 1;
    kt_end = (int)min((long long)n_k, lim);
  }
  // the global position of this warp's first query row
  const long long w_pos = (long long)q_off + q0 + r0;

  // rows lane/4 and + 8 of the warp: the running max (log2 units), this
  // lane's part of the running sum, and the output accumulator
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m2[2] = {NEG_INF2, NEG_INF2}, l[2] = {0.f, 0.f};

  if (kt_end > 0) {
    load_tile_tc<D, ASYNC, TC_BLOCK_Q, TC_THREADS>(s_q, qb, q0, sq, d, qss,
                                                   tid);
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < kt_end) {
        bf16* st = s_kv + t * 2 * KT;
        load_tile_tc<D, ASYNC, TC_BLOCK_K, TC_THREADS>(
            st, kb, t * TC_BLOCK_K, sk, d, kss, tid);
        load_tile_tc<D, ASYNC, TC_BLOCK_K, TC_THREADS>(
            st + KT, vb, t * TC_BLOCK_K, sk, d, vss, tid);
      }
      cp_async_commit();
    }

    const float scale2 = scale * LOG2E;
    const int mi = lane >> 3;
    uint32_t qf[D / 16][4];

    for (int kt = 0; kt < kt_end; ++kt) {
      const int pre = kt + STAGES - 1;    // the tile to prefetch
      if (pre < kt_end) {
        bf16* st = s_kv + (pre % STAGES) * 2 * KT;
        load_tile_tc<D, ASYNC, TC_BLOCK_K, TC_THREADS>(
            st, kb, pre * TC_BLOCK_K, sk, d, kss, tid);
        load_tile_tc<D, ASYNC, TC_BLOCK_K, TC_THREADS>(
            st + KT, vb, pre * TC_BLOCK_K, sk, d, vss, tid);
      }
      cp_async_commit();
      cp_async_wait<STAGES - 1>();        // all but the newest tiles landed
      __syncthreads();

      if (kt == 0) {
        const uint32_t a_q = smem_addr(s_q);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          ldsm_x4(qf[ks],
                  a_q + swz<D>(r0 + (lane & 15), 2 * ks + (lane >> 4)) * 16);
      }
      const int k0 = kt * TC_BLOCK_K;
      // under the causal mask a tile whose first key lies past this
      // warp's last row adds nothing to rows that have seen a key
      const bool skip = causal && w_pos >= k_off &&
                        (long long)k_off + k0 > w_pos + 15;
      if (!skip) {
        const uint32_t a_k = smem_addr(s_kv + (kt % STAGES) * 2 * KT);
        const uint32_t a_v = a_k + KT * sizeof(bf16);

        // s = q k^T: B is K's rows as they lie
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t kf[4];
            ldsm_x4(kf, a_k + swz<D>(np * 16 + (lane & 7) + ((mi >> 1) << 3),
                                     2 * ks + (mi & 1)) * 16);
            mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
            mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
          }
        }

        // scaled to log2 units; only the tiles on the diagonal or the key
        // edge mask
        const bool edge =
            k0 + TC_BLOCK_K > sk ||
            (causal && (long long)k_off + k0 + TC_BLOCK_K - 1 > w_pos);
        float mx[2] = {m2[0], m2[1]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][e] * scale2;
            if (edge) {
              const int kpos = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
              const long long qpos = w_pos + (lane >> 2) + 8 * (e >> 1);
              if (kpos >= sk || (causal && (long long)k_off + kpos > qpos))
                x = NEG_INF2;
            }
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        // a row lives in the 4 lanes of a quad
        float alpha[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] = fmaxf(mx[half],
                           __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] = fmaxf(mx[half],
                           __shfl_xor_sync(0xffffffffu, mx[half], 2));
          alpha[half] = exp2f(m2[half] - mx[half]);
          m2[half] = mx[half];
          l[half] *= alpha[half];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[j][e] - m2[e >> 1]);
            s[j][e] = p;
            l[e >> 1] += p;
          }
        }

        // o += p v: p rounded to bf16 in registers, V read along its rows
        uint32_t pf[NT / 2][4];
        to_a<NT>(pf, s);
        mma_ab<D, NT / 2>(acc, pf, a_v, 0, lane);
      }
      __syncthreads();                    // before this stage is refilled
    }
  }
  cp_async_wait<0>();

  float lc[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    lc[half] = fmaxf(sum, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] /= lc[0];
    acc[j][1] /= lc[0];
    acc[j][2] /= lc[1];
    acc[j][3] /= lc[1];
  }
  store_rows<D>(o, acc, b, hh, h, sq, d, q0 + r0, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + (lane >> 2) + 8 * half;
      // a row that saw no key keeps the masked score itself
      const float m = m2[half] == NEG_INF2 ? NEG_INF : m2[half] * LN2;
      if (row < sq) lse[(long long)bh * sq + row] = m + logf(lc[half]);
    }
  }
}

template <int D, bool ASYNC>
int launch_tc(const Args& a) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static bool configured = false;
  if (int err = configure(flash_fwd_kernel_tc<D, ASYNC>, smem, configured))
    return err;
  dim3 grid(a.b * a.h, (a.sq + TC_BLOCK_Q - 1) / TC_BLOCK_Q);
  flash_fwd_kernel_tc<D, ASYNC><<<grid, TC_THREADS, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o,
      (float*)a.lse, a.h, a.sq, a.sk, a.d, a.qsb, a.qss, a.qsh, a.ksb, a.kss,
      a.ksh, a.vsb, a.vss, a.vsh, a.causal, a.q_off, a.k_off, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int tc_route(const Args& a) {
  // cp.async moves 16-byte chunks: every row of q, k and v must start on
  // 16 bytes (8 bf16) and end on a chunk or at d
  bool aligned = a.d % 8 == 0;
  for (const void* p : {a.q, a.k, a.v})
    aligned = aligned && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  for (long long s : {a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss,
                      a.vsh})
    aligned = aligned && s % 8 == 0;
  return aligned ? launch_tc<D, true>(a) : launch_tc<D, false>(a);
}

int run(int dtype, const Args& a) {
  if (a.b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {            // float32: the FMA body
    if (a.d <= 32) return launch<32>(a);
    if (a.d <= 64) return launch<64>(a);
    if (a.d <= 128) return launch<128>(a);
  } else if (dtype == 1) {     // bfloat16: the tensor-core body
    if (a.d <= 32) return tc_route<32>(a);
    if (a.d <= 64) return tc_route<64>(a);
    if (a.d <= 128) return tc_route<128>(a);
  }
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
  const Args a{q,   k,   v,   o,   lse, b,   h,      sq,    sk,    d,
               qsb, qss, qsh, ksb, kss, ksh, vsb,    vss,   vsh,   causal,
               q_off, k_off, scale, (cudaStream_t)stream};
  return run(dtype, a);
}
