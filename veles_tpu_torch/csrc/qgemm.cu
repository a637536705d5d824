// W8A16 GEMM for Hopper (sm_90a), written by hand: out = act((a @ q) *
// scale[N] + bias), int8 weights read as stored.
//
// Replaces the TPU kernel `_qmatmul_kernel` of veles_tpu/ops/qgemm.py (via
// `_qmatmul_pallas`): a (M, K) f32 or bf16 activations with a row stride,
// q (K, N) int8 weights, scale (N,) f32 per-output-channel dequant
// factors, bias (N,) f32 or bf16 or none; the result in f32 or bf16.
// Activations: linear, the Znicz scaled tanh tanh(x*0.6666)*1.7159,
// sigmoid, smooth relu log1p(exp(min(x, 30))), strict relu, and gelu in
// its tanh form (jax.nn.gelu's default), which the transformer MLP's
// up-projection fuses with its bias.  Every body widens q exactly (|q| <=
// 127 fits the mantissa of bf16 and f32), sums in f32, applies the
// per-output-channel scale once after the K loop (dot-then-scale, as the
// Pallas epilogue), then the bias and the activation, all in f32, and
// casts to the output dtype.  Ragged M, K and N edges are masked or
// zero-filled in the kernel, not padded.
//
// Three bodies, chosen by the activation dtype and M (`veles_qmatmul`):
//
// * bfloat16 at M > 16 (prefill): the tensor-core body
//   (`qmatmul_kernel_tc<A_ASYNC, Q_ASYNC>`).  What bounds it on the H100:
//   the products.  At the largest prefill bucket (M = 2048) a layer's four
//   calls do 2 M K N = 51.5 GFLOP against 80 MB moved: 0.052 ms at 989
//   TFLOP/s against 0.024 ms for the bytes at 3.35 TB/s (w1 alone: 0.0174
//   against 0.0075).  So the products are bf16 `mma.sync.m16n8k16` with
//   f32 sums (mma.cuh).  A block of 8 warps computes a 128 x 128 output tile, each
//   warp 64 x 32 of it, over K in steps of 32.  Each step's a tile (128 x
//   32 bf16) and q tile (32 x 128, still int8: a quarter of bf16's bytes,
//   as the TPU kernel DMAs it) stream through a 4-stage ring filled by
//   `cp.async` (16 bytes a thread, zero-filled past M, K and N), so three
//   steps load while one computes.  Each thread widens the 16 q bytes it
//   copied into a swizzled bf16 tile, one step ahead of the products and
//   double-buffered, so one barrier a step orders the ring, the widening
//   and the products.  The A fragments are read with `ldmatrix` from the
//   swizzled a tile, the B fragments with `ldmatrix.trans` from the (K, N)
//   widened tile.  Rows of a that are not 16-byte aligned (a or lda), and
//   q with N % 16 != 0 or an unaligned base, fill the same tiles with
//   ordinary loads (A_ASYNC or Q_ASYNC false).  64 KB of shared memory and
//   at most 128 registers a thread hold 2 blocks an SM.
// * bfloat16 at M <= 16 (decode; the 16-row prefill bucket): the decode
//   body (`qmatmul_kernel_dec<MT, BN>`).  What bounds it: the bytes of q.
//   CONFIG's block weights (K x N = 1024 x 3072, 1024 x 1024, 1024 x
//   4096, 4096 x 1024) are 12 582 912 int8 bytes a layer, 3.8 us at 3.35
//   TB/s; the FLOPs at M = 4 (101 MFLOP a layer) take 1.5 us even at the
//   CUDA cores' 67 TFLOP/s, 6 us at M = 16.  So the products stay f32 FMA
//   on the CUDA cores over the real rows (MT = 4, 8 or 16, the smallest
//   that holds M; the tensor cores would pad 4 rows to 16 and gain nothing
//   on a body that waits for bytes), and the design is about keeping
//   bytes in flight: a block owns a BN-column tile (BN = 128, one whole
//   128-byte line of q a K row, or 64 where 128 leaves SMs idle) and its
//   rank's K chunk, and issues the whole chunk at once, `cp.async` of 16
//   bytes a thread into a ring of 8 stages of 64 K rows (all of a rank's
//   chunk at CONFIG's decode shapes, so one memory round trip a block).
//   q stays int8 in shared memory; each thread widens the 4 bytes it reads
//   a row exactly in registers (2^23 + 128 + x has x + 128 in its low
//   byte) and sums 4 columns x MT rows over 8 (BN 128) or 4 (BN 64) K rows
//   a stage, a read as bf16 pairs.  The 8 or 16 row groups' sums are added
//   in order through shared memory and pushed into the shared memory of
//   the rank that owns them; after one cluster barrier each rank adds its
//   slice's partials in rank order and runs the epilogue, with the tile's
//   scales and biases read into shared memory while the stages loaded
//   (`ops/qgemm.py:decode_plan` picks BN and the split).
// * float32 at any M: the first version's body (`qmatmul_kernel<BM>`).  A
//   block computes a BM x 64 tile (BM = 16 for M <= 16, else 64), looping
//   over K in steps of 64: q is read as int8 (16 bytes a thread) and
//   widened to f32 in shared memory; the next step's tiles are loaded
//   into registers while this one's f32 FMA products run on the CUDA
//   cores.  It serves the f32 parity checks.
//
// Split K over a cluster (every body).  At decode (M = 4) the grid has
// N / BN column tiles, 8 for N = 1024 at BN 128, and at the small prefill
// buckets a few 128 x 128 tiles: far fewer than the 132 SMs that must
// pull the weights from memory.  So K is split over a thread block
// cluster of up to 8 blocks (`ops/qgemm.py:split_k`): each block sums its
// K range into shared memory, and after a cluster barrier each block
// reduces a slice of the tile from all the blocks' shared memory
// (distributed shared memory) in rank order and runs the epilogue on it
// (the decode body pushes the slices to their owners instead, above).
// No atomics and a fixed order: a launch gives the same bits every time.
// Unsplit, the tensor-core body runs the epilogue from its registers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

// a test build may plant a fault in the decode body's cluster reduction
// (1: the last rank's partial dropped; 2: the scale applied twice), which
// the card checks must report; 0 in every other build
#ifndef VELES_PLANTED_FAULT
#define VELES_PLANTED_FAULT 0
#endif

namespace {

constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;   // 16 x 16 threads, BM/16 x 4 outputs each
constexpr int APAD = 1;        // shared-memory row pad of the a tile

enum Act { LINEAR = 0, TANH = 1, SIGMOID = 2, RELU = 3, STRICT_RELU = 4,
           GELU = 5 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case TANH: return tanhf(x * 0.6666f) * 1.7159f;
    case SIGMOID: return 1.0f / (1.0f + expf(-x));
    case RELU: return log1pf(expf(fminf(x, 30.0f)));
    case STRICT_RELU: return fmaxf(x, 0.0f);
    case GELU: {
      const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.0f + tanhf(inner));
    }
    default: return x;
  }
}

template <int BM>
struct Smem {
  // the a tile [BK][BM + APAD] and the q tile [BK][BN] during the K loop;
  // the partial tile [BM][BN] after it
  static constexpr int LOOP = BK * (BM + APAD) + BK * BN;
  static constexpr int FLOATS = LOOP > BM * BN ? LOOP : BM * BN;
};

template <int BM>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const float* __restrict__ a, const int8_t* __restrict__ q,
               const float* __restrict__ scale, const void* __restrict__ bias,
               void* __restrict__ out, int m, int n, int k, int lda,
               int q_vec, int bias_bf16, int out_bf16, int act,
               int k_chunk) {
  constexpr int TM = BM / 16;                   // rows a thread owns
  constexpr int A_ELEMS = BM * BK / THREADS;    // a values a thread stages
  constexpr int AS = BM + APAD;                 // a tile row stride
  __shared__ __align__(16) float smem[Smem<BM>::FLOATS];
  float* As = smem;
  float* Bs = smem + BK * AS;
  float* Cs = smem;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = rank * k_chunk;
  const int ke = min(k, kb + k_chunk);
  const int qj = tid / 4, qc = (tid % 4) * 16;  // this thread's q bytes

  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  float ar[A_ELEMS];
  union { int4 v; int8_t b[16]; } qr;

  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < A_ELEMS; ++p) {
      const int e = tid + p * THREADS;
      const int row = m0 + e / BK, col = k0 + e % BK;
      ar[p] = (row < m && col < ke)
                  ? a[static_cast<size_t>(row) * lda + col]
                  : 0.0f;
    }
    const int kk = k0 + qj, nn = n0 + qc;
    const int8_t* src = q + static_cast<size_t>(kk) * n + nn;
    if (kk < ke && q_vec && nn + 16 <= n) {
      qr.v = *reinterpret_cast<const int4*>(src);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        qr.b[i] = (kk < ke && nn + i < n) ? src[i] : static_cast<int8_t>(0);
    }
  };

  if (kb < ke) load(kb);
  for (int k0 = kb; k0 < ke; k0 += BK) {
#pragma unroll
    for (int p = 0; p < A_ELEMS; ++p) {
      const int e = tid + p * THREADS;
      As[(e % BK) * AS + e / BK] = ar[p];
    }
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      *reinterpret_cast<float4*>(&Bs[qj * BN + qc + i]) = make_float4(
          static_cast<float>(qr.b[i]), static_cast<float>(qr.b[i + 1]),
          static_cast<float>(qr.b[i + 2]), static_cast<float>(qr.b[i + 3]));
    }
    __syncthreads();
    if (k0 + BK < ke) load(k0 + BK);   // the next tiles, in flight
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * 4]);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float av = As[kk * AS + ty * TM + r];
        acc[r][0] = fmaf(av, b.x, acc[r][0]);
        acc[r][1] = fmaf(av, b.y, acc[r][1]);
        acc[r][2] = fmaf(av, b.z, acc[r][2]);
        acc[r][3] = fmaf(av, b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }

  // this block's partial tile, visible to the whole cluster after the
  // barrier (the K loop ended in a block barrier, so Cs may alias it)
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Cs[(ty * TM + r) * BN + tx * 4 + c] = acc[r][c];
  cluster.sync();

  // each block reduces its slice of the tile over the cluster in rank
  // order, then the epilogue: scale once, bias, activation, cast
  const int chunk = BM * BN / split;
  for (int idx = rank * chunk + tid; idx < (rank + 1) * chunk;
       idx += THREADS) {
    float sum = 0.0f;
    for (int r = 0; r < split; ++r) sum += cluster.map_shared_rank(Cs, r)[idx];
    const int row = m0 + idx / BN, col = n0 + idx % BN;
    if (row < m && col < n) {
      float v = sum * scale[col];
      if (bias != nullptr)
        v += bias_bf16 ? __bfloat162float(
                             static_cast<const __nv_bfloat16*>(bias)[col])
                       : static_cast<const float*>(bias)[col];
      v = activate(v, act);
      const size_t o = static_cast<size_t>(row) * n + col;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <int BM>
cudaError_t launch(const float* a, const int8_t* q, const float* scale,
                   const void* bias, void* out, int m, int n, int k, int lda,
                   int q_vec, int bias_bf16, int out_bf16, int act, int split,
                   cudaStream_t stream) {
  const int k_tiles = (k + BK - 1) / BK;
  const int k_chunk = (k_tiles + split - 1) / split * BK;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + BN - 1) / BN, (m + BM - 1) / BM, split);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, qmatmul_kernel<BM>, a, q, scale,
                            bias, out, m, n, k, lda, q_vec, bias_bf16,
                            out_bf16, act, k_chunk);
}

// ---------------------------------------------------------------------------
// bfloat16 at M > 16: the tensor-core body (building blocks in mma.cuh)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;
constexpr int TC_BN = 128;
constexpr int TC_BK = 32;
constexpr int TC_THREADS = 256;          // 8 warps: 2 along M x 4 along N
constexpr int TC_STAGES = 4;             // the a / q ring
constexpr int WM = 64, WN = 32;          // a warp's part of the tile
constexpr int MT = WM / 16, NT = WN / 8; // its m16 and n8 tiles

struct TcSmem {
  // TC_STAGES x (a tile [BM][BK] bf16 swizzled, q tile [BK][BN] int8),
  // then two widened q tiles [BK][BN] bf16 swizzled; after the K loop the
  // partial f32 tile [BM][BN] of a split K aliases them
  static constexpr int A_BYTES = TC_BM * TC_BK * 2;
  static constexpr int Q_BYTES = TC_BK * TC_BN;
  static constexpr int STAGE = A_BYTES + Q_BYTES;
  static constexpr int W_BYTES = TC_BK * TC_BN * 2;
  static constexpr int LOOP = TC_STAGES * STAGE + 2 * W_BYTES;
  static constexpr int PART = TC_BM * TC_BN * 4;
  static constexpr int BYTES = LOOP > PART ? LOOP : PART;
};

// The epilogue of one output: scale once, bias, activation, all in f32.
__device__ __forceinline__ float epilogue(float acc, int col,
                                          const float* scale,
                                          const void* bias, int bias_bf16,
                                          int act) {
  float v = acc * scale[col];
  if (bias != nullptr)
    v += bias_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(bias)[col])
                   : static_cast<const float*>(bias)[col];
  return activate(v, act);
}

// Outputs (row, col) and (row, col + 1) of a contiguous (M, N) output,
// cast to its dtype; columns past n are dropped.
__device__ __forceinline__ void store_pair(void* out, int n, int row,
                                           int col, float v0, float v1,
                                           int out_bf16) {
  const size_t o = static_cast<size_t>(row) * n + col;
  const bool pair = col + 1 < n && (n & 1) == 0;
  if (out_bf16) {
    bf16* p = static_cast<bf16*>(out) + o;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      if (col < n) p[0] = __float2bfloat16_rn(v0);
      if (col + 1 < n) p[1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* p = static_cast<float*>(out) + o;
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      if (col < n) p[0] = v0;
      if (col + 1 < n) p[1] = v1;
    }
  }
}

template <bool A_ASYNC, bool Q_ASYNC>
__global__ void __launch_bounds__(TC_THREADS, 2)
qmatmul_kernel_tc(const bf16* __restrict__ a, const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  const void* __restrict__ bias, void* __restrict__ out,
                  int m, int n, int k, int lda, int bias_bf16, int out_bf16,
                  int act, int k_chunk) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / (TC_BN / WN), wn = warp % (TC_BN / WN);
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
  const int kb = rank * k_chunk;
  const int ke = min(k, kb + k_chunk);
  const int nk = ke > kb ? (ke - kb + TC_BK - 1) / TC_BK : 0;
  const uint32_t base = smem_addr(smem_tc);
  const uint32_t w_base = base + TC_STAGES * TcSmem::STAGE;
  // this thread's q chunk of a step: 16 bytes of row qr, columns 16 qc ...
  const int qr = tid / (TC_BN / 16), qc = tid % (TC_BN / 16);

  // step t's a and q tiles into ring stage st
  auto load = [&](int t, int st) {
    const int k0 = kb + t * TC_BK;
    const uint32_t sa = base + st * TcSmem::STAGE;
#pragma unroll
    for (int i = 0; i < TC_BM * TC_BK / 8 / TC_THREADS; ++i) {
      const int e = tid + i * TC_THREADS;
      const int r = e / (TC_BK / 8), c = e % (TC_BK / 8);
      const int row = m0 + r, col = k0 + c * 8;
      const uint32_t dst = sa + swz<TC_BK>(r, c) * 16;
      const bf16* src = a + static_cast<size_t>(row) * lda + col;
      if constexpr (A_ASYNC) {
        // a partial chunk at the K edge copies its bytes, zero-fills the
        // rest
        const int bytes = row < m ? max(0, min(16, 2 * (ke - col))) : 0;
        cp_async16(dst, bytes ? src : a, bytes);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in0 = row < m && col + 2 * j < ke;
          const bool in1 = row < m && col + 2 * j + 1 < ke;
          w[j] = pack_bf16(in0 ? __bfloat162float(src[2 * j]) : 0.f,
                           in1 ? __bfloat162float(src[2 * j + 1]) : 0.f);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                     : "memory");
      }
    }
    const int kk = k0 + qr, nn = n0 + qc * 16;
    const uint32_t dq = sa + TcSmem::A_BYTES + qr * TC_BN + qc * 16;
    const int8_t* src = q + static_cast<size_t>(kk) * n + nn;
    if constexpr (Q_ASYNC) {
      const bool in = kk < ke && nn < n;   // n % 16 == 0: whole chunks
      cp_async16(dq, in ? src : q, in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t x = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nn + 4 * j + i;
          const uint32_t byte =
              kk < ke && col < n ? static_cast<uint8_t>(src[4 * j + i]) : 0u;
          x |= byte << (8 * i);
        }
        w[j] = x;
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dq), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  };
  // the 16 q bytes this thread copied in stage st, widened (exactly) into
  // two chunks of widened tile wb; a thread reads only its own copies, so
  // its own wait orders them
  auto widen = [&](int st, int wb) {
    const int8_t* src = reinterpret_cast<const int8_t*>(
        smem_tc + st * TcSmem::STAGE + TcSmem::A_BYTES + qr * TC_BN +
        qc * 16);
    const int4 raw = *reinterpret_cast<const int4*>(src);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = pack_bf16(static_cast<float>(x[2 * j]),
                       static_cast<float>(x[2 * j + 1]));
    const uint32_t dst = w_base + wb * TcSmem::W_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dst + swz<TC_BN>(qr, 2 * qc + h) * 16),
                      "r"(w[4 * h]), "r"(w[4 * h + 1]), "r"(w[4 * h + 2]),
                      "r"(w[4 * h + 3])
                   : "memory");
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int t = 0; t < TC_STAGES - 1; ++t) {
    if (t < nk) load(t, t);
    cp_async_commit();
  }
  if (nk > 0) {
    cp_async_wait<TC_STAGES - 2>();      // step 0 landed
    widen(0, 0);
  }
  const int mi = lane >> 3;
  for (int kt = 0; kt < nk; ++kt) {
    // step kt + 1 landed (this thread's copies); after the barrier every
    // thread's, step kt's widened q is visible, and step kt - 1's
    // products are done with their stage and widened tile
    cp_async_wait<TC_STAGES - 3>();
    __syncthreads();
    const int pre = kt + TC_STAGES - 1;
    if (pre < nk) load(pre, pre % TC_STAGES);
    cp_async_commit();
    if (kt + 1 < nk) widen((kt + 1) % TC_STAGES, (kt + 1) & 1);

    const uint32_t sa = base + (kt % TC_STAGES) * TcSmem::STAGE;
    const uint32_t sw = w_base + (kt & 1) * TcSmem::W_BYTES;
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], sa + swz<TC_BK>(wm * WM + i * 16 + (lane & 15),
                                       2 * ks + (lane >> 4)) * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, sw + swz<TC_BN>(ks * 16 + (lane & 7) +
                                               ((mi & 1) << 3),
                                           (wn * WN) / 8 + 2 * jp +
                                               (mi >> 1)) * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * jp], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (split == 1) {                       // the epilogue from registers
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * (lane & 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + wm * WM + i * 16 + (lane >> 2) + 8 * half;
          if (row >= m || col >= n) continue;
          const float v0 = epilogue(acc[i][j][2 * half], col, scale, bias,
                                    bias_bf16, act);
          const float v1 = col + 1 < n
                               ? epilogue(acc[i][j][2 * half + 1], col + 1,
                                          scale, bias, bias_bf16, act)
                               : 0.f;
          store_pair(out, n, row, col, v0, v1, out_bf16);
        }
      }
    }
    return;
  }

  // split K: this block's partial tile, visible to the whole cluster after
  // the barrier (the ring is done: every copy waited for, every reader
  // past the barrier below)
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem_tc);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * WM + i * 16 + (lane >> 2) + 8 * half;
        const int c = wn * WN + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(&Cs[r * TC_BN + c]) =
            make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
  cluster.sync();

  // each block reduces its slice of the tile over the cluster in rank
  // order, then the epilogue, two neighbouring columns a thread
  const int chunk = TC_BM * TC_BN / split;
  for (int idx = rank * chunk + 2 * tid; idx < (rank + 1) * chunk;
       idx += 2 * TC_THREADS) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = 0; r < split; ++r) {
      const float2 x =
          *reinterpret_cast<const float2*>(cluster.map_shared_rank(Cs, r) +
                                           idx);
      s0 += x.x;
      s1 += x.y;
    }
    const int row = m0 + idx / TC_BN, col = n0 + idx % TC_BN;
    if (row < m && col < n) {
      const float v0 = epilogue(s0, col, scale, bias, bias_bf16, act);
      const float v1 = col + 1 < n ? epilogue(s1, col + 1, scale, bias,
                                              bias_bf16, act)
                                   : 0.f;
      store_pair(out, n, row, col, v0, v1, out_bf16);
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <bool A_ASYNC, bool Q_ASYNC>
cudaError_t launch_tc(const bf16* a, const int8_t* q, const float* scale,
                      const void* bias, void* out, int m, int n, int k,
                      int lda, int bias_bf16, int out_bf16, int act,
                      int split, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_kernel_tc<A_ASYNC, Q_ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TcSmem::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int k_tiles = (k + TC_BK - 1) / TC_BK;
  const int k_chunk = (k_tiles + split - 1) / split * TC_BK;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM,
                        split);
  config.blockDim = dim3(TC_THREADS);
  config.dynamicSmemBytes = TcSmem::BYTES;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, qmatmul_kernel_tc<A_ASYNC, Q_ASYNC>, a,
                            q, scale, bias, out, m, n, k, lda, bias_bf16,
                            out_bf16, act, k_chunk);
}

// ---------------------------------------------------------------------------
// bfloat16 at M <= 16: the decode body, bound by the bytes of q
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_BK = 64;        // K rows a ring stage holds
constexpr int DEC_STAGES = 8;     // ring stages, issued DEC_STAGES - 1 ahead
constexpr int DEC_QPAD = 16;      // q row pad: two row groups a warp at BN 64
constexpr int MAX_SPLIT = 8;      // the portable cluster size

// A cluster barrier in two halves: every block arrives at its start and
// waits before its first write to another block's shared memory, which
// then has surely started (the write needs no other ordering).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int MT, int BN>
struct DecSmem {
  // The ring's stages (q tile [BK][BN + pad] int8, a tile [MT][BK] bf16),
  // as many as a rank's K chunk fills, at most DEC_STAGES; after the K
  // loop every thread's sums [row group][MT][BN] f32 alias them.  Beside
  // them, f32: the tile's scales and biases [BN] each, and what the
  // cluster's ranks push: their sums of this rank's slice of the tile
  // [split][slice].  A launch asks for the bytes its K chunk needs, so a
  // short chunk leaves room for more blocks on an SM.
  static constexpr int QS = BN + DEC_QPAD;
  static constexpr int Q_BYTES = DEC_BK * QS;
  static constexpr int A_BYTES = MT * DEC_BK * 2;
  static constexpr int STAGE = Q_BYTES + A_BYTES;
  static constexpr int RED = DEC_THREADS * 4 * MT * 4;
  static constexpr int TAIL = 4 * (2 * BN + MT * BN + MAX_SPLIT);
  __host__ __device__ static constexpr int work(int k_chunk) {
    const int stages = k_chunk / DEC_BK < DEC_STAGES ? k_chunk / DEC_BK
                                                     : DEC_STAGES;
    return stages * STAGE > RED ? stages * STAGE : RED;
  }
  static constexpr int MAX_BYTES =
      (DEC_STAGES * STAGE > RED ? DEC_STAGES * STAGE : RED) + TAIL;
};

// the four int8 of w as exact floats: 2^23 + 128 + x has x + 128 in the
// low byte of its mantissa
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t t = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(t, 0x4b000000u, 0x7440 + j)) -
           8388736.0f;
}

template <int MT, int BN>
__global__ void __launch_bounds__(DEC_THREADS)
qmatmul_kernel_dec(const bf16* __restrict__ a, const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   const void* __restrict__ bias, void* __restrict__ out,
                   int m, int n, int k, int lda, int a_vec, int q_vec,
                   int bias_bf16, int out_bf16, int act, int k_chunk) {
  typedef DecSmem<MT, BN> S;
  constexpr int CG = BN / 4;                 // column groups, 4 columns each
  constexpr int RG = DEC_THREADS / CG;       // row groups
  constexpr int RPT = DEC_BK / RG;           // a thread's K rows a stage
  extern __shared__ __align__(128) unsigned char smem_dec[];
  float* s_scale = reinterpret_cast<float*>(smem_dec + S::work(k_chunk));
  float* s_bias = s_scale + BN;
  float* recv = s_bias + BN;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int cgi = tid % CG, rg = tid / CG;
  const int n0 = blockIdx.x * BN;
  const int kb = rank * k_chunk;
  const int ke = min(k, kb + k_chunk);
  const int nk = ke > kb ? (ke - kb + DEC_BK - 1) / DEC_BK : 0;
  const uint32_t base = smem_addr(smem_dec);

  // stage t's q rows and a columns into ring slot st, zero past K, N, M
  auto load = [&](int t, int st) {
    const int k0 = kb + t * DEC_BK;
    const uint32_t sq = base + st * S::STAGE;
    for (int e = tid; e < DEC_BK * (BN / 16); e += DEC_THREADS) {
      const int r = e / (BN / 16), c = e % (BN / 16);
      const int kk = k0 + r, nn = n0 + c * 16;
      const uint32_t dst = sq + r * S::QS + c * 16;
      const int8_t* src = q + static_cast<size_t>(kk) * n + nn;
      if (q_vec) {                           // n % 16 == 0: whole pieces
        const bool in = kk < ke && nn < n;
        cp_async16(dst, in ? src : q, in ? 16 : 0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t x = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = nn + 4 * j + i;
            const uint32_t byte = kk < ke && col < n
                                      ? static_cast<uint8_t>(src[4 * j + i])
                                      : 0u;
            x |= byte << (8 * i);
          }
          w[j] = x;
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                     : "memory");
      }
    }
    const uint32_t sa = sq + S::Q_BYTES;
    for (int e = tid; e < MT * (DEC_BK / 8); e += DEC_THREADS) {
      const int r = e / (DEC_BK / 8), c = e % (DEC_BK / 8);
      const int col = k0 + c * 8;
      const uint32_t dst = sa + (r * DEC_BK + c * 8) * 2;
      const bf16* src = a + static_cast<size_t>(r) * lda + col;
      if (a_vec) {
        // a partial piece at the K edge copies its bytes, zero-fills the
        // rest
        const int bytes = r < m ? max(0, min(16, 2 * (ke - col))) : 0;
        cp_async16(dst, bytes ? src : a, bytes);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in0 = r < m && col + 2 * j < ke;
          const bool in1 = r < m && col + 2 * j + 1 < ke;
          const uint32_t lo = in0 ? __bfloat16_as_ushort(src[2 * j]) : 0u;
          const uint32_t hi = in1 ? __bfloat16_as_ushort(src[2 * j + 1])
                                  : 0u;
          w[j] = lo | (hi << 16);
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                     : "memory");
      }
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

#pragma unroll
  for (int t = 0; t < DEC_STAGES - 1; ++t) {
    if (t < nk) load(t, t);
    cp_async_commit();
  }
  // the tile's scales and biases, read while the stages load
  if (tid < BN) {
    const int col = n0 + tid;
    s_scale[tid] = col < n ? scale[col] : 0.f;
    s_bias[tid] = bias == nullptr || col >= n ? 0.f
                  : bias_bf16 ? __bfloat162float(
                                    static_cast<const bf16*>(bias)[col])
                              : static_cast<const float*>(bias)[col];
  }
  for (int t = 0; t < nk; ++t) {
    // stage t landed (this thread's copies); after the barrier every
    // thread's, and stage t - 1's products are done with its slot
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();
    const int pre = t + DEC_STAGES - 1;
    if (pre < nk) load(pre, pre % DEC_STAGES);
    cp_async_commit();

    const unsigned char* st = smem_dec + (t % DEC_STAGES) * S::STAGE;
    const unsigned char* qs = st + rg * RPT * S::QS + cgi * 4;
    const uint32_t* as = reinterpret_cast<const uint32_t*>(st + S::Q_BYTES) +
                         rg * RPT / 2;
#pragma unroll
    for (int i = 0; i < RPT; i += 2) {
      float q0[4], q1[4];
      widen4(*reinterpret_cast<const uint32_t*>(qs + i * S::QS), q0);
      widen4(*reinterpret_cast<const uint32_t*>(qs + (i + 1) * S::QS), q1);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const uint32_t x = as[r * (DEC_BK / 2) + i / 2];   // a[r][2 rows]
        const float a0 = __uint_as_float(x << 16);
        const float a1 = __uint_as_float(x & 0xffff0000u);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] = fmaf(a1, q1[j], fmaf(a0, q0[j], acc[r][j]));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the row groups' sums, added in order, pushed to the rank that owns
  // them: rank x owns elements [x*cap, (x+1)*cap) of the m*BN tile and
  // receives every rank's sums there
  float* red = reinterpret_cast<float*>(smem_dec);
#pragma unroll
  for (int r = 0; r < MT; ++r)
    *reinterpret_cast<float4*>(&red[(rg * MT + r) * BN + cgi * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const int total = m * BN;                  // m <= MT: the real rows
  const int cap = (total + split - 1) / split;
  cluster_wait();
  for (int idx = tid; idx < total; idx += DEC_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g) sum += red[g * MT * BN + idx];
    const int owner = idx / cap;
    cluster.map_shared_rank(recv, owner)[rank * cap + idx - owner * cap] =
        sum;
  }
  // every push has landed; nothing reads another block's memory after
  // this barrier, so no block waits for the others before it leaves
  cluster.sync();

  // this rank's slice: the ranks' sums in rank order, then the epilogue:
  // scale once, bias, activation, cast
  for (int idx = rank * cap + tid; idx < min(total, (rank + 1) * cap);
       idx += DEC_THREADS) {
    float sum = 0.f;
#pragma unroll
    for (int x = 0; x < MAX_SPLIT; ++x) {
      if (x >= split || (VELES_PLANTED_FAULT == 1 && x == split - 1))
        continue;
      sum += recv[x * cap + idx - rank * cap];
    }
    const int row = idx / BN, cl = idx % BN, col = n0 + cl;
    if (col < n) {
      if (VELES_PLANTED_FAULT == 2) sum *= s_scale[cl];
      const float v = activate(sum * s_scale[cl] + s_bias[cl], act);
      const size_t o = static_cast<size_t>(row) * n + col;
      if (out_bf16)
        static_cast<bf16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

template <int MT, int BN>
cudaError_t launch_dec(const bf16* a, const int8_t* q, const float* scale,
                       const void* bias, void* out, int m, int n, int k,
                       int lda, int a_vec, int q_vec, int bias_bf16,
                       int out_bf16, int act, int split,
                       cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmatmul_kernel_dec<MT, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        DecSmem<MT, BN>::MAX_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int k_tiles = (k + DEC_BK - 1) / DEC_BK;
  const int k_chunk = (k_tiles + split - 1) / split * DEC_BK;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + BN - 1) / BN, 1, split);
  config.blockDim = dim3(DEC_THREADS);
  config.dynamicSmemBytes =
      DecSmem<MT, BN>::work(k_chunk) + DecSmem<MT, BN>::TAIL;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, qmatmul_kernel_dec<MT, BN>, a, q, scale,
                            bias, out, m, n, k, lda, a_vec, q_vec, bias_bf16,
                            out_bf16, act, k_chunk);
}

template <int MT>
cudaError_t launch_dec_bn(int block_n, const bf16* a, const int8_t* q,
                          const float* scale, const void* bias, void* out,
                          int m, int n, int k, int lda, int a_vec, int q_vec,
                          int bias_bf16, int out_bf16, int act, int split,
                          cudaStream_t stream) {
#define VELES_QMM_DEC_ARGS                                                  \
  a, q, scale, bias, out, m, n, k, lda, a_vec, q_vec, bias_bf16, out_bf16,  \
      act, split, stream
  if (block_n == 128) return launch_dec<MT, 128>(VELES_QMM_DEC_ARGS);
  if (block_n == 64) return launch_dec<MT, 64>(VELES_QMM_DEC_ARGS);
#undef VELES_QMM_DEC_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// out (M, N) contiguous = act((a @ q) * scale + bias); a (M, K) with row
// stride lda (unit column stride), f32 or bf16 (a_bf16); q (K, N) int8
// contiguous; scale (N,) f32; bias (N,) f32 or bf16 (bias_bf16) or null;
// out f32 or bf16 (out_bf16).  split: the cluster size along K (1..8);
// block_n: the decode body's column tile (64 or 128), which only bf16 at
// M <= 16 reads.  Launches on `stream`, does not synchronise; returns the
// launch's CUDA error (0 on success).
extern "C" int veles_qmatmul(const void* a, const void* q, const void* scale,
                             const void* bias, void* out, int m, int n, int k,
                             int lda, int a_bf16, int bias_bf16, int out_bf16,
                             int act, int split, int block_n, void* stream) {
  if (split < 1 || split > 8 || (split & (split - 1)))
    return cudaErrorInvalidValue;
  const bool q_vec =
      n % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_bf16 && m > 16) {                 // the tensor-core body
    const bf16* ap = static_cast<const bf16*>(a);
    const bool a_vec =
        lda % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
#define VELES_QMM_TC_ARGS \
  ap, qp, sp, bias, out, m, n, k, lda, bias_bf16, out_bf16, act, split, s
    if (a_vec)
      err = q_vec ? launch_tc<true, true>(VELES_QMM_TC_ARGS)
                  : launch_tc<true, false>(VELES_QMM_TC_ARGS);
    else
      err = q_vec ? launch_tc<false, true>(VELES_QMM_TC_ARGS)
                  : launch_tc<false, false>(VELES_QMM_TC_ARGS);
#undef VELES_QMM_TC_ARGS
  } else if (a_bf16) {                    // the decode body, m <= 16
    const bf16* ap = static_cast<const bf16*>(a);
    const int a_vec =
        lda % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
#define VELES_QMM_DEC_ARGS                                                  \
  block_n, ap, qp, sp, bias, out, m, n, k, lda, a_vec, q_vec, bias_bf16,    \
      out_bf16, act, split, s
    if (m <= 4)
      err = launch_dec_bn<4>(VELES_QMM_DEC_ARGS);
    else if (m <= 8)
      err = launch_dec_bn<8>(VELES_QMM_DEC_ARGS);
    else
      err = launch_dec_bn<16>(VELES_QMM_DEC_ARGS);
#undef VELES_QMM_DEC_ARGS
  } else {
    const float* ap = static_cast<const float*>(a);
    err = m <= 16 ? launch<16>(ap, qp, sp, bias, out, m, n, k, lda, q_vec,
                               bias_bf16, out_bf16, act, split, s)
                  : launch<64>(ap, qp, sp, bias, out, m, n, k, lda, q_vec,
                               bias_bf16, out_bf16, act, split, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
