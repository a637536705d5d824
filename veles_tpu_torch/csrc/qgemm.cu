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
// up-projection fuses with its bias.
//
// Design.  A block computes a BM x 64 tile of the output (BM = 16 for
// M <= 16, the decode shape; 64 otherwise), looping over K in steps of 64:
// the Pallas kernel's carried K grid axis becomes this loop.  Each step
// stages a BM x 64 tile of a and a 64 x 64 tile of q in shared memory: q
// is read from device memory as int8 (16 bytes a thread, a quarter of the
// bf16 bytes) and widened to f32 as it is stored, which is exact (|q| <=
// 127); the next step's tiles are loaded into registers while this one's
// products run.  Each of the 256 threads owns BM/16 x 4 outputs and
// accumulates f32 FMA products on the CUDA cores, at every precision
// level.  Ragged M, K and N edges are masked in the kernel, not padded.
// After the loop the per-output-channel scale is applied once
// (dot-then-scale, as the Pallas epilogue), then the bias and the
// activation, all in f32, and the result is cast to the output dtype.
//
// Split K over a cluster.  At decode (M = 4) the grid has N / 64 tiles,
// 16 for N = 1024, far fewer than the 132 SMs that must pull the weights
// from memory.  So K is split over a thread block cluster of up to 8
// blocks (the wrapper doubles the split while the grid covers the SMs
// less than twice): each block sums its K range into shared memory, and
// after a cluster barrier each block reduces a slice of the tile from all
// the blocks' shared memory (distributed shared memory) in rank order and
// runs the epilogue on it.  No atomics and a fixed order: a launch gives
// the same bits every time.
//
// What bounds it on the H100: at decode the bytes.  CONFIG's block
// weights (K x N = 1024 x 3072, 1024 x 1024, 1024 x 4096, 4096 x 1024) are
// 12 582 912 int8 bytes a layer; the FLOPs at M = 4 (2 M K N = 101 MFLOP a
// layer) take 1.5 us at 67 TFLOP/s against 3.8 us for the bytes at
// 3.35 TB/s.  Twelve layers read at least 151 MB a decode step, >= 45 us
// (the bf16 twin 302 MB, >= 90 us).  At prefill (M = 2048) the products
// bound it: 2 M K N over f32 FMA on the CUDA cores.  Tensor cores
// (mma.sync or wgmma with int8 -> bf16 widening in registers) are later
// work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

template <bool BF16>
__device__ __forceinline__ float load_a(const void* a, size_t i) {
  if (BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i]);
  return static_cast<const float*>(a)[i];
}

template <int BM>
struct Smem {
  // the a tile [BK][BM + APAD] and the q tile [BK][BN] during the K loop;
  // the partial tile [BM][BN] after it
  static constexpr int LOOP = BK * (BM + APAD) + BK * BN;
  static constexpr int FLOATS = LOOP > BM * BN ? LOOP : BM * BN;
};

template <int BM, bool A_BF16>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const void* __restrict__ a, const int8_t* __restrict__ q,
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
                  ? load_a<A_BF16>(a, static_cast<size_t>(row) * lda + col)
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

template <int BM, bool A_BF16>
cudaError_t launch(const void* a, const int8_t* q, const float* scale,
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
  return cudaLaunchKernelEx(&config, qmatmul_kernel<BM, A_BF16>, a, q, scale,
                            bias, out, m, n, k, lda, q_vec, bias_bf16,
                            out_bf16, act, k_chunk);
}

}  // namespace

// out (M, N) contiguous = act((a @ q) * scale + bias); a (M, K) with row
// stride lda (unit column stride), f32 or bf16 (a_bf16); q (K, N) int8
// contiguous; scale (N,) f32; bias (N,) f32 or bf16 (bias_bf16) or null;
// out f32 or bf16 (out_bf16).  split: the cluster size along K (1..8).
// Launches on `stream`, does not synchronise; returns the launch's CUDA
// error (0 on success).
extern "C" int veles_qmatmul(const void* a, const void* q, const void* scale,
                             const void* bias, void* out, int m, int n, int k,
                             int lda, int a_bf16, int bias_bf16, int out_bf16,
                             int act, int split, void* stream) {
  if (split < 1 || split > 8 || (split & (split - 1)))
    return cudaErrorInvalidValue;
  const int q_vec = (n % 16 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m <= 16) {
    err = a_bf16 ? launch<16, true>(a, qp, sp, bias, out, m, n, k, lda, q_vec,
                                    bias_bf16, out_bf16, act, split, s)
                 : launch<16, false>(a, qp, sp, bias, out, m, n, k, lda, q_vec,
                                     bias_bf16, out_bf16, act, split, s);
  } else {
    err = a_bf16 ? launch<64, true>(a, qp, sp, bias, out, m, n, k, lda, q_vec,
                                    bias_bf16, out_bf16, act, split, s)
                 : launch<64, false>(a, qp, sp, bias, out, m, n, k, lda, q_vec,
                                     bias_bf16, out_bf16, act, split, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
