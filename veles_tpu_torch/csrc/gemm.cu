// Tiled f32 GEMM with a fused prologue and epilogue for Hopper (sm_90a),
// written by hand, that also carries the bias step of the fused gradient
// descent.
//
// Replaces four TPU kernels of veles_tpu/ops/gemm.py:
// - `_matmul_kernel` (via `_matmul_pallas`): act(a @ w + bias), f32
//   accumulator, the bias and one activation in the epilogue (linear,
//   Znicz scaled tanh tanh(x*0.6666)*1.7159, sigmoid, smooth relu
//   log1p(exp(min(x, 30))), strict relu)            -> veles_matmul (f32;
//   the bf16 operands go to veles_matmul_bf16 in csrc/gemm_bf16.cu);
// - `_gd_dx_kernel`: err_input = delta W^T (delta W in transposed
//   storage), delta = err_output * act'(y) rebuilt per tile from the
//   output y, against the weights BEFORE the update  -> veles_gd_dx;
// - `_gd_dw_kernel`: dW = x^T delta / B (delta^T x straight into the
//   (N, F) storage when transposed), then v' = m v - lr (dW + decay W),
//   W' = W + v', written over W and v in place       -> veles_gd_dw;
// - `_gd_db_kernel`: db = sum(delta) / B and the same update of the bias,
//   which has no launch of its own: it rides in veles_gd_dw's launch (the
//   bias epilogue below), given b and vb             -> veles_gd_dw.
//
// All three GEMMs run one templated body, `veles_gemm_kernel<KIND, TILE>`:
// KIND is the product and its epilogue (0 matmul, 1 gd_dx, 2 gd_dw, 3 gd_dw
// into the transposed storage, where delta is the first operand), TILE the
// tile configuration, so a profile names every instantiation apart.  Full f32
// FMA on the CUDA cores at every precision level (no TF32).  Operands are
// read through their strides, so a transposed weight storage or x^T needs
// no copy, and delta is built in registers while its tile is staged (the
// prologue), never written to device memory; act'(y) is rounded after each
// operation (no contraction), as the plain version computes it.  Ragged M,
// N and K edges are masked or zero-filled in the kernel (784 = 49 * 16,
// N = 10, a short batch), not padded.
//
// What bounds it on the H100.  At the MNIST shapes (100 x 784 x 100,
// 100 x 100 x 10) every call is far below a microsecond of roofline (15.7
// MFLOP and about 0.67 MB for layer 1's forward), so latency bounds it:
// how many SMs the grid reaches and how many dependent memory round trips
// each block makes.  At 4096^3 the work is operation-bound: 137 GFLOP over
// the 67 TFLOP/s of f32 FMA is 2.05 ms, and the limit is how many shared
// memory reads feed each FMA.  So the host (ops/gemm.py `plan`) picks one
// of two tiles a launch:
//
// * TILE 0 (SPLIT_TILE), where the 128 x 128 grid would not cover the
//   SMs: a 32 x 32 output tile, 64 threads of 4 x 4 outputs, K in steps of
//   16, and K split over a thread block cluster of `split` blocks (grid z,
//   up to 8).  Rank r sums K tiles [r T / split, (r + 1) T / split) of the
//   T = ceil(K / 16), a contiguous chunk (the chunks differ by at most one
//   tile; a rank is empty only when T < split), into shared memory; after
//   a cluster barrier each rank reduces one slice of the tile over all the
//   ranks' shared memory (distributed shared memory) in rank order and
//   runs the epilogue on it.  So every output, and every W and V element
//   of the momentum step, is written exactly once, by one block, with no
//   atomics: a launch gives the same bits every time.  Layer 1's forward
//   is 16 tiles split 8: 128 blocks of 6-7 K steps (one block of 64 x 64
//   ran all 49 before).
// * TILE 1 (BIG_TILE): a 128 x 128 tile, 256 threads of 8 x 8 outputs in
//   the two-quadrant layout of the usual SGEMM, K in steps of 8; A and B
//   are staged k-major, so each thread reads 4 float4s of shared memory
//   for 64 FMAs a k step (the first body read 8 floats for 16).  Two
//   blocks an SM hold it to 128 registers a thread, without spills:
//   matmul's epilogue is compiled once for each activation, and gd_dw's
//   kinds stage with 32-bit offsets (an operand spanning 2^32 elements
//   or more takes the split tile instead).
//
// Both run one pipeline: two shared buffers and one barrier a K step.
// Every global load of step k+1 is started before the FMAs of step k and
// stored to the other buffer after them.  An operand whose unit stride
// runs along its outer index (m of A, n of B), 16-byte aligned and with no
// prologue, is copied by `cp.async` (16 bytes, zero-filled at the edges)
// straight into shared memory; the others are held in registers (float4
// where aligned, else masked scalars), delta's act'(y) applied there, and
// an operand whose unit stride runs along k is transposed as it is
// stored.
//
// The bias step.  db reads the 2 B N floats of err_output and y, which a
// launch of its own read a second time after dw and paid a ~3 us launch
// floor for less than a microsecond of bytes.  dw already stages delta
// tile by tile (B in GD_DW, A in GD_DW_T), so the blocks of the first
// tile along the other index (blockIdx.y == 0 in GD_DW, blockIdx.x == 0 in
// GD_DW_T) add each staged row of delta into one sum a neuron, a thread a
// neuron, rows in order.  Split 1: the block finishes the bias update
// itself.  Split over a cluster: each rank pushes its column sums beside
// its dW partial tile, and after the cluster barrier each rank merges a
// slice of the neurons over the ranks in rank order (0 + s_0 + s_1 + ...)
// and runs the bias update on it, exactly as dW is merged.  The owners of
// the split tile load b, vb and the bias hyperparameters before the K
// loop, and the adds ride among the FMAs, so the step adds no dependent
// round trip to the launch.  No atomics: the sums, and b and vb, are the
// same bits every launch, and ops/gemm.py `_bias_sum_plan_ref` models the
// order.
// The dw step takes the learning rate, decay and momentum of W and of the
// bias by value or, where the pointers are given, from device memory read
// at run time: a CUDA graph that captured the launch then sees the values
// written before each replay (the JAX package traces them as scalars).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "act.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

// a test build may plant a fault in the bias merge of a split launch (1:
// the last rank's sums dropped; 2: the update applied by two ranks, the
// next rank's after the owner's), which the card checks must report; 0 in
// every other build
#ifndef VELES_PLANTED_FAULT
#define VELES_PLANTED_FAULT 0
#endif

namespace {

constexpr int PAD = 4;         // shared-memory row pad (banks)
constexpr int MAX_SPLIT = 8;   // a portable cluster

enum Kind { MATMUL = 0, GD_DX = 1, GD_DW = 2, GD_DW_T = 3 };
enum Epilogue { STORE_ACT = 0, STORE = 1, MOMENTUM = 2 };

__host__ __device__ constexpr int epilogue_of(int kind) {
  return kind == MATMUL ? STORE_ACT : kind == GD_DX ? STORE : MOMENTUM;
}

enum TileConfig { SPLIT_TILE = 0, BIG_TILE = 1 };
// how a block stages an operand: four elements a chunk along its outer
// index (by cp.async, a float4 in registers, or masked scalars) or along k
enum Stage { OUTER_ASYNC = 0, OUTER_VEC = 1, OUTER_SCALAR = 2, K_VEC = 3,
             K_SCALAR = 4 };

// the output tile of the split configuration; the big tile's blocks an SM
constexpr int SPLIT_BM = 32;
constexpr int SPLIT_BN = 32;
constexpr int BIG_MIN_BLOCKS = 2;

template <int BM_, int BN_, int BK_, int TM_, int TN_, int MIN_BLOCKS_>
struct TileShape {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int LDA = BM + PAD, LDB = BN + PAD;
  static constexpr int STAGE = BK * (LDA + LDB);   // floats of one buffer
  static constexpr int SMEM = 2 * STAGE;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 reads");
};

template <int TILE> struct TileOf;
template <> struct TileOf<SPLIT_TILE>
    : TileShape<SPLIT_BM, SPLIT_BN, 16, 4, 4, 4> {};
template <> struct TileOf<BIG_TILE>
    : TileShape<128, 128, 8, 8, 8, BIG_MIN_BLOCKS> {};

// gd_dw's big tile stages its operands with 32-bit offsets
__host__ __device__ constexpr bool narrow(int kind, int tile) {
  return tile == BIG_TILE && (kind == GD_DW || kind == GD_DW_T);
}

// the activation of an epilogue: ANY_ACT reads it at run time
constexpr int ANY_ACT = -1;

template <int ACT>
__device__ __forceinline__ float activate_as(float x, int act) {
  return ACT == ANY_ACT ? activate(x, act) : activate<ACT>(x);
}

// act'(y) from the output y (the Znicz convention of _GD_DERIVS), each
// operation rounded on its own as the plain version's (no fused
// multiply-add), so delta, and the bias sums over it, are its bits
__device__ __forceinline__ float derivative(float y, int act) {
  switch (act) {
    case TANH:
      return __fadd_rn(__fmul_rn(__fmul_rn(y, y), -0.388484177f),
                       1.14381894f);
    case SIGMOID: return __fmul_rn(y, __fsub_rn(1.0f, y));
    case RELU: return __fsub_rn(1.0f, expf(-y));
    case STRICT_RELU: return y > 0.0f ? 1.0f : 0.0f;
    default: return 1.0f;
  }
}

// A logical (outer, k) operand read through strides: A as (M, K), B as
// (N, K).  With `y` set the element is p * act'(y) at the same offset
// (delta from err_output and the output, both (B, N) contiguous).
struct Operand {
  const float* p;
  const float* y;
  long long so, sk;   // strides of the outer index and of k
  int act;
  int stage;          // Stage, set by the launch
};

__device__ __forceinline__ bool along_outer(int stage) {
  return stage <= OUTER_SCALAR;
}

// Stages one operand's (BR x BK) tiles, k-major: S[k * (BR + PAD) + r].
// PRO: the operand may carry a prologue (y), so y's loads are held too.
// Off: the type of element offsets (unsigned where the launch checked
// that the operand spans fewer than 2^32 elements).
template <int BR, int BK, int NT, bool PRO, typename Off>
struct Stager {
  static constexpr int LD = BR + PAD;
  static constexpr int CHUNKS = BR * BK / 4;
  static constexpr int PER = (CHUNKS + NT - 1) / NT;
  float4 v[PER];
  float4 yv[PRO ? PER : 1];

  __device__ __forceinline__ static void place(int stage, int c, int& r,
                                               int& kk) {
    if (along_outer(stage)) {
      kk = c / (BR / 4);
      r = c % (BR / 4) * 4;
    } else {
      r = c / (BK / 4);
      kk = c % (BK / 4) * 4;
    }
  }

  // every global load of the tile at (r0, k0): cp.async straight into S,
  // or into registers; nothing here waits for shared memory
  __device__ __forceinline__ void fetch(const Operand& o, int r0,
                                        int extent, int k0, int ke,
                                        float* S) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = threadIdx.x + p * NT;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      int r, kk;
      place(o.stage, c, r, kk);
      const int gr = r0 + r, gk = k0 + kk;
      const float* __restrict__ src = o.p;
      const float* __restrict__ ysrc = o.y;
      if (o.stage == OUTER_ASYNC) {
        const int valid = gk < ke ? min(max(extent - gr, 0), 4) : 0;
        const float* from =
            valid > 0 ? src + ((Off)gr + (Off)gk * (Off)o.sk) : src;
        cp_async16(smem_addr(S + kk * LD + r), from, valid * 4);
        continue;
      }
      const bool outer = along_outer(o.stage);
      const int dr = outer ? 1 : 0, dk = outer ? 0 : 1;
      const bool full = outer ? (gk < ke && gr + 4 <= extent)
                              : (gr < extent && gk + 4 <= ke);
      const Off base = (Off)gr * (Off)o.so + (Off)gk * (Off)o.sk;
      if (full && (o.stage == OUTER_VEC || o.stage == K_VEC)) {
        v[p] = __ldg(reinterpret_cast<const float4*>(src + base));
        if constexpr (PRO)
          if (ysrc != nullptr)
            yv[p] = __ldg(reinterpret_cast<const float4*>(ysrc + base));
        continue;
      }
      auto at = [&](const float* __restrict__ q, int e) -> float {
        const int rr = gr + e * dr, kq = gk + e * dk;
        return (rr < extent && kq < ke)
                   ? __ldg(q + ((Off)rr * (Off)o.so + (Off)kq * (Off)o.sk))
                   : 0.0f;
      };
      v[p] = make_float4(at(src, 0), at(src, 1), at(src, 2), at(src, 3));
      if constexpr (PRO)
        if (ysrc != nullptr)
          yv[p] = make_float4(at(ysrc, 0), at(ysrc, 1), at(ysrc, 2),
                              at(ysrc, 3));
    }
  }

  // the registers of `fetch` into S, delta's act'(y) applied on the way
  __device__ __forceinline__ void store(const Operand& o, float* S) const {
    if (o.stage == OUTER_ASYNC) return;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = threadIdx.x + p * NT;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      int r, kk;
      place(o.stage, c, r, kk);
      float4 x = v[p];
      if constexpr (PRO) {
        if (o.y != nullptr) {
          x.x *= derivative(yv[p].x, o.act);
          x.y *= derivative(yv[p].y, o.act);
          x.z *= derivative(yv[p].z, o.act);
          x.w *= derivative(yv[p].w, o.act);
        }
      }
      if (along_outer(o.stage)) {
        *reinterpret_cast<float4*>(S + kk * LD + r) = x;
      } else {
        S[kk * LD + r] = x.x;
        S[(kk + 1) * LD + r] = x.y;
        S[(kk + 2) * LD + r] = x.z;
        S[(kk + 3) * LD + r] = x.w;
      }
    }
  }
};

struct Params {
  // STORE_ACT / STORE: out (M, N) contiguous; bias (N,) or null
  float* out;
  const float* bias;
  int act;
  // MOMENTUM: W and V (M, N) contiguous, updated in place
  float* w;
  float* v;
  float inv_b, lr, decay, moment;
  // when set, lr / decay / moment are read from here at run time
  const float* lr_p;
  const float* decay_p;
  const float* moment_p;
  // N % 4 == 0 and the epilogue's arrays 16-byte aligned: float4 access
  int vec;
  // MOMENTUM with a bias (b set): the bias step, b and vb (neurons,)
  // updated in place with their own hyperparameters (values or pointers)
  float* b;
  float* vb;
  float lr_b, decay_b, moment_b;
  const float* lr_b_p;
  const float* decay_b_p;
  const float* moment_b_p;
};

// the hyperparameters of a momentum step: by value, or from device memory
__device__ __forceinline__ float hyper(float value, const float* p) {
  return p != nullptr ? *p : value;
}

struct Hyper {
  float lr, decay, moment;
};

// what the bias update of one neuron reads besides its sum
struct BiasStep {
  float b, vb, lr, decay, moment;
};

__device__ __forceinline__ BiasStep load_bias(const Params& P, int c) {
  return BiasStep{P.b[c], P.vb[c], hyper(P.lr_b, P.lr_b_p),
                  hyper(P.decay_b, P.decay_b_p),
                  hyper(P.moment_b, P.moment_b_p)};
}

// the bias update of neuron c from its sum of delta over the batch
__device__ __forceinline__ void finish_bias(const Params& P, int c,
                                            const BiasStep& s, float sum) {
  const float grad = sum * P.inv_b;
  const float v = s.moment * s.vb - s.lr * (grad + s.decay * s.b);
  P.b[c] = s.b + v;
  P.vb[c] = v;
}

// one output element through the epilogue
template <int EPI, int ACT = ANY_ACT>
__device__ __forceinline__ void finish(const Params& P, const Hyper& h,
                                       int m, int n, int N, float x) {
  const long long o = (long long)m * N + n;
  if (EPI == STORE_ACT) {
    if (P.bias != nullptr) x += P.bias[n];
    P.out[o] = activate_as<ACT>(x, P.act);
  } else if (EPI == STORE) {
    P.out[o] = x;
  } else {
    const float grad = x * P.inv_b;
    const float w = P.w[o];
    const float v = h.moment * P.v[o] - h.lr * (grad + h.decay * w);
    P.w[o] = w + v;
    P.v[o] = v;
  }
}

// four neighbouring outputs (n, n + 1, n + 2, n + 3) of row m
template <int EPI, int ACT>
__device__ __forceinline__ void finish4(const Params& P, const Hyper& h,
                                        int m, int n, int N,
                                        float4 r) {
  const float x[4] = {r.x, r.y, r.z, r.w};
  if (!(P.vec && n + 4 <= N)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < N) finish<EPI, ACT>(P, h, m, n + j, N, x[j]);
    return;
  }
  const long long o = (long long)m * N + n;
  if (EPI == STORE_ACT) {
    if (P.bias != nullptr) {
      const float4 b = *reinterpret_cast<const float4*>(P.bias + n);
      r.x += b.x;
      r.y += b.y;
      r.z += b.z;
      r.w += b.w;
    }
    r = make_float4(activate_as<ACT>(r.x, P.act),
                    activate_as<ACT>(r.y, P.act),
                    activate_as<ACT>(r.z, P.act),
                    activate_as<ACT>(r.w, P.act));
    *reinterpret_cast<float4*>(P.out + o) = r;
  } else if (EPI == STORE) {
    *reinterpret_cast<float4*>(P.out + o) = r;
  } else {
    const float4 w = *reinterpret_cast<const float4*>(P.w + o);
    const float4 v = *reinterpret_cast<const float4*>(P.v + o);
    const float wv[4] = {w.x, w.y, w.z, w.w};
    const float vv[4] = {v.x, v.y, v.z, v.w};
    float nw[4], nv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float grad = x[j] * P.inv_b;
      nv[j] = h.moment * vv[j] - h.lr * (grad + h.decay * wv[j]);
      nw[j] = wv[j] + nv[j];
    }
    *reinterpret_cast<float4*>(P.w + o) =
        make_float4(nw[0], nw[1], nw[2], nw[3]);
    *reinterpret_cast<float4*>(P.v + o) =
        make_float4(nv[0], nv[1], nv[2], nv[3]);
  }
}

// A thread's rows (columns) of the tile are TM / 4 (TN / 4) groups of four,
// ROWS_Q (COLS_Q) apart: the two quadrants of the big tile.
template <int TILE>
struct Quadrants {
  using T = TileOf<TILE>;
  static constexpr int ROWS_Q = T::BM / (T::TM / 4);
  static constexpr int COLS_Q = T::BN / (T::TN / 4);
  __device__ __forceinline__ static int row(int i, int ty) {
    return i / 4 * ROWS_Q + ty * 4 + i % 4;
  }
  __device__ __forceinline__ static int col(int q, int tx) {
    return q * COLS_Q + tx * 4;
  }
};

// The unsplit epilogue, straight from the accumulators; ACT is matmul's
// activation, fixed at compile time so that one tile's worth of
// activations is not compiled as five.
template <int EPI, int ACT, int TILE>
__device__ __forceinline__ void store_tile(
    const Params& P, const Hyper& h,
    const float (&acc)[TileOf<TILE>::TM][TileOf<TILE>::TN], int m0, int n0,
    int M, int N, int tx, int ty) {
  using T = TileOf<TILE>;
  using Q = Quadrants<TILE>;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + Q::row(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < T::TN / 4; ++q)
      finish4<EPI, ACT>(P, h, m, n0 + Q::col(q, tx), N,
                        make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                    acc[i][4 * q + 2], acc[i][4 * q + 3]));
    // one row's W and V in registers at a time: no spills at 128
    if (EPI == MOMENTUM) asm volatile("" ::: "memory");
  }
}

// KIND: the product and epilogue (Kind); TILE: the tile configuration.
// The grid is (N tiles, M tiles, split), launched as clusters of (1, 1,
// split): blockIdx.z is the block's rank and picks its K chunk.
template <int KIND, int TILE>
__global__ void __launch_bounds__(TileOf<TILE>::THREADS,
                                  TileOf<TILE>::MIN_BLOCKS)
veles_gemm_kernel(const Operand A, const Operand B, const int M,
                  const int N, const int K, const Params P) {
  using T = TileOf<TILE>;
  using Q = Quadrants<TILE>;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, TM = T::TM,
                TN = T::TN, NT = T::THREADS;
  constexpr int ROWS_Q = Q::ROWS_Q, COLS_Q = Q::COLS_Q;
  constexpr int EPI = epilogue_of(KIND);
  // delta rides A in gd_dx and gd_dw transposed, B in gd_dw
  constexpr bool A_PRO = KIND == GD_DX || KIND == GD_DW_T;
  constexpr bool B_PRO = KIND == GD_DW;
  // the bias step: delta's tile holds BIAS_N neurons (B's columns in
  // gd_dw, A's rows transposed), staged k-major with row pitch BIAS_LD
  constexpr bool BIAS = KIND == GD_DW || KIND == GD_DW_T;
  constexpr int BIAS_N = KIND == GD_DW ? BN : BM;
  constexpr int BIAS_LD = KIND == GD_DW ? T::LDB : T::LDA;
  static_assert(BIAS_N <= NT && BIAS_N % MAX_SPLIT == 0, "bias threads");
  __shared__ __align__(16) float smem[T::SMEM];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = gridDim.z, rank = blockIdx.z;
  const int k_tiles = (K + BK - 1) / BK;
  const int t0 = rank * k_tiles / split, t1 = (rank + 1) * k_tiles / split;
  const int kb = t0 * BK, ke = min(K, t1 * BK), steps = t1 - t0;
  // the blocks of delta's first tile along the other index sum the bias,
  // thread tid < BIAS_N neuron bias_n0 + tid of the `neurons`; the owners
  // (split 1: each of those; split: a slice of BIAS_N / split a rank)
  // finish neuron bias_c.  The split tile loads the update's operands
  // before the K loop, so that their round trip hides under it.
  const bool bias_block = BIAS && P.b != nullptr &&
                          (KIND == GD_DW ? blockIdx.y : blockIdx.x) == 0;
  const int bias_n0 = KIND == GD_DW ? n0 : m0;
  const int neurons = KIND == GD_DW ? N : M;
  const int bias_per = BIAS_N / split;
  const int bias_c = bias_n0 + rank * bias_per + tid;
  const bool bias_owner = bias_block && tid < bias_per && bias_c < neurons;
  BiasStep bias_in = {};
  if (TILE == SPLIT_TILE && bias_owner) bias_in = load_bias(P, bias_c);
  float bias_sum = 0.0f;

  // 64-bit offsets spill gd_dw's big tile past 128 registers
  using Off = std::conditional_t<narrow(KIND, TILE), unsigned, long long>;
  Stager<BM, BK, NT, A_PRO, Off> sa;
  Stager<BN, BK, NT, B_PRO, Off> sb;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  if (steps > 0) {
    sa.fetch(A, m0, M, kb, ke, smem);
    sb.fetch(B, n0, N, kb, ke, smem + BK * T::LDA);
    cp_async_commit();
    sa.store(A, smem);
    sb.store(B, smem + BK * T::LDA);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const float* as = smem + (t & 1) * T::STAGE;
    const float* bs = as + BK * T::LDA;
    float* next = smem + ((t + 1) & 1) * T::STAGE;
    const bool more = t + 1 < steps;
    if (more) {   // step t + 1's loads, in flight under the products
      const int k0 = kb + (t + 1) * BK;
      sa.fetch(A, m0, M, k0, ke, next);
      sb.fetch(B, n0, N, k0, ke, next + BK * T::LDA);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            as + kk * T::LDA + q * ROWS_Q + ty * 4);
        a[4 * q] = x.x;
        a[4 * q + 1] = x.y;
        a[4 * q + 2] = x.z;
        a[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            bs + kk * T::LDB + q * COLS_Q + tx * 4);
        b[4 * q] = x.x;
        b[4 * q + 1] = x.y;
        b[4 * q + 2] = x.z;
        b[4 * q + 3] = x.w;
      }
      // row kk of delta into the bias sums, in order, its adds among the
      // FMAs
      if (BIAS && bias_block && tid < BIAS_N)
        bias_sum += (KIND == GD_DW ? bs : as)[kk * BIAS_LD + tid];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      sa.store(A, next);
      sb.store(B, next + BK * T::LDA);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  if (TILE != SPLIT_TILE && bias_owner) bias_in = load_bias(P, bias_c);
  Hyper h = {0.0f, 0.0f, 0.0f};
  if (EPI == MOMENTUM) {
    h.lr = hyper(P.lr, P.lr_p);
    h.decay = hyper(P.decay, P.decay_p);
    h.moment = hyper(P.moment, P.moment_p);
  }
  if (split == 1) {
    if constexpr (EPI == STORE_ACT) {
      switch (P.act) {
        case TANH:
          store_tile<EPI, TANH, TILE>(P, h, acc, m0, n0, M, N, tx, ty);
          break;
        case SIGMOID:
          store_tile<EPI, SIGMOID, TILE>(P, h, acc, m0, n0, M, N, tx, ty);
          break;
        case RELU:
          store_tile<EPI, RELU, TILE>(P, h, acc, m0, n0, M, N, tx, ty);
          break;
        case STRICT_RELU:
          store_tile<EPI, STRICT_RELU, TILE>(P, h, acc, m0, n0, M, N, tx,
                                             ty);
          break;
        default:
          store_tile<EPI, LINEAR, TILE>(P, h, acc, m0, n0, M, N, tx, ty);
      }
    } else {
      store_tile<EPI, LINEAR, TILE>(P, h, acc, m0, n0, M, N, tx, ty);
    }
    if (bias_owner) finish_bias(P, bias_c, bias_in, bias_sum);
    return;
  }
  if constexpr (BM * BN + BIAS_N <= T::SMEM) {
    // this block's partial tile and bias sums, visible to the cluster
    // after the barrier (the K loop ended in a block barrier, so it may
    // reuse the buffers)
    cg::cluster_group cluster = cg::this_cluster();
    float* cs = smem;
    float* cb = smem + BM * BN;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q)
        *reinterpret_cast<float4*>(
            cs + Q::row(i, ty) * BN + Q::col(q, tx)) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                        acc[i][4 * q + 3]);
    if (BIAS && bias_block && tid < BIAS_N) cb[tid] = bias_sum;
    cluster.sync();
    // each rank sums its slice of the tile over the ranks in rank order,
    // then the epilogue
    const int chunk = BM * BN / split;
    for (int idx = rank * chunk + tid; idx < (rank + 1) * chunk;
         idx += NT) {
      float part[MAX_SPLIT];
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r)
        part[r] = r < split ? cluster.map_shared_rank(cs, r)[idx] : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < MAX_SPLIT; ++r)
        if (r < split) sum += part[r];
      const int m = m0 + idx / BN, n = n0 + idx % BN;
      if (m < M && n < N) finish<EPI>(P, h, m, n, N, sum);
    }
    // each owner merges its neuron's sums over the ranks in rank order,
    // then the bias update
    if (bias_owner) {
      const int c = bias_c - bias_n0;
      float sum = 0.0f;
#if VELES_PLANTED_FAULT == 1   // planted: the last rank's sums dropped
      for (int r = 0; r < split - 1; ++r)
#else
      for (int r = 0; r < split; ++r)
#endif
        sum += cluster.map_shared_rank(cb, r)[c];
      finish_bias(P, bias_c, bias_in, sum);
    }
#if VELES_PLANTED_FAULT == 2   // planted: the next rank updates it again
    cluster.sync();
    const int c = (rank + 1) % split * bias_per + tid;
    if (bias_block && tid < bias_per && bias_n0 + c < neurons) {
      float sum = 0.0f;
      for (int r = 0; r < split; ++r)
        sum += cluster.map_shared_rank(cb, r)[c];
      finish_bias(P, bias_n0 + c, load_bias(P, bias_n0 + c), sum);
    }
#endif
    // no block leaves while another may still read its shared memory
    cluster.sync();
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// every offset of an (extent, k) operand fits 32 bits unsigned
bool spans_32_bits(const Operand& o, int extent, int k) {
  const long long last = (long long)(extent - 1) * o.so +
                         (long long)(k > 0 ? k - 1 : 0) * o.sk;
  return last < (1LL << 32);
}

// How a block stages the operand: along whichever index has the unit
// stride (k when neither has), by vectors where every chunk of four is
// 16-byte aligned, by cp.async where there is no prologue as well.
int stage_of(const Operand& o) {
  const bool outer = o.so == 1 || (o.sk != 1 && o.so < o.sk);
  const long long other = outer ? o.sk : o.so;
  const bool vec = (o.so == 1 || o.sk == 1) && other % 4 == 0 &&
                   aligned16(o.p) && (o.y == nullptr || aligned16(o.y));
  if (outer) return vec ? (o.y == nullptr ? OUTER_ASYNC : OUTER_VEC)
                        : OUTER_SCALAR;
  return vec ? K_VEC : K_SCALAR;
}

template <int KIND, int TILE>
int launch_tile(Operand a, Operand b, int m, int n, int k, const Params& p,
                int split, cudaStream_t stream) {
  using T = TileOf<TILE>;
  if (TILE == BIG_TILE && split != 1) return (int)cudaErrorInvalidValue;
  a.stage = stage_of(a);
  b.stage = stage_of(b);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM,
                        split);
  config.blockDim = dim3(T::THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  config.attrs = attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, veles_gemm_kernel<KIND, TILE>, a,
                                 b, m, n, k, p);
}

// tile: a TileConfig; split: the cluster size, a power of two up to 8
// (1 for the big tile)
template <int KIND>
int launch_gemm(const Operand& a, const Operand& b, int m, int n, int k,
                const Params& p, int tile, int split, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (split < 1 || split > MAX_SPLIT || (split & (split - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // an operand too large for narrow offsets takes the split tile
  if (narrow(KIND, tile) && split == 1 &&
      !(spans_32_bits(a, m, k) && spans_32_bits(b, n, k)))
    tile = SPLIT_TILE;
  if (tile == SPLIT_TILE)
    return launch_tile<KIND, SPLIT_TILE>(a, b, m, n, k, p, split, s);
  if (tile == BIG_TILE)
    return launch_tile<KIND, BIG_TILE>(a, b, m, n, k, p, split, s);
  return (int)cudaErrorInvalidValue;
}

Params no_params() {
  Params p;
  p.out = nullptr;
  p.bias = nullptr;
  p.act = LINEAR;
  p.w = nullptr;
  p.v = nullptr;
  p.inv_b = p.lr = p.decay = p.moment = 0.0f;
  p.lr_p = p.decay_p = p.moment_p = nullptr;
  p.vec = 0;
  p.b = p.vb = nullptr;
  p.lr_b = p.decay_b = p.moment_b = 0.0f;
  p.lr_b_p = p.decay_b_p = p.moment_b_p = nullptr;
  return p;
}

// A (m, k) with strides (s_m, s_k); B (k, n) with strides (s_k, s_n)
Operand a_operand(const float* p, const float* y, long long s_m,
                  long long s_k, int act) {
  return Operand{p, y, s_m, s_k, act, K_SCALAR};
}

Operand b_operand(const float* p, const float* y, long long s_k,
                  long long s_n, int act) {
  return Operand{p, y, s_n, s_k, act, K_SCALAR};
}

}  // namespace

// out (m, n) = act(a @ w + bias); a (m, k) and w (k, n) through strides;
// tile and split as ops/gemm.py `plan` gives them.
extern "C" int veles_matmul(const float* a, const float* w,
                            const float* bias, float* out, int m, int n,
                            int k, long long sam, long long sak,
                            long long swk, long long swn, int act, int tile,
                            int split, void* stream) {
  const Operand A = a_operand(a, nullptr, sam, sak, LINEAR);
  const Operand B = b_operand(w, nullptr, swk, swn, LINEAR);
  Params p = no_params();
  p.out = out;
  p.bias = bias;
  p.act = act;
  p.vec = n % 4 == 0 && aligned16(out) &&
          (bias == nullptr || aligned16(bias));
  return launch_gemm<MATMUL>(A, B, m, n, k, p, tile, split, stream);
}

// out (batch, f) = delta (batch, n) @ Wt, Wt the (n, f) view of the
// weights given by its strides (snk, snf); eo and y (batch, n) contiguous.
extern "C" int veles_gd_dx(const float* eo, const float* y, const float* w,
                           float* out, int batch, int n, int f,
                           long long snk, long long snf, int act, int tile,
                           int split, void* stream) {
  const Operand A = a_operand(eo, y, (long long)n, 1, act);
  const Operand B = b_operand(w, nullptr, snk, snf, LINEAR);
  Params p = no_params();
  p.out = out;
  p.vec = f % 4 == 0 && aligned16(out);
  return launch_gemm<GD_DX>(A, B, batch, f, n, p, tile, split, stream);
}

// dW = x^T delta (f, n), or delta^T x (n, f) when transposed, times inv_b,
// then the momentum update of W and V (contiguous, storage layout) in
// place; x (batch, f) through strides (sxb, sxf), eo and y (batch, n)
// contiguous.  lr, decay and moment are read from lr_p, decay_p and
// moment_p on the device where those are not null.  Where b is not null,
// the same launch also takes the bias step: db = sum over the batch of
// delta, times inv_b, then the momentum update of b and vb (n,) in place
// with lr_b, decay_b and moment_b (or their pointers).
extern "C" int veles_gd_dw(const float* x, const float* eo, const float* y,
                           float* w, float* v, int batch, int f, int n,
                           long long sxb, long long sxf, int transposed,
                           int act, float inv_b, float lr, float decay,
                           float moment, const float* lr_p,
                           const float* decay_p, const float* moment_p,
                           float* b, float* vb, float lr_b, float decay_b,
                           float moment_b, const float* lr_b_p,
                           const float* decay_b_p, const float* moment_b_p,
                           int tile, int split, void* stream) {
  Params p = no_params();
  p.w = w;
  p.v = v;
  p.inv_b = inv_b;
  p.lr = lr;
  p.decay = decay;
  p.moment = moment;
  p.lr_p = lr_p;
  p.decay_p = decay_p;
  p.moment_p = moment_p;
  p.vec = (transposed ? f : n) % 4 == 0 && aligned16(w) && aligned16(v);
  p.b = b;
  p.vb = vb;
  p.lr_b = lr_b;
  p.decay_b = decay_b;
  p.moment_b = moment_b;
  p.lr_b_p = lr_b_p;
  p.decay_b_p = decay_b_p;
  p.moment_b_p = moment_b_p;
  if (transposed) {
    const Operand Dt = a_operand(eo, y, 1, (long long)n, act);  // (n, B)
    const Operand X = b_operand(x, nullptr, sxb, sxf, LINEAR);  // (B, f)
    return launch_gemm<GD_DW_T>(Dt, X, n, f, batch, p, tile, split,
                                stream);
  }
  const Operand Xt = a_operand(x, nullptr, sxf, sxb, LINEAR);  // (f, B)
  const Operand D = b_operand(eo, y, (long long)n, 1, act);    // (B, n)
  return launch_gemm<GD_DW>(Xt, D, f, n, batch, p, tile, split, stream);
}
