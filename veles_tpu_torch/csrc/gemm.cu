// Tiled f32 GEMM with a fused prologue and epilogue for Hopper (sm_90a),
// written by hand; and the bias step of the fused gradient descent.
//
// Replaces four TPU kernels of veles_tpu/ops/gemm.py:
// - `_matmul_kernel` (via `_matmul_pallas`): act(a @ w + bias), f32
//   accumulator, the bias and one activation in the epilogue (linear,
//   Znicz scaled tanh tanh(x*0.6666)*1.7159, sigmoid, smooth relu
//   log1p(exp(min(x, 30))), strict relu)            -> veles_matmul;
// - `_gd_dx_kernel`: err_input = delta W^T (delta W in transposed
//   storage), delta = err_output * act'(y) rebuilt per tile from the
//   output y, against the weights BEFORE the update  -> veles_gd_dx;
// - `_gd_dw_kernel`: dW = x^T delta / B (delta^T x straight into the
//   (N, F) storage when transposed), then v' = m v - lr (dW + decay W),
//   W' = W + v', written over W and v in place       -> veles_gd_dw;
// - `_gd_db_kernel`: db = sum(delta) / B and the same update of the bias
//                                                    -> veles_gd_db.
// All three GEMMs run one kernel body: a block computes a 64 x 64 tile
// of C = A B, looping over K in steps of 16 (the Pallas sequential K grid
// axis becomes this loop), staging A and B tiles in shared memory; each of
// its 256 threads owns 4 x 4 outputs in registers.  Operands are read
// through their strides, so a transposed weight storage or x^T needs no
// copy, and delta is built while its tile is staged (the prologue), never
// written to device memory.  Ragged M, N and K edges are masked in the
// kernel (784 = 6 * 128 + 16, N = 10, a short batch), not padded.  Every
// output is one block's sequential sum: no atomics, no split-K, so a
// launch gives the same bits every time.
//
// What bounds it on the H100: at the MNIST shapes (100 x 784 x 100,
// 100 x 100 x 10) every call is far below a microsecond of roofline
// (15.7 MFLOP and about 0.67 MB for the forward of layer 1), so the
// launch and the eager host loop around it dominate, and 4 blocks cannot
// fill 132 SMs.  At 4096^3 the work is operation-bound: 137 GFLOP over
// the 67 TFLOP/s of f32 FMA on the CUDA cores is 2.05 ms, and this simple
// kernel is bound by shared-memory reads (8 loads per 16 FMAs a k step)
// well above that.  Tensor cores (TF32 mma.sync, then wgmma with TMA) are
// later work; this kernel computes full f32 at every precision level.
// The db step reads 2 B N floats and is bound by bytes and by the launch;
// one block per 32 columns loops over the whole batch, and its 8 row
// groups are summed in a fixed order, so it needs no atomics either.
// The dw and db steps take the learning rate, decay and momentum by value
// or, where the pointers are given, from device memory read at run time:
// a CUDA graph that captured the launch then sees the values written
// before each replay (the JAX package traces them as scalars).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int PAD = 4;         // shared-memory row pad (banks)

enum Act { LINEAR = 0, TANH = 1, SIGMOID = 2, RELU = 3, STRICT_RELU = 4 };
enum Epilogue { STORE_ACT = 0, STORE = 1, MOMENTUM = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case TANH: return tanhf(x * 0.6666f) * 1.7159f;
    case SIGMOID: return 1.0f / (1.0f + expf(-x));
    case RELU: return log1pf(expf(fminf(x, 30.0f)));
    case STRICT_RELU: return fmaxf(x, 0.0f);
    default: return x;
  }
}

// act'(y) from the output y (the Znicz convention of _GD_DERIVS)
__device__ __forceinline__ float derivative(float y, int act) {
  switch (act) {
    case TANH: return y * y * (-0.388484177f) + 1.14381894f;
    case SIGMOID: return y * (1.0f - y);
    case RELU: return 1.0f - expf(-y);
    case STRICT_RELU: return y > 0.0f ? 1.0f : 0.0f;
    default: return 1.0f;
  }
}

// A logical (rows, cols) operand read through strides.  With `y` set the
// element is p * act'(y) at the same offset (delta from err_output and
// the output, both (B, N) contiguous).
struct Operand {
  const float* p;
  const float* y;
  long long s0, s1;
  int act;
};

__device__ __forceinline__ float load(const Operand& o, int r, int c) {
  const long long off = (long long)r * o.s0 + (long long)c * o.s1;
  float v = o.p[off];
  if (o.y != nullptr) v *= derivative(o.y[off], o.act);
  return v;
}

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
};

// the hyperparameters of a momentum step: by value, or from device memory
__device__ __forceinline__ float hyper(float value, const float* p) {
  return p != nullptr ? *p : value;
}

// EPI is the epilogue: one instantiation each for matmul (STORE_ACT),
// gd_dx (STORE) and gd_dw (MOMENTUM), so a profile names them apart.
// Four blocks an SM: without the bound ptxas gives the activation
// epilogues 79 registers, three blocks fit, and 4096^3 runs 26 % slower.
template <int EPI>
__global__ void __launch_bounds__(THREADS, 4)
veles_gemm_kernel(Operand A, Operand B, int M, int N, int K, Params P) {
  __shared__ float As[BK][BM + PAD];   // As[k][m]
  __shared__ float Bs[BK][BN + PAD];   // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // neighbouring threads take neighbouring addresses of whichever index
  // has the unit stride
  const bool a_k_fast = A.s1 == 1;
  const bool b_n_fast = B.s1 == 1;
  float lr = 0.0f, decay = 0.0f, moment = 0.0f;
  if (EPI == MOMENTUM) {
    lr = hyper(P.lr, P.lr_p);
    decay = hyper(P.decay, P.decay_p);
    moment = hyper(P.moment, P.moment_p);
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = a_k_fast ? e / BK : e % BM;
      const int kk = a_k_fast ? e % BK : e / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? load(A, gm, gk) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int nn = b_n_fast ? e % BN : e / BK;
      const int kk = b_n_fast ? e / BN : e % BK;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? load(B, gk, gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const long long o = (long long)m * N + n;
      if (EPI == STORE_ACT) {
        float x = acc[i][j];
        if (P.bias != nullptr) x += P.bias[n];
        P.out[o] = activate(x, P.act);
      } else if (EPI == STORE) {
        P.out[o] = acc[i][j];
      } else {
        const float grad = acc[i][j] * P.inv_b;
        const float w = P.w[o];
        const float v = moment * P.v[o] - lr * (grad + decay * w);
        P.w[o] = w + v;
        P.v[o] = v;
      }
    }
  }
}

constexpr int DB_COLS = 32;
constexpr int DB_GROUPS = THREADS / DB_COLS;

__global__ void __launch_bounds__(THREADS)
veles_gd_db_kernel(const float* __restrict__ eo,
                   const float* __restrict__ y, float* b, float* vb,
                   int batch, int n, int act, float inv_b, float lr_v,
                   float decay_v, float moment_v, const float* lr_p,
                   const float* decay_p, const float* moment_p) {
  __shared__ float part[DB_GROUPS][DB_COLS + 1];
  const int c = threadIdx.x % DB_COLS, g = threadIdx.x / DB_COLS;
  const int col = blockIdx.x * DB_COLS + c;
  float s = 0.0f;
  if (col < n)
    for (int r = g; r < batch; r += DB_GROUPS) {
      const long long o = (long long)r * n + col;
      s += eo[o] * derivative(y[o], act);
    }
  part[g][c] = s;
  __syncthreads();
  if (g == 0 && col < n) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < DB_GROUPS; ++i) t += part[i][c];
    const float grad = t * inv_b;
    const float lr = hyper(lr_v, lr_p), decay = hyper(decay_v, decay_p);
    const float moment = hyper(moment_v, moment_p);
    const float bias = b[col];
    const float v = moment * vb[col] - lr * (grad + decay * bias);
    b[col] = bias + v;
    vb[col] = v;
  }
}

template <int EPI>
int launch_gemm(const Operand& a, const Operand& b, int m, int n, int k,
                const Params& p, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  veles_gemm_kernel<EPI><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, m, n, k, p);
  return (int)cudaGetLastError();
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
  return p;
}

}  // namespace

// out (m, n) = act(a @ w + bias); a (m, k) and w (k, n) through strides.
extern "C" int veles_matmul(const float* a, const float* w,
                            const float* bias, float* out, int m, int n,
                            int k, long long sam, long long sak,
                            long long swk, long long swn, int act,
                            void* stream) {
  Operand A = {a, nullptr, sam, sak, LINEAR};
  Operand B = {w, nullptr, swk, swn, LINEAR};
  Params p = no_params();
  p.out = out;
  p.bias = bias;
  p.act = act;
  return launch_gemm<STORE_ACT>(A, B, m, n, k, p, stream);
}

// out (batch, f) = delta (batch, n) @ Wt, Wt the (n, f) view of the
// weights given by its strides (snk, snf); eo and y (batch, n) contiguous.
extern "C" int veles_gd_dx(const float* eo, const float* y, const float* w,
                           float* out, int batch, int n, int f,
                           long long snk, long long snf, int act,
                           void* stream) {
  Operand A = {eo, y, (long long)n, 1, act};
  Operand B = {w, nullptr, snk, snf, LINEAR};
  Params p = no_params();
  p.out = out;
  return launch_gemm<STORE>(A, B, batch, f, n, p, stream);
}

// dW = x^T delta (f, n), or delta^T x (n, f) when transposed, times inv_b,
// then the momentum update of W and V (contiguous, storage layout) in
// place; x (batch, f) through strides (sxb, sxf), eo and y (batch, n)
// contiguous.  lr, decay and moment are read from lr_p, decay_p and
// moment_p on the device where those are not null.
extern "C" int veles_gd_dw(const float* x, const float* eo, const float* y,
                           float* w, float* v, int batch, int f, int n,
                           long long sxb, long long sxf, int transposed,
                           int act, float inv_b, float lr, float decay,
                           float moment, const float* lr_p,
                           const float* decay_p, const float* moment_p,
                           void* stream) {
  Operand X = {x, nullptr, sxf, sxb, LINEAR};       // x^T: (f, batch)
  Operand D = {eo, y, (long long)n, 1, act};        // delta: (batch, n)
  Operand Dt = {eo, y, 1, (long long)n, act};       // delta^T: (n, batch)
  Operand Xb = {x, nullptr, sxb, sxf, LINEAR};      // x: (batch, f)
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
  if (transposed)
    return launch_gemm<MOMENTUM>(Dt, Xb, n, f, batch, p, stream);
  return launch_gemm<MOMENTUM>(X, D, f, n, batch, p, stream);
}

// db = sum over the batch of delta, times inv_b, then the momentum update
// of b and vb (n,) in place; eo and y (batch, n) contiguous; the
// hyperparameters as for veles_gd_dw.
extern "C" int veles_gd_db(const float* eo, const float* y, float* b,
                           float* vb, int batch, int n, int act, float inv_b,
                           float lr, float decay, float moment,
                           const float* lr_p, const float* decay_p,
                           const float* moment_p, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + DB_COLS - 1) / DB_COLS;
  veles_gd_db_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      eo, y, b, vb, batch, n, act, inv_b, lr, decay, moment, lr_p, decay_p,
      moment_p);
  return (int)cudaGetLastError();
}
