// The activations of the GEMM epilogues (csrc/gemm.cu, csrc/gemm_bf16.cu),
// in f32, as veles_tpu/ops/gemm.py `_ACTIVATIONS` computes them: linear,
// Znicz scaled tanh tanh(x*0.6666)*1.7159, sigmoid, smooth relu
// log1p(exp(min(x, 30))), strict relu.

#pragma once

#include <math.h>

namespace {

enum Act { LINEAR = 0, TANH = 1, SIGMOID = 2, RELU = 3, STRICT_RELU = 4 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if (ACT == TANH) return tanhf(x * 0.6666f) * 1.7159f;
  if (ACT == SIGMOID) return 1.0f / (1.0f + expf(-x));
  if (ACT == RELU) return log1pf(expf(fminf(x, 30.0f)));
  if (ACT == STRICT_RELU) return fmaxf(x, 0.0f);
  return x;
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case TANH: return activate<TANH>(x);
    case SIGMOID: return activate<SIGMOID>(x);
    case RELU: return activate<RELU>(x);
    case STRICT_RELU: return activate<STRICT_RELU>(x);
    default: return x;
  }
}

}  // namespace
