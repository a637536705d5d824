"""The GEMM kernel's autograd (``veles_tpu_torch.ops.gemm.matmul`` as a
``torch.autograd.Function``) and its bf16 plain version against the JAX
package, on the CPU.

- The forward and the three gradients of ``matmul`` against ``jax.vjp``
  of ``veles_tpu.ops.gemm.matmul`` (its custom VJP), on the same numpy
  inputs: every activation, with and without a bias, with a transposed
  view of either operand, in f32 (within 1e-5 absolute: the values are
  O(1), XLA rounds act′'s terms in another order, and the weight and
  bias gradients sum nine such terms, with cancellation) and in bf16
  (within one bf16 ulp of JAX's value: both compute the f32 product of
  the bf16 operands, the epilogue in f32, and round once).
- The bf16 plain version against the Pallas kernel in interpret mode
  (``_matmul_pallas(..., interpret=True)``), within one bf16 ulp.
- The product count of the fused step: 5 products a train step of the
  two-layer MLP (2 forward, 2 weight gradients, 1 input gradient: the
  first layer's input is data, so its ``da`` is skipped) and 2 an eval
  step, in f32 and in bf16.
- The kernel wrapper's type checks: f32 or bf16 operands of one type;
  float64 (CPU debugging only) and mixed types raise ``TypeError``.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu.ops import gemm as jax_gemm
from veles_tpu_torch.ops import gemm
from veles_tpu_torch.znicz import fused_graph

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

ACTIVATIONS = [None, "tanh", "sigmoid", "relu", "strict_relu"]
LAYOUTS = ["plain", "a_transposed", "w_transposed"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = 1e-5
M, K, N = 9, 20, 6


def _inputs(seed, layout):
    rng = numpy.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(numpy.float32)
    w = (rng.standard_normal((K, N)) * 0.3).astype(numpy.float32)
    b = rng.standard_normal(N).astype(numpy.float32)
    g = rng.standard_normal((M, N)).astype(numpy.float32)
    return a, w, b, g


def _torch_operand(x, dtype, transposed):
    """The operand as a (transposed view of a) tensor of ``dtype``."""
    t = torch.tensor(x.T.copy() if transposed else x).to(dtype)
    return t.t() if transposed else t


def _ulp_bf16(x):
    """One bf16 ulp at each value (2^-7 of its binade; the smallest
    normal's where it is 0)."""
    x = numpy.abs(numpy.asarray(x, numpy.float64))
    exp = numpy.floor(numpy.log2(numpy.maximum(x, 2.0 ** -126)))
    return 2.0 ** (exp - 7)


def _within(got, want, dtype_name):
    got = got.float().detach().numpy().astype(numpy.float64)
    want = numpy.asarray(jnp.asarray(want, jnp.float32), numpy.float64)
    assert got.shape == want.shape
    diff = numpy.abs(got - want)
    if dtype_name == "float32":
        assert diff.max() <= F32_TOL, diff.max()
    else:
        assert (diff <= _ulp_bf16(want)).all(), diff.max()


@pytest.fixture(scope="module")
def jax_vjps():
    """Every case's JAX forward and gradients, computed once."""
    out = {}
    for dtype_name, (_t, jdt) in DTYPES.items():
        for act in ACTIVATIONS:
            for bias in (True, False):
                a, w, b, g = _inputs(3, "plain")
                ja, jw, jb = (jnp.asarray(v, jdt) for v in (a, w, b))
                if bias:
                    fwd, vjp = jax.vjp(
                        lambda x, y, z: jax_gemm.matmul(x, y, z, act),
                        ja, jw, jb)
                    grads = vjp(jnp.asarray(g, jdt))
                else:
                    fwd, vjp = jax.vjp(
                        lambda x, y: jax_gemm.matmul(x, y, None, act),
                        ja, jw)
                    grads = vjp(jnp.asarray(g, jdt)) + (None,)
                out[dtype_name, act, bias] = (fwd,) + tuple(grads)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_matmul_and_its_gradients_match_jax_vjp(jax_vjps, dtype_name,
                                                activation, bias, layout):
    dtype = DTYPES[dtype_name][0]
    a, w, b, g = _inputs(3, layout)
    ta = _torch_operand(a, dtype, layout == "a_transposed")
    tw = _torch_operand(w, dtype, layout == "w_transposed")
    tb = torch.tensor(b).to(dtype) if bias else None
    leaves = [t.requires_grad_(True) for t in (ta, tw, tb) if t is not None]
    out = gemm.matmul(ta, tw, tb, activation)
    assert out.dtype == dtype and out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, torch.tensor(g).to(dtype))
    want = jax_vjps[dtype_name, activation, bias]
    _within(out, want[0], dtype_name)
    for got, ref in zip(grads, want[1:]):
        assert got.dtype == dtype
        _within(got, ref, dtype_name)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_bf16_plain_version_matches_the_pallas_kernel(activation, bias):
    a, w, b, _g = _inputs(5, "plain")
    ja, jw, jb = (jnp.asarray(v, jnp.bfloat16) for v in (a, w, b))
    want = jax_gemm._matmul_pallas(ja, jw, jb if bias else None,
                                   activation=activation, interpret=True)
    got = gemm._matmul_ref(torch.tensor(a).bfloat16(),
                           torch.tensor(w).bfloat16(),
                           torch.tensor(b).bfloat16() if bias else None,
                           activation)
    assert got.dtype == torch.bfloat16
    _within(got, want, "bfloat16")


LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_a_train_step_runs_five_products_and_an_eval_step_two(
        monkeypatch, compute_dtype):
    calls = []
    inner = gemm._matmul_call

    def counted(a, w, bias, activation):
        calls.append((tuple(a.shape), tuple(w.shape), a.dtype))
        return inner(a, w, bias, activation)

    monkeypatch.setattr(gemm, "_matmul_call", counted)
    params, step, evaluate, _apply = fused_graph.lower_specs(
        LAYERS, (12,), compute_dtype=compute_dtype,
        input_norm=(1.0 / 255.0, 0.0))
    params = fused_graph.to_tensors(params)
    rng = numpy.random.default_rng(0)
    x = torch.tensor(rng.integers(0, 256, (10, 12)).astype(numpy.uint8))
    labels = torch.tensor(rng.integers(0, 3, 10).astype(numpy.int32))
    step(params, x, labels)
    # 2 forward, layer 2's da and dw, layer 1's dw (its input is data)
    assert len(calls) == 5
    assert sorted(shape for shape, _w, _d in calls[2:]) == sorted(
        [(10, 3), (12, 10), (8, 10)])
    if compute_dtype:
        # layer 1's products are bf16; the softmax layer widens to f32
        assert [d for _a, _w, d in calls].count(torch.bfloat16) == 2
    del calls[:]
    evaluate(params, x, labels)
    assert len(calls) == 2


@pytest.mark.parametrize("case", ["float64", "mixed", "int"])
def test_the_kernel_wrapper_refuses_other_types(case):
    a = torch.zeros((4, 6))
    w = torch.zeros((6, 3))
    if case == "float64":
        a, w = a.double(), w.double()
    elif case == "mixed":
        w = w.bfloat16()
    else:
        a, w = a.int(), w.int()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gemm._matmul_cuda(a, w, None, None)
    # the plain version serves float64 on the CPU (debugging)
    if case == "float64":
        assert gemm.matmul(a, w).dtype == torch.float64
