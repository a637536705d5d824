"""The port's int8 (W8A16) serving deploy against the JAX package's, on
the CPU.

The same numpy inputs (one seed) go through both packages:

- the quantization walks (``quantize_array``,
  ``quantize_transformer_params``, ``quantize_stage_params``) give
  bit-equal ``q`` and ``scale``;
- the plain qmatmul (``_qmatmul_ref``) is held against ``_qmatmul_jnp``
  and against ``_qmatmul_pallas`` in interpret mode, every activation
  including gelu, within 1e-5 relative (both sides take f32 products of
  the same values and sum them in another order, and XLA may fuse the
  epilogue's multiply and add);
- an int8 engine serves the JAX int8 engine's token streams in both kv
  modes, chunked and speculative;
- the calibration drift agrees within 1e-5, and an over-budget drift
  names the same worst block weight;
- ``describe()["params_bytes"]`` equals the JAX engine's
  ``params_nbytes`` at f32, float and int8.

On the CPU the qmatmul wrapper takes its plain version, so no kernel is
launched here; the kernel is held against that plain version on the card
(``chip_smoke.py``, ``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy
import pytest
import torch

from veles_tpu import quant as jax_quant
from veles_tpu.gen import GenerativeEngine as JaxEngine
from veles_tpu.gen import GenerativeScheduler as JaxScheduler
from veles_tpu.gen import TransformerGenModel as JaxModel
from veles_tpu.ops import qgemm as jax_qgemm
from veles_tpu.znicz import all2all as jax_all2all
from veles_tpu_torch import quant
from veles_tpu_torch.dummy import DummyWorkflow
from veles_tpu_torch.gen import (GenerativeEngine, GenerativeScheduler,
                                 TransformerGenModel, params_from_numpy)
from veles_tpu_torch.ops import qgemm
from veles_tpu_torch.samples.transformer import TINY
from veles_tpu_torch.znicz import all2all

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

CFG = dict(TINY, seq_len=64)
CPU = "cpu"
ACTIVATIONS = (None, "tanh", "sigmoid", "relu", "strict_relu", "gelu")
QMM_RTOL = 1e-5
DRIFT_TOL = 1e-5


def _qmm_close(got, want):
    want = numpy.asarray(want, numpy.float32)
    numpy.testing.assert_allclose(
        numpy.asarray(got, numpy.float32), want, rtol=QMM_RTOL,
        atol=QMM_RTOL * float(numpy.abs(want).max()))


# -- the quantization walks ---------------------------------------------------

@pytest.mark.parametrize("shape,axes", [((96, 40), (0,)), ((8, 4), (0,)),
                                        ((6, 3, 4, 5), (1,)),
                                        ((4, 2, 3, 7), (1, 2))])
def test_quantize_array_equals_jax_bitwise(shape, axes):
    w = numpy.random.default_rng(0).standard_normal(shape).astype(
        numpy.float32)
    w[..., 0] = 0.0                            # an all-zero channel
    got, want = quant.quantize_array(w, axes), jax_quant.quantize_array(w,
                                                                        axes)
    for key in ("q", "scale"):
        assert got[key].dtype == want[key].dtype
        assert got[key].tobytes() == want[key].tobytes(), key
    assert quant.dequantize_array(got).tobytes() == \
        jax_quant.dequantize_array(want).tobytes()


@pytest.mark.parametrize("only", [None, "wqkv", "wo", "w1", "w2"])
def test_quantize_transformer_params_equals_jax_bitwise(only):
    params = TransformerGenModel(CFG, device=CPU).init_params(seed=3)
    got = quant.quantize_transformer_params(params, only=only)
    want = jax_quant.quantize_transformer_params(params, only=only)
    for key, leaf in want["blocks"].items():
        mine = got["blocks"][key]
        assert quant.is_quantized_leaf(mine) == \
            jax_quant.is_quantized_leaf(leaf), key
        pairs = [("q", mine["q"], leaf["q"]),
                 ("scale", mine["scale"], leaf["scale"])] \
            if jax_quant.is_quantized_leaf(leaf) else [("w", mine, leaf)]
        for name, a, b in pairs:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (key, name)
    assert quant.tree_is_quantized(got) == jax_quant.tree_is_quantized(want)


@pytest.mark.parametrize("axes_list", [None, [{"w": (1,)}, None, None]])
def test_quantize_stage_params_equals_jax_bitwise(axes_list):
    rng = numpy.random.default_rng(1)
    stages = [{"w": rng.standard_normal((10, 6)).astype(numpy.float32),
               "b": numpy.ones(6, numpy.float32)},
              {"w": rng.standard_normal((3, 3, 2, 5)).astype(numpy.float32)},
              {"seed": numpy.int32(7)}]
    got = quant.quantize_stage_params(stages, axes_list)
    want = jax_quant.quantize_stage_params(stages, axes_list)
    for mine, ref in zip(got, want):
        assert sorted(mine) == sorted(ref)
        for key in ref:
            if jax_quant.is_quantized_leaf(ref[key]):
                for part in ("q", "scale"):
                    assert mine[key][part].tobytes() == \
                        ref[key][part].tobytes()
            else:
                assert numpy.asarray(mine[key]).tobytes() == \
                    numpy.asarray(ref[key]).tobytes()
    assert quant.tree_nbytes(got) == jax_quant.tree_nbytes(want)
    with pytest.raises(quant.QuantizationError):
        quant.quantize_stage_params([{"b": numpy.ones(4, numpy.float32)}])


def test_tree_nbytes_counts_a_storage_once():
    w = torch.ones((100, 10))
    assert quant.tree_nbytes({"w": w}) == 4000
    assert quant.tree_nbytes({"w": w, "alias": w.to(torch.float32),
                              "view": w[3]}) == 4000
    pair = quant.quantize_stage_params([{"w": w.numpy()}])
    assert quant.tree_nbytes(pair) == 1000 + 40 == \
        jax_quant.tree_nbytes(pair)
    assert quant.tree_nbytes(params_from_numpy(pair[0], CPU)) == 1040


# -- the plain qmatmul against the JAX references -----------------------------

def _qmm_case(seed, m, k, n, shuffle=False, bias=True):
    rng = numpy.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(numpy.float32)
    qw = quant.quantize_array(rng.standard_normal((k, n)).astype(
        numpy.float32), axes=(0,))
    q, scale = qw["q"], qw["scale"].reshape(-1)
    if shuffle:
        perm = rng.permutation(n)
        q, scale = numpy.ascontiguousarray(q[:, perm]), scale[perm]
    b = rng.standard_normal(n).astype(numpy.float32) if bias else None
    return a, q, scale, b


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("case", [
    dict(m=32, k=128, n=128, tiles=(32, 128, 128)),          # one block
    dict(m=100, k=300, n=136, tiles=(32, 128, 128), shuffle=True),
    dict(m=5, k=200, n=130, tiles=(8, 128, 128)),            # ragged
    dict(m=16, k=128, n=128, tiles=(16, 128, 128), bias=False)],
    ids=["single_block", "remainder_shuffled", "ragged", "no_bias"])
def test_qmatmul_ref_matches_jnp_and_interpret_pallas(case, activation):
    case = dict(case)
    tiles = case.pop("tiles")
    a, q, scale, b = _qmm_case(7, **case)
    got = qgemm.qmatmul(*(None if x is None else torch.from_numpy(x)
                          for x in (a, q, scale, b)), activation)
    assert got.dtype == torch.float32 and not any(qgemm.launches.values())
    jargs = [None if x is None else jnp.asarray(x) for x in (a, q, scale, b)]
    _qmm_close(got, jax_qgemm._qmatmul_jnp(*jargs, activation=activation))
    _qmm_close(got, jax_qgemm._qmatmul_pallas(
        *jargs, activation=activation, tiles=tiles, interpret=True))


def test_qmatmul_ref_takes_bf16_activations_and_out_dtype():
    a, q, scale, b = _qmm_case(8, 6, 64, 40)
    got = qgemm.qmatmul(torch.from_numpy(a).to(torch.bfloat16),
                        torch.from_numpy(q), torch.from_numpy(scale),
                        torch.from_numpy(b).to(torch.bfloat16), "gelu")
    want = jax_qgemm._qmatmul_jnp(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
        jnp.asarray(b, jnp.bfloat16), activation="gelu")
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the output on each side: within one ulp
    numpy.testing.assert_allclose(got.float().numpy(),
                                  numpy.asarray(want, numpy.float32),
                                  rtol=2 ** -7, atol=1e-6)
    out = qgemm.qmatmul(torch.from_numpy(a).to(torch.bfloat16),
                        torch.from_numpy(q), torch.from_numpy(scale),
                        out_dtype=torch.float32)
    assert out.dtype == torch.float32
    with pytest.raises(ValueError, match="activation"):
        qgemm.qmatmul(torch.from_numpy(a), torch.from_numpy(q),
                      torch.from_numpy(scale), activation="swish")


def test_split_k_covers_the_card_and_keeps_a_tile_per_split():
    assert qgemm.split_k(4, 1024, 1024) == 8        # decode: 16 tiles
    assert qgemm.split_k(4, 3072, 1024) == 8
    assert qgemm.split_k(2048, 1024, 1024) == 1     # prefill: 512 tiles
    assert qgemm.split_k(256, 1024, 1024) == 8      # a chunk: 64 tiles
    assert qgemm.split_k(256, 4096, 1024) == 2
    assert qgemm.split_k(5, 130, 200) == 4          # 4 K tiles, one each
    assert qgemm.split_k(4, 64, 64) == 1            # one K tile


@pytest.mark.parametrize("m,k,n,split", [
    (2048, 1024, 3072, 1),      # 384 tensor-core tiles: no split
    (2048, 1024, 4096, 1),      # 512 tiles
    (2048, 1024, 1024, 2),      # 128 tiles: doubled once, to 256
    (2048, 4096, 1024, 2),
    (256, 1024, 3072, 4),       # 48 tiles
    (256, 1024, 1024, 8),       # 16 tiles
    (32, 4096, 1024, 8),        # 8 tiles
    (17, 100, 100, 4),          # 4 K tiles of 32: one a split
    (2048, 100, 1, 4),
    (17, 32, 100, 1),           # one K tile
])
def test_split_k_of_the_tensor_core_body(m, k, n, split):
    """bf16 at M > 16 runs the tensor-core body: 128 x 128 tiles, K in
    steps of 32, and the split doubles while the grid covers the SMs
    less than once."""
    assert qgemm.tile(m, torch.bfloat16) == qgemm.TC_TILE == (128, 128, 32)
    assert qgemm.split_k(m, n, k, torch.bfloat16) == split


@pytest.mark.parametrize("m,dtype,tile", [
    (4, torch.bfloat16, (16, 128, 64)), (16, torch.bfloat16, (16, 128, 64)),
    (16, torch.float32, (16, 64, 64)), (17, torch.float32, (64, 64, 64)),
    (2048, torch.float32, (64, 64, 64)), (17, torch.bfloat16, (128, 128, 32)),
])
def test_qmatmul_body_tile_follows_dtype_and_m(m, dtype, tile):
    """The decode body for bf16 at M <= 16 (its column tile narrowed to
    64 where ``decode_plan`` says), the tensor-core body for bf16 above,
    the FMA body for f32; the f32 default keeps the FMA body's splits."""
    assert qgemm.tile(m, dtype) == tile
    assert qgemm.split_k(m, 1024, 1024) == qgemm.split_k(m, 1024, 1024,
                                                         torch.float32)


# -- All2All with a quantized leaf --------------------------------------------

@pytest.mark.parametrize("name,activation", [
    ("All2AllStrictRELU", "strict_relu"), ("All2AllTanh", "tanh"),
    ("All2AllSoftmax", None)])
def test_all2all_pure_with_quantized_leaf_matches_jax(name, activation):
    rng = numpy.random.default_rng(8)
    x = rng.standard_normal((6, 8)).astype(numpy.float32)
    w = rng.standard_normal((8, 5)).astype(numpy.float32)
    b = rng.standard_normal(5).astype(numpy.float32)
    # transposed storage: the deploy walk canonicalizes to (fan-in, out)
    for stored, axes in ((w, (0,)), (w.T, (1,))):
        qw = quant.quantize_stage_params(
            [{"w": stored, "b": b}], axes_list=[{"w": axes}])[0]
        unit = getattr(all2all, name)(DummyWorkflow(), output_sample_shape=5,
                                      weights_transposed=axes == (1,))
        got = unit.pure(params_from_numpy(qw, CPU), torch.from_numpy(x))
        want = jax_all2all.All2All.pure(
            {"w": {k: jnp.asarray(v) for k, v in qw["w"].items()},
             "b": jnp.asarray(b)}, jnp.asarray(x), activation=activation,
            is_softmax=name == "All2AllSoftmax", transposed=axes == (1,))
        _qmm_close(got.numpy(), want)


# -- the generative engine ---------------------------------------------------

def gen_workload(n=8, seed=0):
    rng = numpy.random.default_rng(seed)
    return [(rng.integers(0, CFG["vocab"], int(rng.integers(1, 16))).tolist(),
             int(rng.integers(1, 10))) for _ in range(n)]


def _run(engine, scheduler_cls, workload):
    scheduler = scheduler_cls(engine)
    futures = [scheduler.submit(t, m) for t, m in workload]
    scheduler.run_until_idle()
    return [f.result(0) for f in futures]


ENGINE_MODES = {
    "contiguous": {},
    "contiguous_ngram": dict(speculative="ngram", draft_k=4),
    "paged_chunked": dict(kv="paged", block_size=8, num_blocks=3 * 6 + 1,
                          prefill_chunk=8),
    "paged_chunked_prefix_ngram": dict(kv="paged", block_size=8,
                                       prefill_chunk=8, prefix_cache="on",
                                       speculative="ngram", draft_k=3),
}
_jax_streams = {}


def _jax_int8_streams(mode):
    if mode not in _jax_streams:
        engine = JaxEngine(JaxModel(CFG), max_slots=3, max_seq=48,
                           prefill_buckets=(8, 16), seed=0,
                           **ENGINE_MODES[mode])
        engine.quantize_int8()
        _jax_streams[mode] = _run(engine.warmup(), JaxScheduler,
                                  gen_workload())
        engine.close()
    return _jax_streams[mode]


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_int8_engine_streams_equal_jax(mode):
    engine = GenerativeEngine(
        TransformerGenModel(CFG, device=CPU), max_slots=3, max_seq=48,
        prefill_buckets=(8, 16), seed=0, device=CPU, **ENGINE_MODES[mode])
    engine.quantize_int8()
    assert engine.describe()["quantize"] == "int8"
    streams = _run(engine.warmup(), GenerativeScheduler, gen_workload())
    engine.close()
    assert streams == _jax_int8_streams(mode)
    assert [len(s) for s in streams] == [m for _t, m in gen_workload()]


def test_quantized_tree_given_to_the_constructor_serves_alike():
    params = quant.quantize_transformer_params(
        TransformerGenModel(CFG, device=CPU).init_params(seed=0))
    engine = GenerativeEngine(
        TransformerGenModel(CFG, device=CPU), params, max_slots=3,
        max_seq=48, prefill_buckets=(8, 16), device=CPU)
    assert engine.quantized == "int8"
    assert engine._params["blocks"]["w1"]["q"].dtype == torch.int8
    streams = _run(engine.warmup(), GenerativeScheduler, gen_workload())
    engine.close()
    assert streams == _jax_int8_streams("contiguous")


def test_params_bytes_equal_jax_float_and_int8():
    cfg = dict(TINY, dim=64, mlp_ratio=4, seq_len=64)
    port = GenerativeEngine(TransformerGenModel(cfg, device=CPU),
                            max_slots=2, max_seq=32, prefill_buckets=(8,),
                            device=CPU)
    ref = JaxEngine(JaxModel(cfg), max_slots=2, max_seq=32,
                    prefill_buckets=(8,))
    float_bytes = port.describe()["params_bytes"]
    assert float_bytes == ref.params_nbytes == 431104
    assert port.describe()["quantize"] is None
    port.quantize_int8()
    ref.quantize_int8()
    assert port.describe()["params_bytes"] == port.params_nbytes == \
        ref.params_nbytes == 140800
    assert port.params_nbytes / float_bytes <= 0.35
    port.close()
    ref.close()


def test_bf16_engine_quantizes_its_float32_masters_as_jax():
    """At a bf16 compute_dtype the served block weights are bf16; the
    int8 tree is still made from the float32 masters, so ``q`` and
    ``scale`` are bit-equal to the JAX engine's at the same dtype."""
    port = GenerativeEngine(
        TransformerGenModel(CFG, compute_dtype=torch.bfloat16, device=CPU),
        max_slots=2, max_seq=32, prefill_buckets=(8,), device=CPU)
    ref = JaxEngine(JaxModel(CFG, compute_dtype=jnp.bfloat16), max_slots=2,
                    max_seq=32, prefill_buckets=(8,))
    assert port._params["blocks"]["w1"].dtype == torch.bfloat16
    port.quantize_int8(calibration_tokens=[1, 2, 3, 4, 5], tol=0.5)
    ref.quantize_int8(calibration_tokens=[1, 2, 3, 4, 5], tol=0.5)
    for key in ("wqkv", "wo", "w1", "w2"):
        got, want = port._params["blocks"][key], ref._params["blocks"][key]
        numpy.testing.assert_array_equal(got["q"].numpy(),
                                         numpy.asarray(want["q"]))
        numpy.testing.assert_array_equal(got["scale"].numpy(),
                                         numpy.asarray(want["scale"]))
    assert port._masters is None
    port.close()
    ref.close()


def test_quantize_after_warmup_or_a_served_step_is_refused():
    build = (lambda: GenerativeEngine(
        TransformerGenModel(CFG, device=CPU), max_slots=2, max_seq=32,
        prefill_buckets=(8,), device=CPU))
    warmed = build().warmup()
    with pytest.raises(RuntimeError, match="before warmup"):
        warmed.quantize_int8()
    served = build()
    served.prefill([1, 2, 3])
    with pytest.raises(RuntimeError, match="before warmup"):
        served.quantize_int8()
    assert warmed.quantized is None and served.quantized is None
    again = build().quantize_int8()
    assert again.quantize_int8() is again       # already int8: a no-op


# -- the calibration drift gate -----------------------------------------------

def _drift(quant_module, model, params, tokens):
    ref = numpy.asarray(model.calibration_logits(params, tokens),
                        numpy.float32)
    qparams = quant_module.quantize_transformer_params(params)
    got = model.calibration_logits(qparams, tokens)
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    return quant_module.relative_drift(ref, got)


def test_calibration_drift_equals_jax():
    cfg = dict(TINY, seq_len=32)
    params = TransformerGenModel(cfg, device=CPU).init_params(seed=0)
    tokens = [1, 2, 3, 4, 5]
    got = _drift(quant, TransformerGenModel(cfg, device=CPU), params, tokens)
    want = _drift(jax_quant, JaxModel(cfg), params, tokens)
    assert abs(got - want) <= DRIFT_TOL
    qparams = quant.quantize_gen_params(
        TransformerGenModel(cfg, device=CPU), params,
        calibration_tokens=tokens, tol=0.5)
    assert quant.tree_is_quantized(qparams)


def test_over_budget_drift_names_the_same_worst_layer_as_jax():
    cfg = dict(TINY, seq_len=32)
    params = TransformerGenModel(cfg, device=CPU).init_params(seed=0)
    tokens = [1, 2, 3, 4]
    with pytest.raises(quant.QuantizationError) as got:
        quant.quantize_gen_params(TransformerGenModel(cfg, device=CPU),
                                  params, calibration_tokens=tokens)
    with pytest.raises(jax_quant.QuantizationError) as want:
        jax_quant.quantize_gen_params(JaxModel(cfg), params,
                                      calibration_tokens=tokens)
    assert got.value.layer == want.value.layer
    assert got.value.layer.startswith("blocks.")
    assert abs(got.value.drift - want.value.drift) <= DRIFT_TOL
    assert got.value.drift > quant.DRIFT_TOL
    assert got.value.layer in str(got.value)


def test_engine_drift_gate_raises_before_touching_the_params():
    engine = GenerativeEngine(
        TransformerGenModel(dict(TINY, seq_len=32), device=CPU), max_slots=2,
        max_seq=32, prefill_buckets=(8,), device=CPU)
    before = engine.params_nbytes
    with pytest.raises(quant.QuantizationError):
        engine.quantize_int8(calibration_tokens=[1, 2, 3, 4])
    assert engine.quantized is None and engine.params_nbytes == before
    engine.close()

