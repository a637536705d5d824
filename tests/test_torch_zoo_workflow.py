"""Conv workflows of the layer zoo through ``StandardWorkflow`` against
the JAX package, on the CPU.

Tiny class-structured 10×10 images (3 classes, 16 validation and 48
train samples, minibatch 8) drawn from a seed with numpy train two
epochs in both packages from one seed:

- an mnist_conv-shaped stack (conv, max pooling, conv, max pooling, a
  tanh layer, the softmax), the port's eager units (``engine.stitch=
  off``) and its stitched segments against the JAX eager chain: every
  class close's ``n_err`` equal, the evaluators' confusion matrices
  equal, and every weight, bias and momentum within ``PARAM_TOL`` =
  1e-5 max abs (measured: 1e-7 and below, sums in another order);
- the conv autoencoder of ``mnist_ae`` (conv tanh, the stochastic pool-
  depool, the deconv; MSE): the seeds each stochastic run draws are the
  JAX package's, so the last epoch's validation and train MSE are
  within 1e-5 relative and the parameters within ``PARAM_TOL``;
- a stack of the rest of the zoo: the alias spellings, LRN, maxabs and
  avg pooling, a strided conv, a standalone activation, dropout (its
  masks the JAX package's, and the identity on validation minibatches)
  and ``rprop_all2all``, under the same bounds.
"""

import jax
import numpy
import pytest

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.loader.fullbatch import FullBatchLoaderMSE as JaxFullBatchMSE
from veles_tpu.memory import Vector as JaxVector
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
from veles_tpu_torch.samples import mnist_ae
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
import torch

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

PARAM_TOL = 1e-5
MSE_RTOL = 1e-5
N_VALID, N_TRAIN, SIDE, CLASSES, BATCH = 16, 48, 10, 3, 8

_BW = {"learning_rate": 0.05, "gradient_moment": 0.9,
       "weights_decay": 0.0005}

CONV_STACK = [
    {"type": "conv_strict_relu", "->": {"n_kernels": 4, "kx": 3, "ky": 3},
     "<-": dict(_BW)},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 6, "kx": 3, "ky": 3, "padding": 1},
     "<-": dict(_BW)},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": dict(_BW)},
    {"type": "softmax", "->": {"output_sample_shape": CLASSES},
     "<-": dict(_BW)},
]

#: the rest of the zoo in one stack: the alias spellings, LRN, maxabs and
#: avg pooling, a strided conv, a standalone activation, dropout and the
#: rprop all2all
ZOO_STACK = [
    {"type": "conv_str", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                "padding": 1}, "<-": dict(_BW)},
    {"type": "norm", "->": {"n": 3, "alpha": 0.01}},
    {"type": "maxabs_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_tanh", "->": {"n_kernels": 4, "kx": 3, "ky": 3,
                                 "sliding": (2, 2)}, "<-": dict(_BW)},
    {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "activation_str", "->": {}},
    {"type": "dropout", "->": {"dropout_ratio": 0.3}},
    {"type": "rprop_all2all", "->": {"output_sample_shape": 6},
     "<-": {"rprop_delta_init": 0.01, "weights_decay": 0.001}},
    {"type": "all2all_str", "->": {"output_sample_shape": 6},
     "<-": dict(_BW)},
    {"type": "softmax", "->": {"output_sample_shape": CLASSES},
     "<-": dict(_BW)},
]


def _images():
    rng = numpy.random.default_rng(21)
    n = N_VALID + N_TRAIN
    labels = rng.integers(0, CLASSES, n)
    templates = rng.standard_normal((CLASSES, SIDE, SIDE, 1))
    x = (templates[labels] + rng.standard_normal((n, SIDE, SIDE, 1))
         ).astype(numpy.float32)
    return x, [int(v) for v in labels]


def _load(self):
    x, labels = _images()
    self.original_data.mem = x
    self.original_labels = labels
    self.class_lengths[:] = [0, N_VALID, N_TRAIN]


def _load_mse(self):
    x, _labels = _images()
    self.original_data.mem = x
    self.original_targets.mem = x.copy()
    self.original_labels = []
    self.class_lengths[:] = [0, N_VALID, N_TRAIN]


class Images(FullBatchLoader):
    load_data = _load


class JaxImages(JaxFullBatch):
    load_data = _load


class ImagesMSE(FullBatchLoaderMSE):
    load_data = _load_mse


class JaxImagesMSE(JaxFullBatchMSE):
    load_data = _load_mse


def _synchronous(wf):
    """The JAX eager chain waiting for each unit's results (its loader
    rewrites host buffers a dispatched step may still read)."""
    for unit in wf.units:
        def run(unit=unit, inner=unit.run):
            inner()
            for value in list(unit.__dict__.values()):
                if isinstance(value, JaxVector):
                    value = value._devmem_
                if isinstance(value, jax.Array):
                    value.block_until_ready()
        unit.run = run
    return wf


def _record(wf):
    """Record ``(epoch, class, n_err)`` at each of a DecisionGD's class
    closes (both packages close through ``_close_class``)."""
    dec = wf.decision
    dec.closes_seen = []
    if not hasattr(dec, "epoch_n_err"):
        return wf
    close = dec._close_class

    def recording(cls, check_epoch_end):
        dec.closes_seen.append((int(dec.epoch_number), int(cls),
                                float(dec.epoch_n_err[cls])))
        return close(cls, check_epoch_end)
    dec._close_class = recording
    return wf


def _build(jax_side, layers, mse=False, seed=5):
    (jax_prng if jax_side else prng).seed_all(seed)
    if mse:
        loader = JaxImagesMSE if jax_side else ImagesMSE
    else:
        loader = JaxImages if jax_side else Images
    klass = JaxStandardWorkflow if jax_side else StandardWorkflow
    wf = klass(None, loader_factory=lambda w: loader(w,
                                                     minibatch_size=BATCH),
               layers=[dict(s) for s in layers],
               loss_function="mse" if mse else "softmax",
               decision_config={"max_epochs": 2, "fail_iterations": 50})
    wf.launcher = JaxDummyLauncher() if jax_side else DummyLauncher()
    wf.initialize(device=JaxCPUDevice() if jax_side else CPUDevice())
    if jax_side:
        _synchronous(wf)
    return _record(wf)


def _params(wf):
    gds = list(reversed(wf.gds))
    out = {}
    for i, fwd in enumerate(wf.forwards):
        for name, vec in (("w", fwd.weights), ("b", fwd.bias),
                          ("vw", gds[i].gradient_weights),
                          ("vb", gds[i].gradient_bias)):
            if vec:
                vec.map_read()
                out["%d.%s" % (i, name)] = numpy.array(vec.mem)
    return out


def _run_jax(layers, mse=False):
    eng = jax_root.common.engine
    saved = {k: eng.get(k, d) for k, d in (("kernels", "auto"),
                                           ("stitch", "on"))}
    eng.kernels, eng.stitch = "xla", "off"
    try:
        wf = _build(True, layers, mse)
        wf.run()
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)
    out = {"closes": wf.decision.closes_seen, "params": _params(wf)}
    if mse:
        out["mse"] = [float(v) for v in wf.decision.epoch_mse[1:]]
    else:
        wf.evaluator.confusion_matrix.map_read()
        out["confusion"] = numpy.array(wf.evaluator.confusion_matrix.mem)
    return out


def _run_port(layers, stitch, mse=False):
    saved = root.common.engine.get("stitch", "on")
    root.common.engine.stitch = stitch
    try:
        wf = _build(False, layers, mse)
        wf.run()
    finally:
        root.common.engine.stitch = saved
    out = {"closes": wf.decision.closes_seen, "params": _params(wf),
           "segments": [seg.names for seg in wf.stitch_segments]}
    if mse:
        out["mse"] = [float(v) for v in wf.decision.epoch_mse[1:]]
    else:
        wf.evaluator.confusion_matrix.map_read()
        out["confusion"] = numpy.array(wf.evaluator.confusion_matrix.mem)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Each stack trained once by the JAX package."""
    return {"conv": _run_jax(CONV_STACK), "zoo": _run_jax(ZOO_STACK),
            "ae": _run_jax(mnist_ae.make_conv_layers(kernels=4), mse=True)}


def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        err = float(numpy.abs(got[name] - ref).max())
        assert err <= PARAM_TOL, (name, err)


_STACKS = {"conv": CONV_STACK, "zoo": ZOO_STACK}


@pytest.mark.parametrize("stitch", ["off", "on"])
@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_conv_stacks_train_as_the_jax_workflow(jax_runs, stack, stitch):
    want = jax_runs[stack]
    got = _run_port(_STACKS[stack], stitch)
    assert got["closes"] == want["closes"]
    assert numpy.array_equal(got["confusion"], want["confusion"])
    _assert_params(got["params"], want["params"])
    if stitch == "off":
        assert got["segments"] == []
    elif stack == "conv":
        # the loader head, both convs, both poolings, the two GEMM layers
        # and the evaluator in one segment; the whole GD chain in another
        assert got["segments"] == [
            ["Images", "ConvStrictRELU", "MaxPooling", "ConvStrictRELU",
             "MaxPooling", "All2AllTanh", "All2AllSoftmax",
             "EvaluatorSoftmax"],
            ["GDSoftmax", "GDTanh", "GDPooling", "GDConvStrictRELU",
             "GDPooling", "GDConvStrictRELU"]]
    else:
        # dropout draws a seed at every run: a barrier, as in the JAX
        # package, with its backward
        assert not any("DropoutForward" in seg or "DropoutBackward" in seg
                       for seg in got["segments"])


@pytest.mark.parametrize("stitch", ["off", "on"])
def test_conv_autoencoder_trains_as_the_jax_workflow(jax_runs, stitch):
    want = jax_runs["ae"]
    got = _run_port(mnist_ae.make_conv_layers(kernels=4), stitch, mse=True)
    assert got["mse"] == pytest.approx(want["mse"], rel=MSE_RTOL)
    _assert_params(got["params"], want["params"])
