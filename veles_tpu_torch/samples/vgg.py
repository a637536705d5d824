"""VGG-A (VGG-11) through the fused lowering: the port's counterpart of
:mod:`veles_tpu.samples.vgg`.

Simonyan & Zisserman 2014 configuration A: eight 3×3 convs
(64→128→256×2→512×2→512×2, a max pooling after each block), two
4096-wide layers with dropout and the 1000-way softmax.
:func:`build_fused` is :func:`veles_tpu_torch.samples.alexnet
.build_fused` over this stack, with ``remat`` on by default (the 224²×64
early activations); :func:`create_workflow` is its StandardWorkflow twin
over synthetic shape-true data; ``mesh=`` trains data-parallel, as
AlexNet's does.  Run it with

    python -m veles_tpu_torch.samples.vgg [--device cpu] [--batch B]
        [--steps N] [--bf16]
"""

import sys

import numpy

from veles_tpu_torch.samples import alexnet

_CONV_BW = {"learning_rate": 0.01, "gradient_moment": 0.9,
            "weights_decay": 0.0005}


def _conv(n_kernels):
    return {"type": "conv_strict_relu",
            "->": {"n_kernels": n_kernels, "kx": 3, "ky": 3,
                   "padding": 1, "weights_filling": "gaussian",
                   "weights_stddev": 0.01},
            "<-": dict(_CONV_BW)}


def _pool():
    return {"type": "max_pooling",
            "->": {"kx": 2, "ky": 2, "sliding": (2, 2)}}


LAYERS = [
    _conv(64), _pool(),
    _conv(128), _pool(),
    _conv(256), _conv(256), _pool(),
    _conv(512), _conv(512), _pool(),
    _conv(512), _conv(512), _pool(),
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_strict_relu",
     "->": {"output_sample_shape": 4096, "weights_filling": "gaussian",
            "weights_stddev": 0.005},
     "<-": dict(_CONV_BW)},
    {"type": "dropout", "->": {"dropout_ratio": 0.5}},
    {"type": "all2all_strict_relu",
     "->": {"output_sample_shape": 4096, "weights_filling": "gaussian",
            "weights_stddev": 0.005},
     "<-": dict(_CONV_BW)},
    {"type": "softmax",
     "->": {"output_sample_shape": 1000, "weights_filling": "gaussian",
            "weights_stddev": 0.01},
     "<-": dict(_CONV_BW)},
]

INPUT_SHAPE = (224, 224, 3)


def build_fused(mesh=None, layers=None, input_shape=INPUT_SHAPE,
                compute_dtype=None, device=None, remat=True, grad_accum=1):
    """``(params, step, eval, apply)`` as :func:`alexnet.build_fused`
    gives them, over VGG-A."""
    return alexnet.build_fused(
        mesh=mesh, layers=layers or LAYERS, input_shape=input_shape,
        compute_dtype=compute_dtype, device=device, remat=remat,
        grad_accum=grad_accum)


def benchmark(batch=32, steps=10, mesh=None, layers=None,
              input_shape=INPUT_SHAPE, compute_dtype=None, device=None):
    """Images per second of the fused train step."""
    return alexnet.benchmark(
        batch=batch, steps=steps, mesh=mesh, layers=layers,
        input_shape=input_shape, compute_dtype=compute_dtype,
        device=device, build=build_fused)


def create_workflow(device=None, max_epochs=1, minibatch_size=32,
                    layers=None, n_samples=256, input_shape=INPUT_SHAPE,
                    **kwargs):
    """The StandardWorkflow over ``n_samples`` synthetic images of
    ``input_shape`` (a quarter for validation), initialized on
    ``device`` (the card when None)."""
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.samples import mnist_conv

    class SyntheticImageNetLoader(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.default_rng(4)
            self.original_data.mem = rng.standard_normal(
                (n_samples,) + tuple(input_shape)).astype(numpy.float32)
            self.original_labels = [int(v) for v in
                                    rng.integers(0, 1000, n_samples)]
            self.class_lengths[:] = [0, n_samples // 4,
                                     n_samples - n_samples // 4]

    return mnist_conv.create_workflow(
        device=device, max_epochs=max_epochs, minibatch_size=minibatch_size,
        layers=layers or LAYERS, loader_class=SyntheticImageNetLoader,
        **kwargs)


def main(argv=None):
    return alexnet.main(argv, module="vgg", default_batch=32,
                        bench=benchmark)


if __name__ == "__main__":
    sys.exit(main())
