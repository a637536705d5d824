"""The STL-10 convnet (the CIFAR-10 stack with a strided first conv and a
128-wide layer over 96×96×3 images, the TRAIN mean subtracted): the
port's counterpart of :mod:`veles_tpu.samples.stl10`.  The stand-in is
the JAX package's synthetic images when the binaries are absent.  Run
it with

    python -m veles_tpu_torch.samples.stl10 [--device cpu]
        [--max-epochs N] [--stitch on|off] [--fused]
"""

import sys

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples import mnist_conv
from veles_tpu_torch.samples.datasets import load_stl10

_BW = {"learning_rate": 0.001, "gradient_moment": 0.9,
       "weights_decay": 0.004}
_FC_BW = {"learning_rate": 0.001, "gradient_moment": 0.9,
          "weights_decay": 0.03}

LAYERS = [
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2,
            "sliding": (2, 2), "weights_filling": "gaussian",
            "weights_stddev": 0.01},
     "<-": dict(_BW)},
    {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 64, "kx": 5, "ky": 5, "padding": 2,
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": dict(_BW)},
    {"type": "avg_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 64, "kx": 3, "ky": 3, "padding": 1,
            "weights_filling": "gaussian", "weights_stddev": 0.01},
     "<-": dict(_BW)},
    {"type": "avg_pooling", "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}},
    {"type": "all2all", "->": {"output_sample_shape": 128,
                               "weights_filling": "gaussian",
                               "weights_stddev": 0.1},
     "<-": dict(_FC_BW)},
    {"type": "softmax", "->": {"output_sample_shape": 10,
                               "weights_filling": "gaussian",
                               "weights_stddev": 0.1},
     "<-": dict(_FC_BW)},
]


class Stl10Loader(FullBatchLoader):
    def load_data(self):
        tr_x, tr_y, te_x, te_y, real = load_stl10()
        if not real:
            self.warning("real STL-10 not found - synthetic stand-in")
        data = numpy.concatenate([te_x, tr_x])
        labels = numpy.concatenate([te_y, tr_y])
        self.original_data.mem = numpy.ascontiguousarray(
            data, dtype=numpy.float32)
        self.original_labels = [int(v) for v in labels]
        self.class_lengths[:] = [0, len(te_y), len(tr_y)]


def create_workflow(device=None, max_epochs=40, minibatch_size=50,
                    layers=None, **kwargs):
    """The workflow, initialized on ``device`` (the card when None)."""
    kwargs.setdefault("normalization_type", "internal_mean")
    return mnist_conv.create_workflow(
        device=device, max_epochs=max_epochs, minibatch_size=minibatch_size,
        layers=layers or LAYERS, loader_class=Stl10Loader, **kwargs)


def main(argv=None):
    return mnist_conv.run_cli("python -m veles_tpu_torch.samples.stl10",
                              create_workflow, argv, 40)


if __name__ == "__main__":
    sys.exit(main())
