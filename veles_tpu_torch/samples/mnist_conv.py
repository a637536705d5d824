"""The MNIST convnet (LeNet-style: conv/pool twice, a 500-wide tanh
layer and the softmax over 28×28×1 images): the port's counterpart of
:mod:`veles_tpu.samples.mnist_conv`.

``create_workflow()`` builds the ``StandardWorkflow`` over the resident
MNIST images (the synthetic stand-in when the IDX files are absent) and
initializes it on the card; ``device="cpu"`` runs the same units over
CPU tensors.  Stitched (the default), a minibatch is the loader head's
gather with the two convs (cuDNN), the two max poolings, the two GEMM
layers and the evaluator in one segment, and the GD chain in the other:
the two all2all GD units on the dx/dw kernels, the conv and pooling
backwards as VJPs.  ``fused=True`` trains through one
:class:`~veles_tpu_torch.znicz.fused_unit.FusedTrainer` step a
minibatch.  Run it with

    python -m veles_tpu_torch.samples.mnist_conv [--device cpu]
        [--max-epochs N] [--stitch on|off] [--fused]

which prints ``gather_results()`` and the epochs per second.
"""

import argparse
import json
import logging
import sys
import time

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples import launch
from veles_tpu_torch.samples.datasets import load_mnist
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

LAYERS = [
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 20, "kx": 5, "ky": 5,
            "weights_filling": "uniform"},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "conv_strict_relu",
     "->": {"n_kernels": 50, "kx": 5, "ky": 5,
            "weights_filling": "uniform"},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 500},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
]


class MnistConvLoader(FullBatchLoader):
    """The images kept 2-D, (28, 28, 1), for the conv stack."""

    def load_data(self):
        tr_x, tr_y, te_x, te_y, real = load_mnist()
        if not real:
            self.warning("real MNIST not found - synthetic stand-in")
        data = numpy.concatenate([te_x, tr_x]).reshape(-1, 28, 28, 1)
        labels = numpy.concatenate([te_y, tr_y])
        self.original_data.mem = numpy.ascontiguousarray(
            data, dtype=numpy.float32)
        self.original_labels = [int(v) for v in labels]
        self.class_lengths[:] = [0, len(te_y), len(tr_y)]


def create_workflow(device=None, max_epochs=25, minibatch_size=100,
                    layers=None, loader_class=MnistConvLoader, **kwargs):
    """The workflow over ``loader_class``'s dataset, initialized on
    ``device`` (the card when None; raises without one); given
    ``launcher=``, left to the launcher to initialize."""
    launcher = kwargs.pop("launcher", None)
    loader_kwargs = {"minibatch_size": minibatch_size}
    if "normalization_type" in kwargs:
        loader_kwargs["normalization_type"] = kwargs.pop(
            "normalization_type")
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: loader_class(w, **loader_kwargs),
        layers=[{**spec} for spec in (layers or LAYERS)],
        decision_config={"max_epochs": max_epochs},
        **kwargs)
    return launch(wf, launcher, device)


def run_cli(prog, create, argv, max_epochs):
    """The samples' command line: train, print ``gather_results()`` with
    the epochs per second."""
    parser = argparse.ArgumentParser(
        prog=prog, description="Train the sample through the workflow.")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    parser.add_argument("--max-epochs", type=int, default=max_epochs)
    parser.add_argument("--stitch", choices=("on", "off"), default=None,
                        help="engine.stitch (default: the config's, on)")
    parser.add_argument("--fused", action="store_true",
                        help="train through the FusedTrainer")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if args.stitch is not None:
        root.common.engine.stitch = args.stitch
    wf = create(device=args.device, max_epochs=args.max_epochs,
                fused=args.fused)
    tic = time.perf_counter()
    wf.run()
    wf.device.sync()
    elapsed = time.perf_counter() - tic
    results = wf.gather_results()
    results["epochs_per_s"] = (wf.loader.samples_served
                               / wf.loader.total_samples / elapsed)
    print(json.dumps(results))
    return 0


def main(argv=None):
    return run_cli("python -m veles_tpu_torch.samples.mnist_conv",
                   create_workflow, argv, 25)


if __name__ == "__main__":
    sys.exit(main())
