"""MnistSimple: the 784→100→10 softmax MLP, the port's counterpart of
:mod:`veles_tpu.samples.mnist`.

``create_workflow()`` builds the eager ``StandardWorkflow`` over the
resident MNIST dataset (the synthetic stand-in when the IDX files are
absent) and initializes it on the card; ``device="cpu"`` runs the same
units over CPU tensors, where each kernel wrapper takes its plain
version.  Every forward is one GEMM kernel launch and every gradient
unit one dx/dw/db kernel step (``ops/gemm.py``).  Run it with

    python -m veles_tpu_torch.samples.mnist [--device cpu] [--max-epochs N]

which prints ``gather_results()`` and the epochs per second.
"""

import argparse
import json
import logging
import sys
import time

import numpy

from veles_tpu_torch.backends import make_device
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples.datasets import load_mnist
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
]


class MnistLoader(FullBatchLoader):
    """MNIST: validation = the t10k set, train = the train set."""

    def load_data(self):
        tr_x, tr_y, te_x, te_y, real = load_mnist()
        if not real:
            self.warning("real MNIST not found under $VELES_DATASETS or "
                         "root.common.dirs.datasets — using the synthetic "
                         "stand-in data")
        data = numpy.concatenate([te_x, tr_x]).reshape(-1, 784)
        labels = numpy.concatenate([te_y, tr_y])
        self.original_data.mem = numpy.ascontiguousarray(
            data, dtype=numpy.float32)
        self.original_labels = [int(v) for v in labels]
        self.class_lengths[:] = [0, len(te_y), len(tr_y)]


def create_workflow(device=None, max_epochs=25, minibatch_size=100,
                    layers=None, **kwargs):
    """The MNIST MLP workflow, initialized on ``device`` (the card when
    None; raises without one).  ``snapshot_dir`` and ``native`` of the
    JAX function are not ported (ROADMAP items 7 and 1b)."""
    if kwargs.pop("snapshot_dir", None):
        raise NotImplementedError(
            "snapshot_dir (the snapshotter) is not ported yet "
            "(ROADMAP item 7)")
    if kwargs.pop("native", False):
        raise NotImplementedError(
            "native=True (the u8-resident dataset) is not ported yet "
            "(ROADMAP item 1b)")
    device = make_device(device)
    normalization = kwargs.pop("normalization_type", "none")
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: MnistLoader(
            w, minibatch_size=minibatch_size,
            normalization_type=normalization),
        layers=[{**spec} for spec in (layers or LAYERS)],
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": kwargs.pop(
                             "fail_iterations", 50)},
        **kwargs)
    wf.launcher = DummyLauncher()
    wf.initialize(device=device)
    return wf


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.samples.mnist",
        description="Train the MNIST MLP through the eager workflow.")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    parser.add_argument("--max-epochs", type=int, default=25)
    parser.add_argument("--minibatch-size", type=int, default=100)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    wf = create_workflow(device=args.device, max_epochs=args.max_epochs,
                         minibatch_size=args.minibatch_size)
    tic = time.perf_counter()
    wf.run()
    wf.device.sync()
    elapsed = time.perf_counter() - tic
    wf.print_stats()
    results = wf.gather_results()
    # an epoch is one pass over every class (validation + train)
    results["epochs_per_s"] = (wf.loader.samples_served
                               / wf.loader.total_samples / elapsed)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
