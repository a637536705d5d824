"""The MNIST row-sequence LSTM classifier: the port's counterpart of
:mod:`veles_tpu.samples.mnist_rnn`.

Each 28×28 image is read as a sequence of 28 rows (T = 28, D = 28) by
an LSTM of 128 units whose last hidden state feeds a softmax head of
10, minibatch 100, learning rate 0.01 with momentum 0.9: the JAX
sample's width.  ``create_workflow()`` builds the ``StandardWorkflow``
over the resident images (the synthetic stand-in when the IDX files
are absent) and initializes it on the card; ``device="cpu"`` runs the
same units over CPU tensors.  Stitched (the default), a minibatch is
the loader head's gather, the LSTM's loop, the softmax GEMM and the
evaluator in one segment, and the softmax GD (the dx and dw kernels)
with the LSTM's VJP in the other.  ``fused=True`` trains through one
:class:`~veles_tpu_torch.znicz.fused_unit.FusedTrainer` step a
minibatch.  Run it with

    python -m veles_tpu_torch.samples.mnist_rnn [--device cpu]
        [--max-epochs N] [--stitch on|off] [--fused]

which prints ``gather_results()`` and the epochs per second.
"""

import sys

import numpy

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.samples import launch
from veles_tpu_torch.samples.datasets import load_mnist
from veles_tpu_torch.samples.mnist_conv import run_cli
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

INPUT_SHAPE = (28, 28)

LAYERS = [
    {"type": "lstm",
     "->": {"hidden_units": 128, "last_only": True,
            "weights_filling": "uniform"},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.01, "gradient_moment": 0.9}},
]


class MnistRowsLoader(FullBatchLoader):
    """Images served as (28, 28) row sequences."""

    def load_data(self):
        tr_x, tr_y, te_x, te_y, real = load_mnist()
        if not real:
            self.warning("real MNIST not found - synthetic stand-in")
        data = numpy.concatenate([te_x, tr_x]).reshape(-1, 28, 28)
        labels = numpy.concatenate([te_y, tr_y])
        self.original_data.mem = numpy.ascontiguousarray(
            data, dtype=numpy.float32)
        self.original_labels = [int(v) for v in labels]
        self.class_lengths[:] = [0, len(te_y), len(tr_y)]


def create_workflow(device=None, max_epochs=10, minibatch_size=100,
                    layers=None, **kwargs):
    """The workflow, initialized on ``device`` (the card when None;
    raises without one).  ``layers`` replaces :data:`LAYERS` (a narrow
    LSTM for the CPU tests); given ``launcher=``, left to the launcher
    to initialize."""
    launcher = kwargs.pop("launcher", None)
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: MnistRowsLoader(
            w, minibatch_size=minibatch_size),
        layers=[{**spec} for spec in (layers or LAYERS)],
        decision_config={"max_epochs": max_epochs},
        **kwargs)
    return launch(wf, launcher, device)


def main(argv=None):
    return run_cli("python -m veles_tpu_torch.samples.mnist_rnn",
                   create_workflow, argv, 10)


if __name__ == "__main__":
    sys.exit(main())
