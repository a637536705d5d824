"""The Kohonen SOM workflow: the port's counterpart of
:mod:`veles_tpu.samples.kohonen`.

A 2-D Gaussian mixture (``GaussiansLoader``, 1000 samples of 6 centres,
all TRAIN) trains an 8×8 map (:class:`~veles_tpu_torch.znicz.kohonen
.KohonenTrainer`, one batch step a minibatch on the device) for
``max_epochs`` epochs, counted by ``EpochCounter`` (no Decision: a SOM
has no validation error).  ``create_workflow()`` initializes it on the
card; ``device="cpu"`` runs the same units over CPU tensors.  Run it
with

    python -m veles_tpu_torch.samples.kohonen [--device cpu]
        [--max-epochs N]

which prints the quantization error.
"""

import argparse
import json
import logging
import sys

import numpy

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.samples import launch
from veles_tpu_torch.units import Unit
from veles_tpu_torch.znicz.kohonen import KohonenForward, KohonenTrainer


class GaussiansLoader(FullBatchLoader):
    """A 2-D Gaussian mixture, the classic SOM demo dataset."""

    def __init__(self, workflow, n_samples=1000, n_centers=6, **kwargs):
        self._n_samples = n_samples
        self._n_centers = n_centers
        super(GaussiansLoader, self).__init__(workflow, **kwargs)

    def load_data(self):
        rng = numpy.random.default_rng(3)
        centers = rng.uniform(-4, 4, (self._n_centers, 2))
        idx = rng.integers(0, self._n_centers, self._n_samples)
        self.original_data.mem = (
            centers[idx] + rng.standard_normal((self._n_samples, 2))
            * 0.3).astype(numpy.float32)
        self.original_labels = []
        self.class_lengths[:] = [0, 0, self._n_samples]


class EpochCounter(Unit):
    """Stops the SOM loop after ``max_epochs``."""

    def __init__(self, workflow, **kwargs):
        super(EpochCounter, self).__init__(workflow, **kwargs)
        self.max_epochs = kwargs.get("max_epochs", 10)
        self.complete = Bool(False)
        self.epoch_number = None
        self.demand("epoch_number")

    def run(self):
        if int(self.epoch_number) >= self.max_epochs:
            self.complete <<= True


class KohonenWorkflow(AcceleratedWorkflow):
    def __init__(self, workflow=None, shape=(8, 8), max_epochs=10,
                 minibatch_size=100, loader_factory=None, **kwargs):
        super(KohonenWorkflow, self).__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.loader = (loader_factory or GaussiansLoader)(self)
        self.loader.max_minibatch_size = minibatch_size
        self.trainer = KohonenTrainer(self, shape=shape)
        self.forward = KohonenForward(self)
        self.counter = EpochCounter(self, max_epochs=max_epochs)

        self.repeater.link_from(self.start_point)
        self.loader.link_from(self.repeater)
        self.trainer.link_from(self.loader)
        self.trainer.link_attrs(self.loader, ("input", "minibatch_data"))
        self.forward.link_from(self.trainer)
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"))
        self.forward.link_attrs(self.trainer, "weights")
        self.counter.link_from(self.forward)
        self.counter.link_attrs(self.loader, "epoch_number")
        self.repeater.link_from(self.counter)
        self.end_point.link_from(self.counter)
        self.end_point.gate_block = ~self.counter.complete
        self.repeater.gate_block = self.counter.complete

    def get_metric_values(self):
        return {"quantization_error": self.trainer.quantization_error(
            self.loader.original_data.mem)}


def create_workflow(device=None, **kwargs):
    """The SOM workflow, initialized on ``device`` (the card when None;
    raises without one); given ``launcher=``, left to the launcher to
    initialize."""
    launcher = kwargs.pop("launcher", None)
    return launch(KohonenWorkflow(None, **kwargs), launcher, device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.samples.kohonen",
        description="Train the Kohonen map on the Gaussian mixture.")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    parser.add_argument("--max-epochs", type=int, default=10)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    wf = create_workflow(device=args.device, max_epochs=args.max_epochs)
    wf.run()
    print(json.dumps(wf.get_metric_values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
