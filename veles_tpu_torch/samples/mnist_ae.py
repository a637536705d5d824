"""The MNIST autoencoders (MSE): the port's counterpart of
:mod:`veles_tpu.samples.mnist_ae`.  The MLP one is 784→100 sigmoid→784
sigmoid; ``conv=True`` builds the conv one over (28, 28, 1) images: a
3×3 tanh conv of 8 kernels, the stochastic pool + depool bottleneck and
the 3×3 deconv back to one channel (``make_conv_layers``).

``create_workflow()`` builds the ``StandardWorkflow`` over the
resident MNIST images as both data and targets (the synthetic stand-in
when the IDX files are absent), ``loss_function="mse"``, and
initializes it on the card; ``device="cpu"`` runs the same units over
CPU tensors.  Stitched (the default), each minibatch is the loader
head's one served launch (data and targets, two f32 tables 784 wide)
and the two sigmoid GEMMs and the MSE evaluator in one segment, and on
train minibatches the two GD steps in the other; with
``engine.epoch_scan=auto`` a class pass is one window.  The conv
autoencoder's stochastic pool-depool draws a seed at every run, so its
chain is three stitched pieces around it.  ``rbm_pretrain=True`` first
trains an RBM (:class:`~veles_tpu_torch.znicz.rbm.RBMTrainer`, CD-1, one
pass over the first 2000 train images) on the workflow's device, the
card or the CPU when asked (the JAX sample pretrains on the host), and
starts the MLP autoencoder from its weights.  Run it with

    python -m veles_tpu_torch.samples.mnist_ae [--device cpu]
        [--max-epochs N] [--epoch-scan off|auto|K] [--conv]
        [--rbm-pretrain]

which prints ``gather_results()`` and the epochs per second.
"""

import argparse
import json
import logging
import sys
import time

import numpy

from veles_tpu_torch.backends import make_device
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
from veles_tpu_torch.samples import launch
from veles_tpu_torch.samples.datasets import load_mnist
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow


def make_layers(hidden=100, learning_rate=0.01):
    return [
        {"type": "all2all_sigmoid",
         "->": {"output_sample_shape": hidden},
         "<-": {"learning_rate": learning_rate,
                "gradient_moment": 0.9}},
        {"type": "all2all_sigmoid",
         "->": {"output_sample_shape": 784},
         "<-": {"learning_rate": learning_rate,
                "gradient_moment": 0.9}},
    ]


def make_conv_layers(kernels=8, learning_rate=0.01, pool_depool=True):
    """The conv autoencoder: a conv encoder, the stochastic pool + depool
    bottleneck, a deconv decoder."""
    layers = [
        {"type": "conv_tanh",
         "->": {"n_kernels": kernels, "kx": 3, "ky": 3, "padding": 1},
         "<-": {"learning_rate": learning_rate,
                "gradient_moment": 0.9}},
        {"type": "deconv",
         "->": {"n_kernels": kernels, "kx": 3, "ky": 3, "padding": 1,
                "output_channels": 1},
         "<-": {"learning_rate": learning_rate,
                "gradient_moment": 0.9}},
    ]
    if pool_depool:
        layers.insert(1, {"type": "stochastic_pool_depool",
                          "->": {"kx": 2, "ky": 2}})
    return layers


class MnistAELoader(FullBatchLoaderMSE):
    """Targets = inputs (reconstruction); no labels."""

    #: (784,) for the MLP autoencoder, (28, 28, 1) for the conv one
    SAMPLE_SHAPE = (784,)

    def load_data(self):
        tr_x, _tr_y, te_x, te_y, real = load_mnist()
        if not real:
            self.warning("real MNIST not found - synthetic stand-in")
        data = numpy.concatenate([te_x, tr_x]).reshape(
            (-1,) + self.SAMPLE_SHAPE)
        data = numpy.ascontiguousarray(data, dtype=numpy.float32)
        self.original_data.mem = data
        self.original_targets.mem = data.copy()
        self.original_labels = []
        self.class_lengths[:] = [0, len(te_y), len(tr_x)]


class MnistConvAELoader(MnistAELoader):
    SAMPLE_SHAPE = (28, 28, 1)


def pretrain_rbm(loader_data, hidden=100, epochs=3, batch=100,
                 device=None):
    """CD-1 pretraining passes over ``loader_data`` (N, 784) on
    ``device`` (the card when None); returns the trainer, whose ``to_autoencoder_specs()``
    seed the autoencoder's layers."""
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.memory import Vector
    from veles_tpu_torch.znicz.rbm import RBMTrainer
    wf = DummyWorkflow()
    trainer = RBMTrainer(wf, n_hidden=hidden, learning_rate=0.1)
    trainer.input = Vector(loader_data[:batch])
    trainer.initialize(device=make_device(device))
    n = len(loader_data)
    for _ in range(epochs):
        for start in range(0, n - batch + 1, batch):
            trainer.input.reset(loader_data[start:start + batch])
            trainer.run()
    return trainer


def create_workflow(device=None, max_epochs=15, minibatch_size=100,
                    hidden=100, rbm_pretrain=False, conv=False,
                    **kwargs):
    """The autoencoder workflow (the conv one with ``conv``),
    initialized on ``device`` (the card when None; raises without
    one); ``rbm_pretrain`` starts the MLP one from an RBM's weights,
    pretrained on that device (a launcher's device, given ``launcher=``,
    which is then left to initialize the workflow)."""
    launcher = kwargs.pop("launcher", None)
    loader_class = MnistConvAELoader if conv else MnistAELoader
    layers = kwargs.pop("layers", None) or (
        make_conv_layers() if conv else make_layers(hidden=hidden))
    if rbm_pretrain:
        tr_x, _tr_y, _te_x, _te_y, _real = load_mnist()
        trainer = pretrain_rbm(
            numpy.ascontiguousarray(tr_x.reshape(len(tr_x), -1)[:2000],
                                    dtype=numpy.float32),
            hidden=hidden, epochs=1, device=make_device(
                device if launcher is None
                else getattr(launcher, "device_spec", device)))
        for layer, seeded in zip(layers, trainer.to_autoencoder_specs()):
            layer["init"] = seeded["init"]
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: loader_class(
            w, minibatch_size=minibatch_size),
        layers=layers,
        loss_function="mse",
        decision_config={"max_epochs": max_epochs},
        **kwargs)
    return launch(wf, launcher, device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.samples.mnist_ae",
        description="Train the MNIST autoencoder through the "
        "workflow.")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    parser.add_argument("--max-epochs", type=int, default=15)
    parser.add_argument("--minibatch-size", type=int, default=100)
    parser.add_argument("--epoch-scan", default=None,
                        help="engine.epoch_scan: off, auto or a window "
                        "length K (default: the config's, off)")
    parser.add_argument("--conv", action="store_true",
                        help="the conv autoencoder")
    parser.add_argument("--rbm-pretrain", action="store_true",
                        help="start from an RBM's weights (CD-1)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if args.epoch_scan is not None:
        root.common.engine.epoch_scan = args.epoch_scan
    wf = create_workflow(device=args.device, max_epochs=args.max_epochs,
                         minibatch_size=args.minibatch_size, conv=args.conv,
                         rbm_pretrain=args.rbm_pretrain)
    tic = time.perf_counter()
    wf.run()
    wf.device.sync()
    elapsed = time.perf_counter() - tic
    results = wf.gather_results()
    results["epochs_per_s"] = (wf.loader.samples_served
                               / wf.loader.total_samples / elapsed)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
