"""MnistSimple: the 784→100→10 softmax MLP, the port's counterpart of
:mod:`veles_tpu.samples.mnist`.

``create_workflow()`` builds the ``StandardWorkflow`` over the resident
MNIST dataset (the synthetic stand-in when the IDX files are absent) and
initializes it on the card; ``device="cpu"`` runs the same units over
CPU tensors, where each kernel wrapper takes its plain version.  With
``engine.stitch=on`` (the default) each minibatch is two segment
dispatches, ``[loader head, All2AllTanh, All2AllSoftmax,
EvaluatorSoftmax]`` and, on train minibatches, ``[GDSoftmax, GDTanh]``:
two CUDA graph replays on the card.  ``native=True`` keeps the dataset
as uint8 and scales it by 1/255 in the loader head (the gather +
normalize kernel); it needs stitching or ``fused=True``.  With
``engine.stitch=off`` the units run one by one (the gather, GEMM and
dx/dw/db kernels).  ``fused=True`` trains through one
:class:`~veles_tpu_torch.znicz.fused_unit.FusedTrainer` step a
minibatch (one CUDA graph a step shape on the card: the GEMM kernel
forward and in both backward products), with ``fused_config``'s knobs
(``{"epoch_mode": True}``: a whole train epoch a program); a native
dataset is then scaled inside the step, on every route, and
``engine.precision_type="bfloat16"`` runs its products in bf16.  Run it
with

    python -m veles_tpu_torch.samples.mnist [--device cpu] [--max-epochs N]
        [--native] [--stitch on|off] [--fused] [--epoch-mode] [--bf16]

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
    {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
            "weights_decay": 0.0005}},
]


class MnistLoader(FullBatchLoader):
    """MNIST: validation = the t10k set, train = the train set; u8
    pixels when ``native_device_dtype``."""

    def load_data(self):
        raw = self.native_device_dtype
        tr_x, tr_y, te_x, te_y, real = load_mnist(raw=raw)
        if not real:
            self.warning("real MNIST not found under $VELES_DATASETS or "
                         "root.common.dirs.datasets — using the synthetic "
                         "stand-in data")
        data = numpy.concatenate([te_x, tr_x]).reshape(-1, 784)
        labels = numpy.concatenate([te_y, tr_y])
        self.original_data.mem = numpy.ascontiguousarray(
            data, dtype=numpy.uint8 if raw else numpy.float32)
        self.original_labels = [int(v) for v in labels]
        self.class_lengths[:] = [0, len(te_y), len(tr_y)]


def create_workflow(device=None, max_epochs=None, minibatch_size=100,
                    snapshot_dir=None, layers=None, native=False,
                    fused=False, fused_config=None, **kwargs):
    """The MNIST MLP workflow, initialized on ``device`` (the card when
    None; raises without one); given ``launcher=``, left to the
    launcher to initialize.  ``native=True``: the uint8-resident
    dataset, normalized by ``"scale"`` (1/255) in the stitched loader
    head, or in the fused step with ``fused=True``, unless
    ``normalization_type`` says otherwise.  ``fused_config``: the
    FusedTrainer's knobs.
    ``snapshot_dir``: snapshot every improving validation there
    (``mnist_<error>pt.pickle.gz``), which keeps the per-step route.
    ``max_epochs`` defaults to ``root.mnist.max_epochs``, else 25."""
    launcher = kwargs.pop("launcher", None)
    if max_epochs is None:
        # the entry point sets it as root.mnist.max_epochs=N
        max_epochs = int((root.get("mnist") or {}).get("max_epochs", 25))
    normalization = kwargs.pop("normalization_type",
                               "scale" if native else "none")
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: MnistLoader(
            w, minibatch_size=minibatch_size, native_device_dtype=native,
            normalization_type=normalization),
        layers=[{**spec} for spec in (layers or LAYERS)],
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": kwargs.pop(
                             "fail_iterations", 50)},
        snapshotter_config={"directory": snapshot_dir, "prefix": "mnist"}
        if snapshot_dir else None,
        fused=fused, fused_config=fused_config, **kwargs)
    return launch(wf, launcher, device)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.samples.mnist",
        description="Train the MNIST MLP through the workflow.")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    parser.add_argument("--max-epochs", type=int, default=25)
    parser.add_argument("--minibatch-size", type=int, default=100)
    parser.add_argument("--native", action="store_true",
                        help="keep the dataset as uint8, scaled in the "
                        "stitched loader head")
    parser.add_argument("--stitch", choices=("on", "off"), default=None,
                        help="engine.stitch: segments (CUDA graphs on "
                        "the card) or the eager per-unit chain "
                        "(default: the config's, on)")
    parser.add_argument("--fused", action="store_true",
                        help="train through the FusedTrainer (one CUDA "
                        "graph a step shape on the card)")
    parser.add_argument("--epoch-mode", action="store_true",
                        help="with --fused: a whole train epoch a "
                        "program")
    parser.add_argument("--bf16", action="store_true",
                        help="with --fused: engine.precision_type="
                        "bfloat16 (bf16 products, f32 master weights)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if args.stitch is not None:
        root.common.engine.stitch = args.stitch
    if args.bf16:
        root.common.engine.precision_type = "bfloat16"
    wf = create_workflow(device=args.device, max_epochs=args.max_epochs,
                         minibatch_size=args.minibatch_size,
                         native=args.native, fused=args.fused,
                         fused_config={"epoch_mode": True}
                         if args.epoch_mode else None)
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
