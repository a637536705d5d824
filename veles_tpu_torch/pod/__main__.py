"""``python -m veles_tpu_torch.pod``: the pod's seeded task and its smoke.

The port's counterpart of :mod:`veles_tpu.pod.__main__`'s in-process
half.  :func:`make_workflow` builds the stitched workflow every
distributed gate of the repo trains (a seeded 5-cluster task: 384 train
and 128 validation 16-feature points, a 12-unit tanh layer and a
5-class softmax, minibatch 64).  ``--smoke`` trains it twice in this
process, the single-device stitched reference and a :class:`PodRuntime`
over a one-rank group (gloo on the CPU, NCCL on the card), and gates the
pod on bit-equal weights and equal eval metrics, its collectives
counted.  The lease phases of the JAX smoke (the membership session
over the job protocol, the chaos schedule, the multihost follower) are
ROADMAP item 7(e).

    python -m veles_tpu_torch.pod --smoke [--device cpu]
"""

import argparse
import json
import sys

import numpy

SMOKE_SEED = 20260804
SMOKE_EPOCHS = 3
SMOKE_BATCH = 64

SMOKE_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 5},
     "<-": {"learning_rate": 0.05}},
]


def smoke_data():
    """``(data, labels, class_lengths)`` of the seeded 5-cluster task."""
    rng = numpy.random.default_rng(5)
    n = 512
    labels = (numpy.arange(n) % 5).astype(int)
    centers = rng.standard_normal((5, 16)) * 3
    data = (centers[labels]
            + rng.standard_normal((n, 16)) * 0.5).astype(numpy.float32)
    return data, labels, [0, 128, 384]


def make_workflow(max_epochs=SMOKE_EPOCHS, batch=SMOKE_BATCH, device=None,
                  seed=21, layers=None):
    """The smoke's stitched workflow over the seeded 5-cluster task
    (``layers``: another stack over it; default :data:`SMOKE_LAYERS`),
    initialized on ``device`` (the card when None)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

    class PodSmokeLoader(FullBatchLoader):
        def load_data(self):
            data, labels, lengths = smoke_data()
            self.original_data.mem = data
            self.original_labels = [int(v) for v in labels]
            self.class_lengths[:] = lengths

    device = make_device(device)
    prng.seed_all(seed)
    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: PodSmokeLoader(w, minibatch_size=batch),
        layers=[{**spec} for spec in (layers or SMOKE_LAYERS)],
        decision_config={"max_epochs": max_epochs})
    wf.launcher = DummyLauncher()
    wf.initialize(device=device)
    return wf


def final_weights(wf):
    return [numpy.array(unit.weights.mem) for unit in wf.forwards]


def run_smoke(device=None, epochs=SMOKE_EPOCHS):
    """The in-process gates (see the module); an exit code."""
    from veles_tpu_torch.parallel import comm, multihost
    from veles_tpu_torch.pod import PodRuntime, eval_metrics, train_epochs
    reference = make_workflow(max_epochs=epochs, device=device)
    for _ in train_epochs(reference, epochs):
        pass
    multihost.initialize(device=device)
    wf = make_workflow(max_epochs=epochs, device=device)
    pod = PodRuntime(wf).install()
    comm.reset_counts()
    for _ in train_epochs(wf, epochs):
        pass
    got, want = eval_metrics(wf), eval_metrics(reference)
    equal = all(numpy.array_equal(a, b) for a, b in zip(
        final_weights(wf), final_weights(reference)))
    report = {"pod": pod.describe(), "metrics": got, "reference": want,
              "bit_equal": equal,
              "collectives": {k: int(comm.counts[k]) for k in comm.KINDS}}
    print(json.dumps(report, default=str))
    ok = equal and got == want and report["collectives"]["all_gather"] > 0
    print("pod smoke: %s" % ("OK" if ok else "FAIL"),
          file=sys.stdout if ok else sys.stderr)
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.pod",
        description="The pod's in-process smoke (the lease phases are "
        "ROADMAP item 7(e)).")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cpu, or a cuda device (default: the card)")
    args = parser.parse_args(argv)
    if args.smoke:
        return run_smoke(device=args.device)
    parser.print_help()
    return 0


if __name__ == "__main__":  # pragma: no cover - thin CLI
    sys.exit(main())
