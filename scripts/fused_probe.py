#!/usr/bin/env python3
"""Time the fused trainer's per-step route (``StandardWorkflow(fused=True)``)
on the card, for one checkout or several: the MNIST sample's native MLP
(784→100 tanh→10 softmax, minibatch 100, u8-resident, 1/255 in the step)
on its synthetic stand-in (600 train and 100 validation images), f32,
seeded, in one process per checkout.

Each run trains ``--epochs`` epochs and reports the wall ms of each
epoch after the first (from one train close to the next: a validation
pass of 10 minibatches and a train pass of 60, every graph captured in
the first epoch), the graphs' captures, recaptures and replays, and the
validation n_err of each epoch.  ``--tree`` names the checkouts to
import ``veles_tpu_torch`` from (default: this one), each run in its own
subprocess, in the order given, so that ``--tree A B B A`` compares two
versions on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/fused_probe.py [--epochs N] [--tree DIR ...]

(``--device cpu`` runs the same on the CPU, as a check of the script.)

Prints the card's name and power limit, then one JSON object a run.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_one(epochs, device):
    """One fused run on ``device``, in this process: its JSON report."""
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import mnist
    root.common.engine.precision_level = 2
    set_precision()
    prng.seed_all(1234)
    wf = mnist.create_workflow(device=device, max_epochs=epochs,
                               native=True, fused=True)
    stamps = []
    close = wf.decision._close_class

    def timed_close(cls, check_epoch_end):
        out = close(cls, check_epoch_end)
        if cls == 2:             # the class close fetched: a host sync
            stamps.append(time.perf_counter())
        return out
    wf.decision._close_class = timed_close
    wf.run()
    if device == "cuda":
        torch.cuda.synchronize()
    return {"steady_epoch_ms": [(b - a) * 1e3
                                for a, b in zip(stamps, stamps[1:])],
            "graphs": wf.fused_trainer.graph_report(),
            "valid_n_err": [c["n_err"] for c in wf.decision.history
                            if c["cls"] == "validation"]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--tree", nargs="*", default=[str(REPO)])
    parser.add_argument("--device", default="cuda",
                        help="cpu: a check of the script itself")
    parser.add_argument("--one", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        sys.path.insert(0, args.tree[0])
        print(json.dumps(run_one(args.epochs, args.device)))
        return 0
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    for tree in args.tree:
        tree = str(Path(tree).resolve())
        out = subprocess.run(
            [sys.executable, __file__, "--one", "--epochs",
             str(args.epochs), "--device", args.device, "--tree", tree],
            capture_output=True, text=True, cwd=tree)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        report = json.loads(out.stdout.strip().splitlines()[-1])
        report["tree"] = tree
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
