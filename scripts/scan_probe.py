#!/usr/bin/env python3
"""Probe the epoch-scan windows (``veles_tpu_torch/epoch_scan.py``) at
MNIST's full size on the card: a synthetic stand-in of 60 000 train and
10 000 validation u8 images of 784 pixels with labels (made from a seed
with numpy), the stitched native MLP (784→100 tanh→10 softmax,
minibatch 100), in one process:

- ``engine.epoch_scan=auto``, 4 epochs: a train pass is one 600-step
  window and a validation pass one 100-step window; epoch 0 runs them
  eagerly, epoch 1 captures them, epochs 2–3 replay.  Each window graph's
  capture seconds, pool bytes (the segments of its private memory pool
  after the capture, and what stays allocated in them) and launches a
  replay; the nodes of one
  replay of each (the kernels and copies a ``torch.profiler`` window
  around the replay sees, less the window's own block copies); each
  epoch's wall time; then, in a second run, epoch 2 under the profiler
  (wall, busy, busy share, kernels a minibatch, device time by group).
- ``engine.epoch_scan=off`` (the per-step stitched route: two segment
  graph replays a train minibatch), the same: each epoch's wall time and
  epoch 2 under the profiler.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/scan_probe.py [--epochs N] [--out FILE]

Prints the card's name and power limit, then one JSON object a line,
and writes them all to ``--out``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: the full MNIST split the stand-in takes the size of
TRAIN, VALID = 60000, 10000
SEED = 0


def create_workflow(device, max_epochs):
    """The stitched native MLP over the full-size stand-in."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

    class FullSizeLoader(FullBatchLoader):
        def load_data(self):
            rng = numpy.random.default_rng(SEED)
            n = TRAIN + VALID
            self.original_data.mem = rng.integers(
                0, 256, (n, 784), dtype=numpy.uint8)
            self.original_labels = [int(v) for v in rng.integers(0, 10, n)]
            self.class_lengths[:] = [0, VALID, TRAIN]

    wf = StandardWorkflow(
        None,
        loader_factory=lambda w: FullSizeLoader(
            w, minibatch_size=100, native_device_dtype=True,
            normalization_type="scale"),
        layers=[dict(spec) for spec in mnist.LAYERS],
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": 10 ** 6})
    wf.launcher = DummyLauncher()
    wf.initialize(device=device)
    return wf


def replay_nodes():
    """Profile the next run of each captured window graph: the kernels
    and copies its replay put on the card, less the block copies and the
    prior's fill that run before it."""
    import chip_smoke
    from veles_tpu_torch.epoch_scan import WindowGraph
    execute, seen = WindowGraph.execute, {}

    def profiled(self, rows, prior, preds=None, timer=None):
        if not self.graph.captures or self.name in seen:
            return execute(self, rows, prior, preds, timer)
        out = {}
        summary = chip_smoke.profile_window(
            lambda: out.update(r=execute(self, rows, prior, preds,
                                           timer)))
        before = len(self.blocks) + (self.preds is not None) + 1
        seen[self.name] = {"profiled_events": summary["device_kernels"],
                           "nodes": summary["device_kernels"] - before,
                           "by_group": summary["kernels_by_group"],
                           "busy_ms": summary["device_busy_ms"]}
        return out["r"]
    WindowGraph.execute = profiled
    return seen, lambda: setattr(WindowGraph, "execute", execute)


def probe(rows, device, mode, epochs):
    import chip_smoke
    from veles_tpu_torch.ops import gather, gemm
    tic = time.perf_counter()
    wf, info = chip_smoke._scan_counted_run(device, create_workflow, epochs,
                                            mode)
    row = {"probe": "counted", "mode": mode,
           "setup_and_run_s": time.perf_counter() - tic,
           "elapsed_s": info["elapsed_s"],
           "epoch_wall_ms": info["epoch_wall_ms"],
           "dispatch_spans": info["dispatch_spans"],
           "segments": info["segments"],
           "launches": {**gemm.launches, **gather.launches},
           "closes": info["closes"]}
    if mode != "off":
        report = info["epoch_scan"]
        row["windows_by_epoch"] = info["windows_by_epoch"]
        row["graphs"] = {str(k): g for k, g in report["graphs"].items()}
        row["windows"] = list(info["windows"])
        # one more epoch: each captured graph's next replay profiled
        seen, restore = replay_nodes()
        try:
            with chip_smoke.engine_knobs(epoch_scan=mode):
                wf.decision.complete <<= False
                wf.decision.max_epochs = epochs + 1
                wf.run()
                chip_smoke.gpu_sync()
        finally:
            restore()
        row["replay_nodes"] = seen
    chip_smoke.emit(row)
    rows.append(row)
    del wf
    summary, minibatches = chip_smoke._scan_profile(
        device, create_workflow, epochs, chip_smoke._MNIST_NAMES, mode=mode)
    row = {"probe": "steady_epoch_profile", "mode": mode,
           "minibatches": minibatches, **summary}
    chip_smoke.emit(row)
    rows.append(row)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--out", default="chiprun_out/scan_probe.jsonl")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_probe: no CUDA device", file=sys.stderr)
        return 1
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rows = [{"probe": "device", "nvidia_smi": smi,
             "torch": torch.__version__, "cuda": torch.version.cuda}]
    for mode in ("auto", "off"):
        probe(rows, device, mode, args.epochs)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r, default=str) for r in rows)
                   + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
