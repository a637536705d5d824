#!/usr/bin/env python3
"""The pod over N local ranks: one card a rank (NCCL), or N gloo ranks on
the CPU with ``--device cpu``.  The MNIST sample's stitched native MLP
(784→100 tanh→10 softmax, minibatch 100, u8-resident, 1/255 in the
loader head) on its synthetic stand-in, seeded, under
``veles_tpu_torch.pod.PodRuntime`` over a data axis of N (25 rows a rank
at N = 4), per step and in epoch-scan windows, each beside the same run
on one device in the rank's own process.

Each rank reports, for both routes: the class closes (epoch, class,
n_err) of the pod and of the one-device run, the largest |difference|
of every weight and momentum between them, a digest of the pod's weights
(every rank's must be the same), the wall ms of each epoch after the
first (from one train close to the next; the windows capture in the
second epoch, so their last is the steady one) of both, the segments'
captures and replays, and the collectives by kind.

Run from the root of a checkout on a machine with N cards:

    python3 scripts/pod_probe.py --ranks 4 [--epochs 4]

(``--device cpu`` runs the same as gloo ranks on the CPU, as a check of
the script.)  Prints the cards' names and power limits, a JSON line a rank and route
as each finishes, then one JSON object a rank; a rank still running
near the deadline prints its threads' stacks.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SEED = 0
#: seconds the ranks may take before they are killed
TIMEOUT = 300


def _run(device, epochs, pod, scan):
    """One stitched MNIST run: closes, weights and momenta, steady epoch
    ms, segment and window reports, collectives."""
    import numpy
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.parallel import comm
    from veles_tpu_torch.parallel.mesh import mesh_from_topology
    from veles_tpu_torch.pod import PodRuntime
    from veles_tpu_torch.samples import mnist
    eng = root.common.engine
    eng.stitch, eng.loader, eng.epoch_scan = "on", "auto", scan
    prng.seed_all(SEED)
    wf = mnist.create_workflow(device=device, max_epochs=epochs,
                               native=True)
    if pod:
        PodRuntime(wf, mesh=mesh_from_topology({"data": -1})).install()
    dec, closes, times = wf.decision, [], []
    close = dec._close_class

    def recording(cls, check_epoch_end):
        out = close(cls, check_epoch_end)
        closes.append((int(dec.epoch_number), int(cls),
                       float(dec.epoch_n_err[cls])))
        if cls == 2:
            times.append(time.perf_counter())
        return out
    dec._close_class = recording
    comm.reset_counts()
    wf.run()
    if wf.device.torch_device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    state = {k: numpy.array(v) for k, v in wf.params_to_numpy().items()}
    for i, gd in enumerate(reversed(wf.gds)):
        for name in ("gradient_weights", "gradient_bias"):
            vec = getattr(gd, name)
            vec.map_read()
            state["%d.%s" % (i, name)] = numpy.array(vec.mem)
    eng.epoch_scan = "off"
    return {"closes": closes, "state": state,
            "steady_epoch_ms": [(b - a) * 1e3
                                for a, b in zip(times, times[1:])],
            "segments": [{k: r[k] for k in ("dispatches", "captures",
                                            "recaptures", "replays")}
                         for r in wf.stitch_report()],
            "windows": (wf.epoch_scan_report() or {}).get("windows"),
            "collectives": {k: int(comm.counts[k]) for k in comm.KINDS}}


def rank_main(store, ranks, rank, device, epochs, out):
    import faulthandler
    import numpy
    import torch
    torch.set_num_threads(1)
    # a rank still running near the deadline prints where it waits
    faulthandler.dump_traceback_later(TIMEOUT - 30, exit=False)
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    from veles_tpu_torch.parallel import multihost
    root.common.engine.precision_level = 2
    dev = multihost.initialize(store, ranks, rank, device=device,
                               timeout=TIMEOUT)
    set_precision()
    report = {"rank": rank, "device": str(dev), "ranks": ranks}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    for route, scan in (("per_step", "off"), ("windows", "auto")):
        plain = _run(dev, epochs, False, scan)
        pod = _run(dev, epochs, True, scan)
        digest = hashlib.sha256(b"".join(
            pod["state"][k].tobytes() for k in sorted(pod["state"])))
        report[route] = {
            "closes_equal": pod["closes"] == plain["closes"],
            "closes": pod["closes"],
            "max_abs_diff": max(float(numpy.abs(
                pod["state"][k] - plain["state"][k]).max())
                for k in plain["state"]),
            "digest": digest.hexdigest()[:16],
            "steady_epoch_ms": pod["steady_epoch_ms"],
            "plain_steady_epoch_ms": plain["steady_epoch_ms"],
            "segments": pod["segments"], "windows": pod["windows"],
            "collectives": pod["collectives"]}
        print(json.dumps({"rank": rank, route: report[route]}), flush=True)
    with open(os.path.join(out, "rank%d.json" % rank), "w") as f:
        json.dump(report, f)
    import torch.distributed as dist
    dist.barrier()
    if dev.type == "cuda":
        # destroying NCCL communicators that captured CUDA graphs still
        # use waits forever at four cards: leave without tearing down
        sys.stdout.flush()
        os._exit(0)
    multihost.shutdown()
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.store, args.ranks, args.rank, args.device,
                         args.epochs, args.out)
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
        # the path's two kernel libraries, built once for every rank
        sys.path.insert(0, str(REPO))
        from veles_tpu_torch.ops import build
        print(json.dumps({"build_s": build.build_all(("gemm", "gather"))}),
              flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ranks",
             str(args.ranks), "--epochs", str(args.epochs), "--device",
             args.device, "--rank", str(r), "--store", store, "--out", tmp],
            env=env, cwd=str(REPO)) for r in range(args.ranks)]
        deadline = time.monotonic() + TIMEOUT
        failed = False
        try:
            for proc in procs:
                left = max(1.0, deadline - time.monotonic())
                failed |= proc.wait(timeout=left) != 0
        except subprocess.TimeoutExpired:
            failed = True
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            print("pod probe: a rank failed or hung", file=sys.stderr)
            return 1
        reports = []
        for r in range(args.ranks):
            with open(os.path.join(tmp, "rank%d.json" % r)) as f:
                reports.append(json.load(f))
    for report in reports:
        print(json.dumps(report), flush=True)
    digests = {route: {r[route]["digest"] for r in reports}
               for route in ("per_step", "windows")}
    agree = all(len(d) == 1 for d in digests.values())
    print(json.dumps({"ranks_agree": agree, "digests": {
        k: sorted(v) for k, v in digests.items()}}))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
