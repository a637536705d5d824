"""Which kernels does a ``torch.profiler`` window lose, and when?

``chip_smoke.py``'s profiled windows at times count fewer kernels than
the wrappers launched (a train step's 23 of 24 flash forwards; one whole
validation minibatch of an MNIST window), late in its process, while a
fresh process sees them all.  This probe profiles the same kinds of
window in one process at three stages: fresh (after the kernels are
built), after 40 short profiler sessions, and after ``chip_smoke``'s
``kernels`` phase (the many windows, builds and launches before the
serving phases).  At each stage it takes

- ``adds``: a window of 200 ``add_`` kernels, with and without a primer
  of 32 ``fill_`` kernels launched inside the window before the work;
- ``mnist``: eager MNIST windows (``max_epochs=2``, 80 minibatches)
  whose loader calls are marked with ``record_function``, each kernel
  given to the last minibatch that started before it; the minibatches
  whose gather or forward GEMMs are missing are listed.  One window is
  bare, one opens with ``chip_smoke.prime_window`` (its kernels before
  ``chip_smoke.WORK_MARKER`` are the primer's, and are not counted).

Run on the card from the root of the repo::

    python3 scripts/profile_window_probe.py [--out chiprun_out/x.json]
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _window(fn, primer=0):
    """``fn`` under the profiler; ``primer`` fill_ kernels first, or
    ``chip_smoke.prime_window`` when it is ``"chip_smoke"``."""
    from torch.profiler import ProfilerActivity, profile
    cs.gpu_sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if primer == "chip_smoke":
            cs.prime_window()
        elif primer:
            scratch = torch.empty(primer, device="cuda")
            for i in range(primer):
                scratch[i:i + 1].fill_(float(i))
            cs.gpu_sync()
        fn()
        cs.gpu_sync()
    return prof


def _device_events(prof):
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def adds_window(primer):
    x = torch.zeros(1024, device="cuda")

    def work():
        for _ in range(200):
            x.add_(1.0)
    prof = _window(work, primer)
    events = _device_events(prof)
    names = [e.name for e in events]
    adds = [i for i, n in enumerate(names) if "fill" not in n.lower()]
    return {"primer": primer, "device_events": len(events),
            "add_kernels_seen": len(adds), "add_kernels_run": 200,
            "primer_kernels_seen": len(events) - len(adds),
            "first_index_of_an_add": adds[0] if adds else None,
            "value_after": float(x[0])}


def mnist_window(primer=0):
    from torch.autograd.profiler import record_function

    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import gather
    from veles_tpu_torch.samples import mnist
    with cs.engine_knobs(stitch="off"):
        prng.seed_all(cs.SEED)
        wf = mnist.create_workflow(device=torch.device("cuda", 0),
                                   max_epochs=2)
        inner, served = wf.loader.run, []

        def marked():
            with record_function("minibatch_%03d" % len(served)):
                inner()
            served.append(int(wf.loader.minibatch_class))
        wf.loader.run = marked
        cs.reset_all_launches()
        prof = _window(wf.run, primer)
    from torch.autograd import DeviceType
    starts = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith("minibatch_")
                    and e.device_type == DeviceType.CPU)
    work = min((e.time_range.start for e in prof.events()
                if e.name == cs.WORK_MARKER), default=None)
    primer_seen = 0
    per = {name: {"gather": 0, "matmul": 0, "other": 0}
           for _, name in starts}
    before_first = 0
    for e in _device_events(prof):
        if work is not None and e.time_range.start < work:
            primer_seen += 1
            continue
        if e.name.startswith("minibatch_"):
            continue            # the markers' device-side ranges
        owner = None
        for t, name in starts:
            if t <= e.time_range.start:
                owner = name
            else:
                break
        if owner is None:
            before_first += 1
            continue
        kind = ("gather" if "veles_gather" in e.name else
                "matmul" if "veles_gemm_kernel<0," in e.name.replace(
                    " ", "") else "other")
        per[owner][kind] += 1
    missing = {name: dict(c, cls=served[int(name[-3:])])
               for name, c in per.items()
               if c["gather"] != 1 or c["matmul"] != 2}
    return {"primer": primer, "primer_kernels_seen": primer_seen,
            "minibatches_run": len(served),
            "markers_seen": len(starts),
            "gather_launches": gather.launches["gather"],
            "gather_kernels_seen": sum(c["gather"] for c in per.values()),
            "kernels_before_the_first_marker": before_first,
            "minibatches_missing_kernels": missing,
            "classes_served_first": served[:3]}


def stage(name):
    out = {"stage": name,
           "adds": [adds_window(0), adds_window(0), adds_window(32)],
           "mnist": [mnist_window(), mnist_window("chip_smoke")]}
    print(json.dumps(out), flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_window_probe: no CUDA device", file=sys.stderr)
        return 1
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    stages = [stage("fresh")]
    for _ in range(40):
        adds_window(0)
    stages.append(stage("after 40 sessions"))
    cs.phase_kernels(device)
    stages.append(stage("after the kernels phase"))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stages, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
