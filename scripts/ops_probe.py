#!/usr/bin/env python3
"""Probe the ops API's two kernels on the card: the reduction
(``csrc/reduce.cu``) and the uniform fill (``csrc/random.cu``), beside
another version of both and torch's own calls.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/ops_probe.py [--parent DIR] [--out FILE]

It builds both sources as the package does, copies of ``reduce.cu``
with other numbers of loads in flight a lane along each axis
(``VARIANTS``) and, with
``--parent DIR`` (a directory holding another version's ``reduce.cu``
and ``random.cu``, whose C entries may lack the plan arguments: they are
dropped before the stream), that version too, all in parallel.  Every
version runs through the package's own wrappers (its C entries swapped
in), so each gets the same operands, and is held against the plain
version first.

At (4096, 4096) f32 it times each of the six reductions (sum, max, min
along axis 0 and 1), ``torch.sum`` / ``amax`` / ``amin`` along the same
axis, the uniform fill in [0, 1), ``torch.rand`` with a CUDA generator,
and ``fill_(0.5)`` of the same 64 MiB (the card's practical write
ceiling), each under three measures:

- ``event_dirty_ms``: the median of 20 CUDA-event timings, each call
  after the zeroing L2 flush (``chip_smoke.make_l2_flush(dirty=True)``),
  whose ~50 MB of dirty lines are written back inside the timed call;
- ``event_clean_ms``: the same after the clean flush (a 96 MiB read,
  ``chip_smoke.make_l2_flush``), which leaves L2 clean;
- ``device_ms``: device time a call, calls queued behind a spinning
  kernel (``chip_smoke.device_ms``): for the reductions each call on the
  next of ``REDUCE_COPIES`` copies of the matrix
  (``chip_smoke.cold_device_ms``), so none finds it in L2; for the fills
  back to back on one output, so each pays for the previous call's
  write-backs, as a fill in steady state does.

The versions are timed parent, change, change, parent.  Then each
reduction's device time at every split (1, 2, 4, 8), in this build and
in each variant.  Prints the
card's name and power limit, then one JSON object a line, and writes
them all to ``--out``.
"""

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SHAPE = (4096, 4096)
#: copies of the (4096, 4096) f32 matrix the reductions cycle through:
#: 256 MiB, five times the 50 MB L2, between two calls on one copy
REDUCE_COPIES = 4
CALLS = [(op, axis) for op in ("sum", "max", "min") for axis in (0, 1)]
SPLITS = (1, 2, 4, 8)
#: name -> nvcc flags of a copy of reduce.cu
VARIANTS = {"axis0_loads2": ("-DVELES_REDUCE_AXIS0_LOADS=2",),
            "axis0_loads8": ("-DVELES_REDUCE_AXIS0_LOADS=8",),
            "axis1_loads4": ("-DVELES_REDUCE_AXIS1_LOADS=4",)}
LIBRARY = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def ptxas_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def build_copies(copies):
    """``{label: (source, target .so, extra nvcc flags)}``: one nvcc
    each, in parallel; returns ``{label: ptxas lines}``, or for a variant
    that did not build ``{label: {"nvcc_failed": its output's end}}``
    (a parent that does not build raises)."""
    from veles_tpu_torch.ops import build
    procs = {}
    for label, (src, target, flags) in copies.items():
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *flags, "-I",
               str(build.CSRC_DIR), "-o", str(target), str(src)]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    reports = {}
    for label, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            if label.startswith("parent"):
                raise RuntimeError("nvcc failed on %s:\n%s" % (label, out))
            reports[label] = {"nvcc_failed": out[-2000:]}
            continue
        reports[label] = ptxas_lines(out)
    return reports


def _drop_plan(fn):
    """A C entry that takes no plan: the wrapper's arguments between the
    first eight and the stream are dropped."""
    return lambda *a: fn(*a[:8], a[-1])


class Version(object):
    """One build's ``veles_reduce`` and ``veles_uniform``, installed in
    the package's wrappers by :meth:`use`."""

    def __init__(self, reduce_lib, random_lib, parent=False):
        from veles_tpu_torch.ops import random, reduce
        self.entries = []
        for module, lib, symbol in ((reduce, reduce_lib, "veles_reduce"),
                                    (random, random_lib, "veles_uniform")):
            fn = getattr(ctypes.CDLL(str(lib)), symbol)
            argtypes = module._ARGTYPES
            fn.argtypes = argtypes[:8] + argtypes[-1:] if parent \
                else argtypes
            fn.restype = ctypes.c_int
            self.entries.append((module, _drop_plan(fn) if parent else fn))

    @contextlib.contextmanager
    def use(self):
        saved = [(module, list(module._entry_fn))
                 for module, _fn in self.entries]
        for module, fn in self.entries:
            module._entry_fn[:] = [fn]
        try:
            yield
        finally:
            for module, entries in saved:
                module._entry_fn[:] = entries


def measures(fn, cold_calls, dirty, clean):
    """The three measures of one call (see the module's docstring)."""
    import chip_smoke
    return {"event_dirty_ms": chip_smoke.time_ms(fn, flush=dirty),
            "event_clean_ms": chip_smoke.time_ms(fn, flush=clean),
            "device_ms": chip_smoke.device_ms(fn) if cold_calls is None
            else chip_smoke.cold_device_ms(cold_calls,
                                           reps=4 * len(cold_calls))}


def probe_reduce(rows, versions, order, device, dirty, clean):
    import chip_smoke
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import reduce
    rng = numpy.random.default_rng(0)
    copies = [chip_smoke._reduce_matrix(rng, device, SHAPE, torch.float32,
                                        False)
              for _ in range(REDUCE_COPIES)]
    a = copies[0]
    m, n = SHAPE
    for op, axis in CALLS:
        bound, by = bound_seconds(4 * (m * n + (n if axis == 0 else m)),
                                  m * n, "float32")
        want = reduce._reduce_ref(a, axis, op)
        for version in order:
            with versions[version].use():
                got = reduce._reduce_cuda(a, axis, op)
                again = reduce._reduce_cuda(a, axis, op)
                gpu_ok = chip_smoke._reduce_agree(got, want, a, op, axis)
                times = measures(
                    lambda: reduce._reduce_cuda(a, axis, op),
                    [lambda c=c: reduce._reduce_cuda(c, axis, op)
                     for c in copies], dirty, clean)
            emit(rows, dict(times, probe="reduce", op=op, axis=axis,
                            version=version, ok=gpu_ok["ok"],
                            max_abs_err=gpu_ok["max_abs_err"],
                            bit_equal_relaunch=bool(torch.equal(got, again)),
                            bound_ms=bound * 1e3, bound_by=by,
                            bound_share_device=bound * 1e3
                            / times["device_ms"]))
        fn = LIBRARY[op]
        times = measures(lambda: fn(a, dim=axis),
                         [lambda c=c: fn(c, dim=axis) for c in copies],
                         dirty, clean)
        emit(rows, dict(times, probe="reduce", op=op, axis=axis,
                        version="library", bound_ms=bound * 1e3,
                        bound_by=by))
        for label in ["change"] + [v for v in VARIANTS if v in versions]:
            with versions[label].use():
                for split in SPLITS:
                    got = reduce._reduce_cuda(a, axis, op, split)
                    ok = chip_smoke._reduce_agree(got, want, a, op, axis)
                    dev = chip_smoke.cold_device_ms(
                        [lambda c=c: reduce._reduce_cuda(c, axis, op, split)
                         for c in copies], reps=4 * len(copies))
                    emit(rows, {"probe": "reduce_plan", "op": op,
                                "axis": axis, "version": label,
                                "split": split, "ok": ok["ok"],
                                "device_ms": dev,
                                "bound_share_device": bound * 1e3 / dev})
    del copies, a
    torch.cuda.empty_cache()


def probe_uniform(rows, versions, order, device, dirty, clean):
    import chip_smoke
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import random
    count = SHAPE[0] * SHAPE[1]
    bound, by = bound_seconds(4 * count, 0, "float32")
    want = random._uniform_ref(0, SHAPE, device=device)
    for version in order:
        with versions[version].use():
            got = random.uniform_pallas(0, SHAPE)
            times = measures(lambda: random._uniform_cuda(
                0, SHAPE, torch.float32, 0.0, 1.0, device), None, dirty,
                clean)
        emit(rows, dict(times, probe="uniform", version=version,
                        bit_equal=bool(torch.equal(got, want)),
                        bound_ms=bound * 1e3, bound_by=by,
                        bound_share_device=bound * 1e3 / times["device_ms"]))
    gen = torch.Generator(device=device).manual_seed(0)
    emit(rows, dict(measures(lambda: torch.rand(
        SHAPE, generator=gen, device=device), None, dirty, clean),
        probe="uniform", version="torch.rand", bound_ms=bound * 1e3,
        bound_by=by))
    out = torch.empty(SHAPE, device=device)
    emit(rows, dict(measures(lambda: out.fill_(0.5), None, dirty, clean),
                    probe="uniform", version="fill_", bound_ms=bound * 1e3,
                    bound_by=by))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a directory with another "
                        "version's reduce.cu and random.cu")
    parser.add_argument("--out", default="build/ops_probe/probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ops_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from veles_tpu_torch.backends import set_precision
    from veles_tpu_torch.config import root
    from veles_tpu_torch.ops import build
    root.common.engine.precision_level = 2
    set_precision()
    device = torch.device("cuda", 0)
    rows = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    emit(rows, {"probe": "device", "nvidia_smi": smi})

    tic = time.perf_counter()
    work = build.BUILD_DIR.parent / "ops_probe"
    work.mkdir(parents=True, exist_ok=True)
    copies = {label: (build.CSRC_DIR / "reduce.cu",
                      work / ("lib%s.so" % label), flags)
              for label, flags in VARIANTS.items()}
    if args.parent:
        for name in ("reduce", "random"):
            copies["parent_" + name] = (Path(args.parent) / (name + ".cu"),
                                        work / ("libparent_%s.so" % name),
                                        ())
    reports = build_copies(copies)
    build.build_all(("reduce", "random"))
    emit(rows, {"probe": "build", "seconds": time.perf_counter() - tic,
                "ptxas": {name: ptxas_lines(build.build_log[name]["ptxas"])
                          for name in ("reduce", "random")},
                "copies_ptxas": reports})

    versions = {"change": Version(build.library_path("reduce"),
                                  build.library_path("random"))}
    for label in VARIANTS:
        if isinstance(reports[label], dict):    # a copy that did not build
            continue
        versions[label] = Version(copies[label][1],
                                  build.library_path("random"))
    order = ["change"]
    if args.parent:
        versions["parent"] = Version(copies["parent_reduce"][1],
                                     copies["parent_random"][1], parent=True)
        order = ["parent", "change", "change", "parent"]
    dirty = chip_smoke.make_l2_flush(device, dirty=True)
    clean = chip_smoke.make_l2_flush(device)
    probe_reduce(rows, versions, order, device, dirty, clean)
    probe_uniform(rows, versions, order, device, dirty, clean)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
