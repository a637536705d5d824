#!/usr/bin/env python3
"""Probe the stitched loader head's served launch (``csrc/gather.cu``
``veles_gather_served``) on the card, beside the head as another version
runs it: five int32 index ops (seven kernels: each ``where`` against a
scalar first fills a tensor with it), then that version's group launch.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/head_probe.py [--parent DIR] [--out FILE]

``--parent DIR`` is the root of another version's checkout (e.g. ``git
archive`` of the parent commit unpacked under ``build/``), whose
``csrc/gather.cu`` has ``veles_gather_group`` (the same table argument as
this version's).  It is built with this checkout's flags and loaded
with ctypes.  Each case is held against
``_gather_served_ref`` bit for bit, then timed as device time a call
(calls queued behind a spinning kernel, one CUDA-event pair around them:
``chip_smoke.device_ms``), back to back on the same operands, in the
order parent, change, change, parent:

- the MNIST head: 100 rows of a (7000, 784) u8 table normalized (scale
  1/255) and the (7000,) int32 labels, taken from a shuffled 7000-row
  buffer at offset 1000, size 100; the same at a 60-row tail; and 4096
  rows of a (70000, 784) table with its labels;
- parent: each of the five index ops alone (``lt``, ``add``,
  ``where``, ``index_select``, ``where``), the whole head (the five, then
  the parent's group launch), the group launch alone, and once the
  head's kernels by name and device time in a ``torch.profiler`` window;
- change: the served launch, and this version's group launch alone on
  the same rows.

Then, with ``--parent``, the stitched MNIST route's steady epoch in a
fresh process of each checkout, parent, change, change, parent
(``scripts/launch_probe.py``'s ``probe_epoch``): wall and busy time,
kernels a minibatch, device time by group.  Prints the card's name and
power limit, then one JSON object a line, and writes them all to
``--out``.
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
sys.path.insert(0, str(REPO / "scripts"))

#: (label, rows, features, count, offset, size) of each case
CASES = (("mnist_minibatch", 7000, 784, 100, 1000, 100),
         ("mnist_tail_60", 7000, 784, 100, 940, 60),
         ("rows_4096", 70000, 784, 4096, 17500, 4096))


def emit(rows, obj):
    rows.append(obj)
    print(json.dumps(obj), flush=True)


def build_parent(parent, work):
    """The parent's ``gather.cu`` built with this checkout's flags: its
    ``veles_gather_group`` entry, and the ptxas lines."""
    from launch_probe import ptxas_lines
    from veles_tpu_torch.ops import build, gather
    target = work / "libparent_gather.so"
    source = Path(parent) / "veles_tpu_torch" / "csrc" / "gather.cu"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                           str(target), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed on the parent's gather.cu:\n%s"
                           % (proc.stdout + proc.stderr))
    fn = ctypes.CDLL(str(target)).veles_gather_group
    fn.argtypes = gather._ARGTYPES["veles_gather_group"]
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(proc.stdout + proc.stderr)


@contextlib.contextmanager
def group_entry(fn):
    """The package's group wrapper launches ``fn`` inside the block."""
    from veles_tpu_torch.ops import gather
    saved = dict(gather._entries)
    gather._entries["veles_gather_group"] = fn
    try:
        yield
    finally:
        gather._entries.clear()
        gather._entries.update(saved)


def operands(rng, device, n, f):
    import chip_smoke
    from veles_tpu_torch.ops import gather
    data = chip_smoke._gather_table(rng, device, torch.uint8, (n, f))
    labels = chip_smoke._gather_table(rng, device, torch.int32, (n,))
    norm = gather.affine_tensors((1.0 / 255.0, 0.0), device)
    shuffled = torch.from_numpy(rng.permutation(n).astype(
        numpy.int32)).to(device)
    return [(data, norm), (labels, -1)], shuffled


def probe_case(rows, parent_fn, device, order, case):
    import chip_smoke
    from veles_tpu_torch.backends import bound_seconds
    from veles_tpu_torch.ops import gather
    label, n, f, count, offset, size = case
    rng = numpy.random.default_rng(2)
    tables, shuffled = operands(rng, device, n, f)
    _block, at, served_size = chip_smoke._scalars(device, offset, size)
    want = gather._gather_served_ref(tables, shuffled, at, served_size,
                                     count)
    idx = gather._served_indices(shuffled, at, served_size, count)
    index_ops, head = chip_smoke._parent_head(tables, shuffled, at,
                                              served_size, count)
    outs = gather._gather_served_cuda(tables, shuffled, at, served_size,
                                      count)
    bound, by = bound_seconds(chip_smoke._gather_bytes(
        [t for t, _how in tables], idx, outs, extra=16,
        index_bytes=4 * int((idx >= 0).sum())), 2 * size * f, "float32")
    profiled = False
    for version in order:
        row = {"probe": "head", "case": label, "version": version,
               "rows": count, "offset": offset, "size": size,
               "bound_ms": bound * 1e3, "bound_by": by}
        if version == "parent":
            with group_entry(parent_fn):
                got = head()
                chip_smoke.gpu_sync()
                row["exact"] = all(torch.equal(g, w)
                                   for g, w in zip(got, want))
                row["index_kernels_ms"] = {
                    op: chip_smoke.device_ms(fn) for op, fn in
                    index_ops.items()}
                row["index_kernels_sum_ms"] = sum(
                    row["index_kernels_ms"].values())
                row["head_ms"] = chip_smoke.device_ms(head)
                row["group_alone_ms"] = chip_smoke.device_ms(
                    lambda: gather._gather_group_cuda(tables, idx))
                if not profiled:
                    summary = chip_smoke.profile_window(
                        head, ("other", "copy", "veles_gather_group"))
                    row["head_profile"] = {key: summary[key] for key in (
                        "device_kernels", "kernel_names", "top_kernels_ms",
                        "device_busy_ms")}
                    profiled = True
        else:
            got = gather._gather_served_cuda(tables, shuffled, at,
                                             served_size, count)
            chip_smoke.gpu_sync()
            row["exact"] = all(torch.equal(g, w) for g, w in zip(got, want))
            row["served_ms"] = chip_smoke.device_ms(
                lambda: gather._gather_served_cuda(
                    tables, shuffled, at, served_size, count))
            row["group_alone_ms"] = chip_smoke.device_ms(
                lambda: gather._gather_group_cuda(tables, idx))
        emit(rows, row)
    del tables, shuffled
    torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="the root of another version's "
                        "checkout (its csrc/gather.cu)")
    parser.add_argument("--out", default="build/head_probe/probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("head_probe: no CUDA device", file=sys.stderr)
        return 1
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
    work = build.BUILD_DIR.parent / "head_probe"
    work.mkdir(parents=True, exist_ok=True)
    parent_fn, parent_ptxas = None, None
    if args.parent:
        parent_fn, parent_ptxas = build_parent(args.parent, work)
    build.build_all(("gather",))
    emit(rows, {"probe": "build", "seconds": time.perf_counter() - tic,
                "ptxas": build.build_log["gather"]["ptxas"].splitlines(),
                "parent_ptxas": parent_ptxas})
    order = ["parent", "change", "change", "parent"] if args.parent \
        else ["change"]
    for case in CASES:
        probe_case(rows, parent_fn, device, order, case)
    if args.parent:
        from launch_probe import probe_epoch
        probe_epoch(rows, args.parent, order)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
