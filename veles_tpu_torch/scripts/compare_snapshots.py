"""Compare two workflow snapshots unit by unit: the port's counterpart
of :mod:`veles_tpu.scripts.compare_snapshots`.

Every ``Vector`` attribute of every unit is held against its namesake
in the other snapshot and reported ``equal``, ``close`` (within
``rtol`` / ``atol``), ``DIFFERENT`` (or of another shape), ``only-in-A``
or ``only-in-B``, with the largest absolute difference.  The snapshots
load on the host (:func:`veles_tpu_torch.snapshotter.load_snapshot`),
so no card is needed.

Usage: ``python -m veles_tpu_torch.scripts.compare_snapshots A B``
(exit code 0 when every array is equal, 1 otherwise).
"""

import sys

import numpy

from veles_tpu_torch.memory import Vector


def _vectors_of(workflow):
    """``{unit_name.attr: ndarray}`` for every non-empty Vector of
    every unit."""
    out = {}
    for unit in workflow:
        for attr, value in vars(unit).items():
            if isinstance(value, Vector) and value:
                out["%s.%s" % (unit.name, attr)] = numpy.asarray(
                    value.mem)
    return out


def compare(workflow_a, workflow_b, rtol=1e-5, atol=1e-6):
    """``(rows, worst)``: a row is ``(key, status, delta)``, the status
    one of equal / close / DIFFERENT / only-in-A / only-in-B."""
    va, vb = _vectors_of(workflow_a), _vectors_of(workflow_b)
    rows = []
    worst = 0.0
    for key in sorted(set(va) | set(vb)):
        if key not in va:
            rows.append((key, "only-in-B", None))
            continue
        if key not in vb:
            rows.append((key, "only-in-A", None))
            continue
        a, b = va[key], vb[key]
        if a.shape != b.shape:
            rows.append((key, "DIFFERENT", "shape %s vs %s"
                         % (a.shape, b.shape)))
            worst = float("inf")
            continue
        delta = float(numpy.abs(a - b).max()) if a.size else 0.0
        worst = max(worst, delta)
        if delta == 0.0:
            rows.append((key, "equal", 0.0))
        elif numpy.allclose(a, b, rtol=rtol, atol=atol):
            rows.append((key, "close", delta))
        else:
            rows.append((key, "DIFFERENT", delta))
    return rows, worst


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    from veles_tpu_torch.snapshotter import load_snapshot
    rows, worst = compare(load_snapshot(argv[0]), load_snapshot(argv[1]))
    for key, status, delta in rows:
        print("%-50s %-12s %s" % (key, status,
                                  "" if delta is None else delta))
    print("worst delta: %s" % worst)
    return 0 if worst == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
