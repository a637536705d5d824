"""Shared metric primitives: the port's own copy of
:mod:`veles_tpu.metrics`.

:class:`LatencyHistogram` keeps the same log-spaced bucket boundaries,
60 µs … 60 s, so percentiles of the two packages compare;
:func:`emit_histogram` is the one Prometheus histogram renderer the
serving ``/metrics`` page uses."""

import bisect
import threading


def _log_bounds(lo=6e-5, hi=60.0, per_decade=5):
    bounds = []
    value = lo
    factor = 10.0 ** (1.0 / per_decade)
    while value < hi:
        bounds.append(value)
        value *= factor
    bounds.append(hi)
    return bounds


class LatencyHistogram(object):
    """Fixed log-spaced buckets; thread-safe record + percentile."""

    BOUNDS = _log_bounds()

    def __init__(self):
        self._counts = [0] * (len(self.BOUNDS) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def record(self, seconds):
        idx = bisect.bisect_left(self.BOUNDS, seconds)
        with self._lock:
            self._counts[idx] += 1
            self._sum += seconds
            self._n += 1

    @property
    def count(self):
        return self._n

    @property
    def mean(self):
        return self._sum / self._n if self._n else 0.0

    def cumulative(self):
        """Consistent snapshot for Prometheus exposition:
        ``(upper_bounds, cumulative_counts, sum_seconds, count)``;
        ``cumulative_counts[i]`` counts observations <= ``bounds[i]``,
        and the last slot, past the last bound, is ``+Inf``."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        running, cum = 0, []
        for c in counts:
            running += c
            cum.append(running)
        return list(self.BOUNDS), cum, total, n

    def percentile(self, q):
        """q in [0, 100] → seconds (interpolated inside the bucket)."""
        with self._lock:
            counts, n = list(self._counts), self._n
        if not n:
            return 0.0
        target = q / 100.0 * n
        seen = 0
        for idx, c in enumerate(counts):
            if seen + c >= target and c:
                lo = self.BOUNDS[idx - 1] if idx else 0.0
                hi = self.BOUNDS[idx] if idx < len(self.BOUNDS) \
                    else self.BOUNDS[-1]
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.BOUNDS[-1]


def emit_histogram(lines, name, hist, help_, labels=None):
    """Append one :class:`LatencyHistogram`'s Prometheus histogram
    exposition under the full metric ``name``: cumulative ``le``
    buckets, ``_sum`` and ``_count``.  ``help_=None`` skips the
    HELP/TYPE header, for callers grouping several label variants under
    one family header."""
    bounds, cum, total, count = hist.cumulative()
    prefix = "".join('%s="%s",' % (k, v) for k, v in
                     sorted((labels or {}).items()))
    suffix = ("{%s}" % prefix.rstrip(",")) if prefix else ""
    if help_ is not None:
        lines.append("# HELP %s %s" % (name, help_))
        lines.append("# TYPE %s histogram" % name)
    for bound, c in zip(bounds, cum):
        lines.append('%s_bucket{%sle="%.6g"} %d'
                     % (name, prefix, bound, c))
    lines.append('%s_bucket{%sle="+Inf"} %d' % (name, prefix, count))
    lines.append("%s_sum%s %.6f" % (name, suffix, total))
    lines.append("%s_count%s %d" % (name, suffix, count))
    return lines
