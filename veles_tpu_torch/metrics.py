"""Low-overhead latency histogram: the port's own copy of
:class:`veles_tpu.metrics.LatencyHistogram` (same log-spaced bucket
boundaries, 60 µs … 60 s, so percentiles of the two packages compare)."""

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
    def mean(self):
        return self._sum / self._n if self._n else 0.0

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
