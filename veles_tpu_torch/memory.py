"""Device-memory accounting: the port's own copy of the ``Watcher``
ledger of :mod:`veles_tpu.memory` (``track`` / ``untrack`` by category,
current and peak bytes, and the ``generation`` guard that makes
releases taken before a ``reset()`` no-ops).  The generative engine
holds its KV cache under ``kv`` and its parameters under ``params``.
``Vector`` and the transfer counters wait for the MNIST training slice
(ROADMAP.md, 'Slices still to port', item 1)."""

import threading


class Watcher(object):
    """Process-wide ledger of resident device bytes by category."""

    lock = threading.Lock()
    bytes_in_use = 0
    peak_bytes = 0
    #: bumped by reset(); holds taken before it were already wiped
    generation = 0
    bytes_by_category = {}
    peak_by_category = {}

    @classmethod
    def track(cls, nbytes, category=None):
        cat = category or "other"
        with cls.lock:
            cls.bytes_in_use += nbytes
            cls.peak_bytes = max(cls.peak_bytes, cls.bytes_in_use)
            total = cls.bytes_by_category.get(cat, 0) + nbytes
            cls.bytes_by_category[cat] = total
            cls.peak_by_category[cat] = max(
                cls.peak_by_category.get(cat, 0), total)

    @classmethod
    def untrack(cls, nbytes, category=None):
        cat = category or "other"
        with cls.lock:
            cls.bytes_in_use -= nbytes
            cls.bytes_by_category[cat] = \
                cls.bytes_by_category.get(cat, 0) - nbytes

    @classmethod
    def hbm_ledger(cls):
        """JSON-able snapshot: totals and per-category current/peak."""
        with cls.lock:
            by_category = {
                cat: {"bytes": cls.bytes_by_category.get(cat, 0),
                      "peak": peak}
                for cat, peak in cls.peak_by_category.items()}
            return {"bytes_in_use": cls.bytes_in_use,
                    "peak_bytes": cls.peak_bytes,
                    "by_category": by_category}

    @classmethod
    def reset(cls):
        with cls.lock:
            cls.generation += 1
            cls.bytes_in_use = 0
            cls.peak_bytes = 0
            cls.bytes_by_category = {}
            cls.peak_by_category = {}
