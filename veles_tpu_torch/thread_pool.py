"""Host-side background executor: the port's copy of
:mod:`veles_tpu.thread_pool`.

One process-wide :class:`~concurrent.futures.ThreadPoolExecutor` for
host-blocking work: the loader's prefetch ring
(:mod:`veles_tpu_torch.loader.base`), background units
(``wants_thread``, :mod:`veles_tpu_torch.workflow`) and the job layer's
job generation and checkpoint writes
(:mod:`veles_tpu_torch.parallel.jobs`).
"""

import atexit
import threading
from concurrent.futures import ThreadPoolExecutor

_lock = threading.Lock()
_pool = None
#: atexit hook armed once per process — re-registering on every pool
#: recreation after a shutdown() would stack duplicate handlers
_atexit_registered = False


def get_pool():
    """The process-wide background executor (lazily created; worker count
    from ``root.common.engine.thread_pool_workers``, default 4)."""
    global _pool, _atexit_registered
    with _lock:
        if _pool is None:
            from veles_tpu_torch.config import root
            workers = root.common.engine.get("thread_pool_workers", 4)
            _pool = ThreadPoolExecutor(
                max_workers=int(workers) if workers else 4,
                thread_name_prefix="veles-bg")
            if not _atexit_registered:
                _atexit_registered = True
                atexit.register(shutdown)
        return _pool


def submit(fn, *args, **kwargs):
    return get_pool().submit(fn, *args, **kwargs)


def shutdown(wait=True):
    global _pool
    with _lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown(wait=wait)
