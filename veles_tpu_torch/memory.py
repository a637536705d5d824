"""Device memory: the ``Watcher`` ledger and ``Vector``, the buffer that
bridges host numpy and a device tensor.

The port's counterpart of :mod:`veles_tpu.memory`.  ``Watcher`` tracks
resident device bytes by category (``track`` / ``untrack``, current and
peak, and the ``generation`` guard that makes releases taken before a
``reset()`` no-ops) and counts host→device and device→host transfer
bytes.  The generative engine holds its KV cache under ``kv`` and its
parameters under ``params``; the workflow's Vectors hold theirs under
their own ``category``.

``Vector`` keeps ``mem`` (a host numpy array) and ``devmem`` (a
``torch.Tensor`` on the attached device) and knows which side holds the
freshest data: ``map_read`` brings the device copy to the host,
``map_write`` declares a host edit (the next ``devmem`` re-uploads),
``reset`` installs new host contents.  A unit that updates ``devmem``
in place (the GD kernels do) publishes it by assigning it back
(``vec.devmem = tensor``).

A Vector that a captured CUDA graph reads must keep its device address:
a stitched segment sets ``keep_address`` on every Vector its stages
read, and from then on a re-upload after ``map_write``/``reset`` copies
into the bound tensor (counted in the Watcher as an in-place upload),
and a published tensor of the same shape and type is copied into it.
``bind`` rebinds unconditionally: a segment binds the Vectors it
produces to its graph's outputs once.

A pod (:mod:`veles_tpu_torch.pod`) pins a Vector's placement over its
mesh with :meth:`Vector.set_sharding` (a
:class:`~veles_tpu_torch.parallel.mesh.Sharding`): the device then holds
this rank's slice under the spec (the whole array when the spec
replicates), ``shape`` stays the global one, and ``map_read`` gathers
the slices back over the spec's groups, a collective every rank of the
mesh makes in the same order.

A ``Vector`` pickles its host numpy array and its category only: the
pickle first waits for the device and brings a fresher device copy to
the host (the graphs write the weights on the device in place), and
the tensor, the device, the ledger's hold and ``keep_address`` are
transient.  A snapshot written on the card therefore holds no device
storage and loads in a process without CUDA; ``initialize(device)``
attaches it again.
"""

import threading

import numpy
import torch


class Watcher(object):
    """Process-wide ledger of resident device bytes by category and of
    transfer traffic in both directions."""

    lock = threading.Lock()
    bytes_in_use = 0
    peak_bytes = 0
    #: bumped by reset(); holds taken before it were already wiped
    generation = 0
    h2d_bytes = 0
    h2d_transfers = 0
    #: the share of the above that went into an already bound tensor
    h2d_inplace_bytes = 0
    h2d_inplace_transfers = 0
    d2h_bytes = 0
    d2h_transfers = 0
    bytes_by_category = {}
    peak_by_category = {}
    #: ``(nbytes, category, generation)`` releases of Vectors collected by
    #: the garbage collector, which may run inside a locked section of
    #: this very thread (the lock is not reentrant): each locked call
    #: applies them first
    _deferred = []

    @classmethod
    def _apply_deferred(cls):
        """Apply the deferred releases; the caller holds the lock."""
        while cls._deferred:
            nbytes, cat, generation = cls._deferred.pop()
            if generation == cls.generation:
                cls.bytes_in_use -= nbytes
                cls.bytes_by_category[cat] = \
                    cls.bytes_by_category.get(cat, 0) - nbytes

    @classmethod
    def untrack_later(cls, nbytes, category, generation):
        """A release that takes no lock (``Vector.__del__``'s): applied
        at the next locked call, unless a ``reset()`` came between."""
        cls._deferred.append((nbytes, category or "other", generation))

    @classmethod
    def track(cls, nbytes, category=None):
        cat = category or "other"
        with cls.lock:
            cls._apply_deferred()
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
            cls._apply_deferred()
            cls.bytes_in_use -= nbytes
            cls.bytes_by_category[cat] = \
                cls.bytes_by_category.get(cat, 0) - nbytes

    @classmethod
    def track_h2d(cls, nbytes, inplace=False):
        with cls.lock:
            cls.h2d_bytes += int(nbytes)
            cls.h2d_transfers += 1
            if inplace:
                cls.h2d_inplace_bytes += int(nbytes)
                cls.h2d_inplace_transfers += 1

    @classmethod
    def track_d2h(cls, nbytes):
        with cls.lock:
            cls.d2h_bytes += int(nbytes)
            cls.d2h_transfers += 1

    @classmethod
    def transfers(cls):
        """``{h2d_bytes, h2d_transfers, h2d_inplace_bytes,
        h2d_inplace_transfers, d2h_bytes, d2h_transfers}``."""
        with cls.lock:
            return {"h2d_bytes": cls.h2d_bytes,
                    "h2d_transfers": cls.h2d_transfers,
                    "h2d_inplace_bytes": cls.h2d_inplace_bytes,
                    "h2d_inplace_transfers": cls.h2d_inplace_transfers,
                    "d2h_bytes": cls.d2h_bytes,
                    "d2h_transfers": cls.d2h_transfers}

    @classmethod
    def hbm_ledger(cls):
        """JSON-able snapshot: totals and per-category current/peak."""
        with cls.lock:
            cls._apply_deferred()
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
            cls._deferred.clear()
            cls.generation += 1
            cls.bytes_in_use = 0
            cls.peak_bytes = 0
            cls.h2d_bytes = 0
            cls.h2d_transfers = 0
            cls.h2d_inplace_bytes = 0
            cls.h2d_inplace_transfers = 0
            cls.d2h_bytes = 0
            cls.d2h_transfers = 0
            cls.bytes_by_category = {}
            cls.peak_by_category = {}


def _nbytes(tensor):
    return tensor.numel() * tensor.element_size()


def _same_layout(tensor, shape, dtype):
    """True when ``tensor`` can take contents of ``shape`` and ``dtype``
    (a numpy or torch dtype) in place."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(numpy.empty(0, dtype)).dtype
    return tuple(tensor.shape) == tuple(shape) and tensor.dtype == dtype


class Vector(object):
    """Host-mirrored device buffer.  ``category`` tags its device bytes
    in the Watcher (``params`` / ``dataset`` / ``staging``; ``None``
    groups under ``other``)."""

    def __init__(self, data=None, category=None):
        self._mem = None
        self._device = None
        self._devmem = None
        self._host_fresh = True
        self._dev_fresh = False
        self._tracked = 0
        self._tracked_gen = 0
        self.category = category
        #: writes go into the bound device tensor (a graph reads it)
        self.keep_address = False
        #: the pinned placement over a pod's mesh (None: the whole
        #: array on the attached device)
        self._sharding = None
        if data is not None:
            self.reset(data)

    # -- basic properties ---------------------------------------------------
    def reset(self, data):
        """Install new host contents; the device copy is dropped, or
        kept to be overwritten at the next ``devmem`` when
        ``keep_address`` is set."""
        self._mem = numpy.ascontiguousarray(data) \
            if data is not None else None
        if self._mem is None or not self.keep_address:
            self._drop_devmem()
        self._host_fresh = True
        self._dev_fresh = False
        return self

    def _ref(self):
        if self._sharding is not None and self._mem is not None:
            return self._mem            # the device holds a slice
        return self._devmem if self._devmem is not None else self._mem

    @property
    def nbytes(self):
        """The bytes of the whole array (its global shape), read without
        a copy."""
        shape, dtype = self.shape, self.dtype
        if shape is None or dtype is None:
            return 0
        return int(numpy.prod(shape, dtype=numpy.int64)) * dtype.itemsize

    @property
    def shape(self):
        ref = self._ref()
        return tuple(ref.shape) if ref is not None else None

    @property
    def dtype(self):
        if self._mem is not None:
            return self._mem.dtype
        if self._devmem is not None:
            return numpy.dtype(str(self._devmem.dtype).replace("torch.",
                                                               ""))
        return None

    def __bool__(self):
        return self.shape is not None

    def __len__(self):
        shape = self.shape
        return shape[0] if shape else 0

    def __repr__(self):
        where = "dev" if not self._host_fresh else "host"
        return "<Vector %s %s @%s>" % (self.shape, self.dtype, where)

    # -- device attachment --------------------------------------------------
    def initialize(self, device):
        """Attach to a device; the upload happens at the first ``devmem``
        access."""
        self._device = device
        return self

    # -- the coherence protocol --------------------------------------------
    @property
    def mem(self):
        """Host view, brought up to date first.  Call :meth:`map_write`
        before editing it in place."""
        self.map_read()
        return self._mem

    @mem.setter
    def mem(self, value):
        self.reset(value)

    @property
    def devmem(self):
        """The device tensor; uploads the host copy if it is fresher."""
        if self._devmem is None or not self._dev_fresh:
            if self._mem is None:
                raise ValueError("empty Vector has no device memory")
            if self._device is None:
                raise ValueError("Vector is attached to no device: "
                                 "initialize(device) it first")
            host = self._placed_host()
            inplace = (self.keep_address and self._devmem is not None
                       and _same_layout(self._devmem, host.shape,
                                        host.dtype))
            if inplace:
                self._device.put_into(self._devmem, host)
            else:
                self._set_devmem(self._device.put(host))
            Watcher.track_h2d(host.nbytes, inplace=inplace)
            self._dev_fresh = True
        return self._devmem

    @devmem.setter
    def devmem(self, value):
        """Publish a device tensor (new, or the old one updated in
        place): the host copy is stale from here on.  With
        ``keep_address`` a new tensor of the bound one's shape and type
        is copied into it."""
        if value is not self._devmem:
            if (self.keep_address and self._devmem is not None
                    and value.device == self._devmem.device
                    and _same_layout(self._devmem, value.shape,
                                     value.dtype)):
                self._devmem.copy_(value)
            else:
                self._set_devmem(value)
        self._dev_fresh = True
        self._host_fresh = False

    def bind(self, value):
        """Rebind to the device tensor ``value`` whatever
        ``keep_address`` says (a segment binds the Vectors it produces
        to its graph's static outputs); the host copy is stale."""
        if value is not self._devmem:
            self._set_devmem(value)
        self._dev_fresh = True
        self._host_fresh = False

    def publish(self, host_array=None, device_array=None):
        """Install matching host and device copies in one step (the
        consume half of the prefetch ring: a background worker prepared
        both).  ``host_array`` alone is an in-place host edit, as after
        :meth:`map_write`; with ``device_array`` both sides are fresh.
        A ``keep_address`` Vector copies ``device_array`` into its bound
        tensor, as the ``devmem`` setter does."""
        if host_array is not None:
            if self._mem is None or self._mem.shape != host_array.shape \
                    or not self._mem.flags.writeable:
                self._mem = numpy.array(host_array)
            else:
                self._mem[...] = host_array
            self._host_fresh = True
            self._dev_fresh = False
        if device_array is not None:
            self.devmem = device_array
            self._host_fresh = host_array is not None
        return self

    def map_read(self):
        """Bring the host copy up to date (a device→host copy when the
        device holds newer data; a sharded Vector gathers its slices
        first)."""
        if not self._host_fresh and self._devmem is not None:
            dev = self._devmem
            if self._sharding is not None:
                from veles_tpu_torch.parallel.mesh import unshard
                dev = unshard(dev, self._sharding.spec,
                              self._sharding.mesh)
            self._mem = self._device.get(dev)
            self._host_fresh = True
            Watcher.track_d2h(self._mem.nbytes)
        return self

    # -- pod placement --------------------------------------------------------
    @property
    def sharding(self):
        """The pinned placement over a pod's mesh (None: the whole array
        on the attached device)."""
        return self._sharding

    def set_sharding(self, sharding, keep=True):
        """Pin (or clear, with None) this Vector's placement: a
        :class:`~veles_tpu_torch.parallel.mesh.Sharding`.  With ``keep``
        the freshest contents are preserved (a newer device copy is
        read back to the host first, gathered under the old placement);
        ``keep=False`` drops a device copy unread (a staging buffer the
        next step rewrites).  The next ``devmem`` uploads this rank's
        slice under the new spec.  No-op when the placement is
        unchanged."""
        old = self._sharding
        if sharding is old or (
                sharding is not None and old is not None
                and sharding.mesh is old.mesh and sharding.spec == old.spec):
            return self
        if keep and self._devmem is not None:
            self.map_read()
        elif self._devmem is not None and not self._host_fresh:
            self._host_fresh = True     # unread: the host copy stands
        self._sharding = sharding
        self._drop_devmem()
        self._dev_fresh = False
        return self

    def _placed_host(self):
        """The host array this rank's device copy holds: the whole array,
        or its slice under the pinned spec."""
        if self._sharding is None:
            return self._mem
        from veles_tpu_torch.parallel.mesh import shard
        return numpy.ascontiguousarray(shard(
            self._mem, self._sharding.spec, self._sharding.mesh))

    def map_write(self):
        """Declare an in-place edit of the host copy: the next
        ``devmem`` access re-uploads."""
        self.map_read()
        if self._mem is not None and not self._mem.flags.writeable:
            self._mem = numpy.array(self._mem)
        self._dev_fresh = False
        return self

    # -- helpers ------------------------------------------------------------
    def _set_devmem(self, value):
        self._untrack()
        self._devmem = value
        self._tracked = _nbytes(value)
        if self._tracked:
            Watcher.track(self._tracked, self.category)
            self._tracked_gen = Watcher.generation

    def _untrack(self):
        if self._tracked and self._tracked_gen == Watcher.generation:
            Watcher.untrack(self._tracked, self.category)
        self._tracked = 0

    def _drop_devmem(self):
        self._untrack()
        self._devmem = None

    # -- pickling (snapshots) ----------------------------------------------
    def __getstate__(self):
        if not self._host_fresh and self._devmem is not None:
            # a graph may have written the tensor on another stream
            self._device.sync()
        self.map_read()
        return {"mem": self._mem, "category": self.category}

    def __setstate__(self, state):
        self.__init__(category=state.get("category"))
        self._mem = state.get("mem")

    def __del__(self):
        # the collector may run this inside the Watcher's locked section
        # of the same thread: release without taking the lock
        try:
            if self._tracked:
                Watcher.untrack_later(self._tracked, self.category,
                                      self._tracked_gen)
            self._tracked = 0
            self._devmem = None
        except Exception:  # pragma: no cover - interpreter shutdown
            pass


class Staged(object):
    """A staged upload: the device tensor and the event its copy
    recorded on the ring's side stream (None on the CPU)."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor, event=None):
        self.tensor = tensor
        self.event = event

    def take(self):
        """The tensor, with the calling thread's current stream made to
        wait for the copy first (and the allocator told that stream
        uses it)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


class StagingRing(object):
    """The loader prefetch ring's host staging, the port's counterpart
    of ``veles_tpu.memory.StagingRing``: ``depth`` buffers allocated
    once (pinned when ``pin``), handed out round robin by
    :meth:`acquire`, uploaded by :meth:`upload`.

    A slot is never rewritten while its copy is queued: the upload
    records an event on the ring's side stream, and :meth:`acquire`
    waits on the slot's last event before it hands the slot out again
    (the idiom of ``stitch.ScalarBlock``).  The caller still picks
    ``depth`` above its fills in flight plus the slots being read (the
    loader takes 3)."""

    def __init__(self, shape, dtype, depth=2, pin=False):
        self.depth = int(depth)
        dtype = torch.from_numpy(numpy.empty(0, dtype)).dtype
        self._slots = [torch.zeros(shape, dtype=dtype, pin_memory=pin)
                       for _ in range(self.depth)]
        self._arrays = [slot.numpy() for slot in self._slots]
        self._events = [None] * self.depth
        self._pos = 0
        self._lock = threading.Lock()
        self._streams = {}

    def acquire(self):
        """The next buffer (a numpy view of the slot), once the copy
        last queued from it has finished."""
        from veles_tpu_torch import trace
        with trace.span("loader", "ring_acquire"):
            with self._lock:
                pos = self._pos
                self._pos = (pos + 1) % self.depth
                event, self._events[pos] = self._events[pos], None
            if event is not None:
                event.synchronize()
        return self._arrays[pos]

    def _slot_of(self, array):
        for pos, held in enumerate(self._arrays):
            if held is array:
                return pos
        raise ValueError("the array is not a slot of this ring")

    def upload(self, device, array):
        """Queue a copy of the slot ``array`` to ``device`` (a workflow
        device; None gives None) and return it :class:`Staged`.  On a
        card the copy runs on the ring's side stream with
        ``non_blocking=True``; the consumer calls ``take()``."""
        from veles_tpu_torch import trace
        target = getattr(device, "torch_device", None)
        if target is None:
            return None
        pos = self._slot_of(array)
        with trace.span("loader", "staging_upload"):
            if target.type != "cuda":
                staged = Staged(device.put(array))
            else:
                stream = self._streams.get(target)
                if stream is None:
                    stream = self._streams[target] = \
                        torch.cuda.Stream(target)
                with torch.cuda.stream(stream):
                    out = torch.empty(self._slots[pos].shape,
                                      dtype=self._slots[pos].dtype,
                                      device=target)
                    out.copy_(self._slots[pos], non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
                self._events[pos] = event
                staged = Staged(out, event)
        Watcher.track_h2d(array.nbytes)
        return staged
