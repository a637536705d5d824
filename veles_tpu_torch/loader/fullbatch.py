"""FullBatchLoader: the whole dataset resident on the device.

The port's counterpart of :mod:`veles_tpu.loader.fullbatch`.  The
dataset (``original_data``) and its labels, mapped once into
``resident_labels`` (int32, ``-1`` for an unlabeled sample), are
uploaded once.  Minibatch selection then runs on the device, in one of
two ways:

- Eager (``engine.stitch=off``, or ``engine.loader=host``): the loader
  serves each minibatch as a unit, uploading only its index slice
  (``minibatch_indices``, 400 B at minibatch 100), and
  :func:`veles_tpu_torch.ops.gather.take_rows_group` gathers the data
  rows and the labels (one gather launch on the card).
- The device fast path (``engine.loader`` ``auto`` or ``device``, with
  stitching on): the loader HEADS the first stitched segment.
  :meth:`stitch_stage` keeps the serving bookkeeping as the segment's
  prelude and turns the fill into one served launch
  (:func:`veles_tpu_torch.ops.gather.take_rows_served`): over the
  device-resident shuffled-index buffer it takes row ``i`` at
  ``shuffled[offset + i]`` where ``i < size`` (a pad row after the
  tail), with ``offset`` and ``size`` read on the device from the
  segment's scalar block, so one captured graph serves every batch,
  short tails included, and gathers the data row and the labels (pad
  -1) in the same launch.  The shuffled indices move once per shuffle,
  in place.

``native_device_dtype=True`` keeps the dataset in its storage type
(uint8 pixels: a quarter of float32's bytes) and publishes the
normalizer's affine form as ``input_norm``; the head's served launch
then normalizes the data row (as
:func:`~veles_tpu_torch.ops.gather.take_rows_norm`), so the first
forward sees normalized float32.  It needs the head, or a consumer
that normalizes itself: the eager fill cannot normalize.  Without it
the dataset is normalized once on the host at initialize.

``rows_by_consumer`` (set by the fused trainer's link) makes :meth:`run`
serve the minibatch's indices only, as the head's prelude does: the
consumer gathers the rows (and normalizes a native dataset) inside its
own program, from ``minibatch_indices`` and the resident tables.

An epoch-scan window (:mod:`veles_tpu_torch.epoch_scan`) replays the
head's served launch once a step, each time with its own row of the
window's stacked scalar block.  The head stage's ``shard(first, rows)``
is the same launch over rows ``[first, first + rows)`` of each minibatch
(a pod rank's, :mod:`veles_tpu_torch.pod.runtime`): the offset moved by
``first``, the size clamped to the rank's rows.  :class:`FullBatchLoaderMSE` adds the
regression targets, a raw float32 table padded with 0 that rides in the
same launch on both routes.

A slave (:mod:`veles_tpu_torch.parallel.jobs`) keeps the dataset
resident across its jobs: a job moves only its span of indices into the
shuffled index buffer (one in-place upload at the head's next dispatch).
With ``prefetch`` on the device fast path, ``prefetch_job_data`` merges
the next job's span into a copy of the buffer and uploads it in the
background while the current job computes, and
``apply_data_from_master`` publishes that copy when the job comes.
"""

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.base import (INDEX_DTYPE, Loader, LoaderError,
                                         TRAIN)
from veles_tpu_torch.memory import StagingRing, Vector
from veles_tpu_torch.ops.gather import (affine_tensors, take_rows_group,
                                        take_rows_served)

LOADER_MODES = ("auto", "device", "host")


class FullBatchLoader(Loader):
    """Subclasses implement ``load_data()`` filling ``original_data``,
    ``original_labels`` (list or array) and ``class_lengths``."""

    hide_from_registry = True
    #: run() serves ``minibatch_indices`` only: the consumer gathers the
    #: rows itself (the fused trainer's step); a class default, so that
    #: a loader pickled before the attribute existed unpickles with it
    rows_by_consumer = False

    def __init__(self, workflow, **kwargs):
        self.original_data = Vector(category="dataset")
        self.original_labels = []
        #: keep the dataset in its storage dtype and normalize in the
        #: stitched head (needs an affine normalizer)
        self.native_device_dtype = bool(kwargs.get("native_device_dtype",
                                                   False))
        #: the normalizer's ``(scale, shift)`` when native_device_dtype
        self.input_norm = None
        #: the pre-mapped labels (int32, -1 = unlabeled), device-resident
        self.resident_labels = Vector(category="dataset")
        super(FullBatchLoader, self).__init__(workflow, **kwargs)

    def init_unpickled(self):
        super(FullBatchLoader, self).init_unpickled()
        #: ``input_norm`` as device tensors, made at initialize
        self._input_norm_dev_ = None
        #: a slave's staged next job: {(offset, size): (host, Future)}
        self._staged_indices_ = {}
        self._index_ring_ = None

    @property
    def has_labels(self):
        return len(self.original_labels) > 0

    @property
    def device_fast_path_active(self):
        """True when the loader heads the first stitched segment:
        ``engine.loader`` is ``auto`` or ``device``, a device is
        attached and the dataset is resident."""
        mode = str(root.common.engine.get("loader", "auto")).lower()
        if mode not in LOADER_MODES:
            raise ValueError("engine.loader must be one of %s, not %r"
                             % (LOADER_MODES, mode))
        return (mode != "host" and self.device is not None
                and bool(self.original_data))

    def create_minibatch_data(self):
        dtype = numpy.float32 if self.native_device_dtype \
            else self.original_data.dtype
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.original_data.shape[1:],
            dtype=dtype))

    def initialize(self, device=None, **kwargs):
        super(FullBatchLoader, self).initialize(device=device, **kwargs)
        if len(self.original_data) != self.total_samples:
            raise LoaderError(
                "original_data has %d samples, class_lengths say %d" %
                (len(self.original_data), self.total_samples))
        if self.has_labels and \
                len(self.original_labels) != self.total_samples:
            raise LoaderError("original_labels length mismatch")
        if self.native_device_dtype:
            # the dataset keeps its storage dtype; the head normalizes
            self.input_norm = self.normalizer.as_affine()
            if self.input_norm is None:
                raise LoaderError(
                    "native_device_dtype needs an affine normalizer "
                    "(as_affine() returned None for %s)"
                    % type(self.normalizer).__name__)
        else:
            # one-shot normalization of the resident dataset
            self.original_data.map_write()
            self.normalizer.normalize(self.original_data.mem)
        if self.has_labels:
            mapped = [-1 if raw is None
                      else self.labels_mapping.get(raw, raw)
                      for raw in self.original_labels]
            self.resident_labels.reset(
                numpy.asarray(mapped, dtype=numpy.int32))
        vectors = [self.original_data, self.minibatch_data,
                   self.minibatch_indices, self.shuffled_indices]
        if self.has_labels:
            vectors += [self.resident_labels, self.minibatch_labels]
        for vec in vectors:
            vec.initialize(self.device)
        self.original_data.devmem        # upload once
        if self.has_labels:
            self.resident_labels.devmem
        if self.native_device_dtype and self.device is not None:
            self._input_norm_dev_ = affine_tensors(
                self.input_norm, self.device.torch_device)

    def analyze_dataset(self):
        """The dataset is resident: analyze the TRAIN span directly."""
        if self.class_lengths[TRAIN] == 0:
            if not self.normalizer.is_initialized:
                raise LoaderError(
                    "no train samples and uninitialized normalizer")
            return
        start = self.class_end_offsets[TRAIN - 1]
        self.normalizer.analyze(self.original_data.mem[start:])
        if self.has_labels and not self.labels_mapping:
            uniques = sorted(set(
                raw for raw in self.original_labels if raw is not None))
            self.labels_mapping = {raw: i for i, raw in enumerate(uniques)}

    def run(self):
        if self.rows_by_consumer:
            self.stitch_prelude()
        else:
            super(FullBatchLoader, self).run()

    def fill_minibatch(self):
        """Gather the minibatch rows and labels on the device, where the
        dataset is resident: only the index slice goes up."""
        if self.native_device_dtype:
            raise LoaderError(
                "a native_device_dtype dataset is normalized by the "
                "stitched loader head; the eager fill cannot serve it "
                "(engine.stitch=on, engine.loader!=host)")
        plan = self._device_stage_plan()
        rows = take_rows_group([(src.devmem, pad)
                                for _name, src, _out, pad in plan],
                               self.minibatch_indices.devmem)
        for (_name, _src, out, _pad), row in zip(plan, rows):
            out.devmem = row

    def pad_minibatch(self, minibatch_size):
        """No-op: the gather pads the tail rows itself."""

    def normalize_minibatch(self):
        """No-op: the resident dataset was normalized at initialize (or
        the head normalizes a native one)."""

    def map_minibatch_labels(self):
        """No-op: the labels were mapped once into ``resident_labels``."""

    def prefetch_job_data(self, data):
        """Slave lookahead on the device fast path: the next job's span
        merged into a copy of the shuffled indices, uploaded in the
        background (opt in with ``prefetch``, as the host fill ring)."""
        if not self.device_fast_path_active:
            return super(FullBatchLoader, self).prefetch_job_data(data)
        if not self.prefetch or self._staged_indices_:
            # one staged span at a time: a second merge would copy the
            # buffer before the first span lands in it
            return
        key = (int(data["minibatch_offset"]), int(data["minibatch_size"]))
        if self._index_ring_ is None:
            target = getattr(self.device, "torch_device", None)
            self._index_ring_ = StagingRing(
                self.shuffled_indices.shape, INDEX_DTYPE, depth=3,
                pin=target is not None and target.type == "cuda")
        merged = self._index_ring_.acquire()
        merged[...] = self.shuffled_indices.mem
        merged[key[0] - key[1]:key[0]] = numpy.asarray(
            data["indices"], dtype=INDEX_DTYPE)
        from veles_tpu_torch import thread_pool
        fut = thread_pool.submit(self._index_ring_.upload, self.device,
                                 merged)
        self._staged_indices_[key] = (merged, fut)

    def apply_data_from_master(self, data):
        key = (int(data["minibatch_offset"]), int(data["minibatch_size"]))
        staged = self._staged_indices_.pop(key, None)
        # a miss means the lookahead is stale (the pipeline is two deep)
        self._staged_indices_.clear()
        if staged is None:
            return super(FullBatchLoader, self).apply_data_from_master(data)
        self._install_job(data)
        merged, fut = staged
        dev = fut.result()
        self.shuffled_indices.publish(
            merged, dev.take() if dev is not None else None)

    # -- the loader-headed stitched segment (the device fast path) -----------
    def _device_stage_plan(self):
        """``(name, source Vector, output Vector, pad)`` of each row the
        head gathers."""
        plan = [("minibatch_data", self.original_data,
                 self.minibatch_data, 0)]
        if self.has_labels:
            plan.append(("minibatch_labels", self.resident_labels,
                         self.minibatch_labels, -1))
        return plan

    def stitch_stage(self):
        """The head stage of the first segment (see the module doc), or
        None when the device fast path is off."""
        from veles_tpu_torch.stitch import StitchStage
        if not self.device_fast_path_active:
            return None
        plan = self._device_stage_plan()
        pads = {name: pad for name, _src, _out, pad in plan}
        norm = self._input_norm_dev_ if self.native_device_dtype else None
        count = int(self.max_minibatch_size)

        def served(first, rows):
            def fn(t):
                offset, size = t["offset"], t["size"]
                if first:
                    # a pod rank's rows of the minibatch: the same
                    # shuffled buffer from its own offset, the short
                    # tail's rows past the size padded
                    offset = offset + first
                    size = (size - first).clamp(0, rows)
                out = take_rows_served(
                    [(t["src_" + name], norm if norm is not None
                      and name == "minibatch_data" else pad)
                     for name, pad in pads.items()],
                    t["indices"], offset, size, rows)
                return dict(zip(pads, out))
            return fn

        params = {"indices": self.shuffled_indices}
        produces = {}
        for name, src, out_vec, _pad in plan:
            params["src_" + name] = src
            produces[name] = out_vec
        loader = self
        return StitchStage(
            self, served(0, count), produces=produces, params=params,
            shard=served,
            scalars=lambda: {
                "offset": int(loader.minibatch_offset
                              - loader.minibatch_size),
                "size": int(loader.minibatch_size)},
            prelude=self.stitch_prelude)


class FullBatchLoaderMSE(FullBatchLoader):
    """Adds per-sample regression targets (``original_targets``, served
    as ``minibatch_targets``): the port's counterpart of
    ``veles_tpu.loader.fullbatch.FullBatchLoaderMSE``.  The targets
    table joins the data (and labels) in the gather launch on both
    routes, raw float32 padded with 0."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.original_targets = Vector(category="dataset")
        self.minibatch_targets = Vector(category="staging")
        super(FullBatchLoaderMSE, self).__init__(workflow, **kwargs)

    def _device_stage_plan(self):
        plan = super(FullBatchLoaderMSE, self)._device_stage_plan()
        plan.append(("minibatch_targets", self.original_targets,
                     self.minibatch_targets, 0))
        return plan

    def initialize(self, device=None, **kwargs):
        super(FullBatchLoaderMSE, self).initialize(device=device, **kwargs)
        if len(self.original_targets) != self.total_samples:
            raise LoaderError("original_targets length mismatch")
        self.minibatch_targets.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.original_targets.shape[1:],
            dtype=self.original_targets.dtype))
        for vec in (self.original_targets, self.minibatch_targets):
            vec.initialize(self.device)
        self.original_targets.devmem     # upload once
