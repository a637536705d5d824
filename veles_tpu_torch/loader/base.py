"""Loader: the three-set dataset model and minibatch serving.

The port's counterpart of :mod:`veles_tpu.loader.base`, trimmed to the
standalone serving path: the TEST/VALID/TRAIN model over one
concatenated index space, class lengths and end offsets, the per-epoch
serving order test → validation → train with the flags
``last_minibatch`` / ``epoch_ended`` and ``epoch_number``, the
TRAIN-span shuffle through
:mod:`veles_tpu_torch.prng` (so a seed gives the JAX package's shuffles
bit for bit), ``serve_next_minibatch`` / ``fill_indices`` and
``analyze_dataset``.

Serving is host control flow: the minibatch *fill* of a resident
dataset runs on the device in
:class:`veles_tpu_torch.loader.fullbatch.FullBatchLoader`.  A loader
that heads a stitched segment serves through :meth:`stitch_prelude`
(the bookkeeping without the fill; the segment gathers the batch), and
an epoch-scan window (:mod:`veles_tpu_torch.epoch_scan`) serves its K
steps through :meth:`scan_window_step`, the same bookkeeping once a
step.

A loader whose minibatch is filled on the host (``fill_minibatch``
writes ``minibatch_data.mem`` and ``raw_minibatch_labels``; the serve
then normalizes, maps the labels and pads a short batch) may set
``prefetch=True`` when it provides the pure ``fill_minibatch_into``
(``supports_prefetch``): after each serve a background worker
(:mod:`veles_tpu_torch.thread_pool`) fills and prepares the predicted
next minibatch in a :class:`veles_tpu_torch.memory.StagingRing` slot
and uploads it on a side stream, and the next serve publishes it when
its ``(offset, size)`` matches.

The retry queue: ``failed_minibatches`` are served before the offset
advances, each in its own class and with the epoch flags down.  The
minibatch served last stays pending until the next serve; a
``checkpoint_state()`` (``Workflow.capture_train_state``) folds it into
the retry queue with the failed ones, so a restored run serves it again,
as the JAX package's does.

The dataset options of the JAX loader: ``validation_ratio`` carves a
random part of an all-TRAIN dataset into a validation set at
initialize (one ``loader``-stream permutation of the TRAIN span, then
its leading block); ``train_ratio`` (the keyword, else
``root.common.ensemble.train_ratio``) serves only that share of the
TRAIN span each epoch (the effective class end offsets); ``testing``
serves the dataset unshuffled from its start, the TEST pass ending the
epoch.  They act on the serving bookkeeping, so every route serves the
JAX package's index sequence: the eager fill, the stitched loader head
and the epoch-scan windows read the same offsets; the fused trainer's
epoch mode refuses a ``train_ratio`` as the JAX one does.

The job contract (:mod:`veles_tpu_torch.parallel.jobs`): a master serves
each slave's minibatch (``generate_data_for_slave``: its indices, class,
size, offset and epoch) without filling anything, keeps it pending under
the slave's id until its update comes (``apply_data_from_slave``), and
requeues a dead slave's pending minibatches into the retry queue
(``drop_slave``).  A slave installs a job's span of indices into its
shuffled index space and serves exactly that minibatch
(``apply_data_from_master``); ``prefetch_job_data`` fills the next
job's minibatch in the background while the current one computes (a
host-fill loader with ``prefetch``).
"""

import collections
import threading

import numpy

from veles_tpu_torch import prng, trace
from veles_tpu_torch.config import root
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.normalization import normalizer_factory
from veles_tpu_torch.units import Unit

TRAIN = 2
VALID = 1
TEST = 0
CLASS_NAME = ["test", "validation", "train"]

INDEX_DTYPE = numpy.int32
LABEL_DTYPE = numpy.int32

class LoaderError(Exception):
    pass


class Loader(Unit):
    """Base loader.  Subclasses implement ``load_data`` (fill
    ``class_lengths``), ``create_minibatch_data`` (allocate
    ``minibatch_data``) and ``fill_minibatch`` (fill data and labels for
    ``minibatch_indices``)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]
        self._effective_class_end_offsets = [0, 0, 0]
        self.max_minibatch_size = kwargs.get("minibatch_size", 100)
        self.minibatch_class = TRAIN
        self.minibatch_offset = 0
        self.minibatch_size = 0
        self.minibatch_data = Vector(category="staging")
        self.minibatch_labels = Vector(category="staging")
        self.minibatch_indices = Vector(category="staging")
        self.raw_minibatch_labels = []
        self.labels_mapping = {}
        #: the shuffled index space: the eager fill uploads each
        #: minibatch's slice (``minibatch_indices``); a stitched loader
        #: head reads it on the device, uploaded once per shuffle
        self.shuffled_indices = Vector(category="dataset")
        self.shuffle_limit = kwargs.get("shuffle_limit", 2 ** 31)
        # the share of the TRAIN span served an epoch: the keyword, else
        # the ensemble's ratio from the config
        if "train_ratio" in kwargs:
            self.train_ratio = kwargs["train_ratio"]
        else:
            self.train_ratio = float(
                root.common.ensemble.get("train_ratio", 1.0) or 1.0)
        # a (0, 1) ratio carves a validation set out of an all-TRAIN
        # dataset at initialize; checked here, before any data loads
        ratio = kwargs.get("validation_ratio", None)
        if ratio is not None:
            try:
                ratio = float(ratio)
            except (TypeError, ValueError):
                raise LoaderError(
                    "validation_ratio must be a number in (0, 1), "
                    "got %r" % (kwargs["validation_ratio"],))
            if not 0.0 < ratio < 1.0:
                raise LoaderError(
                    "validation_ratio must be in (0, 1), got %r"
                    % ratio)
        self.validation_ratio = ratio
        self.testing = kwargs.get("testing", False)
        self.global_offset = 0
        self.samples_served = 0
        self.epoch_number = 0
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        self.train_ended = Bool(False)
        self.test_ended = Bool(False)
        #: (offset, size) of minibatches to serve again, before the
        #: offset advances
        self.failed_minibatches = []
        self._normalization_type = kwargs.get("normalization_type", "none")
        self._normalization_parameters = kwargs.get(
            "normalization_parameters", {})
        self._prng_name = kwargs.get("prng_name", "loader")
        #: fill the next minibatch in the background (needs a subclass
        #: providing ``fill_minibatch_into``)
        self.prefetch = kwargs.get("prefetch", False)
        #: the attached device (set at initialize)
        self.device = None
        super(Loader, self).__init__(workflow, **kwargs)
        self._normalizer = None

    def init_unpickled(self):
        super(Loader, self).init_unpickled()
        #: the minibatches served and not yet done, by consumer (None:
        #: this process)
        self.pending_minibatches_ = collections.defaultdict(list)
        #: pending background fills: {(offset, size): Future}
        self._prefetch_futures_ = {}
        #: serializes fill_minibatch against a background
        #: fill_minibatch_into (subclasses may share file handles)
        self._fill_lock_ = threading.Lock()
        #: the prefetch ring's (data, labels) staging, made at first use
        self._staging_ring_ = None

    # -- configuration ------------------------------------------------------
    @property
    def prng(self):
        return prng.get(self._prng_name)

    @property
    def normalizer(self):
        if self._normalizer is None:
            self._normalizer = normalizer_factory(
                self._normalization_type, **self._normalization_parameters)
        return self._normalizer

    @property
    def has_labels(self):
        """Subclasses set ``_has_labels = True`` in ``load_data()`` when
        the dataset is labeled."""
        return getattr(self, "_has_labels", False) \
            or bool(self.labels_mapping)

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    @property
    def effective_total_samples(self):
        """The end of an epoch's serving: the TRAIN span cut to
        ``train_ratio``."""
        return self._effective_class_end_offsets[TRAIN]

    @property
    def effective_class_end_offsets(self):
        return self._effective_class_end_offsets

    @property
    def pending_minibatches_count(self):
        return sum(len(v) for v in self.pending_minibatches_.values())

    @property
    def class_ended(self):
        for offset in self.effective_class_end_offsets:
            if self.global_offset == offset:
                return True
            if self.global_offset < offset:
                return False
        raise LoaderError(
            "global_offset %d out of bounds %s" %
            (self.global_offset, self.effective_class_end_offsets))

    # -- the loader contract ------------------------------------------------
    def load_data(self):
        raise NotImplementedError

    def create_minibatch_data(self):
        raise NotImplementedError

    def fill_minibatch(self):
        """Fill ``minibatch_data`` (and the raw labels) for the
        ``minibatch_indices`` just served; the serve then normalizes,
        maps the labels and pads a short batch (a loader with a
        device-resident dataset overrides those three as no-ops)."""
        raise NotImplementedError

    #: True when the subclass provides a pure, thread-safe
    #: ``fill_minibatch_into``: enables :attr:`prefetch`
    supports_prefetch = False

    def fill_minibatch_into(self, indices, data_out, raw_labels_out):
        """Pure fill: write the samples of ``indices`` into the given
        numpy buffers without touching ``self.minibatch_*``; called from
        a background thread while the previous minibatch is consumed."""
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, **kwargs):
        super(Loader, self).initialize(**kwargs)
        device = kwargs.get("device")
        if device is None:
            device = getattr(self.workflow, "device", None)
        if device is not None:
            self.device = device
        # a re-initialize reshuffles: a fill buffered for the old order
        # must not be served under a matching (offset, size)
        self._prefetch_futures_.clear()
        self._staging_ring_ = None
        if self.testing:
            self.shuffle_limit = 0
            self.global_offset = 0
            del self.failed_minibatches[:]
        self.load_data()
        if self.total_samples == 0:
            raise LoaderError("there is no data to serve")
        if self.validation_ratio is not None and \
                self.class_lengths[VALID] == 0 and \
                self.class_lengths[TRAIN] > 0:
            # a random part of the TRAIN span becomes validation: one
            # permutation of the span, then its leading block (a
            # label-sorted dataset would otherwise send whole classes)
            k = int(self.class_lengths[TRAIN] * self.validation_ratio)
            if k > 0:
                start = self.class_lengths[TEST] + self.class_lengths[VALID]
                idx = numpy.arange(self.total_samples, dtype=INDEX_DTYPE)
                self.prng.shuffle(idx[start:])
                self.shuffled_indices.mem = idx
                self.class_lengths[VALID] = k
                self.class_lengths[TRAIN] -= k
                self.info("extracted %d random validation samples from "
                          "train (validation_ratio %.3f)", k,
                          self.validation_ratio)
        self._calc_class_end_offsets()
        self.info("samples: test: %d, validation: %d, train: %d",
                  *self.class_lengths)
        self.minibatch_labels.reset(numpy.zeros(
            self.max_minibatch_size, dtype=LABEL_DTYPE))
        self.raw_minibatch_labels = [None] * self.max_minibatch_size
        self.minibatch_indices.reset(numpy.zeros(
            self.max_minibatch_size, dtype=INDEX_DTYPE))
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise LoaderError("minibatch_data MUST be allocated in "
                              "create_minibatch_data()")
        self.analyze_dataset()
        self.shuffle()

    def run(self):
        """Serve one minibatch, then start the next one's prefetch."""
        self.pending_minibatches_.pop(None, None)
        self.serve_next_minibatch()
        self.samples_served += self.minibatch_size
        self._start_prefetch()

    def stitch_prelude(self):
        """The host half of a loader-headed segment's dispatch: advance
        the serving state (offset, class, epoch flags, the shuffle at an
        epoch's start) without filling a minibatch buffer; the segment
        gathers the batch on the device."""
        self.pending_minibatches_.pop(None, None)
        self.serve_next_minibatch(fill=False)
        self.samples_served += self.minibatch_size

    def scan_window_step(self):
        """One serving step of an epoch-scan window
        (:mod:`veles_tpu_torch.epoch_scan`): the bookkeeping of
        :meth:`stitch_prelude`, called once a step while the window is
        served; the served ``(offset, size)`` becomes that step's row
        of the window's stacked scalars."""
        self.stitch_prelude()

    # -- serving ------------------------------------------------------------
    def shuffle(self):
        """Shuffle the TRAIN span of the index space."""
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=INDEX_DTYPE)
        if self.shuffle_limit <= 0 or self.class_lengths[TRAIN] == 0:
            return
        self.shuffle_limit -= 1
        self.shuffled_indices.map_write()
        self.prng.shuffle(
            self.shuffled_indices.mem[self.class_end_offsets[VALID]:])

    def class_index_by_sample_index(self, index):
        for class_index, offset in enumerate(
                self.effective_class_end_offsets):
            if index < offset:
                return class_index, offset - index
        raise LoaderError("sample index %d out of range" % index)

    def serve_next_minibatch(self, fill=True, consumer_id=None):
        """Take the next (offset, size), a failed one first, update the
        epoch flags and fill the minibatch (``fill=False``: leave the
        fill to a stitched segment).  The minibatch stays pending under
        ``consumer_id`` (a slave's id on a master, which fills
        nothing)."""
        with trace.span("loader", "serve_minibatch"):
            retried = bool(self.failed_minibatches)
            if retried:
                minibatch_def = self.failed_minibatches.pop()
            else:
                minibatch_def = self._advance_global_offset()
            minibatch_offset, minibatch_size = minibatch_def
            self.pending_minibatches_[consumer_id].append(minibatch_def)
            self.minibatch_offset = minibatch_offset
            self.minibatch_size = minibatch_size
            if retried:
                # a retried minibatch keeps its own class; its epoch
                # flags were raised when it was first served
                self.minibatch_class, _ = self.class_index_by_sample_index(
                    minibatch_offset - minibatch_size)
                self.last_minibatch <<= False
                self.epoch_ended <<= False
            else:
                self._update_flags()
            self.fill_indices(minibatch_offset - minibatch_size,
                              minibatch_size)
            if self.is_master or not fill:
                return
            if self._consume_prefetched((minibatch_offset,
                                         minibatch_size)):
                return      # prepared: normalized, mapped and padded
            with trace.span("loader", "sync_fill"):
                with self._fill_lock_:
                    self.fill_minibatch()
                self.normalize_minibatch()
                self.map_minibatch_labels()
                if minibatch_size < self.max_minibatch_size:
                    self.pad_minibatch(minibatch_size)

    def pad_minibatch(self, minibatch_size):
        """Zero the data and -1 the labels past a short batch's end."""
        self.minibatch_data.map_write()
        self.minibatch_data.mem[minibatch_size:] = 0
        if self.has_labels:
            self.minibatch_labels.map_write()
            self.minibatch_labels.mem[minibatch_size:] = -1

    def normalize_minibatch(self):
        self.minibatch_data.map_write()
        self.normalizer.normalize(
            self.minibatch_data.mem[:self.minibatch_size])

    def map_minibatch_labels(self):
        if not self.has_labels:
            return
        self.minibatch_labels.map_write()
        self._map_labels_into(self.minibatch_labels.mem,
                              self.raw_minibatch_labels,
                              self.minibatch_size)

    def _map_labels_into(self, labels_out, raw_labels, count):
        """Raw → mapped labels of the first ``count`` slots: the one
        mapping of the synchronous serve and the prefetch ring."""
        for i, raw in enumerate(raw_labels[:count]):
            labels_out[i] = self.labels_mapping.get(raw, -1) \
                if self.labels_mapping else raw

    def fill_indices(self, start_offset, count):
        """Copy the served span of shuffled indices into
        ``minibatch_indices``; a short batch gets a ``-1`` tail."""
        self.minibatch_indices.map_write()
        self.minibatch_indices.mem[:count] = \
            self.shuffled_indices.mem[start_offset:start_offset + count]
        if count < self.max_minibatch_size:
            self.minibatch_indices.mem[count:] = -1

    def _calc_class_end_offsets(self):
        total = 0
        for i, n in enumerate(self.class_lengths):
            if not isinstance(n, (int, numpy.integer)):
                raise TypeError("class_lengths must be integers")
            total += n
            self.class_end_offsets[i] = total
        self._effective_class_end_offsets = list(self.class_end_offsets)
        self._effective_class_end_offsets[TRAIN] -= int(
            (1.0 - self.train_ratio) * self.class_lengths[TRAIN])

    def _advance_global_offset(self):
        if self.is_slave:
            # the job's minibatch, installed by apply_data_from_master
            return self.minibatch_offset, self.minibatch_size
        if self.global_offset >= self.effective_total_samples:
            self.global_offset = 0
            self.epoch_number += 1
            self.shuffle()
        self.minibatch_class, remainder = self.class_index_by_sample_index(
            self.global_offset)
        minibatch_size = min(remainder, self.max_minibatch_size)
        self.global_offset += minibatch_size
        self.train_ended <<= \
            self.global_offset >= self.effective_total_samples
        self.test_ended <<= \
            self.global_offset >= self.class_end_offsets[TEST]
        return self.global_offset, minibatch_size

    def _update_flags(self):
        if self.is_slave:
            return
        last_mb = (self.class_ended
                   and (not self.pending_minibatches_count
                        or not self.is_master)
                   and not self.failed_minibatches)
        self.last_minibatch <<= last_mb
        self.epoch_ended <<= last_mb and (
            self.minibatch_class == VALID or
            (self.minibatch_class == TEST and
             self.class_lengths[TRAIN] == self.class_lengths[VALID] == 0) or
            (self.minibatch_class == TEST and self.testing) or
            (self.minibatch_class == TRAIN and
             self.class_lengths[VALID] == 0))

    # -- prefetch (the next minibatch filled in the background) -------------
    def _peek_next_minibatch(self):
        """The ``(offset, size)`` the next serve will pick, or None when
        a retried minibatch or an epoch wrap (a reshuffle) comes first,
        or in master/slave mode (a slave's prefetch follows its jobs)."""
        if (self.is_slave or self.is_master or self.failed_minibatches
                or self.global_offset >= self.effective_total_samples):
            return None
        _cls, remainder = self.class_index_by_sample_index(
            self.global_offset)
        size = min(remainder, self.max_minibatch_size)
        return self.global_offset + size, size

    def _staging(self):
        """The ``(data, labels)`` staging rings, made once: depth 3, for
        at most two fills in flight and the slot the consumer may still
        publish from."""
        if self._staging_ring_ is None:
            from veles_tpu_torch.memory import StagingRing
            target = getattr(self.device, "torch_device", None)
            pin = target is not None and target.type == "cuda"
            self._staging_ring_ = (
                StagingRing(self.minibatch_data.shape,
                            self.minibatch_data.dtype, depth=3, pin=pin),
                StagingRing((self.max_minibatch_size,), LABEL_DTYPE,
                            depth=3, pin=pin))
        return self._staging_ring_

    def _prepare_staged(self, data_out, labels_out, raw_labels, size):
        """The worker's share of a serve: the normalize, label map and
        pad of the synchronous path."""
        self.normalizer.normalize(data_out[:size])
        if size < self.max_minibatch_size:
            data_out[size:] = 0
        labels_out[:] = -1
        if self.has_labels:
            self._map_labels_into(labels_out, raw_labels, size)

    def _submit_fill(self, key, indices, size):
        """Queue a background fill of ``indices`` into a ring slot under
        ``key``, the ``(offset, size)`` the matching serve presents: the
        whole preparation, then the uploads."""
        data_ring, labels_ring = self._staging()
        data_out = data_ring.acquire()
        labels_out = labels_ring.acquire()
        raw_labels = [None] * self.max_minibatch_size
        device = self.device

        def work():
            # under the fill lock: it serializes shared file handles and
            # a dropped worker's slot against a newer fill of it
            with trace.span("loader", "prefetch_fill"):
                with self._fill_lock_:
                    self.fill_minibatch_into(indices, data_out[:size],
                                             raw_labels)
                    self._prepare_staged(data_out, labels_out,
                                         raw_labels, size)
                    dev_data = data_ring.upload(device, data_out)
                    dev_labels = labels_ring.upload(device, labels_out) \
                        if self.has_labels else None
            return data_out, labels_out, raw_labels, dev_data, dev_labels

        from veles_tpu_torch import thread_pool
        self._prefetch_futures_[key] = thread_pool.submit(work)

    def _start_prefetch(self):
        """Start a background fill of the predicted next minibatch."""
        if not (self.prefetch and self.supports_prefetch):
            return
        if self.is_slave or self.is_master:
            # a slave's prefetch is prefetch_job_data's (the next job)
            return
        nxt = self._peek_next_minibatch()
        if nxt is None:
            # an epoch wrap reshuffles: whatever is buffered may be
            # wrong for a later serve at the same offset
            self._prefetch_futures_.clear()
            return
        offset, size = nxt
        indices = numpy.array(
            self.shuffled_indices.mem[offset - size:offset])
        self._submit_fill(nxt, indices, size)

    def prefetch_job_data(self, data):
        """Slave: start filling the NEXT job's minibatch (its payload's
        indices) in the background while the current job computes, so
        that its serve publishes it ready."""
        if not (self.prefetch and self.supports_prefetch):
            return
        key = (int(data["minibatch_offset"]), int(data["minibatch_size"]))
        # at most two in flight (the job pipeline is two deep); the same
        # key keeps the older fill, which the serve meets first
        if len(self._prefetch_futures_) >= 2 \
                or key in self._prefetch_futures_:
            return
        self._submit_fill(key, numpy.array(data["indices"]), key[1])

    def _consume_prefetched(self, minibatch_def):
        """Publish the prepared minibatch when a background fill
        matches ``minibatch_def``; False sends the caller to the
        synchronous fill.  A worker's exception surfaces here, is
        logged, and the serve fills synchronously."""
        key = (int(minibatch_def[0]), int(minibatch_def[1]))
        fut = self._prefetch_futures_.pop(key, None)
        if fut is None:
            if not self.is_slave:
                # stale predictions; a slave's may be the next job's
                self._prefetch_futures_.clear()
            return False
        try:
            data, labels, raw_labels, dev_data, dev_labels = fut.result()
        except Exception:
            self.exception("prefetch failed - refilling synchronously")
            return False
        with trace.span("loader", "publish"):
            self.minibatch_data.publish(
                data, dev_data.take() if dev_data is not None else None)
            self.raw_minibatch_labels[:] = raw_labels
            if self.has_labels:
                self.minibatch_labels.publish(
                    labels, dev_labels.take()
                    if dev_labels is not None else None)
        return True

    # -- normalization analysis --------------------------------------------
    def analyze_dataset(self):
        """Stream the TRAIN set through the normalizer once, collecting
        the label mapping from the raw labels (a resident dataset
        analyzes itself directly)."""
        if self.class_lengths[TRAIN] == 0:
            if not self.normalizer.is_initialized:
                raise LoaderError(
                    "no train samples and the normalizer is "
                    "uninitialized; set normalizer.state")
            return
        labels_seen = {}

        def callback():
            if self.has_labels and not self.labels_mapping:
                for raw in self.raw_minibatch_labels[:self.minibatch_size]:
                    if raw is not None and raw not in labels_seen:
                        labels_seen[raw] = len(labels_seen)
            self.normalizer.analyze(
                self.minibatch_data.mem[:self.minibatch_size])

        self._iterate_class(TRAIN, callback)
        if self.has_labels and not self.labels_mapping and labels_seen:
            try:
                ordered = sorted(labels_seen)
            except TypeError:
                ordered = list(labels_seen)
            self.labels_mapping = {raw: i for i, raw in enumerate(ordered)}

    def _iterate_class(self, class_index, fn):
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=INDEX_DTYPE)
        length = self.class_lengths[class_index]
        start = self.class_end_offsets[class_index - 1] \
            if class_index > 0 else 0
        for offset in range(0, length, self.max_minibatch_size):
            self.minibatch_size = min(self.max_minibatch_size,
                                      length - offset)
            self.minibatch_indices.map_write()
            self.minibatch_indices.mem[:self.minibatch_size] = \
                self.shuffled_indices.mem[
                    start + offset:start + offset + self.minibatch_size]
            self.fill_minibatch()
            fn()

    # -- the job contract -----------------------------------------------------
    def generate_data_for_master(self):
        return True

    def generate_data_for_slave(self, slave=None):
        """Master: serve the slave's minibatch (kept pending under its
        id) and describe it."""
        sid = getattr(slave, "id", slave)
        self.serve_next_minibatch(consumer_id=sid)
        data = {"indices": numpy.array(
            self.minibatch_indices.mem[:self.minibatch_size])}
        for attr in ("minibatch_class", "minibatch_size",
                     "minibatch_offset", "epoch_number"):
            data[attr] = int(getattr(self, attr))
        return data

    def _install_job(self, data):
        """The job's serving state: its class, size, offset and epoch,
        the epoch flags down."""
        for attr in ("minibatch_class", "minibatch_size",
                     "minibatch_offset", "epoch_number"):
            setattr(self, attr, int(data[attr]))
        self.last_minibatch <<= False
        self.epoch_ended <<= False
        self.train_ended <<= False
        if numpy.asarray(data["indices"]).size != self.minibatch_size:
            raise LoaderError("minibatch size mismatch in job payload")

    def apply_data_from_master(self, data):
        """Slave: the job's span of indices into the shuffled index
        space, where the serve takes it."""
        self._install_job(data)
        if not self.shuffled_indices:
            self.shuffled_indices.mem = numpy.arange(
                self.total_samples, dtype=INDEX_DTYPE)
        self.shuffled_indices.map_write()
        self.shuffled_indices.mem[
            self.minibatch_offset - self.minibatch_size:
            self.minibatch_offset] = data["indices"]

    def apply_data_from_slave(self, data, slave=None):
        """Master: the slave's oldest pending minibatch is done."""
        sid = getattr(slave, "id", slave)
        if not self.pending_minibatches_.get(sid):
            raise LoaderError("no pending minibatches for slave %r" % sid)
        self.minibatch_offset, self.minibatch_size = \
            self.pending_minibatches_[sid].pop()
        self.samples_served += self.minibatch_size

    def drop_slave(self, slave=None):
        """Master: requeue a gone slave's pending minibatches."""
        sid = getattr(slave, "id", slave)
        if sid in self.pending_minibatches_:
            failed = self.pending_minibatches_.pop(sid)
            self.failed_minibatches.extend(failed)
            self.info("requeued %d failed minibatches", len(failed))

    # -- the train-state checkpoint ------------------------------------------
    def checkpoint_state(self):
        """The serving cursor: the epoch, the offset, the shuffled index
        space and the retry queue, with the pending minibatches (the one
        served last) folded in, so a restored run serves them again."""
        state = {
            "epoch_number": int(self.epoch_number),
            "global_offset": int(self.global_offset),
            "minibatch_class": int(self.minibatch_class or 0),
            "samples_served": int(self.samples_served),
            "failed": [(int(o), int(s))
                       for o, s in self.failed_minibatches],
            "pending": [(int(o), int(s))
                        for defs in self.pending_minibatches_.values()
                        for o, s in defs],
        }
        if self.shuffled_indices:
            state["shuffled_indices"] = numpy.array(
                self.shuffled_indices.mem)
        return state

    def restore_checkpoint_state(self, state):
        self.epoch_number = int(state.get("epoch_number", 0))
        self.global_offset = int(state.get("global_offset", 0))
        self.minibatch_class = int(state.get("minibatch_class", 0))
        self.samples_served = int(state.get("samples_served", 0))
        if state.get("shuffled_indices") is not None:
            # a copy: the next epoch reshuffles it in place
            self.shuffled_indices.reset(numpy.array(
                state["shuffled_indices"], dtype=INDEX_DTYPE))
        requeue = [(int(o), int(s))
                   for o, s in (state.get("failed") or ())]
        requeue += [(int(o), int(s))
                    for o, s in (state.get("pending") or ())]
        self.failed_minibatches = requeue
        self.pending_minibatches_.clear()
        # the epoch flags are computed again at the next serve
        self.last_minibatch <<= False
        self.epoch_ended <<= False
        # a fill buffered for the old cursor must not be published
        self._prefetch_futures_.clear()
        if requeue:
            self.info("resume requeued %d in-flight/failed "
                      "minibatch(es) from the checkpoint", len(requeue))

    # -- results ------------------------------------------------------------
    def get_metric_values(self):
        return {"Total epochs": self.epoch_number}
