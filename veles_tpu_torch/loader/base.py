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
(the bookkeeping without the fill; the segment gathers the batch).  Not
ported: the prefetch staging ring (ROADMAP item 1c), the master/slave
job methods, the retry queue, ``validation_ratio`` and checkpointing
(item 7).
"""

import numpy

from veles_tpu_torch import prng, trace
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

#: loader options of the JAX package this slice does not port, with the
#: ROADMAP item that will
_NOT_PORTED = {"prefetch": "1c", "validation_ratio": "7", "testing": "7",
               "train_ratio": "7"}


class LoaderError(Exception):
    pass


class Loader(Unit):
    """Base loader.  Subclasses implement ``load_data`` (fill
    ``class_lengths``), ``create_minibatch_data`` (allocate
    ``minibatch_data``) and ``fill_minibatch`` (fill data and labels for
    ``minibatch_indices``)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        for key, item in _NOT_PORTED.items():
            if kwargs.get(key):
                raise NotImplementedError(
                    "Loader option %r is not ported yet (ROADMAP item %s)"
                    % (key, item))
        self.class_lengths = [0, 0, 0]
        self.class_end_offsets = [0, 0, 0]
        self.max_minibatch_size = kwargs.get("minibatch_size", 100)
        self.minibatch_class = TRAIN
        self.minibatch_offset = 0
        self.minibatch_size = 0
        self.minibatch_data = Vector(category="staging")
        self.minibatch_labels = Vector(category="staging")
        self.minibatch_indices = Vector(category="staging")
        self.labels_mapping = {}
        #: the shuffled index space: the eager fill uploads each
        #: minibatch's slice (``minibatch_indices``); a stitched loader
        #: head reads it on the device, uploaded once per shuffle
        self.shuffled_indices = Vector(category="dataset")
        self.shuffle_limit = kwargs.get("shuffle_limit", 2 ** 31)
        self.global_offset = 0
        self.samples_served = 0
        self.epoch_number = 0
        self.last_minibatch = Bool(False)
        self.epoch_ended = Bool(False)
        self._normalization_type = kwargs.get("normalization_type", "none")
        self._normalization_parameters = kwargs.get(
            "normalization_parameters", {})
        self._prng_name = kwargs.get("prng_name", "loader")
        #: the attached device (set at initialize)
        self.device = None
        super(Loader, self).__init__(workflow, **kwargs)
        self._normalizer = None

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
        return bool(self.labels_mapping)

    @property
    def total_samples(self):
        return sum(self.class_lengths)

    @property
    def class_ended(self):
        for offset in self.class_end_offsets:
            if self.global_offset == offset:
                return True
            if self.global_offset < offset:
                return False
        raise LoaderError(
            "global_offset %d out of bounds %s" %
            (self.global_offset, self.class_end_offsets))

    # -- the loader contract ------------------------------------------------
    def load_data(self):
        raise NotImplementedError

    def create_minibatch_data(self):
        raise NotImplementedError

    def fill_minibatch(self):
        """Fill ``minibatch_data`` and ``minibatch_labels`` for the
        ``minibatch_indices`` just served (``-1``: an empty slot of a
        short batch) — normalized, labels mapped, tail padded."""
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, **kwargs):
        super(Loader, self).initialize(**kwargs)
        device = kwargs.get("device")
        if device is None:
            device = getattr(self.workflow, "device", None)
        if device is not None:
            self.device = device
        self.load_data()
        if self.total_samples == 0:
            raise LoaderError("there is no data to serve")
        self._calc_class_end_offsets()
        self.info("samples: test: %d, validation: %d, train: %d",
                  *self.class_lengths)
        self.minibatch_labels.reset(numpy.zeros(
            self.max_minibatch_size, dtype=LABEL_DTYPE))
        self.minibatch_indices.reset(numpy.zeros(
            self.max_minibatch_size, dtype=INDEX_DTYPE))
        self.create_minibatch_data()
        if not self.minibatch_data:
            raise LoaderError("minibatch_data MUST be allocated in "
                              "create_minibatch_data()")
        self.analyze_dataset()
        self.shuffle()

    def run(self):
        """Serve one minibatch."""
        self.serve_next_minibatch()
        self.samples_served += self.minibatch_size

    def stitch_prelude(self):
        """The host half of a loader-headed segment's dispatch: advance
        the serving state (offset, class, epoch flags, the shuffle at an
        epoch's start) without filling a minibatch buffer; the segment
        gathers the batch on the device."""
        self.serve_next_minibatch(fill=False)
        self.samples_served += self.minibatch_size

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
        for class_index, offset in enumerate(self.class_end_offsets):
            if index < offset:
                return class_index, offset - index
        raise LoaderError("sample index %d out of range" % index)

    def serve_next_minibatch(self, fill=True):
        """Advance to the next (offset, size), update the epoch flags and
        fill the minibatch (``fill=False``: leave the fill to a
        stitched segment)."""
        with trace.span("loader", "serve_minibatch"):
            minibatch_offset, minibatch_size = \
                self._advance_global_offset()
            self.minibatch_offset = minibatch_offset
            self.minibatch_size = minibatch_size
            self._update_flags()
            self.fill_indices(minibatch_offset - minibatch_size,
                              minibatch_size)
            if fill:
                self.fill_minibatch()

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

    def _advance_global_offset(self):
        if self.global_offset >= self.total_samples:
            self.global_offset = 0
            self.epoch_number += 1
            self.shuffle()
        self.minibatch_class, remainder = self.class_index_by_sample_index(
            self.global_offset)
        minibatch_size = min(remainder, self.max_minibatch_size)
        self.global_offset += minibatch_size
        return self.global_offset, minibatch_size

    def _update_flags(self):
        last_mb = self.class_ended
        self.last_minibatch <<= last_mb
        self.epoch_ended <<= last_mb and (
            self.minibatch_class == VALID or
            (self.minibatch_class == TEST and
             self.class_lengths[TRAIN] == self.class_lengths[VALID] == 0) or
            (self.minibatch_class == TRAIN and
             self.class_lengths[VALID] == 0))

    # -- normalization analysis --------------------------------------------
    def analyze_dataset(self):
        """Stream the TRAIN set through the normalizer once (subclasses
        with a resident dataset analyze it directly)."""
        raise NotImplementedError

    # -- results ------------------------------------------------------------
    def get_metric_values(self):
        return {"Total epochs": self.epoch_number}
