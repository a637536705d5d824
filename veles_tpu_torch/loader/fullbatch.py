"""FullBatchLoader: the whole dataset resident on the device.

The port's counterpart of :mod:`veles_tpu.loader.fullbatch`.  The
dataset (``original_data``) is normalized once on the host and uploaded
once; the labels are mapped once into ``resident_labels`` (int32, ``-1``
for an unlabeled sample) and uploaded with it.  Each minibatch then
moves only its index slice to the device (``minibatch_indices``, 400 B
at minibatch 100), and :func:`take_rows` gathers the data rows and the
labels there, ``-1`` indices giving zero rows and ``-1`` labels.  That
is the counterpart of the JAX package's ``_gather_jnp`` route, the one
its eager chain takes when neither ``pallas_gather`` nor an autotune DB
selects the gather kernel; the gather kernels of
``veles_tpu/ops/gather.py`` and the stitched loader head wait for
ROADMAP item 1b, as do ``native_device_dtype`` and
``FullBatchLoaderMSE``.  The dataset is normalized once, so minibatches need no normalize, label
map or tail pad of their own.
"""

import numpy
import torch

from veles_tpu_torch.loader.base import Loader, LoaderError, TRAIN
from veles_tpu_torch.memory import Vector


def take_rows(data, indices, pad=0):
    """``data[indices]`` along axis 0 with ``pad`` rows where an index
    is negative (the short batch's empty slots)."""
    valid = indices >= 0
    rows = data.index_select(0, indices.clamp(min=0).long())
    mask = valid.reshape((-1,) + (1,) * (rows.dim() - 1))
    return torch.where(mask, rows, torch.full_like(rows, pad))


class FullBatchLoader(Loader):
    """Subclasses implement ``load_data()`` filling ``original_data``,
    ``original_labels`` (list or array) and ``class_lengths``."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        if kwargs.get("native_device_dtype"):
            raise NotImplementedError(
                "native_device_dtype (the u8-resident dataset) is not "
                "ported yet (ROADMAP item 1b)")
        self.original_data = Vector(category="dataset")
        self.original_labels = []
        #: the pre-mapped labels (int32, -1 = unlabeled), device-resident
        self.resident_labels = Vector(category="dataset")
        super(FullBatchLoader, self).__init__(workflow, **kwargs)

    @property
    def has_labels(self):
        return len(self.original_labels) > 0

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.original_data.shape[1:],
            dtype=self.original_data.dtype))

    def initialize(self, device=None, **kwargs):
        super(FullBatchLoader, self).initialize(device=device, **kwargs)
        if len(self.original_data) != self.total_samples:
            raise LoaderError(
                "original_data has %d samples, class_lengths say %d" %
                (len(self.original_data), self.total_samples))
        if self.has_labels and \
                len(self.original_labels) != self.total_samples:
            raise LoaderError("original_labels length mismatch")
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
                   self.minibatch_indices]
        if self.has_labels:
            vectors += [self.resident_labels, self.minibatch_labels]
        for vec in vectors:
            vec.initialize(self.device)
        self.original_data.devmem        # upload once
        if self.has_labels:
            self.resident_labels.devmem

    def analyze_dataset(self):
        """The dataset is resident: analyze the TRAIN span directly."""
        if self.class_lengths[TRAIN] == 0:
            return
        start = self.class_end_offsets[TRAIN - 1]
        self.normalizer.analyze(self.original_data.mem[start:])
        if self.has_labels and not self.labels_mapping:
            uniques = sorted(set(
                raw for raw in self.original_labels if raw is not None))
            self.labels_mapping = {raw: i for i, raw in enumerate(uniques)}

    def fill_minibatch(self):
        """Gather the minibatch rows and labels on the device, where the
        dataset is resident: only the index slice goes up."""
        indices = self.minibatch_indices.devmem
        self.minibatch_data.devmem = take_rows(
            self.original_data.devmem, indices)
        if self.has_labels:
            self.minibatch_labels.devmem = take_rows(
                self.resident_labels.devmem, indices, pad=-1)
