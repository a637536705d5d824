"""Minibatch capture and replay: the port's counterpart of
:mod:`veles_tpu.loader.saver`.

``MinibatchesSaver`` dumps every served minibatch (data, labels, class)
into one gzip stream, a pickled header then one pickled record a
minibatch (the JAX package's layout, so a dump written by either
package replays in the other); ``MinibatchesLoader`` replays such a
file as a dataset, each record in its recorded class and order.  The
minibatch is read from the host copy of the served Vectors (a device
copy is fetched first).
"""


import gzip
import pickle

import numpy

from veles_tpu_torch.loader.base import Loader, LoaderError
from veles_tpu_torch.units import Unit


class MinibatchesSaver(Unit):
    """Link after a loader: records every served minibatch."""

    def __init__(self, workflow, **kwargs):
        super(MinibatchesSaver, self).__init__(workflow, **kwargs)
        self.file_name = kwargs.get("file_name", "minibatches.dump.gz")
        self.compression_level = kwargs.get("compression_level", 6)
        self.minibatch_data = None      # linked
        self.minibatch_labels = None    # linked
        self.minibatch_class = 0        # linked
        self.minibatch_size = 0         # linked
        self.demand("minibatch_data", "minibatch_size")

    def init_unpickled(self):
        super(MinibatchesSaver, self).init_unpickled()
        self._file_ = None
        self._count_ = 0

    def initialize(self, **kwargs):
        super(MinibatchesSaver, self).initialize(**kwargs)
        if self._file_ is None:
            self._file_ = gzip.open(
                self.file_name, "wb",
                compresslevel=self.compression_level)
            pickle.dump({"version": 1}, self._file_,
                        pickle.HIGHEST_PROTOCOL)

    def run(self):
        self.minibatch_data.map_read()
        record = {
            "data": numpy.array(
                self.minibatch_data.mem[:self.minibatch_size]),
            "class": int(self.minibatch_class),
        }
        if self.minibatch_labels is not None and self.minibatch_labels:
            self.minibatch_labels.map_read()
            record["labels"] = numpy.array(
                self.minibatch_labels.mem[:self.minibatch_size])
        pickle.dump(record, self._file_, pickle.HIGHEST_PROTOCOL)
        self._count_ += 1

    def stop(self):
        if self._file_ is not None:
            self._file_.close()
            self._file_ = None
            self.info("saved %d minibatches to %s",
                      self._count_, self.file_name)


def read_minibatch_dump(file_name):
    """Yield the records of a MinibatchesSaver dump."""
    with gzip.open(file_name, "rb") as fin:
        pickle.load(fin)  # header
        while True:
            try:
                yield pickle.load(fin)
            except EOFError:
                return


class MinibatchesLoader(Loader):
    """Replays a :class:`MinibatchesSaver` dump as a dataset
    (records keep their recorded class)."""

    def __init__(self, workflow, **kwargs):
        self.file_name = kwargs.get("file_name", "minibatches.dump.gz")
        super(MinibatchesLoader, self).__init__(workflow, **kwargs)

    def load_data(self):
        self._records = list(read_minibatch_dump(self.file_name))
        if not self._records:
            raise LoaderError("empty minibatch dump %s" % self.file_name)
        lengths = [0, 0, 0]
        self._has_labels = any("labels" in r for r in self._records)
        for record in self._records:
            lengths[record["class"]] += len(record["data"])
        self.class_lengths[:] = lengths
        # replay preserves recorded order: no reshuffling
        self.shuffle_limit = 0
        # group records per class in recorded order
        self._by_class = [[r for r in self._records if r["class"] == c]
                          for c in range(3)]
        self._cursors = [0, 0, 0]
        shapes = {r["data"].shape[1:] for r in self._records}
        if len(shapes) != 1:
            raise LoaderError("inconsistent sample shapes in dump")
        self._sample_shape = shapes.pop()
        self.max_minibatch_size = max(
            len(r["data"]) for r in self._records)

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self._sample_shape,
            dtype=numpy.float32))

    def analyze_dataset(self):
        """Dumped minibatches were already normalized upstream."""

    def fill_minibatch(self):
        records = self._by_class[self.minibatch_class]
        cursor = self._cursors[self.minibatch_class] % len(records)
        self._cursors[self.minibatch_class] += 1
        record = records[cursor]
        count = len(record["data"])
        self.minibatch_size = count
        self.minibatch_data.map_write()
        self.minibatch_data.mem[:count] = record["data"]
        self.minibatch_data.mem[count:] = 0
        self.minibatch_labels.map_write()
        if "labels" in record:
            self.minibatch_labels.mem[:count] = record["labels"]
            self.raw_minibatch_labels[:count] = list(record["labels"])
        self.minibatch_labels.mem[count:] = -1

    def normalize_minibatch(self):
        """No-op: see analyze_dataset."""

    def map_minibatch_labels(self):
        """No-op: dumped labels are already mapped."""
