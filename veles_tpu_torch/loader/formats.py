"""Format loaders: the port's counterpart of
:mod:`veles_tpu.loader.formats`: HDF5 (``HDF5Loader``), pickled
per-class blobs (``PicklesLoader``), WAV audio (``WavLoader``), LMDB
(``LMDBLoader``) and line-oriented text over a path or a WebHDFS URL
(``HDFSTextLoader``).

Each lands the dataset in the device-resident
:class:`~veles_tpu_torch.loader.fullbatch.FullBatchLoader` layout, so
the training path is the resident loaders' one.  h5py and lmdb are
imported when a loader of theirs loads, so importing the port needs
neither.
"""


import os
import pickle

import numpy

from veles_tpu_torch.loader.base import LoaderError, TEST, TRAIN, VALID
from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class HDF5Loader(FullBatchLoader):
    """``test_path`` / ``validation_path`` / ``train_path`` point to
    ``.h5`` files each holding ``data`` (N, ...) and optionally
    ``labels`` (N,) datasets (ref ``loader_hdf5.py:48-125``)."""

    def __init__(self, workflow, **kwargs):
        self.test_path = kwargs.get("test_path")
        self.validation_path = kwargs.get("validation_path")
        self.train_path = kwargs.get("train_path")
        self.data_dataset = kwargs.get("data_dataset", "data")
        self.labels_dataset = kwargs.get("labels_dataset", "labels")
        super(HDF5Loader, self).__init__(workflow, **kwargs)

    def load_data(self):
        try:
            import h5py
        except ImportError:
            raise LoaderError("h5py is required for HDF5Loader")
        chunks, labels, lengths = [], [], [0, 0, 0]
        has_labels = False
        for class_index, path in ((TEST, self.test_path),
                                  (VALID, self.validation_path),
                                  (TRAIN, self.train_path)):
            if not path:
                continue
            with h5py.File(path, "r") as fin:
                data = numpy.asarray(fin[self.data_dataset],
                                     dtype=numpy.float32)
                chunks.append(data)
                lengths[class_index] = len(data)
                if self.labels_dataset in fin:
                    labels.extend(numpy.asarray(
                        fin[self.labels_dataset]).tolist())
                    has_labels = True
                else:
                    labels.extend([None] * len(data))
        if not chunks:
            raise LoaderError("no HDF5 paths given")
        self.original_data.mem = numpy.concatenate(chunks, axis=0)
        if has_labels:
            self.original_labels = labels
        self.class_lengths[:] = lengths


class PicklesLoader(FullBatchLoader):
    """Per-class pickle files each holding ``(data, labels)`` or just
    ``data`` (ref ``pickles.py:55``)."""

    def __init__(self, workflow, **kwargs):
        self.test_path = kwargs.get("test_path")
        self.validation_path = kwargs.get("validation_path")
        self.train_path = kwargs.get("train_path")
        super(PicklesLoader, self).__init__(workflow, **kwargs)

    @staticmethod
    def _read(path):
        with open(path, "rb") as fin:
            blob = pickle.load(fin)
        if isinstance(blob, tuple) and len(blob) == 2:
            data, labels = blob
        elif isinstance(blob, dict):
            data, labels = blob["data"], blob.get("labels")
        else:
            data, labels = blob, None
        data = numpy.asarray(data, dtype=numpy.float32)
        return data, (None if labels is None else list(labels))

    def load_data(self):
        chunks, labels, lengths = [], [], [0, 0, 0]
        has_labels = False
        for class_index, path in ((TEST, self.test_path),
                                  (VALID, self.validation_path),
                                  (TRAIN, self.train_path)):
            if not path:
                continue
            data, raw = self._read(path)
            chunks.append(data)
            lengths[class_index] = len(data)
            if raw is not None:
                labels.extend(raw)
                has_labels = True
            else:
                labels.extend([None] * len(data))
        if not chunks:
            raise LoaderError("no pickle paths given")
        self.original_data.mem = numpy.concatenate(chunks, axis=0)
        if has_labels:
            self.original_labels = labels
        self.class_lengths[:] = lengths


class WavLoader(FullBatchLoader):
    """Audio fullbatch loader over stdlib ``wave`` (the libsndfile role:
    reference ``veles/loader/libsndfile{,_loader}.py``).

    kwargs: ``{test,validation,train}_paths`` — lists of .wav files;
    ``window`` — fixed sample count per clip (pad/trim); ``label_from``
    — callable(path) → label (default: parent directory name).
    """

    def __init__(self, workflow, **kwargs):
        self.test_paths = list(kwargs.pop("test_paths", ()))
        self.validation_paths = list(kwargs.pop("validation_paths", ()))
        self.train_paths = list(kwargs.pop("train_paths", ()))
        self.window = int(kwargs.pop("window", 16384))
        self.label_from = kwargs.pop(
            "label_from",
            lambda path: os.path.basename(os.path.dirname(path)))
        super(WavLoader, self).__init__(workflow, **kwargs)

    def _read_wav(self, path):
        import wave
        with wave.open(path, "rb") as w:
            nchan = w.getnchannels()
            width = w.getsampwidth()
            frames = w.readframes(w.getnframes())
        if width == 2:
            pcm = numpy.frombuffer(frames, "<i2").astype(
                numpy.float32) / 32768.0
        elif width == 1:
            pcm = (numpy.frombuffer(frames, numpy.uint8).astype(
                numpy.float32) - 128.0) / 128.0
        elif width == 4:
            pcm = numpy.frombuffer(frames, "<i4").astype(
                numpy.float32) / 2147483648.0
        else:
            raise LoaderError("unsupported sample width %d in %s"
                              % (width, path))
        if nchan > 1:                       # downmix to mono
            pcm = pcm.reshape(-1, nchan).mean(axis=1)
        if len(pcm) >= self.window:
            pcm = pcm[:self.window]
        else:
            pcm = numpy.pad(pcm, (0, self.window - len(pcm)))
        return pcm

    def load_data(self):
        chunks, labels = [], []
        lengths = [0, 0, 0]
        for class_index, paths in ((TEST, self.test_paths),
                                   (VALID, self.validation_paths),
                                   (TRAIN, self.train_paths)):
            for path in paths:
                chunks.append(self._read_wav(path))
                labels.append(self.label_from(path))
            lengths[class_index] = len(paths)
        if not chunks:
            raise LoaderError("no wav paths given")
        self.original_data.mem = numpy.stack(chunks).astype(
            numpy.float32)
        self.original_labels = labels
        self.class_lengths[:] = lengths


class LMDBLoader(FullBatchLoader):
    """Caffe-style LMDB key-value datasets (reference ``loader_lmdb``;
    requires the ``lmdb`` package, absent from this image — the loader
    fails with a clear error until it is installed).

    kwargs: ``{test,validation,train}_db`` — LMDB directory paths whose
    values are pickled ``(ndarray, label)`` records.
    """

    def __init__(self, workflow, **kwargs):
        self.test_db = kwargs.pop("test_db", None)
        self.validation_db = kwargs.pop("validation_db", None)
        self.train_db = kwargs.pop("train_db", None)
        super(LMDBLoader, self).__init__(workflow, **kwargs)

    def load_data(self):
        try:
            import lmdb
        except ImportError:
            raise LoaderError("lmdb package is required for LMDBLoader")
        chunks, labels = [], []
        lengths = [0, 0, 0]
        for class_index, db_path in ((TEST, self.test_db),
                                     (VALID, self.validation_db),
                                     (TRAIN, self.train_db)):
            if not db_path:
                continue
            try:
                env = lmdb.open(db_path, readonly=True, lock=False)
            except lmdb.Error as e:
                raise LoaderError("cannot open lmdb %s: %s"
                                  % (db_path, e))
            try:
                with env.begin() as txn:
                    for _key, value in txn.cursor():
                        data, label = pickle.loads(value)
                        chunks.append(numpy.asarray(data,
                                                    numpy.float32))
                        labels.append(label)
                        lengths[class_index] += 1
            except (lmdb.Error, pickle.UnpicklingError,
                    ValueError) as e:
                raise LoaderError("bad lmdb record in %s: %s"
                                  % (db_path, e))
            finally:
                env.close()
        if not chunks:
            raise LoaderError("no LMDB paths given")
        self.original_data.mem = numpy.stack(chunks)
        self.original_labels = labels
        self.class_lengths[:] = lengths


class HDFSTextLoader(FullBatchLoader):
    """Line-record ingestion from HDFS over the WebHDFS REST API
    (reference ``veles/loader/hdfs_loader.py:48`` used libhdfs; REST
    needs no native client).  Each line: ``label<TAB>v1,v2,...``.

    kwargs: ``namenode`` — ``http://host:port``; ``{test,validation,
    train}_files`` — HDFS paths.
    """

    def __init__(self, workflow, **kwargs):
        self.namenode = kwargs.pop("namenode", None)
        self.test_files = list(kwargs.pop("test_files", ()))
        self.validation_files = list(kwargs.pop("validation_files", ()))
        self.train_files = list(kwargs.pop("train_files", ()))
        super(HDFSTextLoader, self).__init__(workflow, **kwargs)

    def _fetch(self, path):
        import urllib.request
        url = "%s/webhdfs/v1%s?op=OPEN" % (self.namenode, path)
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.read().decode()

    def _parse_lines(self, text, path="<memory>"):
        rows, labels = [], []
        for lineno, line in enumerate(text.splitlines(), 1):
            if not line.strip():
                continue
            label, tab, values = line.partition("\t")
            if not tab:
                raise LoaderError(
                    "%s:%d: expected 'label<TAB>v1,v2,...', got %r"
                    % (path, lineno, line[:60]))
            try:
                row = numpy.array([float(v) for v in values.split(",")],
                                  numpy.float32)
            except ValueError as e:
                raise LoaderError("%s:%d: bad values: %s"
                                  % (path, lineno, e))
            if rows and row.shape != rows[0].shape:
                raise LoaderError(
                    "%s:%d: row has %d values, expected %d"
                    % (path, lineno, row.size, rows[0].size))
            rows.append(row)
            labels.append(label)
        return rows, labels

    def load_data(self):
        if not self.namenode:
            raise LoaderError("HDFSTextLoader requires namenode=")
        chunks, labels = [], []
        lengths = [0, 0, 0]
        for class_index, paths in ((TEST, self.test_files),
                                   (VALID, self.validation_files),
                                   (TRAIN, self.train_files)):
            for path in paths:
                rows, raw = self._parse_lines(self._fetch(path), path)
                if chunks and rows and \
                        rows[0].shape != chunks[0].shape:
                    raise LoaderError(
                        "%s: rows have %d values but earlier files "
                        "had %d" % (path, rows[0].size,
                                    chunks[0].size))
                chunks.extend(rows)
                labels.extend(raw)
                lengths[class_index] += len(rows)
        if not chunks:
            raise LoaderError("no HDFS paths given")
        self.original_data.mem = numpy.stack(chunks)
        self.original_labels = labels
        self.class_lengths[:] = lengths
