"""Snapshotter: whole-workflow snapshots with codecs, and loading them.

The port's counterpart of :mod:`veles_tpu.snapshotter`:

* ``SnapshotterBase`` decides *when*: every ``interval``-th run, at
  most once in ``time_interval`` seconds, and with ``reset_flag`` (a
  ``Bool``) cleared after each export, so a level-triggered gate such
  as ``Decision.improved`` gives one snapshot an improvement.  The
  interval is read on ``time.monotonic()``: the JAX package reads the
  wall clock, and a step of it backwards made the gate skip an export
  at ``time_interval`` 0, which lost that improvement's snapshot when
  the next close lowered the flag;
* ``SnapshotterToFile`` pickles the workflow to
  ``<directory>/<prefix>_<suffix>.pickle[.<codec>]`` with a
  ``<prefix>_current.pickle[.<codec>]`` symlink and a size warning.
  The capture (``pickle.dumps``) runs at the gate, so the snapshot is a
  consistent cut of the workflow; the compress and write run on
  :mod:`veles_tpu_torch.thread_pool`, and reading ``destination`` joins
  that write;
* ``SnapshotterToDB`` stores the same blobs as rows of a SQLite
  database, loaded back as ``db://<database>#<id|latest>``;
* ``load_snapshot`` from a path, an ``http(s)://`` URL or ``db://``,
  and ``save_snapshot``;
* ``DEBUG_PICKLE``, ``diagnose_pickle`` and ``checked_dumps``: a pickle
  that fails names the attribute at fault.

What a snapshot holds follows the ``_``-suffix convention of
:mod:`veles_tpu_torch.distributable`: the units, the host copies of the
``Vector`` buffers (synced from the device first), the random streams'
exact positions where a unit holds one, and the gate expressions.  No
torch object is in it: the devices pickle as None and the tensors, CUDA
graphs and streams are transient, so a snapshot written on the card
loads in a process without CUDA.  ``initialize(device=...)`` of the
loaded workflow attaches its device again and rebuilds (on the card,
recaptures) the stitched segments.  snappy is not among the codecs, as
in the JAX package.
"""

import bz2
import gzip
import lzma
import os
import pickle
import time

from veles_tpu_torch.config import root
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit

CODECS = {
    "": (lambda path: open(path, "wb"), lambda path: open(path, "rb")),
    "gz": (lambda path: gzip.open(path, "wb", 6),
           lambda path: gzip.open(path, "rb")),
    "bz2": (lambda path: bz2.open(path, "wb", 6),
            lambda path: bz2.open(path, "rb")),
    "xz": (lambda path: lzma.open(path, "wb", preset=1),
           lambda path: lzma.open(path, "rb")),
}

#: in-memory (compress, decompress) pairs for the database rows, under
#: the codec names of CODECS
BYTES_CODECS = {
    "": (lambda b: b, lambda b: b),
    "gz": (lambda b: gzip.compress(b, 6), gzip.decompress),
    "bz2": (lambda b: bz2.compress(b, 6), bz2.decompress),
    "xz": (lambda b: lzma.compress(b, preset=1), lzma.decompress),
}

SIZE_WARNING_BYTES = 500 * 1024 * 1024


class SnapshotterBase(Unit):
    """Decides *when* to snapshot; subclasses decide *where*.

    ``suffix`` (linked from ``Decision.snapshot_suffix`` in
    ``StandardWorkflow``) names the artifact; gated on
    ``~Decision.improved``, only improving models are kept."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(SnapshotterBase, self).__init__(workflow, **kwargs)
        self.prefix = kwargs.get("prefix", "veles_tpu_torch")
        self.interval = kwargs.get("interval", 1)
        self.time_interval = kwargs.get("time_interval", 1.0)
        self.suffix = None
        self._destination = None
        self.skipped = Bool(False)
        #: a one-shot trigger, cleared after each export
        self.reset_flag = None
        self._run_counter = 0

    def init_unpickled(self):
        super(SnapshotterBase, self).init_unpickled()
        #: ``time.monotonic()`` at the last export in this process (a
        #: monotonic reading means nothing in another one), None before
        self._last_export_ = None

    def run(self):
        self._run_counter += 1
        if self._run_counter % max(self.interval, 1) != 0:
            self.skipped <<= True
            return
        now = time.monotonic()
        if self._last_export_ is not None \
                and now - self._last_export_ < self.time_interval:
            self.skipped <<= True
            return
        self.skipped <<= False
        self._last_export_ = now
        self.export()
        if self.reset_flag is not None:
            self.reset_flag <<= False

    def export(self):
        raise NotImplementedError

    @property
    def destination(self):
        """The last artifact written; reading it joins a write still in
        flight, so the artifact is whole on disk."""
        self._join_pending_write()
        return self._destination

    @destination.setter
    def destination(self, value):
        self._destination = value

    def _join_pending_write(self):
        pass

    def get_metric_values(self):
        """The artifact, for the result files."""
        if getattr(self, "destination", None):
            return {"snapshot": self.destination}
        return {}


class SnapshotterToFile(SnapshotterBase):
    """Pickle the owning workflow to
    ``<directory>/<prefix>_<suffix>.pickle[.<codec>]`` and point the
    ``_current`` symlink at it."""

    def __init__(self, workflow, **kwargs):
        super(SnapshotterToFile, self).__init__(workflow, **kwargs)
        self.directory = kwargs.get(
            "directory") or root.common.dirs.get("snapshots")
        if not self.directory:
            # the port's config has no default under the home directory
            raise ValueError("SnapshotterToFile needs directory= or "
                             "root.common.dirs.snapshots")
        self.compression = kwargs.get("compression", "gz")
        if self.compression not in CODECS:
            raise ValueError("unknown compression %r (have %s)" %
                             (self.compression, sorted(CODECS)))
        #: compress and write on the host thread pool
        self.background = kwargs.get("background", True)

    def init_unpickled(self):
        super(SnapshotterToFile, self).init_unpickled()
        self._write_future_ = None

    def export(self):
        os.makedirs(self.directory, exist_ok=True)
        suffix = self.suffix or time.strftime("%Y%m%d_%H%M%S")
        ext = (".%s" % self.compression) if self.compression else ""
        name = "%s_%s.pickle%s" % (self.prefix, suffix, ext)
        path = os.path.join(self.directory, name)
        data = checked_dumps(self.workflow, logger=self)
        self._join_pending_write()
        self._destination = path
        if self.background:
            from veles_tpu_torch import thread_pool
            self._write_future_ = thread_pool.submit(
                self._write, data, path, name, ext)
        else:
            self._write(data, path, name, ext)

    def _write(self, data, path, name, ext):
        opener = CODECS[self.compression][0]
        with opener(path) as fout:
            fout.write(data)
        size = os.path.getsize(path)
        if size > SIZE_WARNING_BYTES:
            self.warning("snapshot %s is %.1f MiB - consider trimming "
                         "resident datasets before snapshotting",
                         name, size / 2 ** 20)
        current = os.path.join(self.directory,
                               "%s_current.pickle%s" % (self.prefix, ext))
        try:
            if os.path.islink(current) or os.path.exists(current):
                os.unlink(current)
            os.symlink(name, current)
        except OSError:  # a file system without symlinks
            pass
        self.info("snapshotted to %s (%.1f KiB)", path, size / 1024)

    def _join_pending_write(self):
        fut, self._write_future_ = self._write_future_, None
        if fut is not None:
            try:
                fut.result()
            except Exception:
                self.exception("background snapshot write failed")

    def stop(self):
        self._join_pending_write()
        super(SnapshotterToFile, self).stop()

    @staticmethod
    def import_(path):
        """Load a snapshot file, the codec read from its extension."""
        ext = path.rsplit(".", 1)[-1]
        codec = ext if ext in CODECS else ""
        with CODECS[codec][1](path) as fin:
            return pickle.load(fin)


def load_snapshot(path):
    """A workflow from a snapshot: a local path, an ``http(s)://`` URL
    (streamed to a temporary file first, so the codec is read from the
    name as for a path) or ``db://<database>#<id|latest>``."""
    if path.startswith("db://"):
        return SnapshotterToDB.import_(path)
    if path.startswith(("http://", "https://")):
        import shutil
        import tempfile
        import urllib.request
        suffix = "_" + path.rsplit("/", 1)[-1]
        tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
        try:
            with tmp, urllib.request.urlopen(path) as resp:
                shutil.copyfileobj(resp, tmp)
            return SnapshotterToFile.import_(tmp.name)
        finally:
            os.unlink(tmp.name)
    return SnapshotterToFile.import_(path)


def save_snapshot(workflow, path):
    """Pickle ``workflow`` to ``path``, the codec read from its
    extension."""
    ext = path.rsplit(".", 1)[-1]
    codec = ext if ext in CODECS else ""
    with CODECS[codec][0](path) as fout:
        pickle.dump(workflow, fout, protocol=pickle.HIGHEST_PROTOCOL)
    return path


class SnapshotterToDB(SnapshotterBase):
    """Store snapshots as rows of a SQLite database: (id, prefix,
    suffix, created, codec, blob).  Load one with
    ``load_snapshot('db://<database>#<id|latest>')``."""

    def __init__(self, workflow, **kwargs):
        super(SnapshotterToDB, self).__init__(workflow, **kwargs)
        self.database = kwargs.get("database") or os.path.join(
            root.common.dirs.get("snapshots", "."), "snapshots.sqlite")
        self.compression = kwargs.get("compression", "gz")
        if self.compression not in CODECS:
            raise ValueError("unknown compression %r" % self.compression)

    def init_unpickled(self):
        super(SnapshotterToDB, self).init_unpickled()
        self._write_future_ = None

    @staticmethod
    def _connect_rw(database):
        import sqlite3
        os.makedirs(os.path.dirname(os.path.abspath(database)),
                    exist_ok=True)
        conn = sqlite3.connect(database)
        conn.execute(
            "CREATE TABLE IF NOT EXISTS snapshots ("
            "id INTEGER PRIMARY KEY AUTOINCREMENT, prefix TEXT, "
            "suffix TEXT, created REAL, codec TEXT, blob BLOB)")
        return conn

    def export(self):
        data = checked_dumps(self.workflow, logger=self)
        self._join_pending_write()
        # the row id is known after the insert, which runs on the pool
        self._destination = None
        from veles_tpu_torch import thread_pool
        self._write_future_ = thread_pool.submit(
            self._write, data, self.compression, self.suffix or "")

    def _write(self, data, codec, suffix):
        blob = BYTES_CODECS[codec][0](data)
        conn = self._connect_rw(self.database)
        try:
            with conn:
                cur = conn.execute(
                    "INSERT INTO snapshots (prefix, suffix, created, "
                    "codec, blob) VALUES (?, ?, ?, ?, ?)",
                    (self.prefix, suffix, time.time(), codec, blob))
                rowid = cur.lastrowid
        finally:
            conn.close()
        self._destination = "db://%s#%d" % (self.database, rowid)
        self.info("snapshot stored as id %d in %s (%d bytes)",
                  rowid, self.database, len(blob))

    def _join_pending_write(self):
        fut, self._write_future_ = self._write_future_, None
        if fut is not None:
            try:
                fut.result()
            except Exception:
                self.exception("background snapshot insert failed")

    def stop(self):
        self._join_pending_write()
        super(SnapshotterToDB, self).stop()

    @classmethod
    def import_(cls, spec):
        """``db://<database>[#<id|latest>]`` → the unpickled workflow.

        Opened read-only: a wrong path raises ``KeyError`` and makes no
        empty database.  Only a trailing ``#<digits>`` or ``#latest`` is
        a fragment, so a ``#`` inside the path is kept."""
        import re
        import sqlite3
        from urllib.parse import quote
        body = spec[len("db://"):]
        database, sep, rowid = body.rpartition("#")
        if not sep or not re.fullmatch(r"\d+|latest", rowid):
            database, rowid = body, "latest"
        if not os.path.exists(database):
            raise KeyError("snapshot database %r does not exist"
                           % database)
        conn = sqlite3.connect(
            "file:%s?mode=ro" % quote(os.path.abspath(database),
                                      safe="/"), uri=True)
        try:
            if rowid == "latest":
                row = conn.execute(
                    "SELECT codec, blob FROM snapshots "
                    "ORDER BY id DESC LIMIT 1").fetchone()
            else:
                row = conn.execute(
                    "SELECT codec, blob FROM snapshots WHERE id = ?",
                    (int(rowid),)).fetchone()
        except sqlite3.Error as e:
            raise KeyError("cannot read snapshot db %r: %s"
                           % (database, e))
        finally:
            conn.close()
        if row is None:
            raise KeyError("no snapshot %r in %s" % (rowid, database))
        codec, blob = row
        return pickle.loads(BYTES_CODECS[codec][1](blob))


#: when True, a snapshot pickle that fails is diagnosed attribute by
#: attribute, and the log names the slot at fault
DEBUG_PICKLE = False


def diagnose_pickle(obj, path="workflow", max_depth=4, _seen=None):
    """``["path.attr: error", ...]`` for the sub-attributes that fail to
    pickle: walks ``__getstate__`` (so the ``_``-suffix convention
    holds), lists, tuples and dicts down to ``max_depth``, and reports
    the deepest failures."""
    _seen = _seen if _seen is not None else set()
    if id(obj) in _seen or max_depth < 0:
        return []
    _seen.add(id(obj))
    try:
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        return []
    except Exception as exc:
        problems = ["%s: %s" % (path, exc)]
    children = []
    if isinstance(obj, (list, tuple)):
        for i, value in enumerate(obj):
            children.extend(diagnose_pickle(
                value, "%s[%d]" % (path, i), max_depth - 1, _seen))
    elif isinstance(obj, dict):
        for key, value in sorted(obj.items(), key=lambda kv: repr(kv)):
            children.extend(diagnose_pickle(
                value, "%s[%r]" % (path, key), max_depth - 1, _seen))
    else:
        getstate = getattr(obj, "__getstate__", None)
        try:
            state = getstate() if callable(getstate) else vars(obj)
        except Exception:
            return problems
        if not isinstance(state, dict):
            return problems
        for key, value in sorted(state.items(), key=lambda kv: kv[0]):
            children.extend(diagnose_pickle(
                value, "%s.%s" % (path, key), max_depth - 1, _seen))
    # when the children pinpoint the failure, the parent line is noise
    return children or problems


def checked_dumps(obj, logger=None):
    """``pickle.dumps``, diagnosed when ``DEBUG_PICKLE`` is set."""
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:
        if DEBUG_PICKLE:
            for line in diagnose_pickle(obj):
                (logger.error if logger else print)(
                    "pickle diagnostics: %s" % line)
        raise
