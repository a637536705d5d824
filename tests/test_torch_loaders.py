"""The loaders' dataset options and the loader modules against the JAX
package, on the CPU.

- ``validation_ratio``, ``train_ratio`` and ``testing``: a standalone
  port loader serves the JAX loader's minibatches (class, size, index
  sequence, rows, labels) over three epochs, from one seed; the same
  options through a ``StandardWorkflow`` serve the JAX sequence on every
  route (eager units, the stitched loader head, the epoch-scan windows,
  the fused trainer's per-step route).
- ``loader/saver.py``: a dump written by the port's ``MinibatchesSaver``
  reads back in the JAX ``read_minibatch_dump`` with the served rows,
  and the port's ``MinibatchesLoader`` replays it as the JAX one does.
- ``loader/streaming.py``: ``InteractiveLoader``, ``RestfulLoader`` (a
  local HTTP server) and ``ZeroMQLoader`` (a local socket; skipped
  without pyzmq) serve what was fed, with the epoch and stream markers;
  every wait has a timeout, and the ZeroMQ pump stops within a second.
- ``loader/image.py``: ``FileImageLoader``, ``AutoLabelFileImageLoader``
  (crop, mirror, rotations), ``ImageLoaderMSE`` and
  ``FullBatchImageLoader`` over PNGs written here, against the JAX
  loaders from one seed (skipped without PIL).
- ``loader/formats.py``: HDF5 (skipped without h5py), pickles, WAV, LMDB
  (skipped without lmdb) and the WebHDFS text loader over a local HTTP
  server, each dataset equal to the JAX loader's.
"""

import http.server
import json
import os
import pickle
import threading
import urllib.request
import wave

import numpy
import pytest
import torch

from veles_tpu import prng as jax_prng
from veles_tpu.backends import CPUDevice as JaxCPUDevice
from veles_tpu.config import root as jax_root
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
from veles_tpu.loader import formats as jax_formats
from veles_tpu.loader import image as jax_image
from veles_tpu.loader import saver as jax_saver
from veles_tpu.loader import streaming as jax_streaming
from veles_tpu.loader.fullbatch import FullBatchLoader as JaxFullBatch
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.backends import CPUDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow
from veles_tpu_torch.loader import formats, image, saver, streaming
from veles_tpu_torch.loader.base import Loader, LoaderError
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

# one intra-op thread a test process: the suite runs one xdist worker a
# core, and torch's default of a thread a core oversubscribes the box
torch.set_num_threads(1)

N_TEST, N_VALID, N_TRAIN, FEATURES, CLASSES = 6, 0, 41, 5, 3
TIMEOUT = 10.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: these small ops, thousands a
    minibatch, otherwise wait for a descheduled pool thread whenever the
    box's cores are busy (~8 ms an op beside the parallel suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset():
    rng = numpy.random.default_rng(17)
    n = N_TEST + N_VALID + N_TRAIN
    labels = rng.integers(0, CLASSES, n)
    x = (rng.standard_normal((n, FEATURES)) + labels[:, None]).astype(
        numpy.float32)
    return x, [int(v) for v in labels]


def _load(self):
    self.original_data.mem, self.original_labels = _dataset()
    self.class_lengths[:] = [N_TEST, N_VALID, N_TRAIN]


class Blobs(FullBatchLoader):
    load_data = _load


class JaxBlobs(JaxFullBatch):
    load_data = _load


_OPTIONS = {
    "validation_ratio": {"validation_ratio": 0.25},
    "train_ratio": {"train_ratio": 0.6},
    "both": {"validation_ratio": 0.3, "train_ratio": 0.5},
    "testing": {"testing": True},
}


def _served(loader, count, data=True):
    out = []
    for _ in range(count):
        loader.run()
        size = loader.minibatch_size
        item = (int(loader.minibatch_class), int(size),
                numpy.array(loader.minibatch_indices.mem[:size]).tolist(),
                bool(loader.last_minibatch), bool(loader.epoch_ended))
        if data:
            item += (numpy.array(loader.minibatch_data.mem[:size]),
                     numpy.array(loader.minibatch_labels.mem[:size]))
        out.append(item)
    return out


def _assert_served(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:5] == w[:5]
        for a, b in zip(g[5:], w[5:]):
            assert numpy.array_equal(a, b)


def _standalone(jax_side, options, batch=7):
    (jax_prng if jax_side else prng).seed_all(9)
    if jax_side:
        loader = JaxBlobs(JaxDummyWorkflow(), minibatch_size=batch,
                          **options)
        loader.initialize(device=None)
    else:
        loader = Blobs(DummyWorkflow(), minibatch_size=batch, **options)
        loader.initialize(device=CPUDevice())
    return loader


@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_standalone_loader_serves_the_jax_sequence(option):
    want = _served(_standalone(True, _OPTIONS[option]), 24)
    loader = _standalone(False, _OPTIONS[option])
    got = _served(loader, 24)
    _assert_served(got, want)
    if option == "testing":
        assert loader.shuffle_limit == 0
    else:
        assert loader.class_lengths == _standalone(
            True, _OPTIONS[option]).class_lengths


def test_bad_validation_ratios_are_refused_as_in_jax():
    for bad in (0.0, 1.0, "x"):
        with pytest.raises(LoaderError, match="validation_ratio"):
            Blobs(DummyWorkflow(), validation_ratio=bad)


_LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 6},
            "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
           {"type": "softmax", "->": {"output_sample_shape": CLASSES},
            "<-": {"learning_rate": 0.05}}]


def _workflow(jax_side, options, **kwargs):
    (jax_prng if jax_side else prng).seed_all(9)
    klass = JaxStandardWorkflow if jax_side else StandardWorkflow
    loader = JaxBlobs if jax_side else Blobs
    wf = klass(None, loader_factory=lambda w: loader(w, minibatch_size=7,
                                                     **options),
               layers=[dict(s) for s in _LAYERS],
               decision_config={"max_epochs": 3, "fail_iterations": 50},
               **kwargs)
    wf.launcher = JaxDummyLauncher() if jax_side else DummyLauncher()
    wf.initialize(device=JaxCPUDevice() if jax_side else CPUDevice())
    return wf


def _record_serves(klass, store):
    """Wrap ``fill_indices`` on the class: every route serves through it
    (the eager run, the head's prelude, a window's step)."""
    inner = klass.fill_indices

    def recording(self, start, count):
        result = inner(self, start, count)
        store.append((int(self.minibatch_class), int(count),
                      self.shuffled_indices.mem[start:start + count]
                      .tolist()))
        return result
    return inner, recording


@pytest.fixture(scope="module")
def jax_route_serves():
    out = {}
    eng = jax_root.common.engine
    saved = {k: eng.get(k, d) for k, d in (("kernels", "auto"),
                                           ("stitch", "on"))}
    eng.kernels, eng.stitch = "xla", "off"
    try:
        for name in ("validation_ratio", "both"):
            store = []
            inner, recording = _record_serves(JaxBlobs, store)
            JaxBlobs.fill_indices = recording
            try:
                _workflow(True, _OPTIONS[name]).run()
            finally:
                JaxBlobs.fill_indices = inner
            out[name] = store
    finally:
        for key, value in saved.items():
            setattr(eng, key, value)
    return out


_ROUTES = {"eager": {"stitch": "off"}, "stitched": {"stitch": "on"},
           "windows": {"stitch": "on", "epoch_scan": "auto"},
           "fused": {"stitch": "on"}}


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("option", ["validation_ratio", "both"])
def test_every_route_serves_the_jax_sequence(jax_route_serves, option,
                                             route):
    eng = root.common.engine
    saved = {k: eng.get(k, d) for k, d in (("stitch", "on"),
                                           ("epoch_scan", "off"))}
    for key, value in _ROUTES[route].items():
        setattr(eng, key, value)
    store = []
    inner, recording = _record_serves(Blobs, store)
    Blobs.fill_indices = recording
    try:
        wf = _workflow(False, _OPTIONS[option], fused=(route == "fused"))
        wf.run()
    finally:
        Blobs.fill_indices = inner
        for key, value in saved.items():
            setattr(eng, key, value)
    assert store == jax_route_serves[option]
    if route == "windows":
        assert wf.epoch_runner is not None and wf.epoch_runner.windows
    assert wf.loader.class_lengths[1] > 0


# -- ensemble.train_ratio from the config -------------------------------------

@pytest.mark.parametrize("ratio", [0.5, 0.9])
def test_config_train_ratio_serves_the_jax_sequence(ratio):
    saved = (root.common.ensemble.__dict__.get("train_ratio"),
             jax_root.common.ensemble.__dict__.get("train_ratio"))
    root.common.ensemble.train_ratio = ratio
    jax_root.common.ensemble.train_ratio = ratio
    try:
        want = _served(_standalone(True, {}), 20)
        loader = _standalone(False, {})
        got = _served(loader, 20)
    finally:
        for node, value in zip((root, jax_root), saved):
            if value is None:
                node.common.ensemble.__dict__.pop("train_ratio", None)
            else:
                node.common.ensemble.train_ratio = value
    assert loader.train_ratio == ratio
    _assert_served(got, want)


# -- the saver ----------------------------------------------------------------

def test_saver_dump_replays_in_both_packages(tmp_path):
    loader = _standalone(False, {"validation_ratio": 0.25})
    path = str(tmp_path / "port.dump.gz")
    wf = DummyWorkflow()
    dump = saver.MinibatchesSaver(wf, file_name=path)
    for attr in ("minibatch_data", "minibatch_labels"):
        setattr(dump, attr, getattr(loader, attr))
    dump.initialize()
    served = []
    for _ in range(9):
        loader.run()
        dump.minibatch_class = loader.minibatch_class
        dump.minibatch_size = loader.minibatch_size
        dump.run()
        served.append((int(loader.minibatch_class),
                       numpy.array(loader.minibatch_data.mem[
                           :loader.minibatch_size])))
    dump.stop()
    records = list(jax_saver.read_minibatch_dump(path))
    assert [(r["class"], len(r["data"])) for r in records] == \
        [(c, len(d)) for c, d in served]
    for record, (_cls, data) in zip(records, served):
        assert numpy.array_equal(record["data"], data)
    assert [r["class"] for r in saver.read_minibatch_dump(path)] == \
        [r["class"] for r in records]
    # both replayers serve the dump alike
    port = saver.MinibatchesLoader(DummyWorkflow(), file_name=path)
    port.initialize(device=CPUDevice())
    ref = jax_saver.MinibatchesLoader(JaxDummyWorkflow(), file_name=path)
    ref.initialize(device=None)
    _assert_served(_served(port, 9), _served(ref, 9))


# -- streaming ----------------------------------------------------------------

def _start_run(loader):
    """``loader.run()`` on a daemon thread (a stream's run blocks until
    an item arrives); join it with :func:`_joined`."""
    errors = []

    def target():
        try:
            loader.run()
        except Exception as exc:  # noqa: BLE001 - re-raised in the test
            errors.append(exc)
    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.errors = errors
    return thread


def _joined(thread, timeout=TIMEOUT):
    thread.join(timeout=timeout)
    assert not thread.is_alive(), "the stream's run did not return"
    if thread.errors:
        raise thread.errors[0]


def _run(loader):
    _joined(_start_run(loader))


def _feed_and_serve(loader, batches):
    out = []
    for data, labels in batches:
        loader.feed(data, labels, timeout=TIMEOUT)
    loader.end_epoch()
    for _ in range(len(batches) + 1):
        _run(loader)
        out.append((int(loader.epoch_number), bool(loader.epoch_ended),
                    int(loader.minibatch_size),
                    numpy.array(loader.minibatch_data.mem[
                        :loader.minibatch_size]),
                    numpy.array(loader.minibatch_labels.mem)))
    return out


def _stream_batches():
    rng = numpy.random.default_rng(2)
    return [(rng.standard_normal((n, 2, 3)).astype(numpy.float32),
             [int(v) for v in rng.integers(0, 4, n)] if n != 2 else None)
            for n in (4, 2, 3)]


def _stream_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert numpy.array_equal(g[3], w[3])
        assert numpy.array_equal(g[4], w[4])


def test_interactive_loader_serves_as_the_jax_one():
    kwargs = {"sample_shape": (2, 3), "minibatch_size": 4}
    port = streaming.InteractiveLoader(DummyWorkflow(), **kwargs)
    port.initialize(device=CPUDevice())
    ref = jax_streaming.InteractiveLoader(JaxDummyWorkflow(), **kwargs)
    ref.initialize(device=None)
    batches = _stream_batches()
    _stream_equal(_feed_and_serve(port, batches),
                  _feed_and_serve(ref, batches))
    with pytest.raises(LoaderError, match="max_minibatch_size"):
        port.feed(numpy.zeros((5, 2, 3)))
    # a run waits for the producer, as the JAX loader's does
    waiting = _start_run(port)
    waiting.join(timeout=0.2)
    assert waiting.is_alive()
    port.end_stream()
    _joined(waiting)
    assert port.stream_ended


def test_restful_loader_serves_what_is_posted():
    port = streaming.RestfulLoader(DummyWorkflow(), sample_shape=(2, 3),
                                   minibatch_size=4)
    port.initialize(device=CPUDevice())
    try:
        url = "http://127.0.0.1:%d/feed" % port.port
        batches = _stream_batches()
        for data, labels in batches:
            body = {"input": data.tolist()}
            if labels is not None:
                body["labels"] = labels
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                assert json.loads(resp.read()) == {"ok": True}
        req = urllib.request.Request(
            url, data=json.dumps({"control": "end_of_epoch"}).encode())
        urllib.request.urlopen(req, timeout=TIMEOUT).close()
        got = []
        for _ in range(len(batches) + 1):
            _run(port)
            got.append((int(port.minibatch_size),
                        numpy.array(port.minibatch_data.mem[
                            :port.minibatch_size])))
        assert [g[0] for g in got] == [4, 2, 3, 0]
        for (size, data), (want, _labels) in zip(got, batches):
            assert numpy.array_equal(data, want)
        assert port.epoch_number == 1 and bool(port.epoch_ended)
    finally:
        port.stop()


def test_zeromq_loader_serves_what_is_pushed():
    zmq = pytest.importorskip("zmq")
    port = streaming.ZeroMQLoader(DummyWorkflow(), sample_shape=(2, 3),
                                  minibatch_size=4)
    port.initialize(device=CPUDevice())
    push = zmq.Context.instance().socket(zmq.PUSH)
    push.setsockopt(zmq.SNDTIMEO, int(TIMEOUT * 1000))
    push.setsockopt(zmq.LINGER, 0)
    try:
        push.connect("tcp://127.0.0.1:%d" % port.port)
        batches = _stream_batches()
        for item in batches:
            push.send(pickle.dumps(item))
        push.send(pickle.dumps("end_of_epoch"))
        sizes = []
        for _ in range(len(batches) + 1):
            _run(port)
            sizes.append(int(port.minibatch_size))
        assert sizes == [4, 2, 3, 0]
        assert numpy.array_equal(port.minibatch_labels.mem[:3],
                                 numpy.array(batches[2][1], numpy.int32))
    finally:
        push.close(0)
        thread = port._zmq_thread_
        port.stop()
    # the stop's wake-up reaches the pump: it has closed its socket
    thread.join(timeout=1.0)
    assert not thread.is_alive()


# -- images -------------------------------------------------------------------

@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    PIL = pytest.importorskip("PIL.Image")
    base = tmp_path_factory.mktemp("images")
    rng = numpy.random.default_rng(3)
    for split, count in (("train", 5), ("test", 2)):
        for label in ("cat", "dog"):
            folder = base / split / label
            folder.mkdir(parents=True)
            for i in range(count):
                pixels = rng.integers(0, 256, (12, 10, 3)).astype(
                    numpy.uint8)
                PIL.fromarray(pixels).save(str(folder / ("%d.png" % i)))
    return base


class _FileMSE(image.ImageLoaderMSE, image.FileImageLoader):
    """Reconstruction pairs over the per-class paths."""


class _JaxFileMSE(jax_image.ImageLoaderMSE, jax_image.FileImageLoader):
    pass


def _image_loaders(base, klass_name, **kwargs):
    out = []
    for jax_side in (True, False):
        (jax_prng if jax_side else prng).seed_all(13)
        module = jax_image if jax_side else image
        wf = JaxDummyWorkflow() if jax_side else DummyWorkflow()
        if klass_name == "ImageLoaderMSE":
            klass = _JaxFileMSE if jax_side else _FileMSE
        else:
            klass = getattr(module, klass_name)
        loader = klass(
            wf, train_paths=[str(base / "train")],
            test_paths=[str(base / "test")], minibatch_size=6, **kwargs)
        loader.initialize(device=None if jax_side else CPUDevice())
        out.append(loader)
    return out


@pytest.mark.parametrize("klass,kwargs", [
    ("AutoLabelFileImageLoader", {"size": (8, 6), "crop": (6, 5),
                                  "mirror": True}),
    ("AutoLabelFileImageLoader", {"size": (10, 12), "color_space": "GRAY",
                                  "rotations": (0.0, 0.3),
                                  "add_sobel": True}),
    ("FileImageLoader", {"size": (10, 12), "scale": 0.5}),
])
def test_image_loaders_serve_as_the_jax_ones(image_tree, klass, kwargs):
    ref, port = _image_loaders(image_tree, klass, **kwargs)
    assert port.class_lengths == ref.class_lengths
    _assert_served(_served(port, 8), _served(ref, 8))


def test_image_mse_and_full_batch_loaders_match_jax(image_tree):
    ref, port = _image_loaders(image_tree, "ImageLoaderMSE",
                               size=(8, 6), crop=(6, 4), mirror=True)
    for _ in range(4):
        ref.run()
        port.run()
        assert numpy.array_equal(port.minibatch_targets.mem,
                                 ref.minibatch_targets.mem)
        assert numpy.array_equal(port.minibatch_data.mem,
                                 ref.minibatch_data.mem)
    full = []
    for jax_side in (True, False):
        module = jax_image if jax_side else image
        loader = module.FullBatchImageLoader(
            JaxDummyWorkflow() if jax_side else DummyWorkflow(),
            image_loader_class=module.AutoLabelFileImageLoader,
            train_paths=[str(image_tree / "train")], size=(8, 6))
        loader.initialize(device=None if jax_side else CPUDevice())
        full.append(loader)
    assert numpy.array_equal(full[1].original_data.mem,
                             full[0].original_data.mem)
    assert full[1].original_labels == full[0].original_labels


# -- formats ------------------------------------------------------------------

def _blob(seed, n=5):
    rng = numpy.random.default_rng(seed)
    return (rng.standard_normal((n, 3)).astype(numpy.float32),
            [int(v) for v in rng.integers(0, 3, n)])


def _both(klass_name, **kwargs):
    out = []
    for module, wf, device in ((jax_formats, JaxDummyWorkflow(), None),
                               (formats, DummyWorkflow(), CPUDevice())):
        loader = getattr(module, klass_name)(wf, minibatch_size=4,
                                             **kwargs)
        loader.initialize(device=device)
        out.append(loader)
    return out


def _assert_same_dataset(ref, port):
    assert port.class_lengths == ref.class_lengths
    assert numpy.array_equal(port.original_data.mem, ref.original_data.mem)
    assert list(port.original_labels) == list(ref.original_labels)


def test_hdf5_loader_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    paths = {}
    for name, seed in (("train_path", 1), ("test_path", 2)):
        data, labels = _blob(seed)
        paths[name] = str(tmp_path / (name + ".h5"))
        with h5py.File(paths[name], "w") as fout:
            fout["data"] = data
            fout["labels"] = numpy.array(labels)
    _assert_same_dataset(*_both("HDF5Loader", **paths))


def test_pickles_loader_matches_jax(tmp_path):
    paths = {}
    for name, seed, form in (("train_path", 1, "tuple"),
                             ("validation_path", 2, "dict")):
        data, labels = _blob(seed)
        paths[name] = str(tmp_path / (name + ".pickle"))
        blob = (data, labels) if form == "tuple" else {
            "data": data, "labels": labels}
        with open(paths[name], "wb") as fout:
            pickle.dump(blob, fout)
    _assert_same_dataset(*_both("PicklesLoader", **paths))


def test_wav_loader_matches_jax(tmp_path):
    rng = numpy.random.default_rng(4)
    paths = []
    for label, width, channels in (("a", 2, 1), ("b", 1, 2), ("b", 4, 1)):
        folder = tmp_path / label
        folder.mkdir(exist_ok=True)
        path = str(folder / ("%d_%d.wav" % (width, channels)))
        dtype = {1: numpy.uint8, 2: "<i2", 4: "<i4"}[width]
        info = numpy.iinfo(numpy.dtype(dtype))
        frames = rng.integers(info.min, info.max, 300 * channels).astype(
            dtype)
        with wave.open(path, "wb") as fout:
            fout.setnchannels(channels)
            fout.setsampwidth(width)
            fout.setframerate(8000)
            fout.writeframes(frames.tobytes())
        paths.append(path)
    _assert_same_dataset(*_both("WavLoader", train_paths=paths, window=256))


def test_lmdb_loader_matches_jax(tmp_path):
    lmdb = pytest.importorskip("lmdb")
    data, labels = _blob(5)
    env = lmdb.open(str(tmp_path / "db"), map_size=1 << 20)
    with env.begin(write=True) as txn:
        for i, (row, label) in enumerate(zip(data, labels)):
            txn.put(b"%04d" % i, pickle.dumps((row, label)))
    env.close()
    _assert_same_dataset(*_both("LMDBLoader", train_db=str(tmp_path / "db")))


def test_hdfs_text_loader_matches_jax():
    files = {"/data/train.txt": "a\t1,2,3\nb\t4,5,6\n\na\t7,8,9\n",
             "/data/test.txt": "b\t0.5,0.25,1\n"}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0][len("/webhdfs/v1"):]
            body = files[path].encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        namenode = "http://127.0.0.1:%d" % server.server_address[1]
        ref, port = _both("HDFSTextLoader", namenode=namenode,
                          train_files=["/data/train.txt"],
                          test_files=["/data/test.txt"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)
    _assert_same_dataset(ref, port)
    assert port.class_lengths == [1, 0, 3]


def test_loader_modules_name_their_counterparts():
    for module in (formats, image, saver, streaming):
        name = module.__name__.replace("veles_tpu_torch", "veles_tpu")
        assert (":mod:`%s`" % name) in module.__doc__
    assert issubclass(streaming.StreamLoader, Loader)
    assert os.path.basename(formats.__file__) == "formats.py"
