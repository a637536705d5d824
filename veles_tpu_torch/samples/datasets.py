"""Dataset access for the sample workflows: the port's counterpart of
:mod:`veles_tpu.samples.datasets`, ported for MNIST, CIFAR-10 and STL-10.

The real IDX files are read from ``$VELES_DATASETS/mnist/`` (else
``root.common.dirs.datasets``) when all four are there; nothing is ever
downloaded.  Otherwise ``load_mnist`` returns the JAX package's
synthetic stand-in: 28×28 images of 10 classes (a per-class template
plus noise, min-max scaled into [0, 1]), 6000 train and 1000
validation samples from ``numpy.random.default_rng(1234)`` — the same
arrays bit for bit.  ``raw=True`` gives the u8 pixels a u8-resident
dataset keeps: the IDX bytes as they are, or the stand-in mapped to
bytes by one mapping fit on the train split, as the JAX package maps
it.  CIFAR-10 is read from ``cifar-10-batches-bin/`` (the binary
batches) and STL-10 from ``stl10_binary/``; without them the stand-ins
are the JAX package's 32×32×3 (5000 + 1000) and 96×96×3 (1000 + 800)
synthetic images, the same arrays.
"""

import gzip
import os
import struct

import numpy

from veles_tpu_torch.config import root


def _dataset_dir():
    return os.environ.get("VELES_DATASETS") \
        or root.common.dirs.get("datasets", ".")


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fin:
        magic, = struct.unpack(">I", fin.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, fin.read(4 * ndim))
        data = numpy.frombuffer(fin.read(), dtype=numpy.uint8)
    return data.reshape(dims)


def _mnist_paths():
    base = os.path.join(_dataset_dir(), "mnist")
    names = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    paths = []
    for name in names:
        for cand in (os.path.join(base, name),
                     os.path.join(base, name + ".gz")):
            if os.path.exists(cand):
                paths.append(cand)
                break
    return paths if len(paths) == 4 else None


def _cifar10_paths():
    base = os.path.join(_dataset_dir(), "cifar-10-batches-bin")
    batches = [os.path.join(base, "data_batch_%d.bin" % i)
               for i in range(1, 6)]
    test = os.path.join(base, "test_batch.bin")
    return (batches, test) if all(
        os.path.exists(p) for p in batches + [test]) else None


def _stl10_paths():
    base = os.path.join(_dataset_dir(), "stl10_binary")
    names = ("train_X.bin", "train_y.bin", "test_X.bin", "test_y.bin")
    paths = [os.path.join(base, n) for n in names]
    return paths if all(os.path.exists(p) for p in paths) else None


def load_mnist(raw=False):
    """``(train_x, train_y, test_x, test_y, real)``: floats in [0, 1]
    (u8 pixels when ``raw``) and int64 labels, ``real`` False for the
    synthetic stand-in."""
    paths = _mnist_paths()
    if paths:
        tr_x, te_x = _read_idx(paths[0]), _read_idx(paths[2])
        if not raw:
            tr_x = tr_x.astype(numpy.float32) / 255.0
            te_x = te_x.astype(numpy.float32) / 255.0
        tr_y = _read_idx(paths[1]).astype(numpy.int64)
        te_y = _read_idx(paths[3]).astype(numpy.int64)
        return tr_x, tr_y, te_x, te_y, True
    tr_x, tr_y, te_x, te_y = _synthetic_images((28, 28), 10, 6000, 1000)
    if raw:
        # one byte mapping fit on TRAIN for both splits (a split-local
        # min/max would scale train and validation pixels differently)
        lo, hi = tr_x.min(), tr_x.max()

        def to_u8(x):
            return numpy.clip((x - lo) / max(hi - lo, 1e-6) * 255.0, 0,
                              255).astype(numpy.uint8)
        tr_x, te_x = to_u8(tr_x), to_u8(te_x)
    return tr_x, tr_y, te_x, te_y, False


def _synthetic_images(shape, n_classes, n_train, n_valid):
    """Class-structured random images: a per-class template + noise."""
    rng = numpy.random.default_rng(1234)
    total = n_train + n_valid
    labels = rng.integers(0, n_classes, total)
    templates = rng.standard_normal((n_classes,) + tuple(shape)) * 1.5
    x = (templates[labels]
         + rng.standard_normal((total,) + templates.shape[1:])
         ).astype(numpy.float32)
    x = (x - x.min()) / (x.max() - x.min())
    return (x[:n_train], labels[:n_train].astype(numpy.int64),
            x[n_train:], labels[n_train:].astype(numpy.int64))


def load_cifar10():
    """``(train_x, train_y, test_x, test_y, real)``: (N, 32, 32, 3)
    floats in [0, 1] and int64 labels, or the synthetic stand-in."""
    found = _cifar10_paths()
    if found:
        batches, test = found

        def read(path):
            raw = numpy.fromfile(path, dtype=numpy.uint8).reshape(-1, 3073)
            labels = raw[:, 0].astype(numpy.int64)
            imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(
                0, 2, 3, 1).astype(numpy.float32) / 255.0
            return imgs, labels
        xs, ys = zip(*[read(p) for p in batches])
        te_x, te_y = read(test)
        return (numpy.concatenate(xs), numpy.concatenate(ys), te_x, te_y,
                True)
    return _synthetic_images((32, 32, 3), 10, 5000, 1000) + (False,)


def load_stl10():
    """STL-10 (96×96×3, 10 classes) from the official binaries (uint8
    CHW images, column-major a channel; 1-based labels), else the
    synthetic stand-in."""
    paths = _stl10_paths()
    if paths:
        def read_x(path):
            imgs = numpy.fromfile(path, dtype=numpy.uint8).reshape(
                -1, 3, 96, 96)
            # column-major a channel: transposed into (N, H, W, C)
            return imgs.transpose(0, 3, 2, 1).astype(numpy.float32) / 255.0

        def read_y(path):
            return numpy.fromfile(path, dtype=numpy.uint8).astype(
                numpy.int64) - 1
        return (read_x(paths[0]), read_y(paths[1]), read_x(paths[2]),
                read_y(paths[3]), True)
    return _synthetic_images((96, 96, 3), 10, 1000, 800) + (False,)
