"""Dataset access for the sample workflows: the port's counterpart of
:mod:`veles_tpu.samples.datasets`, ported for MNIST.

The real IDX files are read from ``$VELES_DATASETS/mnist/`` (else
``root.common.dirs.datasets``) when all four are there; nothing is ever
downloaded.  Otherwise ``load_mnist`` returns the JAX package's
synthetic stand-in: 28×28 images of 10 classes (a per-class template
plus noise, min-max scaled into [0, 1]), 6000 train and 1000
validation samples from ``numpy.random.default_rng(1234)`` — the same
arrays bit for bit.  ``raw=True`` gives the u8 pixels a u8-resident
dataset keeps: the IDX bytes as they are, or the stand-in mapped to
bytes by one mapping fit on the train split, as the JAX package maps
it.
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
