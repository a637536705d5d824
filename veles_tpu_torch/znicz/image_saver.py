"""ImageSaver: misclassified samples written to disk for inspection.
The port's counterpart of :mod:`veles_tpu.znicz.image_saver`.

``out_dirs`` holds one directory per sample class ``[test, validation,
train]``.  Each minibatch, the samples the evaluator got wrong are
written as PNGs named ``<epoch>_<truth>_<predicted>_<n>.png`` into the
minibatch class's directory, at most ``limit`` a directory an epoch; a
directory is emptied of its PNGs when a new epoch first writes to it,
so each gallery holds the latest epoch's mistakes.  Eager mode only
(it reads the evaluator's per-sample ``max_idx``).

The JAX unit writes through PIL, which the card's machine does not
have: :func:`write_png` writes the same 8-bit grayscale (or RGB, RGBA)
image with ``zlib`` and ``struct`` from the standard library.
"""

import os
import struct
import zlib

import numpy

from veles_tpu_torch.units import Unit

#: channels of the last axis -> PNG colour type
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xffffffff))


def write_png(path, image):
    """Write a uint8 image, (H, W) grayscale or (H, W, 3|4) RGB(A), as
    an 8-bit PNG (no filtering, one IDAT chunk)."""
    image = numpy.ascontiguousarray(image, dtype=numpy.uint8)
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPES:
        raise ValueError("write_png takes (H, W) or (H, W, 3|4) images, "
                         "got %s" % (image.shape,))
    height, width, channels = image.shape
    header = struct.pack(">IIBBBBB", width, height, 8,
                         _COLOR_TYPES[channels], 0, 0, 0)
    rows = numpy.concatenate(
        [numpy.zeros((height, 1), numpy.uint8),
         image.reshape(height, width * channels)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 9)))
        f.write(_chunk(b"IEND", b""))


class ImageSaver(Unit):
    """See the module.  Linked after the Decision; reads ``input`` (the
    minibatch data Vector), ``labels``, ``max_idx`` (the evaluator's
    argmax) and the loader counters."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.out_dirs = list(kwargs.pop("out_dirs", []))
        self.limit = int(kwargs.pop("limit", 100))    # per dir and epoch
        super(ImageSaver, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.input = None
        self.labels = None
        self.max_idx = None
        self.minibatch_class = None
        self.minibatch_size = None
        self.epoch_number = 0
        self._saved = {}              # dir index -> count this epoch
        self._epoch_seen = {}         # dir index -> epoch of its gallery
        self.demand("input", "labels", "max_idx")

    def _to_image(self, arr):
        arr = numpy.asarray(arr, numpy.float32)
        if arr.ndim == 1:
            side = int(numpy.sqrt(arr.size))
            arr = arr.reshape(side, side) if side * side == arr.size \
                else arr.reshape(1, -1)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        lo, hi = float(arr.min()), float(arr.max())
        scaled = (arr - lo) / max(hi - lo, 1e-12) * 255.0
        return scaled.astype(numpy.uint8)

    @staticmethod
    def _host(value):
        mem = getattr(value, "mem", value)
        return numpy.asarray(mem)

    def run(self):
        cls = int(self.minibatch_class)
        if cls >= len(self.out_dirs) or not self.out_dirs[cls]:
            return
        out_dir = self.out_dirs[cls]
        epoch = int(self.epoch_number)
        if self._epoch_seen.get(cls) != epoch:
            # this gallery's first minibatch of a new epoch: empty it
            self._epoch_seen[cls] = epoch
            self._saved[cls] = 0
            if os.path.isdir(out_dir):
                for name in os.listdir(out_dir):
                    if name.endswith(".png"):
                        os.unlink(os.path.join(out_dir, name))
        n = int(self.minibatch_size)
        labels = self._host(self.labels)[:n]
        preds = self._host(self.max_idx)[:n]
        data = self._host(self.input)
        wrong = numpy.nonzero(labels != preds)[0]
        if not len(wrong):
            return
        os.makedirs(out_dir, exist_ok=True)
        for idx in wrong:
            count = self._saved.get(cls, 0)
            if count >= self.limit:
                return
            name = "%d_%d_%d_%05d.png" % (epoch, int(labels[idx]),
                                          int(preds[idx]), count)
            write_png(os.path.join(out_dir, name), self._to_image(data[idx]))
            self._saved[cls] = count + 1
