"""Image loading pipeline: the port's counterpart of
:mod:`veles_tpu.loader.image`.

``FileFilter`` scans directories by extension and pattern;
``ImageLoader`` decodes per-class keys on the fly and scales, resizes,
rotates (blending a background into the exposed corners), crops,
mirrors and appends a Sobel channel, with the augmentation draws from
the ``loader`` stream, so a seed gives the JAX loader's minibatches;
``FileImageLoader`` / ``AutoLabelFileImageLoader`` take the keys from
per-class paths (the label the parent directory's name);
``ImageLoaderMSE`` pairs each input with a target image under the same
draws; ``FullBatchImageLoader`` decodes the whole set once into the
device-resident :class:`~veles_tpu_torch.loader.fullbatch
.FullBatchLoader` layout.  Decoding is host work (PIL and numpy), as in
the JAX package; PIL is imported at the first decode, so importing the
port needs none.
"""


import os
import re

import numpy

from veles_tpu_torch.loader.base import (Loader, LoaderError, TEST, TRAIN,
                                        VALID)
from veles_tpu_torch.loader.fullbatch import FullBatchLoader

MODE_COLOR_MAP = {
    "1": "GRAY", "L": "GRAY", "P": "RGB", "RGB": "RGB", "RGBA": "RGBA",
    "CMYK": "RGB", "YCbCr": "YCR_CB", "I": "GRAY", "F": "GRAY",
}


def _pil():
    try:
        from PIL import Image
    except ImportError:
        raise LoaderError(
            "PIL is required for image loaders (pip install pillow)")
    return Image


class FileFilter(object):
    """Directory scanner with extension + regex filters
    (ref ``file_loader.py:54``)."""

    DEFAULT_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif",
                          ".tif", ".tiff", ".ppm", ".pgm")

    def __init__(self, extensions=None, ignored_files=(),
                 included_files=(".*",)):
        self.extensions = tuple(
            e.lower() for e in (extensions or self.DEFAULT_EXTENSIONS))
        self.ignored_files = [re.compile(p) for p in ignored_files]
        self.included_files = [re.compile(p) for p in included_files]

    def matches(self, name):
        if os.path.splitext(name)[1].lower() not in self.extensions:
            return False
        if any(p.match(name) for p in self.ignored_files):
            return False
        return any(p.match(name) for p in self.included_files)

    def scan(self, path):
        """Yield matching file paths under ``path`` (sorted, recursive)."""
        if os.path.isfile(path):
            if self.matches(os.path.basename(path)):
                yield path
            return
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for name in sorted(files):
                if self.matches(name):
                    yield os.path.join(root, name)


class ImageLoader(Loader):
    """On-the-fly image loader over per-class *keys* (usually file
    paths).  Subclasses supply ``get_keys(class_index)`` and
    ``load_key(key) -> ndarray`` (HWC uint8/float); this base handles
    scale / crop / mirror / color conversion (ref ``image.py:106``).

    Parameters (ref ``image.py`` ctor kwargs):
      - ``size`` — (W, H) target; images are resized to it.
      - ``scale`` — float uniform pre-scale before crop.
      - ``crop`` — (W, H) random crop taken after scaling (TRAIN only;
        center crop for TEST/VALID).
      - ``mirror`` — random horizontal flip on TRAIN samples.
      - ``color_space`` — "RGB" | "GRAY".
      - ``normalization_type`` — as in :class:`Loader`.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.size = tuple(kwargs.get("size", (32, 32)))
        self.scale = kwargs.get("scale", 1.0)
        self.crop = kwargs.get("crop")
        self.mirror = kwargs.get("mirror", False)
        self.color_space = kwargs.get("color_space", "RGB")
        #: tuple of angles in RADIANS; every key yields one sample per
        #: rotation (the reference's samples_inflation,
        #: ref ``image.py:294-312``) — (0.0,) = no inflation
        rot = kwargs.get("rotations", (0.0,))
        if not isinstance(rot, (tuple, list)) or not rot:
            raise LoaderError("rotations must be a non-empty tuple "
                              "of radians (got %r)" % (rot,))
        self.rotations = tuple(float(r) for r in rot)
        #: exposed-corner fill after rotation: an HWC array blended in
        #: (ref ``image.py:316-341``) or a per-channel color tuple
        #: (ref ``:344``); image wins when both are set, default zeros
        self.background_image = kwargs.get("background_image")
        self.background_color = kwargs.get("background_color")
        #: append a Sobel gradient-magnitude channel (ref
        #: ``image.py:484`` — intent re-implemented: the reference's
        #: ``linalg.norm(sobel_xy)`` collapses to a SCALAR; here the
        #: channel is the per-pixel magnitude)
        self.add_sobel = bool(kwargs.get("add_sobel", False))
        #: random crops drawn per (key, rotation) sample — a further
        #: inflation factor (ref ``image.py`` crop_number); needs
        #: ``crop`` to mean anything beyond 1
        self.crop_number = int(kwargs.get("crop_number", 1))
        if self.crop_number < 1:
            raise LoaderError("crop_number must be >= 1")
        if self.crop_number > 1 and not kwargs.get("crop"):
            raise LoaderError("crop_number > 1 requires crop=")
        self.keys = [[], [], []]
        self.labels = [[], [], []]
        super(ImageLoader, self).__init__(workflow, **kwargs)

    # -- subclass contract --------------------------------------------------
    def get_keys(self, class_index):
        raise NotImplementedError

    def get_label(self, key, class_index):
        """Default: unlabeled."""
        return None

    def load_key(self, key):
        """Decode one image to an HWC numpy array."""
        Image = _pil()
        with Image.open(key) as img:
            if self.color_space == "GRAY":
                img = img.convert("L")
            else:
                img = img.convert("RGB")
            return numpy.asarray(img)

    # -- geometry -----------------------------------------------------------
    @property
    def channels(self):
        base = 1 if self.color_space == "GRAY" else 3
        return base + (1 if self.add_sobel else 0)

    @property
    def _decode_channels(self):
        """Channels as decoded, before the appended Sobel plane."""
        return 1 if self.color_space == "GRAY" else 3

    @property
    def sample_shape(self):
        if self.crop:
            wh = self.crop
        elif self.scale != 1.0:
            # no crop: preprocess() resizes to size*scale — the buffer
            # must match the scaled geometry
            wh = (max(1, int(round(self.size[0] * self.scale))),
                  max(1, int(round(self.size[1] * self.scale))))
        else:
            wh = self.size
        return (wh[1], wh[0], self.channels)

    @property
    def samples_inflation(self):
        """Samples per source key: one per (rotation, crop draw) pair
        (ref ``image.py:311``; the reference also doubles for
        mirror=True — here mirror stays a random TRAIN flip, not an
        inflation)."""
        return len(self.rotations) * self.crop_number

    def _background(self, shape):
        """HWC float32 fill for rotation-exposed corners."""
        if self.background_image is not None:
            bg = numpy.asarray(self.background_image, numpy.float32)
            if bg.ndim == 2:
                bg = bg[:, :, None]
            if bg.shape != tuple(shape):
                raise LoaderError(
                    "background_image shape %s != rotated pre-crop "
                    "image shape %s — rotation (and its background "
                    "fill) happens BEFORE crop, so the background "
                    "must match the resized geometry, not sample_shape"
                    " (ref image.py:329 validates the same stage)"
                    % (bg.shape, tuple(shape)))
            return bg
        if self.background_color is not None:
            color = numpy.asarray(self.background_color, numpy.float32)
            if color.size != shape[-1]:
                raise LoaderError(
                    "background_color %s must have %d channels"
                    % (self.background_color, shape[-1]))
            return numpy.broadcast_to(color, shape)
        return numpy.zeros(shape, numpy.float32)

    def _rotate(self, image, angle):
        """Rotate an HWC array by ``angle`` radians about its center,
        blending :meth:`_background` into the exposed corners (ref
        ``image.py`` background_image/background_color semantics)."""
        import math

        Image = _pil()
        degrees = math.degrees(angle)
        # per-channel float-mode rotation: load_key's contract allows
        # float images (class docstring), and a uint8 round-trip would
        # truncate them (a [0,1] image came back all zeros —
        # code-review r5); mode "F" preserves any numeric range
        img32 = numpy.asarray(image, numpy.float32)
        rot = numpy.stack([
            numpy.asarray(Image.fromarray(img32[:, :, c], "F")
                          .rotate(degrees, Image.BILINEAR))
            for c in range(img32.shape[-1])], axis=-1)
        # an all-opaque mask rotated the same way marks the exposed
        # (out-of-frame) pixels exactly, including the anti-aliased rim
        h, w = img32.shape[:2]
        mask = numpy.asarray(Image.new("L", (w, h), 255)
                             .rotate(degrees, Image.BILINEAR))
        mask = (mask.astype(numpy.float32) / 255.0)[:, :, None]
        bg = self._background(rot.shape)
        return rot * mask + bg * (1.0 - mask)

    def preprocess(self, image, train, rotation=0.0, decisions=None,
                   crop_index=0):
        """scale → resize to ``size`` → rotate (background-blended) →
        crop → mirror → float32 HWC.

        ``decisions``: a mutable dict capturing this call's random
        augmentation draws (crop offset, mirror flag) so a SECOND
        tensor — the MSE target — can replay them and stay
        geometrically aligned with its input.

        ``crop_index``: the inflated sample's crop sub-index; under
        ``crop_number > 1`` non-train samples take the DETERMINISTIC
        anchor for that index (center/corners/golden-walk — the
        classic multi-crop eval) instead of crop_number identical
        center crops."""
        Image = _pil()
        if image.ndim == 2:
            image = image[:, :, None]
        size = self.size
        if self.scale != 1.0:
            size = (max(1, int(round(size[0] * self.scale))),
                    max(1, int(round(size[1] * self.scale))))
        if image.shape[1::-1] != size:
            pil = Image.fromarray(image.squeeze(-1)
                                  if self._decode_channels == 1
                                  else image)
            image = numpy.asarray(pil.resize(size, Image.BILINEAR))
            if image.ndim == 2:
                image = image[:, :, None]
        if rotation:
            image = self._rotate(image, rotation)
        if self.crop:
            cw, ch = self.crop
            h, w = image.shape[:2]
            if ch > h or cw > w:
                raise LoaderError("crop %s larger than image %s"
                                  % ((cw, ch), (w, h)))
            if decisions is not None and "crop" in decisions:
                y, x = decisions["crop"]
            elif train:
                y = int(self.prng.randint(0, h - ch + 1))
                x = int(self.prng.randint(0, w - cw + 1))
            elif self.crop_number > 1:
                ay, ax = self._crop_anchor(crop_index)
                y = int(round(ay * (h - ch)))
                x = int(round(ax * (w - cw)))
            else:
                y, x = (h - ch) // 2, (w - cw) // 2
            if decisions is not None:
                decisions["crop"] = (y, x)
            image = image[y:y + ch, x:x + cw]
        if self.mirror:
            if decisions is not None and "mirror" in decisions:
                flip = decisions["mirror"]
            else:
                flip = bool(train and self.prng.randint(0, 2))
            if decisions is not None:
                decisions["mirror"] = flip
            if flip:
                image = image[:, ::-1]
        image = numpy.ascontiguousarray(image, dtype=numpy.float32)
        if self.add_sobel:
            image = numpy.concatenate(
                [image, self._sobel_channel(image)], axis=-1)
        return image

    @staticmethod
    def _sobel_channel(image):
        """Per-pixel Sobel gradient magnitude of the luma, (H, W, 1)
        float32 (ref ``image.py:484`` add_sobel_channel — intent, not
        the scalar-norm bug).  Pure numpy: same-padded 3x3 separable
        convolution."""
        gray = image.mean(axis=-1)
        p = numpy.pad(gray, 1, mode="edge")
        # Gx = [1,0,-1] ⊗ [1,2,1]ᵀ ; Gy = Gxᵀ
        smooth_y = p[:-2] + 2.0 * p[1:-1] + p[2:]      # vertical [1,2,1]
        gx = smooth_y[:, :-2] - smooth_y[:, 2:]
        smooth_x = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]
        gy = smooth_x[:-2] - smooth_x[2:]
        return numpy.hypot(gx, gy).astype(numpy.float32)[:, :, None]

    # -- ILoader ------------------------------------------------------------
    def load_data(self):
        infl = self.samples_inflation
        for class_index in (TEST, VALID, TRAIN):
            keys = sorted(self.get_keys(class_index))
            self.keys[class_index] = keys
            self.labels[class_index] = [
                self.get_label(key, class_index) for key in keys]
            # every key contributes one sample per rotation (ref
            # ``image.py:630``: len(keys) * samples_inflation)
            self.class_lengths[class_index] = len(keys) * infl
        self._flat_keys = sum(self.keys, [])
        self._flat_labels = sum(self.labels, [])
        self._has_labels = any(
            label is not None for label in self._flat_labels)

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape,
            dtype=numpy.float32))

    def _decode_index(self, idx):
        """Global sample index → (flat key index, rotation angle,
        crop sub-index) — the reference's divmod decode
        (``image.py:766``), crop index fastest-varying."""
        key_idx, sub = divmod(int(idx), self.samples_inflation)
        rot_idx, crop_i = divmod(sub, self.crop_number)
        return key_idx, self.rotations[rot_idx], crop_i

    def _key_and_rotation(self, idx):
        key_idx, rotation, _crop_i = self._decode_index(idx)
        return key_idx, rotation

    #: deterministic multi-crop anchors (fractions of the slack): the
    #: classic center + 4-corner eval crops, then a golden-ratio walk
    #: for larger crop_number — DIVERSE and reproducible, so eval (and
    #: the full-batch resident decode) never stores crop_number copies
    #: of one center crop (code-review r5)
    _CROP_ANCHORS = ((0.5, 0.5), (0.0, 0.0), (0.0, 1.0), (1.0, 0.0),
                     (1.0, 1.0))

    def _crop_anchor(self, crop_i):
        if crop_i < len(self._CROP_ANCHORS):
            return self._CROP_ANCHORS[crop_i]
        t = (crop_i * 0.6180339887498949) % 1.0
        u = (crop_i * 0.7548776662466927) % 1.0
        return t, u

    def fill_minibatch(self):
        self.minibatch_data.map_write()
        self.minibatch_indices.map_read()
        train = self.minibatch_class == TRAIN
        for i, idx in enumerate(
                self.minibatch_indices.mem[:self.minibatch_size]):
            if idx < 0:
                self.minibatch_data.mem[i] = 0
                self.raw_minibatch_labels[i] = None
                continue
            key_idx, rotation, crop_i = self._decode_index(idx)
            image = self.load_key(self._flat_keys[key_idx])
            self.minibatch_data.mem[i] = self.preprocess(
                image, train, rotation=rotation, crop_index=crop_i)
            self.raw_minibatch_labels[i] = self._flat_labels[key_idx]


class FileImageLoader(ImageLoader):
    """Images from per-class directory lists
    (ref ``file_image.py:150``): ``test_paths`` / ``validation_paths`` /
    ``train_paths`` each a list of files or directories."""

    def __init__(self, workflow, **kwargs):
        self.test_paths = list(kwargs.get("test_paths", ()))
        self.validation_paths = list(kwargs.get("validation_paths", ()))
        self.train_paths = list(kwargs.get("train_paths", ()))
        self.file_filter = kwargs.get("file_filter") or FileFilter(
            extensions=kwargs.get("extensions"),
            ignored_files=kwargs.get("ignored_files", ()),
            included_files=kwargs.get("included_files", (".*",)))
        super(FileImageLoader, self).__init__(workflow, **kwargs)

    def get_keys(self, class_index):
        paths = (self.test_paths, self.validation_paths,
                 self.train_paths)[class_index]
        keys = []
        for path in paths:
            keys.extend(self.file_filter.scan(path))
        return keys


class AutoLabelFileImageLoader(FileImageLoader):
    """Label = name of the image's parent directory
    (ref ``file_image.py:177``)."""

    def get_label(self, key, class_index):
        return os.path.basename(os.path.dirname(key))


class ImageLoaderMSE(ImageLoader):
    """Image → target-image pairs for regression workflows (ref
    ``image_mse.py:46`` ``ImageLoaderMSEMixin``/``ImageLoaderMSE``):
    inputs come from the usual per-class key space; each sample's
    TARGET image is :meth:`load_target` of :meth:`get_target_key` —
    by default the input key itself (the denoising/reconstruction-AE
    recipe, where :meth:`load_key` may corrupt and the target stays
    clean).  Subclasses with separate target sets override
    ``get_target_key`` to map a label to its target key (the
    reference's ``target_label_map``).

    Input and target share ONE set of augmentation draws per sample
    (rotation, crop offset, mirror flag — the ``decisions`` replay in
    :meth:`ImageLoader.preprocess`), so their geometry stays aligned
    even under random TRAIN augmentation."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        from veles_tpu_torch.memory import Vector
        self.minibatch_targets = Vector()
        super(ImageLoaderMSE, self).__init__(workflow, **kwargs)

    def load_target(self, key):
        """Decode the clean target for ``key``; default = the input
        decode (override to read from a separate target set)."""
        return ImageLoader.load_key(self, key)

    def get_target_key(self, key, label):
        """Input key/label → target key (ref ``target_label_map``,
        ``image_mse.py:79``); default: identity."""
        return key

    def create_minibatch_data(self):
        super(ImageLoaderMSE, self).create_minibatch_data()
        self.minibatch_targets.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape,
            dtype=numpy.float32))

    def fill_minibatch(self):
        # joint fill (no super() delegate): each sample's input and
        # target must replay the SAME random crop/mirror draws
        self.minibatch_data.map_write()
        self.minibatch_targets.map_write()
        self.minibatch_indices.map_read()
        train = self.minibatch_class == TRAIN
        for i, idx in enumerate(
                self.minibatch_indices.mem[:self.minibatch_size]):
            if idx < 0:
                self.minibatch_data.mem[i] = 0
                self.minibatch_targets.mem[i] = 0
                self.raw_minibatch_labels[i] = None
                continue
            key_idx, rotation, crop_i = self._decode_index(idx)
            key = self._flat_keys[key_idx]
            label = self._flat_labels[key_idx]
            decisions = {}
            self.minibatch_data.mem[i] = self.preprocess(
                self.load_key(key), train, rotation=rotation,
                decisions=decisions, crop_index=crop_i)
            self.minibatch_targets.mem[i] = self.preprocess(
                self.load_target(self.get_target_key(key, label)),
                train, rotation=rotation, decisions=decisions,
                crop_index=crop_i)
            self.raw_minibatch_labels[i] = label


class FullBatchImageLoader(FullBatchLoader):
    """Whole image set decoded once into the device-resident dataset
    (ref ``fullbatch_image.py:56``): wraps any :class:`ImageLoader`
    subclass's key space eagerly.  Use for datasets that fit in the
    card's memory: the per-step path is then a device gather."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        # the embedded on-the-fly loader does the decode/preprocess work
        self._image_loader_class = kwargs.pop(
            "image_loader_class", FileImageLoader)
        self._image_kwargs = dict(kwargs)
        super(FullBatchImageLoader, self).__init__(workflow, **kwargs)

    def load_data(self):
        from veles_tpu_torch.dummy import DummyWorkflow
        sub = self._image_loader_class(
            DummyWorkflow(), **self._image_kwargs)
        sub.load_data()
        total = sum(sub.class_lengths)
        if total == 0:
            raise LoaderError("no images found")
        data = numpy.zeros((total,) + sub.sample_shape,
                           dtype=numpy.float32)
        labels = []
        # one resident row per INFLATED sample: the sub-loader's
        # class_lengths already count len(keys) x samples_inflation,
        # and each (key, rotation) pair gets its own decoded row +
        # label (a fill keyed on _flat_keys alone left the inflated
        # rows zero and the labels truncated — code-review r5)
        for i in range(total):
            key_idx, rotation, crop_i = sub._decode_index(i)
            data[i] = sub.preprocess(sub.load_key(
                sub._flat_keys[key_idx]), train=False,
                rotation=rotation, crop_index=crop_i)
            labels.append(sub._flat_labels[key_idx])
        self.original_data.mem = data
        if any(label is not None for label in labels):
            self.original_labels = labels
        self.class_lengths[:] = sub.class_lengths
