"""Feature normalizers: the port's counterpart of
:mod:`veles_tpu.normalization`, trimmed to the registry,
``normalizer_factory`` and the stateless normalizers (``none``,
``scale``, ``linear``) and ``internal_mean`` (the TRAIN set's mean
subtracted, which the CIFAR-10 and STL-10 samples take).  The other
ones that fit statistics on the TRAIN set (``range_linear``,
``mean_disp``, ``exp``, ``pointwise``, ``external_mean``) are not
ported (ROADMAP item 7(c)).

The contract: ``analyze(data)`` streams over the TRAIN set once;
``normalize(data)`` edits a host batch in place; ``as_affine()`` is the
``(scale, shift)`` pair with ``normalize(x) == x*scale + shift`` for
every sample, or None (the stitched loader head of a u8-resident
dataset applies it, ``ops.gather.take_rows_norm``).  ``denormalize``
has no caller in the port.
"""

import numpy

#: the JAX package's normalizers the port does not have yet
_NOT_PORTED = ("range_linear", "mean_disp", "exp", "pointwise",
               "external_mean")


class NormalizerRegistry(type):
    """MAPPING name → class."""

    normalizers = {}

    def __init__(cls, name, bases, namespace):
        super(NormalizerRegistry, cls).__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            NormalizerRegistry.normalizers[mapping] = cls


def normalizer_factory(name, **kwargs):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            "normalization type %r is not ported yet (ROADMAP item "
            "7(c))"
            % name)
    try:
        klass = NormalizerRegistry.normalizers[name]
    except KeyError:
        raise ValueError(
            "unknown normalization type %r (have: %s)" %
            (name, ", ".join(sorted(NormalizerRegistry.normalizers))))
    return klass(**kwargs)


class NormalizerBase(object, metaclass=NormalizerRegistry):
    MAPPING = None

    def __init__(self, **kwargs):
        pass

    def analyze(self, data):
        """Stateless normalizers fit nothing."""

    def normalize(self, data):
        raise NotImplementedError

    def as_affine(self):
        """``(scale, shift)``, scalars or flat per-feature arrays, such
        that ``normalize(x) == x*scale + shift`` for every sample; None
        when the normalizer is not a sample-independent affine map."""
        return None


class NoneNormalizer(NormalizerBase):
    """Identity."""

    MAPPING = "none"

    def normalize(self, data):
        pass

    def as_affine(self):
        return (1.0, 0.0)


class ScaleNormalizer(NormalizerBase):
    """Fixed multiplicative scale (``1/255`` for byte images)."""

    MAPPING = "scale"

    def __init__(self, scale=1.0 / 255.0, **kwargs):
        self.scale = float(scale)
        super(ScaleNormalizer, self).__init__(**kwargs)

    def normalize(self, data):
        data *= self.scale

    def as_affine(self):
        """The u8 dataset scaled by the head gives pre-scaled float32's
        trajectory: both multiply by ``float32(scale)``."""
        return (self.scale, 0.0)


class LinearNormalizer(NormalizerBase):
    """Each sample scaled into ``interval`` by its own min and max."""

    MAPPING = "linear"

    def __init__(self, interval=(-1, 1), **kwargs):
        self.interval = tuple(interval)
        super(LinearNormalizer, self).__init__(**kwargs)

    def normalize(self, data):
        lo, hi = self.interval
        flat = data.reshape(len(data), -1)
        dmin = flat.min(axis=1, keepdims=True)
        dmax = flat.max(axis=1, keepdims=True)
        span = numpy.where(dmax > dmin, dmax - dmin, 1)
        flat[...] = (flat - dmin) / span * (hi - lo) + lo


class InternalMeanNormalizer(NormalizerBase):
    """Subtract the TRAIN set's mean sample (summed in float64 over every
    ``analyze`` call, as the JAX normalizer sums it)."""

    MAPPING = "internal_mean"

    def __init__(self, **kwargs):
        self._sum = None
        self._count = 0
        super(InternalMeanNormalizer, self).__init__(**kwargs)

    def analyze(self, data):
        batch = data.reshape(len(data), -1).astype(numpy.float64)
        if self._sum is None:
            self._sum = batch.sum(axis=0)
        else:
            self._sum += batch.sum(axis=0)
        self._count += len(batch)

    @property
    def mean(self):
        if self._sum is None:
            raise RuntimeError("InternalMeanNormalizer used before "
                               "analyze()")
        return (self._sum / max(self._count, 1)).astype(numpy.float32)

    def normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= self.mean

    def as_affine(self):
        return (1.0, -self.mean.reshape(-1))
