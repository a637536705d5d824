"""Pluggable, stateful, pickleable feature normalizers: the port's
counterpart of :mod:`veles_tpu.normalization`, whole: the registry,
``normalizer_factory`` and the types ``none``, ``scale``, ``linear``,
``range_linear``, ``mean_disp``, ``exp``, ``pointwise``,
``external_mean`` and ``internal_mean``.

The contract: ``analyze(data)`` streams over the TRAIN set once to
accumulate statistics (in float64 where the JAX normalizers sum);
``normalize(data)`` edits a host batch in place and ``denormalize``
inverts it where the map is invertible; ``state`` is a picklable dict,
so a derived loader or a served model reuses the statistics without
the dataset; ``as_affine()`` is the ``(scale, shift)`` pair with
``normalize(x) == x*scale + shift`` for every sample, or None (the
stitched loader head of a u8-resident dataset applies it on the device,
``ops.gather.take_rows_norm``).  The normalizers are host numpy, as in
the JAX package; :mod:`veles_tpu_torch.ops.normalize` is the device
side of ``mean_disp``.
"""

import numpy


class NormalizerRegistry(type):
    """MAPPING name → class (ref ``normalization.py:110``)."""

    normalizers = {}

    def __init__(cls, name, bases, namespace):
        super(NormalizerRegistry, cls).__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            NormalizerRegistry.normalizers[mapping] = cls


def normalizer_factory(name, **kwargs):
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
        self.reset()

    @property
    def is_initialized(self):
        return self._initialized

    @property
    def state(self):
        """Picklable statistics dict; assignable (ref normalizer.state)."""
        return {k: v for k, v in self.__dict__.items()}

    @state.setter
    def state(self, value):
        self.__dict__.update(value)

    def reset(self):
        self._initialized = False

    def analyze(self, data):
        self._initialized = True

    def normalize(self, data):
        raise NotImplementedError

    def denormalize(self, data):
        raise NotImplementedError

    def as_affine(self):
        """``(scale, shift)`` such that ``normalize(x) == x*scale +
        shift`` for every sample, or None when this normalizer is not a
        sample-independent affine map (per-sample linear, exp, ...).

        Affine normalizers can be FUSED into a jitted train step
        (``fused_graph.lower_specs input_norm``) so the dataset stays
        device-resident in its native storage dtype — see
        ``FullBatchLoader(native_device_dtype=True)``.  scale/shift may
        be scalars or flat per-feature arrays.
        """
        return None

    def _require(self):
        if not self._initialized:
            raise RuntimeError(
                "%s used before analyze()" % type(self).__name__)


class StatelessNormalizer(NormalizerBase):
    """No statistics needed (ref ``normalization.py:260``)."""

    @property
    def is_initialized(self):
        return True

    def analyze(self, data):
        self._initialized = True


class NoneNormalizer(StatelessNormalizer):
    """Identity (ref ``:496``)."""

    MAPPING = "none"

    def normalize(self, data):
        pass

    def denormalize(self, data):
        pass

    def as_affine(self):
        return (1.0, 0.0)


class ScaleNormalizer(StatelessNormalizer):
    """Fixed multiplicative scale (e.g. ``1/255`` for byte images).

    The affine form feeds ``FullBatchLoader(native_device_dtype=True)``
    exactly: u8 pixels stay resident, the fused step multiplies
    in-program, and the trajectory is bit-identical to pre-scaled
    float32 data."""

    MAPPING = "scale"

    def __init__(self, scale=1.0 / 255.0, **kwargs):
        self.scale = float(scale)
        super(ScaleNormalizer, self).__init__(**kwargs)

    def normalize(self, data):
        data *= self.scale

    def denormalize(self, data):
        data /= self.scale

    def as_affine(self):
        return (self.scale, 0.0)


class LinearNormalizer(StatelessNormalizer):
    """Per-sample scale into [interval] by that sample's min/max
    (ref ``:347``)."""

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

    def denormalize(self, data):
        raise NotImplementedError(
            "per-sample linear normalization is not invertible without the "
            "original min/max")


class RangeLinearNormalizer(NormalizerBase):
    """Global min/max over TRAIN → scale into [interval] (ref ``:398``)."""

    MAPPING = "range_linear"

    def __init__(self, interval=(-1, 1), **kwargs):
        self.interval = tuple(interval)
        super(RangeLinearNormalizer, self).__init__(**kwargs)

    def reset(self):
        super(RangeLinearNormalizer, self).reset()
        self.gmin = None
        self.gmax = None

    def analyze(self, data):
        dmin, dmax = float(data.min()), float(data.max())
        self.gmin = dmin if self.gmin is None else min(self.gmin, dmin)
        self.gmax = dmax if self.gmax is None else max(self.gmax, dmax)
        super(RangeLinearNormalizer, self).analyze(data)

    def normalize(self, data):
        self._require()
        lo, hi = self.interval
        span = (self.gmax - self.gmin) or 1.0
        data[...] = (data - self.gmin) / span * (hi - lo) + lo

    def denormalize(self, data):
        self._require()
        lo, hi = self.interval
        span = (self.gmax - self.gmin) or 1.0
        data[...] = (data - lo) / (hi - lo) * span + self.gmin

    def as_affine(self):
        self._require()
        lo, hi = self.interval
        scale = (hi - lo) / ((self.gmax - self.gmin) or 1.0)
        return (scale, lo - self.gmin * scale)


class MeanDispersionNormalizer(NormalizerBase):
    """Per-feature ``(x - mean) / (max - min)`` accumulated over TRAIN
    (ref ``:284``); the device-side consumer is
    :func:`veles_tpu.ops.normalize.mean_disp_normalize`."""

    MAPPING = "mean_disp"

    def reset(self):
        super(MeanDispersionNormalizer, self).reset()
        self._sum = None
        self._count = 0
        self._min = None
        self._max = None

    def analyze(self, data):
        batch = data.reshape(len(data), -1).astype(numpy.float64)
        if self._sum is None:
            self._sum = batch.sum(axis=0)
            self._min = batch.min(axis=0)
            self._max = batch.max(axis=0)
        else:
            self._sum += batch.sum(axis=0)
            self._min = numpy.minimum(self._min, batch.min(axis=0))
            self._max = numpy.maximum(self._max, batch.max(axis=0))
        self._count += len(batch)
        super(MeanDispersionNormalizer, self).analyze(data)

    @property
    def mean(self):
        self._require()
        return (self._sum / max(self._count, 1)).astype(numpy.float32)

    @property
    def disp(self):
        """Reciprocal dispersion multiplier (ref multiplies by it)."""
        self._require()
        span = self._max - self._min
        return (1.0 / numpy.where(span > 0, span, 1)).astype(numpy.float32)

    def normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat[...] = (flat - self.mean) * self.disp

    def denormalize(self, data):
        flat = data.reshape(len(data), -1)
        flat[...] = flat / self.disp + self.mean

    def as_affine(self):
        disp = self.disp
        return (disp, -self.mean * disp)


class ExponentNormalizer(StatelessNormalizer):
    """Per-sample softmax-style squash: exp(x - max) / sum (ref ``:467``)."""

    MAPPING = "exp"

    def normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= flat.max(axis=1, keepdims=True)
        numpy.exp(flat, out=flat)
        flat /= flat.sum(axis=1, keepdims=True)

    def denormalize(self, data):
        raise NotImplementedError("exp normalization is not invertible")


class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map fit from TRAIN min/max into [-1, 1]
    (ref ``:511``)."""

    MAPPING = "pointwise"

    def reset(self):
        super(PointwiseNormalizer, self).reset()
        self._min = None
        self._max = None

    def analyze(self, data):
        batch = data.reshape(len(data), -1)
        bmin = batch.min(axis=0)
        bmax = batch.max(axis=0)
        if self._min is None:
            self._min, self._max = bmin.copy(), bmax.copy()
        else:
            self._min = numpy.minimum(self._min, bmin)
            self._max = numpy.maximum(self._max, bmax)
        super(PointwiseNormalizer, self).analyze(data)

    def _coeffs(self):
        span = self._max - self._min
        mul = numpy.where(span > 0, 2.0 / numpy.where(span > 0, span, 1), 0)
        add = numpy.where(span > 0, -1.0 - self._min * mul, 0)
        return mul, add

    def normalize(self, data):
        self._require()
        mul, add = self._coeffs()
        flat = data.reshape(len(data), -1)
        flat[...] = flat * mul + add

    def denormalize(self, data):
        self._require()
        mul, add = self._coeffs()
        flat = data.reshape(len(data), -1)
        flat[...] = (flat - add) / numpy.where(mul != 0, mul, 1)

    def as_affine(self):
        self._require()
        return self._coeffs()


class ExternalMeanNormalizer(StatelessNormalizer):
    """Subtract a user-supplied mean array (ref ``:593``)."""

    MAPPING = "external_mean"

    def __init__(self, mean_source=None, scale=1.0, **kwargs):
        if mean_source is None:
            raise ValueError("external_mean requires mean_source")
        if isinstance(mean_source, str):
            mean_source = numpy.load(mean_source)
        self.mean = numpy.asarray(mean_source, dtype=numpy.float32)
        self.scale = scale
        super(ExternalMeanNormalizer, self).__init__(**kwargs)

    def normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= self.mean.reshape(1, -1)
        if self.scale != 1.0:
            flat *= self.scale

    def denormalize(self, data):
        flat = data.reshape(len(data), -1)
        if self.scale != 1.0:
            flat /= self.scale
        flat += self.mean.reshape(1, -1)

    def as_affine(self):
        return (float(self.scale),
                -self.mean.reshape(-1) * float(self.scale))


class InternalMeanNormalizer(NormalizerBase):
    """Subtract the TRAIN-set mean (ref ``:636``)."""

    MAPPING = "internal_mean"

    def reset(self):
        super(InternalMeanNormalizer, self).reset()
        self._sum = None
        self._count = 0

    def analyze(self, data):
        batch = data.reshape(len(data), -1).astype(numpy.float64)
        if self._sum is None:
            self._sum = batch.sum(axis=0)
        else:
            self._sum += batch.sum(axis=0)
        self._count += len(batch)
        super(InternalMeanNormalizer, self).analyze(data)

    @property
    def mean(self):
        self._require()
        return (self._sum / max(self._count, 1)).astype(numpy.float32)

    def normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= self.mean

    def denormalize(self, data):
        flat = data.reshape(len(data), -1)
        flat += self.mean

    def as_affine(self):
        return (1.0, -self.mean.reshape(-1))
