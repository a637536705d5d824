"""Named deterministic random streams: the port's counterpart of
:mod:`veles_tpu.prng`.

Each named stream is the JAX package's numpy side copied exactly: a
``numpy.random.Generator(Philox(key=seed))`` with the stream's seed
derived from the global base seed and a hash of its name.  So
``seed_all(s)`` gives the port the JAX package's initial weights
(``forward_init``) and epoch shuffles (``loader``) bit for bit, and
``randint`` the int32 seeds of dropout and stochastic pooling
(``dropout``, ``stochastic_pooling``), whose masks
:mod:`veles_tpu_torch.ops.random`'s threefry gives as JAX's
``jax.random`` gives them.  The JAX stream's own ``key()`` (a
``fold_in`` of the stream's seed) has no caller in the ported units and
is not ported.  A stream pickles its exact Philox position
(the JAX package's state dict): :class:`veles_tpu_torch.checkpoint
.TrainCheckpointer` carries every stream's state in its meta, so a
restored run draws from where the saved one stood.  The streams are the
process's, not a workflow's: a workflow snapshot does not hold them.
"""

import hashlib
import os
import threading

import numpy

_streams = {}
_base_seed = 0x5eed
_lock = threading.Lock()


class RandomGenerator(object):
    """A named deterministic stream over numpy's Philox."""

    def __init__(self, name, seed=None):
        self.name = name
        self.seed(seed if seed is not None else 0x5eed)

    def seed(self, seed):
        """Seed from an int, bytes, or the first 64 bytes of a file."""
        if isinstance(seed, str) and os.path.exists(seed):
            with open(seed, "rb") as fin:
                seed = fin.read(64)
        if isinstance(seed, (bytes, bytearray)):
            seed = int.from_bytes(
                hashlib.sha256(bytes(seed)).digest()[:8], "little")
        self._seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        self._counter = 0
        self._numpy = numpy.random.Generator(
            numpy.random.Philox(key=self._seed))
        return self

    def shuffle(self, arr):
        self._counter += 1
        self._numpy.shuffle(arr)

    def permutation(self, n):
        self._counter += 1
        return self._numpy.permutation(n)

    def fill_normal(self, arr, stddev=1.0, mean=0.0):
        self._counter += 1
        arr[...] = self._numpy.normal(
            loc=mean, scale=stddev, size=arr.shape).astype(arr.dtype)

    def fill_uniform(self, arr, low=-1.0, high=1.0):
        self._counter += 1
        arr[...] = self._numpy.uniform(
            low=low, high=high, size=arr.shape).astype(arr.dtype)

    def randint(self, low, high=None, size=None):
        self._counter += 1
        return self._numpy.integers(low, high, size=size)

    def __getstate__(self):
        return {"name": self.name, "seed": self._seed,
                "counter": self._counter,
                "numpy_state": self._numpy.bit_generator.state}

    def __setstate__(self, state):
        self.name = state["name"]
        self._seed = state["seed"]
        self._counter = state["counter"]
        self._numpy = numpy.random.Generator(
            numpy.random.Philox(key=self._seed))
        self._numpy.bit_generator.state = state["numpy_state"]

    def __repr__(self):
        return "<RandomGenerator %r seed=%#x n=%d>" % (
            self.name, self._seed, self._counter)


def _derived_seed(name):
    offset = int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:4], "little")
    return _base_seed + offset


def get(name="master"):
    """The named stream (created on first use from the base seed)."""
    with _lock:
        stream = _streams.get(name)
        if stream is None:
            stream = _streams[name] = RandomGenerator(
                name, seed=_derived_seed(name))
        return stream


def seed_all(seed):
    """Set the global base seed and reseed every stream, each offset by
    a hash of its name."""
    global _base_seed
    with _lock:
        _base_seed = int(seed)
        for name, stream in _streams.items():
            stream.seed(_derived_seed(name))
        if "master" not in _streams:
            _streams["master"] = RandomGenerator(
                "master", seed=_derived_seed("master"))
