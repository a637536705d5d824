"""Local response normalization and dropout: the port's counterpart of
:mod:`veles_tpu.znicz.normalization_units`.

LRN (Znicz ``normalization.LRNormalizer{Forward,Backward}``): across
channels, ``x / (k + α·Σ x²)^β`` over a window of ``n`` channels, the
window sum taken as the JAX unit takes it, the n shifted squares added
one after another (``F.local_response_norm`` divides α by n and sums in
another order).  At β = 0.75 the power is ``rsqrt(t)·rsqrt(sqrt(t))``,
as in the JAX unit; its rounding differs from XLA's rsqrt by a few ulp.

Dropout (Znicz ``dropout.Dropout{Forward,Backward}``): inverted
dropout whose mask is ``jax.random.bernoulli(jax.random.key(seed),
keep, shape)``'s, from the int32 ``seed`` in the unit's
``pure_params`` (:func:`veles_tpu_torch.ops.random.threefry_bernoulli`,
the same bits), so the port drops what the JAX package drops.  The
eager unit draws a seed from the ``dropout`` stream at every TRAIN run
and its backward replays it; ``forward_mode`` (the workflow's
``ClassSkipGate``: true off TRAIN) makes both a passthrough.  The unit
is ``SKIP_AT_EVAL``: the fused eval step leaves it out.  Dropout stays a
stitching barrier, as in the JAX package.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch import prng
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.random import threefry_bernoulli
from veles_tpu_torch.znicz.gd_base import GDViaVJP
from veles_tpu_torch.znicz.nn_units import PureForward


class LRNormalizerForward(PureForward):
    """Across-channel LRN: x / (k + α·Σ_{n window} x²)^β."""

    MAPPING = "lrn"
    MAPPING_ALIASES = ("norm",)

    def __init__(self, workflow, **kwargs):
        super(LRNormalizerForward, self).__init__(workflow, **kwargs)
        self.include_bias = False
        self.alpha = kwargs.get("alpha", 1e-4)
        self.beta = kwargs.get("beta", 0.75)
        self.k = kwargs.get("k", 2.0)
        self.n = kwargs.get("n", 5)

    def pure_config(self):
        return {"alpha": self.alpha, "beta": self.beta, "k": self.k,
                "n": self.n}

    @staticmethod
    def pure_fn(params, x, alpha=1e-4, beta=0.75, k=2.0, n=5):
        del params
        half = n // 2
        channels = x.shape[-1]
        padded = F.pad(x * x, (half, n - 1 - half))
        window = torch.zeros_like(x)
        for i in range(n):
            window = window + padded[..., i:i + channels]
        t = k + alpha * window
        cost.add((n + cost.LRN_FLOPS) * x.numel(), 2 * cost.nbytes(x))
        if beta == 0.75:
            inv = torch.rsqrt(t) * torch.rsqrt(torch.sqrt(t))
            return (x * inv).to(x.dtype)
        return (x / t ** beta).to(x.dtype)

    def initialize(self, device=None, **kwargs):
        super(LRNormalizerForward, self).initialize(device=device,
                                                    **kwargs)
        self.output.reset(numpy.zeros(self.input.shape, numpy.float32))
        self.init_vectors(self.output)


class LRNormalizerBackward(GDViaVJP):
    MAPPING = "gd_lrn"


class DropoutForward(PureForward):
    """Inverted dropout; the identity while ``forward_mode`` is true."""

    MAPPING = "dropout"
    #: the fused eval step leaves the layer out (inverted dropout is the
    #: identity at inference)
    SKIP_AT_EVAL = True

    def __init__(self, workflow, **kwargs):
        super(DropoutForward, self).__init__(workflow, **kwargs)
        self.include_bias = False
        self.dropout_ratio = kwargs.get("dropout_ratio", 0.5)
        #: identity passthrough (set True off TRAIN)
        self.forward_mode = Bool(False)

    def pure_config(self):
        return {"keep": 1.0 - self.dropout_ratio}

    @staticmethod
    def pure_fn(params, x, keep=0.5):
        mask = threefry_bernoulli(params["seed"], keep, x.shape, x.device)
        cost.add(2 * x.numel(), 2 * cost.nbytes(x))
        # x / keep as XLA computes it: the product with the float32
        # reciprocal of the constant
        scale = float(numpy.float32(1.0) / numpy.float32(keep))
        return torch.where(mask, x * scale, 0.0).to(x.dtype)

    def pure_params(self, host=False):
        seed = numpy.int32(getattr(self, "_last_seed", 0))
        return {"seed": seed if host else torch.tensor(
            seed, device=self.device.torch_device)}

    def initialize(self, device=None, **kwargs):
        super(DropoutForward, self).initialize(device=device, **kwargs)
        self.output.reset(numpy.zeros(self.input.shape, numpy.float32))
        self.init_vectors(self.output)

    def cuda_run(self):
        if bool(self.forward_mode):
            self.output.devmem = self.input.devmem
            return
        self._last_seed = int(prng.get("dropout").randint(0, 2 ** 31))
        super(DropoutForward, self).cuda_run()


class DropoutBackward(GDViaVJP):
    """Replays the forward's mask through the shared seed; a passthrough
    while the forward's ``forward_mode`` is true."""

    MAPPING = "gd_dropout"

    def run(self):
        if bool(getattr(self.forward, "forward_mode", False)):
            if self.need_err_input:
                self.err_input.devmem = self.err_output.devmem
            return
        super(DropoutBackward, self).run()
