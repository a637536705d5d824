"""The remaining Znicz layer types: the port's counterpart of
:mod:`veles_tpu.znicz.misc_units`.

``Deconv`` (the transposed convolution, weights ``(ky, kx, C, K)``
shared in layout with the paired conv), ``Cutter`` (a spatial crop),
``ChannelSplitter`` / ``ChannelMerger`` (a channel slice and a channel
concatenation of NHWC tensors), ``ResizableAll2All`` (an all2all whose
width can change between initializations, keeping the old rows and
columns), ``RPropAll2All`` (an all2all trained by iRprop−,
:class:`~veles_tpu_torch.znicz.gd_base.GDRProp`) and ``ZeroFiller``
(zeroes a masked block of a layer's weights every run).

``Deconv.pure_fn`` is ``jax.lax.conv_transpose`` without
``transpose_kernel``: a stride-1 correlation of the stride-dilated input
with the kernel as stored, padded by ``k - 1 - pad`` a side.
``F.conv_transpose2d`` correlates with the kernel flipped in both
spatial axes, so it gets the flipped kernel, and an asymmetric padding
is a crop of its unpadded output.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.units import MissingDemandedAttributes, Unit
from veles_tpu_torch.znicz.all2all import All2All
from veles_tpu_torch.znicz.conv import tally_conv
from veles_tpu_torch.znicz.fused import _activate
from veles_tpu_torch.znicz.gd_base import GDViaVJP
from veles_tpu_torch.znicz.nn_units import PureForward


def deconv_nhwc(x, w, stride, padding):
    """``jax.lax.conv_transpose(x, w, stride, ((ky-1-top, ky-1-bottom),
    (kx-1-left, kx-1-right)), ("NHWC", "HWOI", "NHWC"))``: x (B, H, W,
    K), w (ky, kx, C, K), ``stride`` (y, x), ``padding`` (left, right,
    top, bottom); (B, (H-1)·sy + ky - top - bottom, …, C)."""
    left, right, top, bottom = padding
    ky, kx = w.shape[0], w.shape[1]
    wt = w.flip(0, 1).permute(3, 2, 0, 1)       # (K, C, ky, kx)
    xn = x.permute(0, 3, 1, 2)
    if left == right and top == bottom and top < ky and left < kx:
        out = F.conv_transpose2d(xn, wt, stride=tuple(stride),
                                 padding=(top, left))
    else:
        out = F.conv_transpose2d(xn, wt, stride=tuple(stride))
        h, wd = out.shape[2], out.shape[3]
        out = out[:, :, top:h - bottom, left:wd - right]
    return out.permute(0, 2, 3, 1)


class Deconv(PureForward):
    """Transposed convolution: input (B, H, W, K) up to (B, H·sy, W·sx,
    C) with weights (ky, kx, C, K)."""

    MAPPING = "deconv"
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        super(Deconv, self).__init__(workflow, **kwargs)
        self.n_kernels = kwargs["n_kernels"]
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        padding = kwargs.get("padding", (0, 0, 0, 0))
        if isinstance(padding, int):
            padding = (padding,) * 4
        self.padding = tuple(padding)
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.output_channels = kwargs.get("output_channels")

    def pure_config(self):
        return {"padding": self.padding, "sliding": self.sliding,
                "activation": self.ACTIVATION}

    @staticmethod
    def pure_fn(params, x, padding=(0, 0, 0, 0), sliding=(1, 1),
                activation=None):
        w = params["w"]
        # sliding is (x, y); the strides are (H, W)
        out = deconv_nhwc(x, w, (sliding[1], sliding[0]), padding)
        tally_conv(x, w, None, out, activation, x.numel(),
                   w.shape[0] * w.shape[1] * w.shape[2])
        return _activate(out, activation).to(x.dtype)

    def output_shape_for(self, input_shape):
        batch, h, w, _k = input_shape
        left, right, top, bottom = self.padding
        sx, sy = self.sliding
        return (batch, (h - 1) * sy + self.ky - top - bottom,
                (w - 1) * sx + self.kx - left - right,
                self.output_channels or input_shape[-1])

    def initialize(self, device=None, **kwargs):
        super(Deconv, self).initialize(device=device, **kwargs)
        self.include_bias = False
        c_out = self.output_channels or self.input.shape[-1]
        if not self.weights:
            w = numpy.zeros((self.ky, self.kx, c_out, self.n_kernels),
                            dtype=numpy.float32)
            self.fill_array(
                w, self.weights_filling, self.weights_stddev or
                1.0 / numpy.sqrt(self.kx * self.ky * self.n_kernels))
            self.weights.reset(w)
        self.output.reset(numpy.zeros(
            self.output_shape_for(self.input.shape), numpy.float32))
        self.init_vectors(self.weights, self.output)


class GDDeconv(GDViaVJP):
    MAPPING = "gd_deconv"


class Cutter(PureForward):
    """Crops a spatial window ``(y, x, h, w)``."""

    MAPPING = "cutter"

    def __init__(self, workflow, **kwargs):
        super(Cutter, self).__init__(workflow, **kwargs)
        self.include_bias = False
        self.window = tuple(kwargs.get("window"))

    def pure_config(self):
        return {"window": self.window}

    @staticmethod
    def pure_fn(params, x, window=None):
        del params
        y, xo, h, w = window
        return x[:, y:y + h, xo:xo + w, :]

    def initialize(self, device=None, **kwargs):
        super(Cutter, self).initialize(device=device, **kwargs)
        _y, _x, h, w = self.window
        batch, _, _, c = self.input.shape
        self.output.reset(numpy.zeros((batch, h, w, c), numpy.float32))
        self.init_vectors(self.output)


class GDCutter(GDViaVJP):
    MAPPING = "gd_cutter"


class ResizableAll2All(All2All):
    """All2All whose output width can change between initializations:
    the existing rows and columns of the weights are kept on a resize."""

    MAPPING = "resizable_all2all"

    def resize(self, new_neurons):
        old_w = numpy.array(self.weights.mem) if self.weights else None
        old_b = numpy.array(self.bias.mem) if self.bias else None
        self.output_sample_shape = (int(new_neurons),)
        if old_w is not None:
            if self.weights_transposed:
                # storage (neurons, fan-in): the neuron axis leads
                w = numpy.zeros((new_neurons, old_w.shape[1]),
                                dtype=numpy.float32)
                self.fill_array(
                    w, self.weights_filling, self.weights_stddev
                    or 1.0 / numpy.sqrt(max(old_w.shape[1], 1)))
                keep = min(old_w.shape[0], new_neurons)
                w[:keep] = old_w[:keep]
            else:
                w = numpy.zeros((old_w.shape[0], new_neurons),
                                dtype=numpy.float32)
                self.fill_array(w, self.weights_filling,
                                self.weights_stddev)
                keep = min(old_w.shape[1], new_neurons)
                w[:, :keep] = old_w[:, :keep]
            self.weights.reset(w)
        if old_b is not None:
            b = numpy.zeros((new_neurons,), dtype=numpy.float32)
            keep = min(len(old_b), new_neurons)
            b[:keep] = old_b[:keep]
            self.bias.reset(b)
        self._is_initialized = False
        return self


class RPropAll2All(All2All):
    """All2All trained with resilient propagation: the paired GD unit
    (``gd_rprop``) uses sign-based per-weight step sizes."""

    MAPPING = "rprop_all2all"


class ZeroFiller(Unit):
    """Zeroes a block of ``target_unit``'s weights (``mask`` multiplies
    them) every run: a sparsity mask."""

    MAPPING = "zero_filter"

    def __init__(self, workflow, **kwargs):
        super(ZeroFiller, self).__init__(workflow, **kwargs)
        self.target_unit = None
        self.mask = kwargs.get("mask")
        self.demand("target_unit")

    def run(self):
        weights = self.target_unit.weights
        if not weights or self.mask is None:
            return
        weights.map_write()
        weights.mem[...] *= self.mask


class ChannelSplitter(PureForward):
    """A contiguous channel slice ``[start, start + count)`` of an NHWC
    tensor (``count`` None: to the end)."""

    MAPPING = "channel_splitter"

    def __init__(self, workflow, **kwargs):
        super(ChannelSplitter, self).__init__(workflow, **kwargs)
        self.include_bias = False
        self.start = int(kwargs.get("start", 0))
        self.count = kwargs.get("count")

    def pure_config(self):
        return {"start": self.start, "count": self.count}

    @staticmethod
    def pure_fn(params, x, start=0, count=None):
        del params
        stop = x.shape[-1] if count is None else start + count
        return x[..., start:stop]

    def initialize(self, device=None, **kwargs):
        super(ChannelSplitter, self).initialize(device=device, **kwargs)
        channels = self.input.shape[-1]
        count = (channels - self.start) if self.count is None \
            else self.count
        if self.start < 0 or count <= 0 or self.start + count > channels:
            raise ValueError("channel slice [%d:%d) outside %d channels"
                             % (self.start, self.start + count, channels))
        self.output.reset(numpy.zeros(self.input.shape[:-1] + (count,),
                                      numpy.float32))
        self.init_vectors(self.output)


class ChannelMerger(AcceleratedUnit):
    """Several units' NHWC outputs concatenated along the channels:
    ``link_inputs(unit_a, "output", unit_b, "output")``; spatial shapes
    must agree."""

    MAPPING = "channel_merger"

    def __init__(self, workflow, **kwargs):
        super(ChannelMerger, self).__init__(workflow, **kwargs)
        self.inputs = list(kwargs.get("inputs", ()))
        self.output = Vector()

    def link_inputs(self, *pairs):
        if len(pairs) % 2:
            raise ValueError("link_inputs takes (unit, attr) pairs")
        self._input_links = list(zip(pairs[::2], pairs[1::2]))
        return self

    def initialize(self, device=None, **kwargs):
        super(ChannelMerger, self).initialize(device=device, **kwargs)
        for unit, attr in getattr(self, "_input_links", ()):
            vec = getattr(unit, attr)
            if not any(vec is known for known in self.inputs):
                self.inputs.append(vec)
        if not self.inputs:
            raise ValueError("ChannelMerger has no inputs")
        if any(not vec for vec in self.inputs):
            # the producers are not initialized yet: requeue after them
            raise MissingDemandedAttributes(
                "%r: input Vectors not yet allocated" % self.name)
        lead = self.inputs[0].shape
        channels = 0
        for vec in self.inputs:
            if vec.shape[:-1] != lead[:-1]:
                raise ValueError("spatial shapes differ: %s vs %s"
                                 % (vec.shape, lead))
            channels += vec.shape[-1]
        self.output.reset(numpy.zeros(lead[:-1] + (channels,),
                                      numpy.float32))
        self.init_vectors(self.output, *self.inputs)

    def cuda_run(self):
        self.output.devmem = torch.cat(
            [vec.devmem for vec in self.inputs], dim=-1)
