"""Convolutional forward layers: the port's counterpart of
:mod:`veles_tpu.znicz.conv`.

Znicz ``conv.Conv{,Tanh,Sigmoid,RELU,StrictRELU}`` with ``n_kernels``,
``kx``/``ky``, the asymmetric ``padding`` (left, right, top, bottom),
``sliding`` (x, y) and ``grouping`` (g independent channel groups,
AlexNet's two towers).  The JAX layouts hold at the boundary: NHWC
activations and ``(ky, kx, C/g, K)`` weights, so the numpy weights, the
``init`` specs, snapshots and the fused lowering's parameters carry
across as they are.  ``pure_fn`` views them as NCHW (the activations'
memory is then ``channels_last``) and ``(K, C/g, ky, kx)`` for
``F.conv2d``, cuDNN on the card, as the JAX package leaves the conv to
XLA; an asymmetric padding is an explicit pad first.  A bf16 input
gives a bf16 output with f32 sums, as the JAX conv without
``preferred_element_type`` does.

A strided conv over few channels may run as a stride-1 conv over the
space-to-depth rearranged input (:func:`_s2d_conv`, the same sum in
another order): ``pure_config`` picks it for an eligible conv
(symmetric stride > 1, at most 32 channels, C·s² ≤ 256, no grouping)
unless ``root.common.engine.s2d_conv`` is True or False, which forces
the choice for an eligible conv.  Under ``"auto"`` (the default) the
port takes the eligibility heuristic, which is what the JAX package
does when its device database holds no measured A/B (the database is
ROADMAP item 7(e)).

``pure_fn`` adds the conv's work to the ledger's tally
(:func:`veles_tpu_torch.ops.cost.conv`), and, when the forward is
recorded for a gradient, its VJP's two transposed products.  The
backward units are :class:`~veles_tpu_torch.znicz.gd_base.GDViaVJP`.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.config import root
from veles_tpu_torch.ops import cost
from veles_tpu_torch.znicz.fused import _activate
from veles_tpu_torch.znicz.gd_base import GDViaVJP
from veles_tpu_torch.znicz.nn_units import PureForward


def tally_conv(x, w, b, out, activation, dots, dot_length):
    """Add a conv's (or a transposed conv's) work to the ledger: ``dots``
    dot products of ``dot_length`` terms, each tensor's bytes once; with
    a gradient being recorded, also the VJP's input and weight products
    (the incoming gradient read, the gradients written)."""
    flops = cost.conv(dots, dot_length, b is not None, activation)
    nbytes = cost.nbytes(x, w, b, out)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        flops += cost.conv_grads(dots, dot_length, x.requires_grad,
                                 w.requires_grad)
        if x.requires_grad:
            nbytes += cost.nbytes(out, w, x)
        if w.requires_grad:
            nbytes += cost.nbytes(out, x, w)
    cost.add(flops, nbytes)


def conv_nhwc(x, w, stride, padding, groups=1):
    """The NHWC conv of ``w`` (ky, kx, C/g, K) over ``x`` (B, H, W, C):
    ``stride`` (y, x), ``padding`` (left, right, top, bottom)."""
    left, right, top, bottom = padding
    xn = x.permute(0, 3, 1, 2)
    if left == right and top == bottom:
        pad = (top, left)
    else:
        xn = F.pad(xn, (left, right, top, bottom))
        pad = (0, 0)
    out = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=tuple(stride),
                   padding=pad, groups=groups)
    return out.permute(0, 2, 3, 1)


def _s2d_conv(x, w, s, padding):
    """A stride-``s`` conv as a stride-1 conv over the space-to-depth
    input: splitting each kernel offset dy = p·s + q (q < s) regroups the
    sum into a kernel of (⌈ky/s⌉, ⌈kx/s⌉) over the s×s phases × C
    channels.  The weights are zero-padded to a multiple of s and
    regrouped the same way; the stored layout stays (ky, kx, C, K)."""
    left, right, top, bottom = padding
    ky, kx, c, n_k = w.shape
    x = F.pad(x, (0, 0, left, right, top, bottom))
    b_, h, wd, _c = x.shape
    out_h = (h - ky) // s + 1
    out_w = (wd - kx) // s + 1
    py, px = -(-ky // s), -(-kx // s)
    # spatial dims up to a multiple of s: the extra rows and columns
    # feed only windows past out_h / out_w, cropped below
    hp, wp = -(-h // s) * s, -(-wd // s) * s
    x = F.pad(x, (0, 0, 0, wp - wd, 0, hp - h))
    x = x.reshape(b_, hp // s, s, wp // s, s, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b_, hp // s, wp // s, s * s * c)
    w = F.pad(w, (0, 0, 0, 0, 0, px * s - kx, 0, py * s - ky))
    w = w.reshape(py, s, px, s, c, n_k).permute(0, 2, 1, 3, 4, 5)
    w = w.reshape(py, px, s * s * c, n_k)
    out = conv_nhwc(x, w, (1, 1), (0, 0, 0, 0))
    return out[:, :out_h, :out_w, :]


class Conv(PureForward):
    """2-D convolution; input (B, H, W, C); weights (ky, kx, C/g, K)."""

    MAPPING = "conv"
    ACTIVATION = None

    def __init__(self, workflow, **kwargs):
        super(Conv, self).__init__(workflow, **kwargs)
        self.n_kernels = kwargs["n_kernels"]
        self.kx = kwargs["kx"]
        self.ky = kwargs["ky"]
        padding = kwargs.get("padding", (0, 0, 0, 0))
        if isinstance(padding, int):
            padding = (padding,) * 4
        #: (left, right, top, bottom)
        self.padding = tuple(padding)
        self.sliding = tuple(kwargs.get("sliding", (1, 1)))
        self.grouping = int(kwargs.get("grouping", 1))

    def pure_config(self):
        sx, sy = self.sliding
        c_in = self.input.shape[-1] if self.input else None
        eligible = bool(c_in and sx == sy and sx > 1 and c_in <= 32
                        and c_in * sx * sx <= 256 and self.grouping == 1)
        s2d = eligible
        if eligible:
            forced = root.common.engine.get("s2d_conv", "auto")
            if isinstance(forced, bool):
                s2d = forced
        return {"padding": self.padding, "sliding": self.sliding,
                "activation": self.ACTIVATION, "s2d": s2d,
                "grouping": self.grouping}

    @staticmethod
    def pure_fn(params, x, padding=(0, 0, 0, 0), sliding=(1, 1),
                activation=None, s2d=False, grouping=1):
        w = params["w"]
        b = params.get("b")
        if s2d:
            if sliding[0] != sliding[1]:
                raise ValueError("s2d conv requires symmetric sliding, got "
                                 "%r" % (sliding,))
            out = _s2d_conv(x, w, sliding[0], padding)
        else:
            # sliding is (x, y); the strides are (H, W)
            out = conv_nhwc(x, w, (sliding[1], sliding[0]), padding,
                            grouping)
        tally_conv(x, w, b, out, activation, out.numel(),
                   w.shape[0] * w.shape[1] * w.shape[2])
        if b is not None:
            out = out + b
        return _activate(out, activation).to(x.dtype)

    def output_shape_for(self, input_shape):
        batch, h, w, _c = input_shape
        left, right, top, bottom = self.padding
        sx, sy = self.sliding
        out_h = (h + top + bottom - self.ky) // sy + 1
        out_w = (w + left + right - self.kx) // sx + 1
        return (batch, out_h, out_w, self.n_kernels)

    def initialize(self, device=None, **kwargs):
        super(Conv, self).initialize(device=device, **kwargs)
        c_in = self.input.shape[-1]
        if self.grouping > 1:
            if c_in % self.grouping or self.n_kernels % self.grouping:
                raise ValueError(
                    "grouping %d must divide both in-channels %d and "
                    "n_kernels %d" % (self.grouping, c_in, self.n_kernels))
            c_in //= self.grouping
        if not self.weights:
            w = numpy.zeros((self.ky, self.kx, c_in, self.n_kernels),
                            dtype=numpy.float32)
            self.fill_array(w, self.weights_filling, self.weights_stddev
                            or 1.0 / numpy.sqrt(self.kx * self.ky * c_in))
            self.weights.reset(w)
        if self.include_bias and not self.bias:
            b = numpy.zeros((self.n_kernels,), dtype=numpy.float32)
            self.fill_array(b, self.bias_filling, self.bias_stddev
                            or 1.0 / numpy.sqrt(self.kx * self.ky * c_in))
            self.bias.reset(b)
        self.output.reset(numpy.zeros(
            self.output_shape_for(self.input.shape), numpy.float32))
        self.init_vectors(self.weights, self.bias, self.output)


class ConvTanh(Conv):
    MAPPING = "conv_tanh"
    ACTIVATION = "tanh"


class ConvSigmoid(Conv):
    MAPPING = "conv_sigmoid"
    ACTIVATION = "sigmoid"


class ConvRELU(Conv):
    MAPPING = "conv_relu"
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    MAPPING = "conv_strict_relu"
    MAPPING_ALIASES = ("conv_str",)
    ACTIVATION = "strict_relu"


class GDConv(GDViaVJP):
    MAPPING = "gd_conv"


class GDConvTanh(GDViaVJP):
    MAPPING = "gd_conv_tanh"


class GDConvSigmoid(GDViaVJP):
    MAPPING = "gd_conv_sigmoid"


class GDConvRELU(GDViaVJP):
    MAPPING = "gd_conv_relu"


class GDConvStrictRELU(GDViaVJP):
    MAPPING = "gd_conv_strict_relu"
