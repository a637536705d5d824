"""Pooling layers and their gradients: the port's counterpart of
:mod:`veles_tpu.znicz.pooling`.

Znicz ``pooling.{Max, MaxAbs, Avg, Stochastic, StochasticAbs}Pooling``
with ``kx``/``ky``/``sliding`` over NHWC activations.  ``max`` and
``avg`` are ``F.max_pool2d`` / ``F.avg_pool2d`` over the NCHW view of
the NHWC tensor (``channels_last`` memory, as cuDNN takes it): their
gradients go, as JAX's ``reduce_window`` VJPs send them, to the first
maximal element of a window (the strict ``>`` scan of both) or evenly
over it.  The selective kinds (``maxabs``, ``stochastic``,
``stochasticabs``) take explicit window patches (``Tensor.unfold``, the
window index row-major over (ky, kx) as the JAX patches order it) and
pick one element a window: by ``|x|`` for maxabs (the output keeps the
sign); with probability ∝ ``|x|`` for the stochastic kinds (Zeiler &
Fergus), drawing one threefry uniform a window from the unit's int32
``seed`` (:func:`veles_tpu_torch.ops.random.threefry_uniform`, the bits
of ``jax.random.uniform``) and taking the first window position whose
cumulative probability reaches it; the cumulative sum adds one term at
a time, in JAX's order on the CPU, so the same draw picks the same
element.
``stochasticabs`` outputs the magnitude.

``store_offsets`` records each window's choice for a :class:`Depooling`
(the decoder half of a conv autoencoder); :class:`StochasticPooling
Depooling` pools and depools in one unit.  The eager unit draws a fresh
seed from the ``stochastic_pooling`` stream at every run, and its
backward replays that seed, so a stochastic pooling (like a depooling,
whose ``pure_params`` holds its offsets, and a pooling that stores
offsets) is a stitching barrier.  ``pure_fn`` tallies one operation an
input element of each window and the tensors' bytes.
"""

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch import prng
from veles_tpu_torch.memory import Vector
from veles_tpu_torch.ops import cost
from veles_tpu_torch.ops.random import threefry_uniform
from veles_tpu_torch.znicz.gd_base import GDViaVJP
from veles_tpu_torch.znicz.nn_units import PureForward

_STOCHASTIC = ("stochastic", "stochasticabs")


def _extract_patches(x, kx, ky, sliding):
    """(b, out_h, out_w, ky*kx, c) window patches."""
    b, _h, _w, c = x.shape
    p = x.unfold(1, ky, sliding[1]).unfold(2, kx, sliding[0])
    oh, ow = p.shape[1], p.shape[2]             # (b, oh, ow, c, ky, kx)
    return p.reshape(b, oh, ow, c, ky * kx).permute(0, 1, 2, 4, 3)


def _cumsum(elems, axis):
    """The inclusive cumulative sum along ``axis``, one term at a time in
    order (``c[i] = c[i-1] + e[i]``), as XLA sums ``jnp.cumsum`` on the
    CPU: a window axis is short, and the same order rounds the same."""
    terms = elems.unbind(axis)
    out = [terms[0]]
    for term in terms[1:]:
        out.append(out[-1] + term)
    return torch.stack(out, dim=axis)


def _select_window(patches, kind, params):
    """Each window's chosen element → ((b, oh, ow, c), the choice's index
    (b, oh, ow, 1, c) in [0, ky*kx))."""
    magnitude = torch.abs(patches)
    if kind in ("max", "maxabs"):
        source = patches if kind == "max" else magnitude
        sel = torch.argmax(source, dim=3, keepdim=True)
    else:
        probs = magnitude / torch.clamp(
            magnitude.sum(dim=3, keepdim=True), min=1e-12)
        cum = _cumsum(probs.detach(), 3)
        b, oh, ow, _k, c = patches.shape
        u = threefry_uniform(params["seed"], (b, oh, ow, 1, c),
                             patches.device)
        sel = torch.argmax((cum >= u).to(torch.int8), dim=3, keepdim=True)
    chosen = torch.gather(patches, 3, sel)[..., 0, :]
    if kind == "stochasticabs":
        chosen = torch.abs(chosen)
    return chosen, sel


def _scatter_windows(values, sel, kx, ky):
    """Each pooled value back at its window offset ``sel`` (b, oh, ow,
    c), zeros elsewhere: (b, oh*ky, ow*kx, c); non-overlapping windows."""
    b, oh, ow, c = values.shape
    onehot = F.one_hot(sel.long(), ky * kx).to(values.dtype)
    spread = values[..., None] * onehot          # (b, oh, ow, c, K)
    spread = spread.reshape(b, oh, ow, c, ky, kx).permute(0, 1, 4, 2, 5, 3)
    return spread.reshape(b, oh * ky, ow * kx, c)


def _tally(x, out, window):
    cost.add(out.numel() * window, cost.nbytes(x, out))


class PoolingBase(PureForward):
    hide_from_registry = True
    #: "max" | "maxabs" | "avg" | "stochastic" | "stochasticabs"
    KIND = None

    def __init__(self, workflow, **kwargs):
        super(PoolingBase, self).__init__(workflow, **kwargs)
        self.kx = kwargs.get("kx", 2)
        self.ky = kwargs.get("ky", 2)
        self.sliding = tuple(kwargs.get("sliding", (self.kx, self.ky)))
        self.include_bias = False
        #: record each window's choice for a Depooling (selective kinds)
        self.store_offsets = kwargs.get("store_offsets", False)
        self.output_offsets = Vector()

    def pure_config(self):
        return {"kx": self.kx, "ky": self.ky, "sliding": self.sliding,
                "kind": self.KIND}

    @staticmethod
    def pure_fn(params, x, kx=2, ky=2, sliding=(2, 2), kind="max"):
        if kind in ("avg", "max"):
            xn = x.permute(0, 3, 1, 2)
            pool = F.avg_pool2d if kind == "avg" else F.max_pool2d
            out = pool(xn, (ky, kx), (sliding[1], sliding[0])).permute(
                0, 2, 3, 1)
        else:
            out, _sel = _select_window(
                _extract_patches(x, kx, ky, sliding), kind, params)
        _tally(x, out, kx * ky)
        return out

    @staticmethod
    def pure_with_offsets(params, x, kx=2, ky=2, sliding=(2, 2),
                          kind="max"):
        """``(pooled, offsets)``: also each window's chosen in-window
        index (b, oh, ow, c) int32, which :class:`Depooling` reads."""
        if kind == "avg":
            raise ValueError("avg pooling records no offsets")
        chosen, sel = _select_window(_extract_patches(x, kx, ky, sliding),
                                     kind, params)
        _tally(x, chosen, kx * ky)
        return chosen, sel[..., 0, :].to(torch.int32)

    def output_shape_for(self, input_shape):
        batch, h, w, c = input_shape
        out_h = (h - self.ky) // self.sliding[1] + 1
        out_w = (w - self.kx) // self.sliding[0] + 1
        return (batch, out_h, out_w, c)

    def initialize(self, device=None, **kwargs):
        super(PoolingBase, self).initialize(device=device, **kwargs)
        out_shape = self.output_shape_for(self.input.shape)
        self.output.reset(numpy.zeros(out_shape, numpy.float32))
        self.init_vectors(self.output)
        if self.store_offsets:
            if self.KIND == "avg":
                raise ValueError("avg pooling records no offsets")
            self.output_offsets.reset(numpy.zeros(out_shape, numpy.int32))
            self.init_vectors(self.output_offsets)

    def pure_params(self, host=False):
        params = super(PoolingBase, self).pure_params(host=host)
        if self.KIND in _STOCHASTIC:
            # the seed the latest forward drew: its backward replays the
            # same choices
            seed = numpy.int32(getattr(self, "_last_seed", 0))
            params["seed"] = seed if host else torch.tensor(
                seed, device=self.device.torch_device)
        return params

    def stitch_stage(self):
        if self.store_offsets:
            return None
        return super(PoolingBase, self).stitch_stage()

    def _draw_seed(self):
        if self.KIND in _STOCHASTIC:
            self._last_seed = int(
                prng.get("stochastic_pooling").randint(0, 2 ** 31))

    def cuda_run(self):
        self._draw_seed()
        if self.store_offsets:
            out, offs = type(self).pure_with_offsets(
                self.pure_params(), self.input.devmem, **self.pure_config())
            self.output.devmem = out
            self.output_offsets.devmem = offs
        else:
            self.output.devmem = self.pure(self.pure_params(),
                                           self.input.devmem)


class MaxPooling(PoolingBase):
    MAPPING = "max_pooling"
    KIND = "max"


class MaxAbsPooling(PoolingBase):
    MAPPING = "maxabs_pooling"
    KIND = "maxabs"


class AvgPooling(PoolingBase):
    MAPPING = "avg_pooling"
    KIND = "avg"


class StochasticPooling(PoolingBase):
    MAPPING = "stochastic_pooling"
    KIND = "stochastic"


class StochasticAbsPooling(PoolingBase):
    MAPPING = "stochasticabs_pooling"
    MAPPING_ALIASES = ("stochastic_abs_pooling",)
    KIND = "stochasticabs"


class Depooling(PureForward):
    """Pooled values scattered back to their recorded positions: link
    ``offsets`` from the pooling unit's ``output_offsets`` (made with
    ``store_offsets=True``).  Non-overlapping windows only (``sliding ==
    (kx, ky)``)."""

    MAPPING = "depooling"

    def __init__(self, workflow, **kwargs):
        super(Depooling, self).__init__(workflow, **kwargs)
        self.kx = kwargs.get("kx", 2)
        self.ky = kwargs.get("ky", 2)
        self.sliding = tuple(kwargs.get("sliding", (self.kx, self.ky)))
        if self.sliding != (self.kx, self.ky):
            raise ValueError("depooling needs non-overlapping windows "
                             "(sliding == (kx, ky)), got %r"
                             % (self.sliding,))
        self.include_bias = False
        self.offsets = None
        self.demand("offsets")

    def pure_config(self):
        return {"kx": self.kx, "ky": self.ky}

    @staticmethod
    def pure_fn(params, x, kx=2, ky=2):
        out = _scatter_windows(x, params["offsets"], kx, ky)
        _tally(x, out, 1)
        return out

    def pure_params(self, host=False):
        return {"offsets": self.offsets.mem if host
                else self.offsets.devmem}

    def initialize(self, device=None, **kwargs):
        super(Depooling, self).initialize(device=device, **kwargs)
        b, h, w, c = self.input.shape
        self.output.reset(numpy.zeros((b, h * self.ky, w * self.kx, c),
                                      numpy.float32))
        self.init_vectors(self.output)


class _PoolDepoolBase(PoolingBase):
    """Pool and depool in ONE unit: the output has the input's spatial
    shape (cropped to whole windows), only each window's chosen element
    kept."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(_PoolDepoolBase, self).__init__(workflow, **kwargs)
        if self.sliding != (self.kx, self.ky):
            raise ValueError("pool-depool needs non-overlapping windows "
                             "(sliding == (kx, ky)), got %r"
                             % (self.sliding,))

    @staticmethod
    def pure_fn(params, x, kx=2, ky=2, sliding=(2, 2), kind="stochastic"):
        chosen, sel = _select_window(_extract_patches(x, kx, ky, sliding),
                                     kind, params)
        out = _scatter_windows(chosen, sel[..., 0, :], kx, ky)
        _tally(x, out, kx * ky)
        return out

    def output_shape_for(self, input_shape):
        b, h, w, c = input_shape
        out_h = (h - self.ky) // self.sliding[1] + 1
        out_w = (w - self.kx) // self.sliding[0] + 1
        return (b, out_h * self.ky, out_w * self.kx, c)


class StochasticPoolingDepooling(_PoolDepoolBase):
    MAPPING = "stochastic_pool_depool"
    KIND = "stochastic"


class StochasticAbsPoolingDepooling(_PoolDepoolBase):
    MAPPING = "stochastic_abs_pool_depool"
    KIND = "stochasticabs"


class GDPooling(GDViaVJP):
    MAPPING = "gd_max_pooling"


class GDAvgPooling(GDViaVJP):
    MAPPING = "gd_avg_pooling"


class GDStochasticPooling(GDViaVJP):
    MAPPING = "gd_stochastic_pooling"
