"""Recurrent layers, LSTM and the simple RNN: the port's counterpart of
:mod:`veles_tpu.znicz.rnn`.

Input ``(B, T, D)``; output ``(B, T, H)``, or ``(B, H)`` (the last
hidden state) with ``last_only``, the shape a classifier head wants.
The JAX package runs the sequence under ``lax.scan``; ``pure_fn`` here
is a Python loop over the T steps, each one product ``[x_t, h] @ W``
with ``W: (D + H, GATES·H)`` (all the gates in one product, cuBLAS on
the card, as the JAX package leaves it to XLA) and the gate arithmetic
on the slices ``i, f, g, o`` in that order.  The step outputs are
collected with ``torch.stack``, so autograd's saved tensors are never
written in place.  The backward is
:class:`~veles_tpu_torch.znicz.gd_base.GDGeneric` (``gd_generic``):
autograd through the loop.  On the stitched route and in the fused step
the loop is traced once into the segment's or the step's CUDA graph,
so a replay launches the T steps without the host.

``pure_fn`` adds the JAX formula :func:`lstm_fwd_flops` to the ledger's
tally (:mod:`veles_tpu_torch.ops.cost`), and, when the forward is
recorded for a gradient, the backward's twice that.  The ledger counts
the work a route executes, as the conv tally
(:func:`veles_tpu_torch.znicz.conv.tally_conv`) does: on the eager and
stitched routes ``GDGeneric``'s VJP runs the forward again under grad,
so a train step tallies 4× ``lstm_fwd_flops`` there (the forward
unit's 1×, the VJP's 3×); the fused step runs the forward once, 3×,
which is :func:`lstm_train_flops`.  A model-flops utilization takes
:func:`lstm_train_flops` whatever the route.
"""

import numpy
import torch

from veles_tpu_torch.ops import cost
from veles_tpu_torch.znicz.nn_units import PureForward


def lstm_fwd_flops(batch, t, d, h, gates=4, head_classes=0):
    """Flops of one LSTM (``gates=4``) / SimpleRNN (``gates=1``) forward
    over a ``(batch, t, d)`` input: the step's product ``[x_t, h] @ W``
    with ``W: (d + h, gates·h)``, ~10 flops a hidden unit of gate
    arithmetic, and ``head_classes`` a dense head on the last state."""
    per_step = 2.0 * (d + h) * gates * h + 10.0 * h
    return float(batch) * (t * per_step + 2.0 * h * head_classes)


def lstm_train_flops(batch, t, d, h, gates=4, head_classes=0):
    """Flops of one train step (forward, backward through the sequence
    at twice the forward's products, update): 3× the forward."""
    return 3.0 * lstm_fwd_flops(batch, t, d, h, gates, head_classes)


def _tally(x, w, b, out, hidden_units, gates):
    """The executed work of one ``pure_fn`` call (see the module doc):
    the forward, and the backward's two products with a gradient."""
    batch, t, d = x.shape
    flops = lstm_fwd_flops(batch, t, d, hidden_units, gates)
    nbytes = cost.nbytes(x, w, b, out)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        flops *= 3.0
        nbytes += cost.nbytes(out, x, w, b)
    cost.add(flops, nbytes)


class LSTM(PureForward):
    """Long short-term memory layer.  ``->`` params: ``hidden_units``
    (H), ``last_only`` (default False), the weights' filling; the bias
    defaults to ``constant`` zeros and its forget-gate slice ``[H:2H]``
    starts at +1."""

    MAPPING = "lstm"
    #: gate blocks in the stacked weight matrix (i, f, g, o)
    GATES = 4

    def __init__(self, workflow, **kwargs):
        super(LSTM, self).__init__(workflow, **kwargs)
        self.hidden_units = int(kwargs["hidden_units"])
        self.last_only = bool(kwargs.get("last_only", False))
        self.bias_filling = kwargs.get("bias_filling", "constant")
        self.bias_stddev = kwargs.get("bias_stddev", 0.0)

    def pure_config(self):
        return {"hidden_units": self.hidden_units,
                "last_only": self.last_only}

    @staticmethod
    def pure_fn(params, x, hidden_units=None, last_only=False):
        w = params["w"]
        bias = params.get("b")
        h = torch.zeros((x.shape[0], hidden_units), dtype=x.dtype,
                        device=x.device)
        c = h
        outs = []
        for step in range(x.shape[1]):
            z = torch.cat([x[:, step], h], dim=-1) @ w
            if bias is not None:
                z = z + bias
            i, f, g, o = torch.split(z, hidden_units, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        out = h if last_only else torch.stack(outs, dim=1)
        _tally(x, w, bias, out, hidden_units, LSTM.GATES)
        return out

    def output_shape_for(self, input_shape):
        batch, t, _d = input_shape
        if self.last_only:
            return (batch, self.hidden_units)
        return (batch, t, self.hidden_units)

    def _init_bias(self, b):
        """The forget-gate slice starts at +1 (remember by default)."""
        h = self.hidden_units
        b[h:2 * h] += 1.0

    def initialize(self, device=None, **kwargs):
        super(LSTM, self).initialize(device=device, **kwargs)
        d = self.input.shape[-1]
        h = self.hidden_units
        if not self.weights:
            w = numpy.zeros((d + h, self.GATES * h), dtype=numpy.float32)
            self.fill_array(w, self.weights_filling, self.weights_stddev)
            self.weights.reset(w)
        if self.include_bias and not self.bias:
            b = numpy.zeros((self.GATES * h,), dtype=numpy.float32)
            self.fill_array(b, self.bias_filling, self.bias_stddev)
            self._init_bias(b)
            self.bias.reset(b)
        self.output.reset(numpy.zeros(
            self.output_shape_for(self.input.shape), numpy.float32))
        self.init_vectors(self.weights, self.bias, self.output)


class SimpleRNN(LSTM):
    """Elman RNN: ``h_t = tanh([x_t, h] @ W + b)``, the loop of
    :class:`LSTM` with a quarter of the weights."""

    MAPPING = "rnn"
    GATES = 1

    def _init_bias(self, b):
        pass                        # no gate offsets

    @staticmethod
    def pure_fn(params, x, hidden_units=None, last_only=False):
        w = params["w"]
        bias = params.get("b")
        h = torch.zeros((x.shape[0], hidden_units), dtype=x.dtype,
                        device=x.device)
        outs = []
        for step in range(x.shape[1]):
            z = torch.cat([x[:, step], h], dim=-1) @ w
            if bias is not None:
                z = z + bias
            h = torch.tanh(z)
            outs.append(h)
        out = h if last_only else torch.stack(outs, dim=1)
        _tally(x, w, bias, out, hidden_units, SimpleRNN.GATES)
        return out
