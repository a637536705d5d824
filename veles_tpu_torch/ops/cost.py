"""The work each kernel wrapper call does: a per-thread tally of flops
and bytes, the performance ledger's cost model.

The JAX package reads a program's flops from XLA's cost analysis; a
CUDA graph or an eager step carries no cost model, so every wrapper of
:mod:`veles_tpu_torch.ops` (and the plain products of
:mod:`veles_tpu_torch.gen.model`) adds the work of its call here, by the
formula written beside it: ``2·M·N·K`` for a product plus its epilogue's
per-element work, the attention products over the keys a row reads,
and bytes with each input read once and each output written once.  A
wrapper adds on both routes, the kernel's and the plain version's: the
function is the same work.

A program's cost is the tally of its body: :class:`Tally` reads the
difference around it on the calling thread (the batcher's and the
scheduler's threads keep their own tallies).  A CUDA graph's wrappers
run once, at capture, so the cost is read there and each replay
dispatches that cost again without running any Python.
"""

import threading

#: the flops one element of an epilogue costs, by activation (the
#: elementwise arithmetic and transcendental calls, one each): the
#: Znicz tanh ``1.7159·tanh(0.6666·x)`` is three, the smooth relu
#: ``log1p(exp(min(x, 30)))`` three, the tanh gelu eight
EPILOGUE_FLOPS = {None: 0, "linear": 0, "tanh": 3, "sigmoid": 1,
                  "relu": 3, "strict_relu": 1, "gelu": 8}

#: the flops of the GD derivative act'(y) and its product with the
#: incoming error, per element of δ
DERIVATIVE_FLOPS = {None: 0, "linear": 0, "tanh": 4, "sigmoid": 3,
                    "relu": 3, "strict_relu": 2}

#: the flops of one momentum step per parameter: dW·(1/B), + λ·W (two),
#: · lr, m·v, the difference, W + v
UPDATE_FLOPS = 7

_local = threading.local()


def add(flops, nbytes):
    """Add one call's work to this thread's tally."""
    state = _local.__dict__
    state["flops"] = state.get("flops", 0.0) + float(flops)
    state["bytes"] = state.get("bytes", 0.0) + float(nbytes)


def read():
    """``(flops, bytes)`` tallied on this thread so far."""
    state = _local.__dict__
    return state.get("flops", 0.0), state.get("bytes", 0.0)


def nbytes(*tensors):
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def product(m, n, k, bias=False, activation=None):
    """Flops of ``act(a(M, K) @ w(K, N) + bias)``."""
    return (2.0 * m * n * k + (m * n if bias else 0)
            + EPILOGUE_FLOPS[activation] * m * n)


def conv(dots, length, bias=False, activation=None):
    """Flops of a convolution (or a transposed one) of ``dots`` dot
    products of ``length`` terms (a conv: B·OH·OW·K outputs of
    ky·kx·C/g, so ``2·B·OH·OW·K·ky·kx·C/g``), plus the bias and the
    activation an output, as :func:`product` counts them."""
    return (2.0 * dots * length + (dots if bias else 0)
            + EPILOGUE_FLOPS[activation] * dots)


def conv_grads(dots, length, dx=True, dw=True):
    """Flops of a convolution's VJP: its two transposed products, the
    input's gradient and the weights', each as many as the forward's."""
    return 2.0 * dots * length * (int(bool(dx)) + int(bool(dw)))


#: the flops of one output element of local response normalization
#: beyond its n-channel window sum: the square, the scale and offset,
#: the power and the product
LRN_FLOPS = 5


class Tally(object):
    """The work tallied on this thread inside a ``with`` block:
    ``flops`` and ``bytes`` after it exits, or :meth:`cost` as the
    ledger's cost dict."""

    __slots__ = ("flops", "bytes", "_start")

    def __init__(self):
        self.flops = self.bytes = 0.0
        self._start = None

    def __enter__(self):
        self._start = read()
        return self

    def __exit__(self, *exc):
        flops, nbytes_ = read()
        self.flops = flops - self._start[0]
        self.bytes = nbytes_ - self._start[1]
        return False

    def cost(self, scale=1.0):
        """The ledger's cost dict (``scale`` divides a K-step window's
        tally into one step's)."""
        return {"flops": self.flops / scale,
                "bytes_accessed": self.bytes / scale,
                "arg_bytes": 0, "out_bytes": 0, "temp_bytes": 0}
