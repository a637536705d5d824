"""MCDNN-notation topology strings: the port's counterpart of
:mod:`veles_tpu.znicz.mcdnnic` (the documented "second way to set
topology": ``mcdnnic_topology = "12x256x256-32C4-MP2-64C4-MP3-32N-4N"``,
with ``mcdnnic_parameters`` giving every generated layer the same
``->`` / ``<-`` dicts).

Grammar (dash-separated tokens after the input shape):

- ``<C>x<H>x<W>`` (first token): the declared input shape, channels
  first; informational (the loader owns the real input shape).
- ``<n>C<k>``: a convolution of ``n`` kernels of ``k×k`` (scaled tanh).
- ``MP<k>``: max pooling ``k×k`` with stride ``k``.
- ``<n>N``: a fully-connected layer of ``n`` neurons; the LAST one is
  the softmax output layer, earlier ones scaled-tanh hidden layers.

The whole grammar parses here, and every token builds: ``C`` gives a
``conv_tanh`` layer and ``MP`` a ``max_pooling`` one
(:mod:`veles_tpu_torch.znicz.conv`, :mod:`veles_tpu_torch.znicz.pooling`).
"""

import re

_CONV = re.compile(r"^(\d+)C(\d+)$")
_POOL = re.compile(r"^MP(\d+)$")
_DENSE = re.compile(r"^(\d+)N$")
_INPUT = re.compile(r"^(\d+)x(\d+)x(\d+)$")


def parse_topology(topology, parameters=None):
    """``(input_shape | None, layers)`` from an mcdnnic string.

    ``parameters``: the ``mcdnnic_parameters`` dict, whose ``"->"`` and
    ``"<-"`` entries are merged into every generated layer (the
    structure parsed from the string wins over them).  ``input_shape``
    is the loader-layout (H, W, C) tuple, or None when the string has no
    leading shape token."""
    params = parameters or {}
    fwd = dict(params.get("->", {}))
    bwd = dict(params.get("<-", {}))
    tokens = [t for t in str(topology).strip().split("-") if t]
    if not tokens:
        raise ValueError("empty mcdnnic topology %r" % (topology,))
    input_shape = None
    m = _INPUT.match(tokens[0])
    if m:
        c, h, w = (int(g) for g in m.groups())
        input_shape = (h, w, c)
        tokens = tokens[1:]

    dense_positions = [i for i, t in enumerate(tokens) if _DENSE.match(t)]
    if not dense_positions or dense_positions[-1] != len(tokens) - 1:
        raise ValueError(
            "mcdnnic topology must end with an <n>N output layer, "
            "got %r" % (topology,))

    layers = []
    for i, token in enumerate(tokens):
        m = _CONV.match(token)
        if m:
            n, k = int(m.group(1)), int(m.group(2))
            layers.append({"type": "conv_tanh",
                           "->": {**fwd, "n_kernels": n, "kx": k, "ky": k},
                           "<-": dict(bwd)})
            continue
        m = _POOL.match(token)
        if m:
            k = int(m.group(1))
            layers.append({"type": "max_pooling",
                           "->": {**fwd, "kx": k, "ky": k,
                                  "sliding": (k, k)},
                           "<-": dict(bwd)})
            continue
        m = _DENSE.match(token)
        if m:
            n = int(m.group(1))
            last = i == len(tokens) - 1
            layers.append({
                "type": "softmax" if last else "all2all_tanh",
                "->": {**fwd, "output_sample_shape": n},
                "<-": dict(bwd)})
            continue
        raise ValueError(
            "unknown mcdnnic token %r in %r (want <n>C<k>, MP<k>, "
            "<n>N, or a leading CxHxW shape)" % (token, topology))
    return input_shape, layers
