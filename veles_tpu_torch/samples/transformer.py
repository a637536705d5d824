"""Decoder-only transformer LM: configurations and parameter layout.

The port's own copy of the numpy-only part of
:mod:`veles_tpu.samples.transformer` (``CONFIG``, ``TINY``, the shape
table and ``init_params``).  It draws from the same
``numpy.random.default_rng(seed)`` in the same order, so one seed gives
bit-identical weights in both packages.  The training step waits for
the transformer-training slice of the port.
"""

import math

import numpy

CONFIG = {
    "vocab": 32000, "dim": 1024, "heads": 16, "layers": 12,
    "mlp_ratio": 4, "seq_len": 2048,
}
TINY = {
    "vocab": 64, "dim": 32, "heads": 4, "layers": 2,
    "mlp_ratio": 2, "seq_len": 16,
}


def _shape_table(cfg):
    """The one parameter-layout table: ``name -> (shape, init)`` with
    ``init`` = ("randn", scale) | ("ones",) | ("zeros",).  Entry order
    is the RNG draw order of :func:`init_params`."""
    d, h, L = cfg["dim"], cfg["heads"], cfg["layers"]
    dh = d // h
    f = cfg["mlp_ratio"] * d
    sq = math.sqrt
    return {
        "embed": ((cfg["vocab"], d), ("randn", 0.02)),
        "pos": ((cfg["seq_len"], d), ("randn", 0.02)),
        "blocks": {
            "ln1_g": ((L, d), ("ones",)),
            "ln1_b": ((L, d), ("zeros",)),
            "wqkv": ((L, d, 3, h, dh), ("randn", 1 / sq(d))),
            "wo": ((L, h, dh, d), ("randn", 1 / sq(d) / sq(2 * L))),
            "ln2_g": ((L, d), ("ones",)),
            "ln2_b": ((L, d), ("zeros",)),
            "w1": ((L, d, f), ("randn", 1 / sq(d))),
            "b1": ((L, f), ("zeros",)),
            "w2": ((L, f, d), ("randn", 1 / sq(f) / sq(2 * L))),
            "b2": ((L, d), ("zeros",)),
        },
        "lnf_g": ((d,), ("ones",)),
        "lnf_b": ((d,), ("zeros",)),
    }


def _build_params(table, make):
    """Walk the shape table in INSERTION order (dict order is the RNG
    draw order)."""
    out = {}
    for name, entry in table.items():
        out[name] = (_build_params(entry, make)
                     if isinstance(entry, dict) else make(entry))
    return out


def init_params(cfg, seed=0, dtype=numpy.float32):
    """Stacked-block GPT params as a numpy tree (leading axis = layer)."""
    rng = numpy.random.default_rng(seed)

    def make(entry):
        shape, init = entry
        if init[0] == "randn":
            return (rng.standard_normal(shape)
                    * init[1]).astype(dtype)
        fn = numpy.ones if init[0] == "ones" else numpy.zeros
        return fn(shape, dtype)

    return _build_params(_shape_table(cfg), make)
