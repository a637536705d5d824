"""Deploy-time weight quantization: per-output-channel symmetric int8.

Counterpart of :mod:`veles_tpu.quant.core`, copied whole: a walk that
replaces each eligible float weight leaf of a param tree with an
``{"q": int8, "scale": float32}`` pair — ``w ≈ q * scale`` with one
scale per OUTPUT channel (abs-max calibration: ``scale = max|w| / 127``
over the contraction axes), biases / norms / embeddings kept float32.
The generative engine and the All2All units consume the pair through
:func:`veles_tpu_torch.ops.qgemm.qmatmul`, whose epilogue applies the
dequant after the int8 dot, so the stored form IS the served form and
no dequantized copy is ever made on the card.

The walks are numpy on the host, as in the JAX package; the only
differences are where that package imported JAX: :func:`tree_nbytes`
walks tensors and numpy arrays (each storage counted once, so a tensor
that two leaves share is one allocation), and :func:`quantize_gen_params`
copies tensors to host numpy and reads the model's logits back from its
device.

**Calibration gate**: a layer whose dynamic range cannot survive 8
bits (one giant outlier weight flattens every other channel's
resolution) must fail at DEPLOY time, not as silent accuracy loss —
``check_drift`` compares float vs quantized logits on a calibration
batch and raises a typed :class:`QuantizationError` NAMING the worst
layer when the relative drift exceeds ``tol`` (default 1e-2).
"""

import numpy
import torch


#: relative logit drift a quantized deploy must stay within on its
#: calibration batch (the JAX package's default)
DRIFT_TOL = 1e-2

#: contraction axes of the stacked transformer block weights
#: (leading axis = layer): everything NOT reduced is an output
#: channel, so each (layer, out-channel) pair owns one scale
TRANSFORMER_BLOCK_AXES = {
    "wqkv": (1,),        # [L, d, 3, h, dh] — contract d
    "wo": (1, 2),        # [L, h, dh, d]   — contract (h, dh)
    "w1": (1,),          # [L, d, f]       — contract d
    "w2": (1,),          # [L, f, d]       — contract f
}


class QuantizationError(ValueError):
    """A layer's dynamic range cannot hold the deploy's drift budget
    (or the quantization request is structurally impossible).  Carries
    ``layer`` (the offending leaf's name) and ``drift`` (the measured
    relative logit drift) so deploy tooling can report precisely."""

    def __init__(self, message, layer=None, drift=None):
        super(QuantizationError, self).__init__(message)
        self.layer = layer
        self.drift = drift


def quantize_array(w, axes=(0,)):
    """One float weight → ``{"q": int8, "scale": float32}`` with
    abs-max symmetric scales over the contraction ``axes`` (keepdims,
    so ``q * scale`` broadcasts back to ``w``'s shape exactly)."""
    w = numpy.asarray(w, numpy.float32)
    amax = numpy.max(numpy.abs(w), axis=tuple(axes), keepdims=True)
    scale = (amax / 127.0).astype(numpy.float32)
    # all-zero channels (fresh bias-like rows): scale 1 keeps q = 0
    scale = numpy.where(amax > 0, scale, numpy.float32(1.0))
    q = numpy.clip(numpy.rint(w / scale), -127, 127)
    return {"q": q.astype(numpy.int8), "scale": scale}


def dequantize_array(qw, dtype=numpy.float32):
    """``q * scale`` back to float — the reference reconstruction
    (tests price against it; serving never calls
    this: the dequant lives in the qgemm epilogue)."""
    return (qw["q"].astype(numpy.float32)
            * numpy.asarray(qw["scale"], numpy.float32)).astype(dtype)


def is_quantized_leaf(leaf):
    """True for the ``{"q", "scale"}`` pair this module emits."""
    return (isinstance(leaf, dict) and "q" in leaf and "scale" in leaf
            and len(leaf) == 2)


def tree_is_quantized(params):
    """True when any leaf-level dict in ``params`` is a quantized
    pair (the engines' deploy-mode detector)."""
    found = []

    def walk(node):
        if is_quantized_leaf(node):
            found.append(True)
            return
        if isinstance(node, dict):
            for child in node.values():
                walk(child)
        elif isinstance(node, (list, tuple)):
            for child in node:
                walk(child)

    walk(params)
    return bool(found)


def _leaves(node):
    if isinstance(node, dict):
        for child in node.values():
            yield from _leaves(child)
    elif isinstance(node, (list, tuple)):
        for child in node:
            yield from _leaves(child)
    else:
        yield node


def tree_nbytes(params):
    """Actual bytes of every array leaf — int8 leaves count one byte
    per element, which is the whole point: the HBM ledger and
    ``describe()`` price the deploy from THIS, not from an assumed
    float width.  A tensor counts its storage once however many leaves
    share it (a cast to the dtype a tensor already has returns the
    tensor itself); a numpy array counts its own bytes."""
    seen = set()
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            storage = leaf.untyped_storage()
            key = (str(leaf.device), storage.data_ptr())
            size = storage.nbytes()
        elif hasattr(leaf, "size") and hasattr(leaf, "dtype"):
            array = numpy.asarray(leaf)
            key = ("host", array.__array_interface__["data"][0],
                   array.nbytes)
            size = array.nbytes
        else:
            continue
        if key not in seen:
            seen.add(key)
            total += int(size)
    return total


def _host(node):
    """A param tree as host numpy: float tensors as float32 (bf16 has
    no numpy dtype), int8 and others as they are."""
    if isinstance(node, dict):
        return {key: _host(child) for key, child in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_host(child) for child in node)
    if isinstance(node, torch.Tensor):
        node = node.detach().to("cpu")
        if node.is_floating_point():
            node = node.float()
        return node.numpy().copy()
    return numpy.asarray(node)


def _logits(tensor):
    return tensor.detach().to("cpu", torch.float32).numpy()


def relative_drift(ref, got):
    """``||got - ref||₂ / ||ref||₂`` — the calibration drift metric
    (scale-free; an L2 norm so one noisy near-zero logit cannot veto
    a deploy whose decision surface moved by nothing)."""
    ref = numpy.asarray(ref, numpy.float32).ravel()
    got = numpy.asarray(got, numpy.float32).ravel()
    denom = float(numpy.linalg.norm(ref)) or 1.0
    return float(numpy.linalg.norm(got - ref)) / denom


def check_drift(name, drift, tol=DRIFT_TOL, blame=None):
    """Raise :class:`QuantizationError` when ``drift`` exceeds
    ``tol``; ``blame()`` (optional) refines the offending layer name
    by re-measuring with one layer quantized at a time."""
    if drift <= tol:
        return drift
    layer = name
    worst = drift
    if blame is not None:
        layer, worst = blame()
    raise QuantizationError(
        "int8 quantization drifts the calibration logits by %.4g "
        "relative (budget %.4g) — layer %r's dynamic range does not "
        "fit 8 bits; keep it float (or rescale its weights) and "
        "redeploy" % (drift, tol, layer), layer=layer, drift=worst)


# -- the two deploy walks ----------------------------------------------------

def quantize_transformer_params(params, only=None):
    """Quantize the stacked block matmul weights of a
    :class:`~veles_tpu.gen.model.TransformerGenModel` params tree
    (``TRANSFORMER_BLOCK_AXES``); embed / pos / norms / biases stay
    float32.  ``only``: quantize a single key (the calibration
    blame probe)."""
    out = dict(params)
    blocks = dict(params["blocks"])
    for key, axes in TRANSFORMER_BLOCK_AXES.items():
        if key not in blocks or (only is not None and key != only):
            continue
        leaf = blocks[key]
        if is_quantized_leaf(leaf):
            continue
        blocks[key] = quantize_array(numpy.asarray(leaf), axes)
    out["blocks"] = blocks
    return out


def quantize_gen_params(model, params, calibration_tokens=None,
                        tol=DRIFT_TOL):
    """Deploy-time walk for the generative engine: quantize the block
    weights (``params`` a tree of tensors or numpy arrays; the result
    is host numpy), then (when a calibration prompt is given) gate the
    relative logit drift of the model's OWN forward
    (``calibration_logits`` runs the same shared ``_run_layers``
    body the engine serves from, on the model's device: on the card
    the quantized forward launches the qmatmul kernel) at ``tol`` —
    blame is per block weight key."""
    host = _host(params)
    qparams = quantize_transformer_params(host)
    if calibration_tokens is not None:
        ref = _logits(model.calibration_logits(host, calibration_tokens))

        def drift_of(tree):
            return relative_drift(ref, _logits(model.calibration_logits(
                tree, calibration_tokens)))

        def blame():
            per_key = {
                key: drift_of(quantize_transformer_params(host,
                                                          only=key))
                for key in TRANSFORMER_BLOCK_AXES
                if key in host["blocks"]}
            worst = max(per_key, key=per_key.get)
            return "blocks.%s" % worst, per_key[worst]

        check_drift("blocks", drift_of(qparams), tol, blame)
    return qparams


def quantize_stage_params(params_list, axes_list=None, only=None):
    """Deploy-time walk for the serve engine's per-stage params (the
    ``[{"w": ..., "b": ...}, ...]`` list both engine constructors
    build): every 2D float ``"w"`` quantizes over its fan-in axis
    (``axes_list[i]["w"]`` — ``(1,)`` for transposed storage, default
    ``(0,)``); biases / seeds / conv kernels (non-2D) stay float.
    ``only``: quantize a single stage index (the blame probe).

    Transposed storage is CANONICALIZED here: a ``(1,)``-axes stage's
    weight is transposed once to (fan-in, out) before quantizing, so
    the serving kernel consumes ``q`` exactly as stored — a per-call
    ``q.T`` in the hot path would materialize an int8 copy per
    forward, re-paying the very HBM bytes the kernel exists to save.
    Raises :class:`QuantizationError` when NOTHING is quantizable —
    a silent float "int8 deploy" would misreport its footprint."""
    out = []
    hits = 0
    for index, state in enumerate(params_list):
        state = dict(state)
        w = state.get("w")
        eligible = (
            w is not None and not is_quantized_leaf(w)
            and getattr(w, "ndim", 0) == 2
            and numpy.issubdtype(numpy.asarray(w).dtype,
                                 numpy.floating))
        if eligible and (only is None or only == index):
            axes = (0,)
            if axes_list is not None and index < len(axes_list):
                axes = tuple((axes_list[index] or {}).get("w", (0,)))
            w = numpy.asarray(w)
            if axes == (1,):
                w, axes = numpy.ascontiguousarray(w.T), (0,)
            state["w"] = quantize_array(w, axes)
            hits += 1
        out.append(state)
    if not hits:
        raise QuantizationError(
            "no quantizable weight leaf in the params list — every "
            "stage is bias-only, already quantized, or non-2D; an "
            "int8 deploy of this model would be a no-op lie")
    return out
