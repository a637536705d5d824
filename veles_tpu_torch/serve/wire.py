"""Request decoding for the serving wire contract: the port's copy of
:mod:`veles_tpu.serve.wire`, shared by
:class:`veles_tpu_torch.serve.server.ServingServer` and the
:class:`veles_tpu_torch.restful_api.RESTfulAPI` adapter.

Two accepted input encodings:

- ``{"input": [[...], ...]}`` — nested JSON lists;
- ``{"input_b64": "<base64 raw bytes>", "shape": [n, ...],
  "dtype": "float32"}`` — raw C-order numpy bytes, the cheap path for
  image-sized samples (a 227×227×3 float32 sample is ~3.7× smaller as
  base64 bytes than as a JSON list, and decodes without building a
  million Python floats).
"""

import base64
import binascii

import numpy

#: dtypes a request may declare; everything is cast to float32 for the
#: forward (the engines compile float32 entry buffers)
_ALLOWED_DTYPES = frozenset({
    "float32", "float64", "float16", "uint8", "int8", "int16", "int32",
    "int64",
})


def decode_input(payload):
    """``payload`` (parsed JSON body) → float32 ndarray with a batch dim.

    Raises ``ValueError`` with a wire-safe message on any malformed
    request — the HTTP layer maps that to a 400.
    """
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    has_json = "input" in payload
    has_b64 = "input_b64" in payload
    if has_json == has_b64:
        raise ValueError(
            "request must carry exactly one of 'input' (JSON lists) or "
            "'input_b64' (base64 numpy bytes + 'shape' [+ 'dtype'])")
    if has_json:
        try:
            batch = numpy.asarray(payload["input"], dtype=numpy.float32)
        except (TypeError, ValueError) as e:
            raise ValueError("'input' is not numeric array data: %s" % e)
    else:
        dtype = str(payload.get("dtype", "float32"))
        if dtype not in _ALLOWED_DTYPES:
            raise ValueError("unsupported dtype %r (allowed: %s)"
                             % (dtype, ", ".join(sorted(_ALLOWED_DTYPES))))
        shape = payload.get("shape")
        if (not isinstance(shape, (list, tuple)) or not shape
                or not all(isinstance(d, int) and d > 0 for d in shape)):
            raise ValueError("'input_b64' requires 'shape': a non-empty "
                             "list of positive ints")
        try:
            raw = base64.b64decode(payload["input_b64"], validate=True)
        except (binascii.Error, TypeError) as e:
            raise ValueError("'input_b64' is not valid base64: %s" % e)
        want = int(numpy.prod(shape)) * numpy.dtype(dtype).itemsize
        if len(raw) != want:
            raise ValueError(
                "input_b64 payload is %d bytes, but shape %s dtype %s "
                "needs %d" % (len(raw), list(shape), dtype, want))
        batch = numpy.frombuffer(raw, dtype=dtype).reshape(shape)
        batch = batch.astype(numpy.float32)
    if batch.ndim == 0:
        raise ValueError("input must be at least 1-D")
    if batch.ndim == 1:
        batch = batch[None, :]
    return numpy.ascontiguousarray(batch, dtype=numpy.float32)


#: request caps the wire enforces before anything reaches a scheduler
#: (the engine re-validates against ITS max_seq; these bound malice)
MAX_PROMPT_TOKENS = 65536
MAX_NEW_TOKENS = 65536


def decode_gen_request(payload):
    """Parsed JSON body of a ``POST /generate`` → ``(tokens,
    max_new_tokens, stream)``.

    - ``tokens``: non-empty list of non-negative ints (the prompt;
      tokenization happens client-side — the serving tier moves
      int32s, like the training tier);
    - ``max_new_tokens``: positive int, default 16;
    - ``stream``: bool, default False — True asks the HTTP layer for
      ndjson token events instead of one final document.

    Raises ``ValueError`` with a wire-safe message on any malformed
    field — the HTTP layer maps it to 400.
    """
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    tokens = payload.get("tokens")
    if not isinstance(tokens, list) or not tokens:
        raise ValueError("'tokens' must be a non-empty list of ints "
                         "(the prompt token ids)")
    if len(tokens) > MAX_PROMPT_TOKENS:
        raise ValueError("prompt of %d tokens exceeds the wire cap %d"
                         % (len(tokens), MAX_PROMPT_TOKENS))
    if not all(isinstance(t, int) and not isinstance(t, bool)
               and t >= 0 for t in tokens):
        raise ValueError("'tokens' entries must be non-negative ints")
    max_new = payload.get("max_new_tokens", 16)
    if not isinstance(max_new, int) or isinstance(max_new, bool) \
            or not 1 <= max_new <= MAX_NEW_TOKENS:
        raise ValueError("'max_new_tokens' must be an int in 1..%d"
                         % MAX_NEW_TOKENS)
    stream = payload.get("stream", False)
    if not isinstance(stream, bool):
        raise ValueError("'stream' must be a boolean")
    return numpy.asarray(tokens, numpy.int32), max_new, stream
