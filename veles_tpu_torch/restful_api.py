"""RESTful inference endpoint unit: a thin adapter over
:mod:`veles_tpu_torch.serve`, the port's counterpart of
:mod:`veles_tpu.restful_api`.

An in-workflow HTTP endpoint accepting JSON or base64 numpy input and
returning the model output::

    POST /service  {"input": [[...]]}                    → {"result": [[...]]}
    POST /service  {"input_b64": ..., "shape": [...]}    → {"result": [[...]]}

The forward chain becomes an
:class:`~veles_tpu_torch.serve.engine.InferenceEngine`
(``from_forwards``) behind a
:class:`~veles_tpu_torch.serve.server.ServingServer`, so concurrent
requests coalesce into bucket calls and the workflow's links are never
touched.  ``live=True`` (the default) copies the forwards' current
weights into the engine before every call, so a workflow that keeps
training serves its latest weights.  The engine runs on the unit's
device (``device=``, else the one ``initialize`` is given, else the
workflow's; the card when none).
"""

import numpy

from veles_tpu_torch.units import Unit


class RESTfulAPI(Unit):
    """Serves the workflow's forward pass over HTTP."""

    def __init__(self, workflow, **kwargs):
        super(RESTfulAPI, self).__init__(workflow, **kwargs)
        self.view_group = "SERVICE"
        self.port = kwargs.get("port", 0)
        self.host = kwargs.get("host", "127.0.0.1")
        self.path = kwargs.get("path", "/service")
        #: serving knobs forwarded to the engine and the batcher
        self.max_batch_size = kwargs.get("max_batch_size", 64)
        self.max_wait_ms = kwargs.get("max_wait_ms", 2.0)
        self.max_queue_rows = kwargs.get("max_queue_rows", 1024)
        self.buckets = kwargs.get("buckets")
        #: capture every bucket at initialize() (False: each bucket is
        #: captured at its first use)
        self.warmup = kwargs.get("warmup", False)
        #: copy the forwards' weights in before every call
        self.live = kwargs.get("live", True)
        self.device = kwargs.get("device")
        self.forwards = None     # list of forward units (linked)
        self._server_ = None
        self.demand("forwards")

    def init_unpickled(self):
        super(RESTfulAPI, self).init_unpickled()
        self._server_ = None

    @property
    def engine(self):
        """The serving engine (None before :meth:`initialize`)."""
        return (self._server_.registry.get("default").engine
                if self._server_ is not None else None)

    @property
    def metrics(self):
        return self._server_.metrics if self._server_ is not None \
            else None

    def infer(self, batch):
        """Run the forward on a host batch; returns host output.  The
        live units' links and state are not touched."""
        if self._server_ is None:
            raise RuntimeError("initialize() the unit before infer()")
        batch = numpy.ascontiguousarray(batch, dtype=numpy.float32)
        return self._server_.registry.infer("default", batch)

    def initialize(self, device=None, **kwargs):
        super(RESTfulAPI, self).initialize(**kwargs)
        if self._server_ is not None:
            return
        from veles_tpu_torch.serve import InferenceEngine, ServingServer
        device = self.device or device or getattr(self.workflow,
                                                  "device", None)
        device = getattr(device, "torch_device", device)
        engine = InferenceEngine.from_forwards(
            self.forwards, live=self.live,
            max_batch_size=self.max_batch_size, buckets=self.buckets,
            device=device)
        self._server_ = ServingServer(
            engine=engine, host=self.host, port=self.port,
            path=self.path, warmup=self.warmup,
            batcher_config={"max_wait_ms": self.max_wait_ms,
                            "max_queue_rows": self.max_queue_rows})
        self._server_.start()
        self.port = self._server_.port
        self.info("REST inference on http://%s:%d%s (buckets %s)",
                  self.host, self.port, self.path,
                  list(engine.buckets))

    def stop(self):
        if self._server_ is not None:
            self._server_.stop()
            self._server_ = None
