"""Streaming loaders, an interactive feed and REST- and ZeroMQ-fed ones:
the port's counterpart of :mod:`veles_tpu.loader.streaming`.

A queue-backed :class:`StreamLoader` base: the stream is host control
flow, so these are ordinary Python units, and the minibatch Vectors
they fill reach the device as the resident loaders' do.  Everything a
stream feeds is TRAIN, and epochs are delimited by an explicit
``end_of_epoch`` marker pushed by the producer; ``run`` blocks until
the next item arrives.  pyzmq is imported when a ``ZeroMQLoader``
initializes, so importing the port needs none.
"""


import pickle
import queue

import numpy

from veles_tpu_torch.loader.base import Loader, LoaderError, TRAIN

#: sentinel a producer pushes to mark an epoch boundary
END_OF_EPOCH = "end_of_epoch"
#: sentinel a producer pushes to terminate the stream
END_OF_STREAM = "end_of_stream"


class StreamLoader(Loader):
    """Queue-backed loader: ``feed(data, labels)`` from any thread;
    ``run()`` blocks until a minibatch (or a sentinel) is available."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.sample_shape = tuple(kwargs.get("sample_shape", ()))
        self.queue_size = kwargs.get("queue_size", 128)
        super(StreamLoader, self).__init__(workflow, **kwargs)

    def init_unpickled(self):
        super(StreamLoader, self).init_unpickled()
        self.queue_ = queue.Queue(self.queue_size)
        self._stream_ended_ = False

    # -- producer side ------------------------------------------------------
    def feed(self, data, labels=None, timeout=None):
        """Push one minibatch (B, *sample_shape) into the stream."""
        data = numpy.ascontiguousarray(data, dtype=numpy.float32)
        if len(data) > self.max_minibatch_size:
            raise LoaderError(
                "fed minibatch of %d > max_minibatch_size %d"
                % (len(data), self.max_minibatch_size))
        self.queue_.put((data, labels), timeout=timeout)

    def end_epoch(self):
        self.queue_.put(END_OF_EPOCH)

    def end_stream(self):
        self.queue_.put(END_OF_STREAM)

    # -- ILoader ------------------------------------------------------------
    def load_data(self):
        if not self.sample_shape:
            raise LoaderError("sample_shape must be given for streams")
        self._has_labels = True
        # class_lengths are a fiction for streams: one "virtual" train
        # sample keeps the base bookkeeping happy (ref interactive.py
        # does the same with a unit-length dataset).
        self.class_lengths[:] = [0, 0, 1]
        self.shuffle_limit = 0

    def create_minibatch_data(self):
        self.minibatch_data.reset(numpy.zeros(
            (self.max_minibatch_size,) + self.sample_shape,
            dtype=numpy.float32))

    def analyze_dataset(self):
        """Streams cannot be pre-analyzed; require a stateless
        normalizer or one derived from a resident loader."""
        if not self.normalizer.is_initialized:
            try:
                self.normalizer.analyze(numpy.zeros(
                    (1,) + self.sample_shape, dtype=numpy.float32))
            except Exception:
                raise LoaderError(
                    "stream loaders need a stateless normalizer or "
                    "derive_from() a trained loader")

    def fill_minibatch(self):
        pass  # filled directly in run()

    def run(self):
        item = self.queue_.get()
        if item == END_OF_STREAM:
            self._stream_ended_ = True
            self.minibatch_size = 0
            self.last_minibatch <<= True
            self.epoch_ended <<= True
            self.train_ended <<= True
            return
        if item == END_OF_EPOCH:
            self.epoch_number += 1
            self.last_minibatch <<= True
            self.epoch_ended <<= True
            self.train_ended <<= True
            self.minibatch_size = 0
            return
        data, labels = item
        count = len(data)
        self.minibatch_class = TRAIN
        self.minibatch_size = count
        self.last_minibatch <<= False
        self.epoch_ended <<= False
        self.train_ended <<= False
        self.minibatch_data.map_write()
        self.minibatch_data.mem[:count] = \
            data.reshape((count,) + self.sample_shape)
        self.minibatch_data.mem[count:] = 0
        self.normalizer.normalize(self.minibatch_data.mem[:count])
        self.minibatch_labels.map_write()
        if labels is not None:
            for i, raw in enumerate(labels):
                self.minibatch_labels.mem[i] = \
                    self.labels_mapping.get(raw, raw) \
                    if self.labels_mapping else raw
                self.raw_minibatch_labels[i] = raw
            self.minibatch_labels.mem[count:] = -1
        else:
            # an unlabeled batch must not inherit the previous batch's
            # labels
            self.minibatch_labels.mem[:] = -1
            self.raw_minibatch_labels[:count] = [None] * count
        self.samples_served += count

    @property
    def stream_ended(self):
        return self._stream_ended_


class InteractiveLoader(StreamLoader):
    """Direct in-process feed (ref ``interactive.py:57``): the user (or
    an interactive shell) calls ``feed()``."""


class ZeroMQLoader(StreamLoader):
    """Minibatches arriving over a ZeroMQ PULL socket as pickled
    ``(data, labels)`` tuples (ref ``zmq_loader.py:74``; the reference
    binds ROUTER at a random port — same here via ``bind_to_random_port``,
    its ``rndtcp://`` scheme)."""

    def __init__(self, workflow, **kwargs):
        self.endpoint = kwargs.get("endpoint", "tcp://127.0.0.1")
        super(ZeroMQLoader, self).__init__(workflow, **kwargs)

    def init_unpickled(self):
        super(ZeroMQLoader, self).init_unpickled()
        self._zmq_socket_ = None
        self._zmq_thread_ = None

    def initialize(self, **kwargs):
        super(ZeroMQLoader, self).initialize(**kwargs)
        if self._zmq_socket_ is not None:
            return
        import threading
        import zmq
        context = zmq.Context.instance()
        sock = context.socket(zmq.PULL)
        if self.endpoint.count(":") >= 2:   # explicit port
            sock.bind(self.endpoint)
            self.port = int(self.endpoint.rsplit(":", 1)[1])
        else:
            self.port = sock.bind_to_random_port(self.endpoint)
        self._zmq_socket_ = sock
        self.info("ZeroMQ ingestion on %s:%d", self.endpoint, self.port)

        def pump():
            # the pump thread OWNS the socket: libzmq sockets are not
            # thread-safe, and closing one from another thread while
            # recv() is blocked aborts the process (signaler.cpp)
            try:
                while True:
                    try:
                        blob = sock.recv()
                    except Exception:
                        return
                    try:
                        item = pickle.loads(blob)
                        if item in (END_OF_EPOCH, END_OF_STREAM):
                            self.queue_.put(item)
                            if item == END_OF_STREAM:
                                return
                        else:
                            data, labels = item
                            self.feed(data, labels)
                    except Exception:
                        # a malformed/oversized payload must not kill
                        # the pump (the consumer would hang on queue_
                        # forever); drop the batch and keep serving
                        self.exception("dropping malformed ZMQ batch")
            finally:
                sock.close(0)
                self._zmq_socket_ = None

        self._zmq_thread_ = threading.Thread(
            target=pump, daemon=True, name="zmq-loader")
        self._zmq_thread_.start()

    def stop(self):
        if self._zmq_thread_ is not None and self._zmq_thread_.is_alive():
            # wake the pump via the wire so IT closes the socket; the
            # waker lingers until its message is out (the JAX loader
            # closes it at once, which drops the message while the
            # connect is still pending, and the join times out)
            import zmq
            waker = zmq.Context.instance().socket(zmq.PUSH)
            try:
                waker.connect("tcp://127.0.0.1:%d" % self.port)
                waker.send(pickle.dumps(END_OF_STREAM))
            finally:
                waker.close(linger=5000)
            self._zmq_thread_.join(timeout=5)
        self._zmq_thread_ = None


class RestfulLoader(StreamLoader):
    """Minibatches arriving over HTTP POST (ref ``restful.py:52``) —
    the ingestion counterpart of
    :class:`veles_tpu_torch.restful_api.RESTfulAPI`
    (which *serves*): POST {"input": [...], "labels": [...]} feeds the
    stream."""

    def __init__(self, workflow, **kwargs):
        self.port = kwargs.get("port", 0)
        self.host = kwargs.get("host", "127.0.0.1")
        self.path = kwargs.get("path", "/feed")
        super(RestfulLoader, self).__init__(workflow, **kwargs)

    def init_unpickled(self):
        super(RestfulLoader, self).init_unpickled()
        self._server_ = None

    def initialize(self, **kwargs):
        super(RestfulLoader, self).initialize(**kwargs)
        if self._server_ is not None:
            return
        import json
        import threading
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer
        loader = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                if self.path != loader.path:
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length))
                    if payload.get("control") in (END_OF_EPOCH,
                                                  END_OF_STREAM):
                        loader.queue_.put(payload["control"])
                    else:
                        data = numpy.asarray(payload["input"],
                                             dtype=numpy.float32)
                        loader.feed(data, payload.get("labels"))
                    body = b'{"ok": true}'
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 - wire boundary
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                loader.debug("http: " + fmt, *args)

        self._server_ = ThreadingHTTPServer((self.host, self.port),
                                            Handler)
        self.port = self._server_.server_address[1]
        threading.Thread(target=self._server_.serve_forever,
                         daemon=True, name="restful-loader").start()
        self.info("REST ingestion on http://%s:%d%s", self.host,
                  self.port, self.path)

    def stop(self):
        if self._server_ is not None:
            self._server_.shutdown()
            self._server_.server_close()  # release the bound port now
            self._server_ = None
