"""The job layer's wire: length-prefixed frames over TCP, on the Python
standard library's ``socket`` and ``selectors``.

The JAX package's job layer is a ZeroMQ ROUTER/DEALER pair
(:mod:`veles_tpu.parallel.jobs`).  The port keeps no ZeroMQ: the
machine with the card has no pyzmq, and the job path must run there.
This module gives the two roles what the job protocol used of them:

* :class:`Router` (the master): binds with ``SO_REUSEADDR`` (a
  restarted master binds its old port while the dead one's connections
  linger in TIME_WAIT), accepts slaves, and routes by connection
  identity: a frame arrives as ``(identity, blob)`` and a reply goes
  back with ``send_multipart([identity, blob])`` to the connection it
  came on.  A reply to a connection that has closed is dropped, as a
  ROUTER drops an unroutable frame.  :meth:`Router.wake` ends a
  :meth:`Router.poll` early from another thread (the job generation
  workers use it so the loop sends their replies at once).
* :class:`Dealer` (a slave): one ordered stream to the master.  Replies
  arrive in the order the master sent them, so the job protocol's
  ``req`` echo can skip the orphan reply of a timed-out request.  A send
  with no live connection connects first, and a frame that cannot be
  delivered is lost, as a frame sent to a dead peer is; the rpc then
  times out.  ZeroMQ's DEALER reconnected on its own; here
  :meth:`Dealer.reconnect` opens a new stream explicitly (the job
  client calls it before every rejoin handshake).

A frame is an 8-byte big-endian length and the payload bytes (the job
layer's pickled messages).  Both sides set ``TCP_NODELAY``: the
protocol is small request/reply frames, which Nagle's algorithm would
hold back.
"""

import collections
import select
import selectors
import socket
import struct
import threading
import time

_HEADER = struct.Struct("!Q")
#: the largest frame either side accepts; a longer length is a broken
#: stream, and the connection is closed
MAX_FRAME = 1 << 32
#: a slave's connect attempt, and a send the master does not take
CONNECT_TIMEOUT_S = 2.0
SEND_TIMEOUT_S = 30.0


class Again(Exception):
    """No complete frame is queued (the ``NOBLOCK`` receive's answer)."""


def frame(blob):
    """``blob`` with its length prefix."""
    return _HEADER.pack(len(blob)) + blob


def parse_endpoint(endpoint):
    """``tcp://host:port`` (or ``host:port``) → ``(host, port)``."""
    spec = str(endpoint)
    if spec.startswith("tcp://"):
        spec = spec[len("tcp://"):]
    host, sep, port = spec.rpartition(":")
    if not sep:
        raise ValueError("endpoint %r has no port" % (endpoint,))
    return host or "127.0.0.1", int(port)


def _split_frames(buf):
    """Pop every complete frame off the front of ``buf`` (a bytearray).
    Raises ``ValueError`` on a length past :data:`MAX_FRAME`."""
    frames = []
    while len(buf) >= _HEADER.size:
        (size,) = _HEADER.unpack_from(buf)
        if size > MAX_FRAME:
            raise ValueError("frame of %d bytes: the stream is broken"
                             % size)
        end = _HEADER.size + size
        if len(buf) < end:
            break
        frames.append(bytes(buf[_HEADER.size:end]))
        del buf[:end]
    return frames


class _Connection(object):
    """One accepted slave connection of a :class:`Router`."""

    def __init__(self, sock, identity):
        self.sock = sock
        self.identity = identity
        self.rbuf = bytearray()
        self.wbuf = bytearray()

    def read(self):
        """Read what the kernel holds; returns ``(frames, alive)``."""
        while True:
            try:
                data = self.sock.recv(1 << 20)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return _split_frames(self.rbuf), False
            if not data:
                return _split_frames(self.rbuf), False
            self.rbuf += data
        return _split_frames(self.rbuf), True

    def flush(self):
        """Send what the kernel takes; returns False on a dead peer."""
        while self.wbuf:
            try:
                sent = self.sock.send(self.wbuf)
            except (BlockingIOError, InterruptedError):
                return True
            except OSError:
                return False
            del self.wbuf[:sent]
        return True


class Router(object):
    """The master's side: bind, accept, route replies by connection.
    Only one thread may poll, receive and send; :meth:`wake` and
    :meth:`close` are safe from any thread."""

    def __init__(self, host="127.0.0.1", port=0):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind((host, int(port)))
            self._listener.listen(128)
        except OSError:
            self._listener.close()
            raise
        self._listener.setblocking(False)
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ, None)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._lock = threading.Lock()
        self._closed = False
        self._connections = {}
        self._serial = 0
        self._inbox = collections.deque()

    def wake(self):
        """End a :meth:`poll` in progress (from any thread)."""
        with self._lock:
            if self._closed:
                return
            try:
                self._wake_w.send(b"\0")
            except (BlockingIOError, OSError):
                pass        # a wake is already pending, or closing

    def poll(self, timeout_ms):
        """Accept, read and flush for up to ``timeout_ms``; True when a
        frame is queued for :meth:`recv_multipart`."""
        if self._closed:
            time.sleep(max(timeout_ms, 0) / 1e3)
            return False
        timeout = 0 if self._inbox else max(timeout_ms, 0) / 1e3
        for key, mask in self._selector.select(timeout):
            if key.data is None:
                self._accept()
            elif key.data == "wake":
                try:
                    while self._wake_r.recv(4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
            else:
                conn = key.data
                alive = True
                if mask & selectors.EVENT_READ:
                    try:
                        frames, alive = conn.read()
                    except ValueError:
                        frames, alive = [], False
                    self._inbox.extend((conn.identity, f) for f in frames)
                if alive and mask & selectors.EVENT_WRITE:
                    alive = conn.flush()
                    if alive and not conn.wbuf:
                        self._selector.modify(conn.sock,
                                              selectors.EVENT_READ, conn)
                if not alive:
                    self._drop(conn)
        return bool(self._inbox)

    def _accept(self):
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._serial += 1
            conn = _Connection(sock, b"c%d" % self._serial)
            self._connections[conn.identity] = conn
            self._selector.register(sock, selectors.EVENT_READ, conn)

    def _drop(self, conn):
        if self._connections.pop(conn.identity, None) is None:
            return
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.sock.close()

    def recv_multipart(self):
        """``(identity, blob)`` of the oldest queued frame; raises
        :class:`Again` when none is queued."""
        if not self._inbox:
            raise Again()
        return self._inbox.popleft()

    def recv(self, timeout_ms=5000):
        """Poll until a frame arrives and return ``(identity, blob)``;
        ``TimeoutError`` after ``timeout_ms``."""
        deadline = time.monotonic() + timeout_ms / 1e3
        while not self._inbox:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("no frame within %d ms" % timeout_ms)
            self.poll(left * 1e3)
        return self._inbox.popleft()

    def send_multipart(self, parts):
        """Send ``[identity, blob]`` to the connection ``identity``;
        False when that connection is gone (the frame is dropped)."""
        identity, blob = parts
        conn = self._connections.get(identity)
        if conn is None:
            return False
        pending = bool(conn.wbuf)
        conn.wbuf += frame(blob)
        if not conn.flush():
            self._drop(conn)
            return False
        if conn.wbuf and not pending:
            self._selector.modify(
                conn.sock, selectors.EVENT_READ | selectors.EVENT_WRITE,
                conn)
        return True

    def close(self):
        """Close the listener and every connection: the slaves see their
        streams end, as after a master process dies."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for conn in list(self._connections.values()):
                self._drop(conn)
            for sock in (self._listener, self._wake_r, self._wake_w):
                try:
                    self._selector.unregister(sock)
                except (KeyError, ValueError):
                    pass
                sock.close()
            self._selector.close()
            self._inbox.clear()


class Dealer(object):
    """A slave's stream to the master.  Not thread-safe: the job client
    serializes its threads on one lock."""

    def __init__(self, endpoint):
        self.host, self.port = parse_endpoint(endpoint)
        self._sock = None
        self._rbuf = bytearray()
        self._frames = collections.deque()
        self.connect()

    def connect(self):
        """Open the stream if none is open; False when the master does
        not answer (nothing is raised: the next send tries again)."""
        if self._sock is not None:
            return True
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=CONNECT_TIMEOUT_S)
        except OSError:
            return False
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(SEND_TIMEOUT_S)
        self._sock = sock
        return True

    def reconnect(self):
        """Close the stream (discarding what it still held) and open a
        new one."""
        self._drop()
        return self.connect()

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rbuf = bytearray()
        self._frames.clear()

    def send(self, blob):
        """Send one frame; False when it could not be delivered (no
        master at the endpoint, or the stream broke)."""
        if self._sock is None and not self.connect():
            return False
        try:
            self._sock.sendall(frame(blob))
        except OSError:
            self._drop()
            return False
        return True

    def poll(self, timeout_ms):
        """Wait up to ``timeout_ms`` for a frame; True when one is
        queued.  A stream that ends is closed; the wait goes on until
        the timeout, as it would for a silent master."""
        deadline = time.monotonic() + max(timeout_ms, 0) / 1e3
        while not self._frames:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            if self._sock is None:
                time.sleep(left)
                return False
            try:
                readable, _w, _x = select.select(
                    [self._sock], [], [], left)
            except (OSError, ValueError):
                self._drop()
                continue
            if not readable:
                return False
            try:
                data = self._sock.recv(1 << 20)
            except (BlockingIOError, InterruptedError, socket.timeout):
                continue
            except OSError:
                self._drop()
                continue
            if not data:
                self._drop()
                continue
            self._rbuf += data
            try:
                self._frames.extend(_split_frames(self._rbuf))
            except ValueError:
                self._drop()
        return True

    def recv(self):
        """The oldest queued frame; raises :class:`Again` when none is
        queued (poll first)."""
        if not self._frames:
            raise Again()
        return self._frames.popleft()

    def close(self):
        self._drop()
