"""Minimal TCP RPC (the port's counterpart of
``paddle_tpu/distributed/rpc.py``): a length-prefixed pickled
``(method, args, kwargs)`` request, an ``(ok, result-or-traceback)``
response.

The wire format is the JAX package's byte for byte (an 8-byte
little-endian length, then a pickle at the highest protocol), so a port
client talks to a reference server and the reverse.  It stands in for the
reference's three RPC stacks (gRPC ``operators/detail/grpc_server.cc``, Go
``net/rpc`` ``go/connection/conn.go`` and the epoll LightNetwork
``pserver/LightNetwork.cpp``); reconnection follows
``go/connection/conn.go`` (dial retries with backoff).

Payloads are builtins and numpy arrays only.  A torch tensor pickles with
its device (a CUDA tensor would be unpickled onto a card inside a server
process, or fail on a host with none), and an instance of a port class
would make the peer import this package — so ``_send_msg`` refuses both,
and callers convert at their boundary (``core.scope.tensor_to_numpy``).
"""

import io
import pickle
import socket
import socketserver
import struct
import threading
import time
import traceback


class _WirePickler(pickle.Pickler):
    """``pickle.dumps``'s bytes, refusing torch and port objects."""

    def reducer_override(self, obj):
        mod = type(obj).__module__ or ""
        if mod.split(".")[0] in ("torch", "paddle_tpu_torch"):
            raise TypeError(
                f"RPC payloads are builtins and numpy arrays only, got a "
                f"{mod}.{type(obj).__qualname__} (convert tensors with "
                f"core.scope.tensor_to_numpy at the caller)")
        return NotImplemented


def _dumps(obj):
    buf = io.BytesIO()
    _WirePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _send_msg(sock, obj):
    data = _dumps(obj)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_exact(sock, n, what):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError(f"peer closed {what}")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock):
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8, "before a message"))
    return pickle.loads(_recv_exact(sock, n, "mid-message"))


class Server:
    """Serve an object's public methods over TCP."""

    def __init__(self, service, host="127.0.0.1", port=0):
        self.service = service
        svc = service

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        method, args, kwargs = _recv_msg(self.request)
                    except (ConnectionError, EOFError):
                        return
                    try:
                        result = getattr(svc, method)(*args, **kwargs)
                        _send_msg(self.request, (True, result))
                    except Exception:
                        _send_msg(self.request,
                                  (False, traceback.format_exc()))

        class TS(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = TS((host, port), Handler)
        self.addr = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    @property
    def endpoint(self):
        return f"{self.addr[0]}:{self.addr[1]}"

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class Client:
    """Reconnecting RPC client (go/connection/conn.go analog).  Dial
    retries use the shared jittered-exponential backoff
    (``resilience.retry.Backoff``, seeded from ``retry_interval``)."""

    def __init__(self, endpoint, timeout=30.0, retry_interval=0.2):
        host, port = endpoint.rsplit(":", 1)
        self.addr = (host, int(port))
        self.timeout = timeout
        self.retry_interval = retry_interval
        self._sock = None
        self._lock = threading.Lock()

    def _connect(self):
        from ..resilience.retry import Backoff

        deadline = time.time() + self.timeout
        backoff = iter(Backoff(base=self.retry_interval, factor=2.0,
                               max_delay=max(self.retry_interval, 2.0),
                               jitter=0.25))
        while True:
            try:
                s = socket.create_connection(self.addr, timeout=self.timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return s
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(next(backoff))

    def call(self, method, *args, **kwargs):
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    self._sock = self._connect()
                try:
                    _send_msg(self._sock, (method, args, kwargs))
                    ok, result = _recv_msg(self._sock)
                    break
                except (ConnectionError, OSError):
                    self._sock = None
                    if attempt:
                        raise
        if not ok:
            raise RuntimeError(f"remote error calling {method}:\n{result}")
        return result

    def close(self):
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
