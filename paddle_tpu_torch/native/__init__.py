"""paddle_tpu_torch.native — the port's native host runtime (ctypes
bindings), the counterpart of ``paddle_tpu/native``.

The reference implements its data runtime in native code (data providers
``paddle/gserver/dataproviders``, RecordIO chunk partitioning in
``go/master``).  This package keeps that runtime host-side and native:

* ``recordio`` — the chunked, CRC-checked record file format (writer,
  reader, chunk index): the storage layer of datasets and of the
  distributed master's task partitioning.  Its files are byte for byte
  the JAX package's.
* ``Loader`` — the multithreaded prefetching record loader with a
  bounded queue (PyDataProvider2's background-thread pattern, with no
  GIL in the IO path).

``src/recordio.cc`` and ``src/loader.cc`` are built with g++ at first use
(``build.py``).  ``available()`` is false only when the library cannot be
built or loaded; ``lib()`` then raises with the compiler's output.  The
recordio module keeps a pure-Python codec of the same format, chosen by
its explicit ``use_native`` switch; ``Loader`` has no such codec and
raises.  Nothing here touches the card.
"""

import ctypes
import os

from . import build as _build

__all__ = ["available", "lib", "Loader"]

_lib = None
_lib_err = None


def _declare(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    sigs = {
        "rio_writer_open": (c.c_void_p, [c.c_char_p, c.c_int, c.c_uint64]),
        "rio_writer_write": (c.c_int, [c.c_void_p, u8p, c.c_uint64]),
        "rio_writer_close": (c.c_int, [c.c_void_p]),
        "rio_reader_open": (c.c_void_p, [c.c_char_p]),
        "rio_reader_open_at": (c.c_void_p, [c.c_char_p, c.c_uint64]),
        "rio_reader_read": (u8p, [c.c_void_p, c.POINTER(c.c_uint64)]),
        "rio_reader_error": (c.c_char_p, [c.c_void_p]),
        "rio_reader_close": (None, [c.c_void_p]),
        "rio_reader_chunk_drained": (c.c_int, [c.c_void_p]),
        "rio_index": (c.c_int64, [c.c_char_p, c.POINTER(c.c_uint64),
                                  c.POINTER(c.c_uint32), c.c_int64]),
        "loader_create": (c.c_void_p, [c.POINTER(c.c_char_p), c.c_int64,
                                       c.c_int, c.c_uint64, c.c_int64]),
        "loader_next": (u8p, [c.c_void_p, c.POINTER(c.c_uint64)]),
        "loader_next_batch": (c.c_int64, [c.c_void_p, c.c_int64,
                                          c.c_uint64, c.c_uint64,
                                          c.c_void_p, c.c_void_p]),
        "loader_error": (c.c_char_p, [c.c_void_p]),
        "loader_destroy": (None, [c.c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build.build())
        _declare(lib)
    except (OSError, RuntimeError, AttributeError) as e:
        _lib_err = e
        return None
    _lib = lib
    return _lib


def available():
    """Whether the native library builds and loads on this host."""
    return _load() is not None


def lib():
    """The loaded library; ``RuntimeError`` (with the build's error) when
    it cannot be built or loaded."""
    handle = _load()
    if handle is None:
        raise RuntimeError(f"native library unavailable: {_lib_err}")
    return handle


class Loader:
    """Multithreaded prefetching reader over recordio files.

    Iterates raw record bytes; a deterministic chunk-order shuffle when
    ``shuffle_seed >= 0``."""

    def __init__(self, paths, num_threads=4, queue_cap=4096,
                 shuffle_seed=-1):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._lib = lib()
        arr = (ctypes.c_char_p * len(paths))(
            *[os.fspath(p).encode() for p in paths])
        self._h = self._lib.loader_create(arr, len(paths), num_threads,
                                          queue_cap, shuffle_seed)
        if not self._h:
            raise IOError(f"loader_create failed for {paths}")

    def __iter__(self):
        n = ctypes.c_uint64()
        while True:
            p = self._lib.loader_next(self._h, ctypes.byref(n))
            if not p:
                err = self._lib.loader_error(self._h)
                if err:
                    raise IOError(f"loader: {err.decode()}")
                return
            yield ctypes.string_at(p, n.value)

    def next_batch(self, batch_size, prefix_bytes, payload_bytes,
                   prefix_dtype="uint8", payload_dtype="uint8"):
        """Assemble up to ``batch_size`` fixed-size records C-side: every
        record must be exactly ``prefix_bytes + payload_bytes``; prefixes
        (labels) and payloads (tensors) are copied contiguously into
        fresh numpy buffers.  Returns ``(prefix, payload)`` arrays of
        ``n`` rows (``n < batch_size`` at the end of the stream), or
        ``None`` when exhausted.  Raises on malformed records or IO
        errors; the good records of a short batch cut by an error ride
        on the exception as ``err.partial``."""
        import numpy as np

        prefix = np.empty((batch_size, prefix_bytes), np.uint8)
        payload = np.empty((batch_size, payload_bytes), np.uint8)
        n = self._lib.loader_next_batch(
            self._h, batch_size, prefix_bytes, payload_bytes,
            prefix.ctypes.data_as(ctypes.c_void_p),
            payload.ctypes.data_as(ctypes.c_void_p))
        err = self._lib.loader_error(self._h)
        if n < 0:
            raise IOError(f"loader batch: {err.decode() if err else '?'}")
        if n == 0:
            if err:
                raise IOError(f"loader: {err.decode()}")
            return None
        pre, pay = prefix[:n], payload[:n]
        if prefix_dtype != "uint8":
            pre = pre.view(prefix_dtype)
        if payload_dtype != "uint8":
            pay = pay.view(payload_dtype)
        if n < batch_size and err:
            e = IOError(f"loader: {err.decode()}")
            e.partial = (pre, pay)
            raise e
        return pre, pay

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
