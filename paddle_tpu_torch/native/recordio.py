"""recordio — the Python API over the chunked record format (the port's
counterpart of ``paddle_tpu/native/recordio.py``).

RecordIO files are the cluster dataset interchange format: the reference's
``python/paddle/v2/reader/creator.py:60 recordio`` reads them and
``go/master/service.go:106 partition`` splits them into chunk tasks.  The
native codec is ``src/recordio.cc``; a pure-Python codec of the same
on-disk bytes sits beside it.  Every entry takes ``use_native``: ``None``
picks the native codec when the library is available, ``True`` requires
it, ``False`` takes the Python codec.  Files written by either codec, and
by the JAX package, read back through both.

File layout: ``Chunk*``; a chunk is a little-endian header (magic
``0x50545243``, compressor 0 none / 1 zlib, CRC32 of the stored bytes,
record count, raw length, stored length) and its payload of
``{u32 length, bytes}`` records.
"""

import ctypes
import os
import struct
import zlib

from . import available, lib

__all__ = ["MAGIC", "Writer", "reader", "index", "read_chunk"]

MAGIC = 0x50545243
_HEADER = struct.Struct("<IIIIQQ")  # magic, compressor, crc, nrec, raw, stored


def _native(use_native):
    return available() if use_native is None else bool(use_native)


class Writer:
    """Append records to a recordio file.  ``compressor``: 0 none, 1 zlib;
    a chunk is closed once its payload reaches ``max_chunk_bytes``."""

    def __init__(self, path, compressor=0, max_chunk_bytes=1 << 20,
                 use_native=None):
        self.path = os.fspath(path)
        self._native = None
        self._f = None
        if _native(use_native):
            self._lib = lib()
            self._native = self._lib.rio_writer_open(
                self.path.encode(), compressor, max_chunk_bytes)
            if not self._native:
                raise IOError(f"cannot open {path} for writing")
        else:
            self._f = open(self.path, "wb")
            self._compressor = compressor
            self._max = max_chunk_bytes
            self._buf = bytearray()
            self._nrec = 0

    def write(self, record: bytes):
        if self._native:
            buf = (ctypes.c_uint8 * len(record)).from_buffer_copy(record)
            if self._lib.rio_writer_write(self._native, buf,
                                          len(record)) != 0:
                raise IOError("recordio write failed")
            return
        self._buf += struct.pack("<I", len(record)) + record
        self._nrec += 1
        if len(self._buf) >= self._max:
            self._flush()

    def _flush(self):
        if self._nrec == 0:
            return
        raw = bytes(self._buf)
        stored = zlib.compress(raw) if self._compressor == 1 else raw
        crc = zlib.crc32(stored) & 0xFFFFFFFF
        self._f.write(_HEADER.pack(MAGIC, self._compressor, crc, self._nrec,
                                   len(raw), len(stored)))
        self._f.write(stored)
        self._buf = bytearray()
        self._nrec = 0

    def close(self):
        if self._native:
            rc = self._lib.rio_writer_close(self._native)
            self._native = None
            if rc != 0:
                raise IOError("recordio close failed")
        elif self._f is not None:
            self._flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _py_header(f):
    """The next chunk header of ``f``, or None at the end of the file."""
    hdr = f.read(_HEADER.size)
    if not hdr:
        return None
    if len(hdr) < _HEADER.size:
        raise IOError("truncated recordio chunk header")
    fields = _HEADER.unpack(hdr)
    if fields[0] != MAGIC:
        raise IOError("corrupt recordio chunk header")
    return fields


def _py_chunk_records(f, fields):
    _, comp, crc, nrec, _, stored_len = fields
    stored = f.read(stored_len)
    if len(stored) != stored_len:
        raise IOError("truncated recordio chunk")
    if zlib.crc32(stored) & 0xFFFFFFFF != crc:
        raise IOError("recordio crc mismatch")
    payload = zlib.decompress(stored) if comp == 1 else stored
    pos = 0
    for _ in range(nrec):
        (ln,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        yield payload[pos:pos + ln]
        pos += ln


def _native_records(handle, one_chunk=False):
    l = lib()
    try:
        n = ctypes.c_uint64()
        while True:
            p = l.rio_reader_read(handle, ctypes.byref(n))
            if not p:
                err = l.rio_reader_error(handle)
                if err:
                    raise IOError(f"recordio: {err.decode()}")
                return
            yield ctypes.string_at(p, n.value)
            if one_chunk and l.rio_reader_chunk_drained(handle):
                return
    finally:
        l.rio_reader_close(handle)


def reader(path, use_native=None):
    """Generator over the records of a recordio file."""
    path = os.fspath(path)
    if not _native(use_native):
        with open(path, "rb") as f:
            while (fields := _py_header(f)) is not None:
                yield from _py_chunk_records(f, fields)
        return
    h = lib().rio_reader_open(path.encode())
    if not h:
        raise IOError(f"cannot open {path}")
    yield from _native_records(h)


def index(path, use_native=None):
    """``[(chunk_offset, num_records)]`` — the master's partition unit
    (go/master/service.go:106)."""
    path = os.fspath(path)
    if not _native(use_native):
        out = []
        with open(path, "rb") as f:
            while True:
                off = f.tell()
                fields = _py_header(f)
                if fields is None:
                    return out
                out.append((off, fields[3]))
                f.seek(fields[5], os.SEEK_CUR)
    l = lib()
    cnt = l.rio_index(path.encode(), None, None, 0)
    if cnt < 0:
        raise IOError(f"cannot index {path}")
    offs = (ctypes.c_uint64 * cnt)()
    counts = (ctypes.c_uint32 * cnt)()
    l.rio_index(path.encode(), offs, counts, cnt)
    return list(zip(offs, counts))


def read_chunk(path, offset, use_native=None):
    """The records of the single chunk at ``offset`` (a master task)."""
    path = os.fspath(path)
    if not _native(use_native):
        with open(path, "rb") as f:
            f.seek(offset)
            fields = _py_header(f)
            if fields is None:
                raise IOError("truncated recordio chunk header")
            yield from _py_chunk_records(f, fields)
        return
    h = lib().rio_reader_open_at(path.encode(), offset)
    if not h:
        raise IOError(f"cannot open {path}@{offset}")
    yield from _native_records(h, one_chunk=True)
