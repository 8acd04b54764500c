"""Dataset cache helpers (``paddle_tpu/dataset/common.py``; the
reference's ``v2/dataset/common.py``): where a cached file lives, its
md5, ``download``, which succeeds only for a file already cached
(nothing is fetched), and the recordio-backed record files with
``convert``, which writes a reader's samples into the chunked files that
``reader.creator.recordio`` and the distributed master read."""

import hashlib
import os
import pickle

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")


def data_path(module, filename):
    """The cache path of ``filename`` for the reader ``module`` (the path
    only: nothing is created)."""
    return os.path.join(DATA_HOME, module, filename)


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None):
    """The cached copy of ``url``'s file, checked against ``md5sum``; an
    ``IOError`` when it is not cached."""
    filename = data_path(module_name, url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise IOError(f"md5 mismatch for cached {filename}")
        return filename
    raise IOError(
        f"cannot download {url} (nothing is fetched); place the file at "
        f"{filename} to use real data"
    )


# -- recordio-backed record files (chunked, CRC-checked; the native codec
# of native/src/recordio.cc, or its pure-Python spelling) -------------------
def write_records(path, records, compressor=0, max_chunk_bytes=1 << 20):
    from ..native import recordio

    with recordio.Writer(path, compressor=compressor,
                         max_chunk_bytes=max_chunk_bytes) as w:
        for rec in records:
            w.write(rec)


def read_records(path):
    from ..native import recordio

    yield from recordio.reader(path)


def convert(output_path, reader, line_count, name_prefix):
    """Pickle a reader's samples into record files of ``line_count``
    samples each, ``<output_path>/<name_prefix>-00000`` on (reference
    common.py convert -> RecordIO chunks consumed by the Go master);
    returns their paths."""
    idx = 0
    chunk = []
    paths = []

    def flush():
        nonlocal idx, chunk
        if not chunk:
            return
        p = os.path.join(output_path, f"{name_prefix}-{idx:05d}")
        write_records(p, [pickle.dumps(s) for s in chunk])
        paths.append(p)
        idx += 1
        chunk = []

    for sample in reader():
        chunk.append(sample)
        if len(chunk) >= line_count:
            flush()
    flush()
    return paths
