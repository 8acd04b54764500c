"""Dataset cache helpers (``paddle_tpu/dataset/common.py``; the
reference's ``v2/dataset/common.py``): where a cached file lives, its
md5, and ``download``, which succeeds only for a file already cached
(nothing is fetched)."""

import hashlib
import os

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
