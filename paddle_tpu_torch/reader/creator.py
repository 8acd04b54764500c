"""Reader creators — the port's counterpart of
``paddle_tpu/reader/creator.py`` (reference:
python/paddle/v2/reader/creator.py — np_array, text_file, recordio,
cloud_reader via Go master).

``recordio`` and ``cloud_reader`` need the native recordio loader and the
distributed master, which the port does not have yet (ROADMAP A9): they
raise ``NotImplementedError``."""

import numpy as np

__all__ = ["np_array", "text_file", "recordio", "cloud_reader"]


def np_array(x):
    def reader():
        for e in np.asarray(x):
            yield e

    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100, num_threads=0, shuffle_seed=-1):
    """Not ported yet: the recordio format and its native multithreaded
    loader (``paddle_tpu/native``) are ROADMAP A9."""
    raise NotImplementedError(
        "reader.creator.recordio needs the native recordio loader, which "
        "the port does not have yet (ROADMAP.md A9)")


def cloud_reader(paths, etcd_endpoints=None, timeout_sec=5, buf_size=64):
    """Not ported yet: the elastic reader pulls task chunks from the
    distributed master service (``paddle_tpu/distributed``), ROADMAP A9."""
    raise NotImplementedError(
        "reader.creator.cloud_reader needs the distributed master service, "
        "which the port does not have yet (ROADMAP.md A9)")
