"""Reader creators — the port's counterpart of
``paddle_tpu/reader/creator.py`` (reference:
python/paddle/v2/reader/creator.py — np_array, text_file, recordio,
cloud_reader via Go master).

``recordio`` reads the files ``dataset.common.convert`` writes, through
the port's native codec or its multithreaded ``native.Loader``;
``cloud_reader`` pulls task chunks from the distributed master
(``distributed.master.MasterClient``).  Samples are host values; nothing
here touches the card."""

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
    """Read recordio files written by ``dataset.common.convert``
    (reference creator.py:60).  With ``num_threads > 0`` the native
    multithreaded prefetching ``Loader`` decodes chunks off the main
    thread (PyDataProvider2's background-feed pattern, in C++)."""
    import pickle

    from .. import native
    from ..native import recordio as rio

    if isinstance(paths, str):
        paths = paths.split(",")

    if num_threads > 0 and native.available():
        def reader():
            with native.Loader(paths, num_threads=num_threads,
                               queue_cap=max(buf_size, 16),
                               shuffle_seed=shuffle_seed) as loader:
                for rec in loader:
                    yield pickle.loads(rec)

        return reader

    def reader():
        for p in paths:
            for rec in rio.reader(p):
                yield pickle.loads(rec)

    return reader


def cloud_reader(paths, etcd_endpoints=None, timeout_sec=5, buf_size=64):
    """Elastic dataset reader backed by the distributed master service
    (reference creator.py:91 cloud_reader -> Go master): each pass pulls
    task chunks from ``distributed.master.MasterClient`` at
    ``etcd_endpoints`` (the master's endpoint; an in-process master when
    None) and yields every record of the pass once."""
    import pickle

    from ..distributed.master import MasterClient

    def reader():
        client = MasterClient(etcd_endpoints, timeout_sec=timeout_sec)
        client.set_dataset(paths)
        while True:
            rec = client.next_record()
            if rec is None:
                break
            yield pickle.loads(rec)

    return reader
