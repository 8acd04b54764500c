"""UCI housing (``paddle_tpu/dataset/uci_housing.py``).  A sample is 13
float32 features and a float32 target ``[1]``: the cached
``housing.data`` (features standardised; rows 0-403 train, 404-505
test), else a linear model plus noise."""

import os

import numpy as np

from . import common


def _synthetic(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        w = np.linspace(-2, 2, 13).astype(np.float32)
        for _ in range(n):
            x = rng.randn(13).astype(np.float32)
            y = float(x @ w + 0.1 * rng.randn())
            yield x, np.asarray([y], np.float32)

    return reader


def _real(path, start, end):
    def reader():
        data = np.loadtxt(path)
        feat = data[:, :-1].astype(np.float32)
        feat = (feat - feat.mean(0)) / (feat.std(0) + 1e-6)
        tgt = data[:, -1:].astype(np.float32)
        for x, y in zip(feat[start:end], tgt[start:end]):
            yield x, y

    return reader


def train():
    path = common.data_path("uci_housing", "housing.data")
    if os.path.exists(path):
        return _real(path, 0, 404)
    return _synthetic(404, 7)


def test():
    path = common.data_path("uci_housing", "housing.data")
    if os.path.exists(path):
        return _real(path, 404, 506)
    return _synthetic(102, 8)
