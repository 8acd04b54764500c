"""WMT14 fr->en (``paddle_tpu/dataset/wmt14.py``).  A sample is
``(src_ids, [<s>] + trg_ids, trg_ids + [<e>])`` with ``<s>`` = 0,
``<e>`` = 1, ``<unk>`` = 2 and dictionaries capped at 30,000.
Synthetic: a reversal task (the target is the source reversed), so a
seq2seq model learns structure."""

import numpy as np

START = "<s>"
END = "<e>"
UNK = "<unk>"

_DICT_SIZE = 30000


def _synthetic(n, dict_size, seed):
    def reader():
        rng = np.random.RandomState(seed)
        hi = min(dict_size, 1000)
        for _ in range(n):
            length = int(rng.randint(3, 12))
            src = rng.randint(3, hi, size=length).astype(np.int64).tolist()
            trg = list(reversed(src))
            yield src, [0] + trg, trg + [1]

    return reader


def train(dict_size=_DICT_SIZE):
    return _synthetic(2048, dict_size, 31)


def test(dict_size=_DICT_SIZE):
    return _synthetic(256, dict_size, 32)
