"""The Penn Treebank language-model corpus (``paddle_tpu/dataset/
imikolov.py``): n-gram tuples or whole sentences of word ids, from the
cached ``ptb.*.txt`` files, else from a synthetic corpus of the same
schema over 2,000 words (an order-1 Markov chain, so an n-gram model
has something to learn)."""

import os

import numpy as np

from . import common

N_GRAM = "ngram"
SEQ = "seq"

_SYN_VOCAB = 2000


def build_dict(min_word_freq=50):
    """word -> id, most frequent first, ``<unk>`` last; the synthetic
    corpus's words are ``w0 .. w1999``."""
    path = common.data_path("imikolov", "ptb.train.txt")
    if os.path.exists(path):
        freq = {}
        with open(path) as f:
            for line in f:
                for w in line.strip().split():
                    freq[w] = freq.get(w, 0) + 1
        freq = {w: c for w, c in freq.items() if c >= min_word_freq}
        words = sorted(freq, key=lambda w: (-freq[w], w))
        d = {w: i for i, w in enumerate(words)}
        d["<unk>"] = len(d)
        return d
    return {f"w{i}": i for i in range(_SYN_VOCAB)}


def _file_reader(path, word_dict, n, data_type):
    unk = word_dict.get("<unk>", len(word_dict) - 1)

    def reader():
        with open(path) as f:
            for line in f:
                ids = [word_dict.get(w, unk) for w in line.strip().split()]
                if data_type == N_GRAM:
                    if len(ids) < n:
                        continue
                    for i in range(n - 1, len(ids)):
                        yield tuple(ids[i - n + 1: i + 1])
                else:
                    yield ids

    return reader


def _synthetic(n_samples, n, data_type, seed):
    def reader():
        rng = np.random.RandomState(seed)
        trans = rng.randint(0, _SYN_VOCAB, size=(_SYN_VOCAB,))
        for _ in range(n_samples):
            length = n if data_type == N_GRAM else int(rng.randint(5, 30))
            w = int(rng.randint(0, _SYN_VOCAB))
            seq = [w]
            for _ in range(length - 1):
                w = int((trans[w] + rng.randint(0, 3)) % _SYN_VOCAB)
                seq.append(w)
            yield tuple(seq) if data_type == N_GRAM else seq

    return reader


def _reader(split, word_dict, n, data_type, n_syn, seed):
    path = common.data_path("imikolov", f"ptb.{split}.txt")
    if os.path.exists(path):
        return _file_reader(path, word_dict, n, data_type)
    return _synthetic(n_syn, n, data_type, seed)


def train(word_dict, n, data_type=N_GRAM):
    return _reader("train", word_dict, n, data_type, 8192, seed=61)


def test(word_dict, n, data_type=N_GRAM):
    return _reader("valid", word_dict, n, data_type, 1024, seed=62)
