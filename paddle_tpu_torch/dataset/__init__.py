"""Dataset readers (``paddle_tpu/dataset``): the ones the port's models
read so far — ``uci_housing`` (fit_a_line), ``imikolov`` (word2vec),
``movielens`` (recommender) and ``wmt14`` (seq2seq).

There is no download: each reader looks for the reference's cache
layout under ``common.DATA_HOME`` and otherwise serves a deterministic
synthetic surrogate with the real dataset's sample schema (shapes,
dtypes, vocabulary conventions), so every model runs unchanged; put the
files in the cache to use real data.  The rest of the reference's
readers, and its record-file converter (it needs ``native``'s recordio),
are ``ROADMAP.md`` A9's.
"""

from . import common  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import uci_housing  # noqa: F401
from . import wmt14  # noqa: F401

__all__ = ["common", "uci_housing", "imikolov", "movielens", "wmt14"]
