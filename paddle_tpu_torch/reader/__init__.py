"""Composable data readers — the port's counterpart of
``paddle_tpu/reader``.

Reference: python/paddle/v2/reader — a reader is a no-arg callable returning
an iterable of samples; decorators compose them (decorator.py: map_readers,
shuffle, batched/batch, buffered, compose, chain, firstn, xmap_readers,
pipe_reader; creator.py: np_array, text_file, recordio, cloud_reader).
Identical protocol here; ``prefetch_to_device`` moves batches to the card
ahead of the step on a side CUDA stream.
"""

from .decorator import (
    map_readers,
    buffered,
    compose,
    chain,
    shuffle,
    firstn,
    xmap_readers,
    batch,
    prefetch_to_device,
    resumable,
    ResumableReader,
)
from . import creator
from . import provider

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle", "firstn",
    "xmap_readers", "batch", "prefetch_to_device", "resumable",
    "ResumableReader", "creator", "provider",
]
