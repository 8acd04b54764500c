"""Continuous-batching serving — multi-request greedy decode over a
paged, prefix-shared KV cache with SLO-aware goodput scheduling; the
port's counterpart of ``paddle_tpu.serving`` (speculative decoding is
not ported yet).

``ServingEngine`` keeps one batched decode step saturated across many
concurrent, variable-length requests: a slot pool over a PAGED block KV
cache (``kvcache``), admission between decode chunks ordered by the SLO
scheduler (``scheduler``), power-of-two bucketed SUFFIX prefill, and
``serving.*`` telemetry through the port's observability registry.
Attention runs through the hand-written CUDA paged-attention kernel on
the card.
"""

from . import batched_decode, kvcache, scheduler
from .engine import Request, ServingEngine
from .kvcache import BlockPool, PoolExhausted, PrefixTrie
from .scheduler import (FifoScheduler, SheddedRequest, SloScheduler,
                        TtftPredictor)

__all__ = [
    "Request", "ServingEngine", "batched_decode", "kvcache", "scheduler",
    "BlockPool", "PoolExhausted", "PrefixTrie",
    "FifoScheduler", "SheddedRequest", "SloScheduler", "TtftPredictor",
]
