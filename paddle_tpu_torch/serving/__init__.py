"""Continuous-batching serving — multi-request greedy decode over a
paged, prefix-shared KV cache with SLO-aware goodput scheduling; the
port's counterpart of ``paddle_tpu.serving``.

``ServingEngine`` keeps one batched decode step saturated across many
concurrent, variable-length requests: a slot pool over a PAGED block KV
cache (``kvcache``), admission between decode chunks ordered by the SLO
scheduler (``scheduler``), power-of-two bucketed SUFFIX prefill, and
``serving.*`` telemetry through the port's observability registry, and
speculative decoding with a draft model (``speculative``).  Attention
runs through the hand-written CUDA paged-attention kernel on the card,
or under ``PADDLE_TPU_PAGED_ATTN=0`` through the hand-written
``decode_gather`` kernel and a dense softmax.
"""

from . import batched_decode, kvcache, scheduler, speculative
from .engine import Request, ServingEngine
from .kvcache import BlockPool, PoolExhausted, PrefixTrie
from .scheduler import (FifoScheduler, SheddedRequest, SloScheduler,
                        TtftPredictor)
from .speculative import depth_draft, spec_enabled

__all__ = [
    "Request", "ServingEngine", "batched_decode", "kvcache", "scheduler",
    "speculative", "depth_draft", "spec_enabled",
    "BlockPool", "PoolExhausted", "PrefixTrie",
    "FifoScheduler", "SheddedRequest", "SloScheduler", "TtftPredictor",
]
