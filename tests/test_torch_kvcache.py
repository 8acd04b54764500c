"""The port's copies of the host-side serving state (paddle_tpu_torch/
serving/kvcache.py and scheduler.py) against the JAX package's: one
seeded random sequence of alloc / ref / deref / insert / match / peek /
evict operations drives both ``BlockPool``+``PrefixTrie`` pairs, and the
refcounts, free lists, trie sizes and every returned value must agree at
every step."""

import collections

import numpy as np
import pytest

from paddle_tpu.serving import kvcache as jkv
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu_torch.serving import kvcache as tkv
from paddle_tpu_torch.serving import scheduler as tsched

B = 3


def _call(obj, name, *args):
    """(result, exception type) of one operation."""
    try:
        return getattr(obj, name)(*args), None
    except (tkv.PoolExhausted, jkv.PoolExhausted, ValueError) as e:
        return None, type(e).__name__


def _state(pool, trie):
    return (pool._ref.tolist(), list(pool._free), pool.blocks_in_use,
            len(trie), trie._trie_only_count())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_trie_agree_step_by_step(seed):
    rng = np.random.default_rng(seed)
    jpool, tpool = jkv.BlockPool(16, B), tkv.BlockPool(16, B)
    jtrie = jkv.PrefixTrie(jpool, capacity_blocks=5)
    ttrie = tkv.PrefixTrie(tpool, capacity_blocks=5)
    held = []             # block ids we hold one reference to
    stems = [rng.integers(0, 3, (12,)) for _ in range(3)]

    def tokens():
        # a few shared stems with random tails, so prefixes collide
        t = stems[rng.integers(len(stems))].copy()
        cut = int(rng.integers(1, len(t) + 1))
        t[cut:] = rng.integers(0, 3, (len(t) - cut,))
        return t[: int(rng.integers(1, len(t) + 1))]

    for _ in range(300):
        op = rng.choice(["alloc", "deref", "insert", "match", "peek",
                         "evict", "budget"])
        if op == "alloc":
            n = int(rng.integers(1, 5))
            (jr, je), (tr, te) = _call(jpool, "alloc", n), _call(tpool,
                                                                 "alloc", n)
            assert (jr, je) == (tr, te)
            held += tr or []
        elif op == "deref" and held:
            b = held.pop(int(rng.integers(len(held))))
            jpool.deref(b)
            tpool.deref(b)
        elif op == "insert" and held:
            toks = tokens()
            bids = [held[int(i)] for i in rng.integers(len(held),
                                                       size=len(toks) // B)]
            assert jtrie.insert(toks, bids) == ttrie.insert(toks, bids)
        elif op == "match":
            toks = tokens()
            limit = int(rng.integers(0, len(toks) + 1))
            got = ttrie.match(toks, limit)
            assert jtrie.match(toks, limit) == got
            shared, cow, _ = got
            for b in list(shared) + ([cow[0]] if cow else []):
                jpool.ref(b)
                tpool.ref(b)
                held.append(b)
        elif op == "peek":
            toks = tokens()
            limit = int(rng.integers(0, len(toks) + 1))
            assert jtrie.peek_hit(toks, limit) == ttrie.peek_hit(toks, limit)
        elif op == "evict":
            n = int(rng.integers(1, 4))
            assert jtrie.evict_lru(n) == ttrie.evict_lru(n)
        elif op == "budget":
            jtrie.enforce_budget()
            ttrie.enforce_budget()
        assert _state(jpool, jtrie) == _state(tpool, ttrie)
    for b in held:
        jpool.deref(b)
        tpool.deref(b)
    jtrie.clear()
    ttrie.clear()
    assert _state(jpool, jtrie) == _state(tpool, ttrie)
    assert tpool.blocks_in_use == 0


class _Req:
    def __init__(self, submit_t, max_new, ttft=None, e2e=None):
        self.submit_t, self.max_new = submit_t, max_new
        self.ttft_slo_s, self.e2e_slo_s = ttft, e2e
        self.sheddable = True


class _Budgets:
    ttft_slo_s = 0.5
    e2e_slo_s = 2.0


@pytest.mark.parametrize("kind", ["slo", "fifo"])
def test_scheduler_picks_and_sheds_alike(kind):
    rng = np.random.default_rng(4)
    reqs = [_Req(float(rng.uniform(0, 1)), int(rng.integers(1, 64)),
                 ttft=(None if i % 3 else float(rng.uniform(0.1, 1))),
                 e2e=(None if i % 4 else float(rng.uniform(0.5, 3))))
            for i in range(12)]
    buckets = {id(r): int(2 ** rng.integers(2, 6)) for r in reqs}
    picks = []
    for mod in (jsched, tsched):
        pred = mod.TtftPredictor()
        for b in (4, 16):
            pred.observe_prefill(b, 0.01 * b)
        pred.observe_chunk(0.05, 8)
        sched = mod.make_scheduler(kind, pred, _Budgets())
        queue = collections.deque(reqs)
        order = []
        while queue:
            req, shed = sched.pick(queue, 1.5, lambda r: buckets[id(r)])
            order.append((reqs.index(req) if req is not None else None,
                          [reqs.index(s) for s in shed]))
        picks.append(order)
    assert picks[0] == picks[1]
