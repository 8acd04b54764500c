"""Speculative decoding over the paged serving engine — draft-model
propose, single-pass target verify, token-exact rollback.  The port's
counterpart of ``paddle_tpu/serving/speculative.py``.

* **Propose** — a small DRAFT model (the same ``transformer.build``
  family, depth-pruned: identical vocab / d_model / head geometry,
  fewer layers) runs ``k + 1`` greedy steps per slot through
  ``make_decode_chunk``, writing its KV into SCRATCH block chains
  allocated from the same :class:`BlockPool` the real chains live in:
  disjoint block ids inside the first ``draft_n_layer`` pool tensors,
  which the draft receives as a sliced list of the engine's own tensors,
  so its writes land in place.
* **Verify** — ONE target forward scores all ``k + 1`` window positions
  per slot (``batched_decode.make_verify_window``): the weights are read
  once for the whole window instead of once per token.
* **Accept** — greedy acceptance walks the longest prefix where the
  draft's proposal equals the target's argmax, then commits one BONUS
  token (the target's argmax at the first divergence).  Every committed
  token equals the sequential greedy one by induction, and at least one
  commits per round.
* **Roll back** — scratch blocks past the new committed frontier return
  to the pool (``serving.spec_rollback_blocks``); the rejected draft K/V
  is dead data that is rewritten before it is ever attended, so rollback
  is host accounting only.  Slot finish, death and abort release the
  whole scratch chain through the engine's ``_release_slot``.

The draft never touches the engine's committed slot state: it keeps its
own ``last``/``pos`` scratch tensors, which propose refills from the
host's committed frontier every round and the draft prefill writes.

Kill switch: ``PADDLE_TPU_SPEC=0`` (or ``off``/``false``/``no``) makes
the engine ignore ``draft_params`` entirely — no validation, no extra
pool blocks, no draft callables — identical to the plain engine.
"""

import os

import numpy as np
import torch

from ..models.transformer import params_from_numpy
from . import batched_decode as _bd

__all__ = ["DEFAULT_SPEC_K", "spec_enabled", "draft_depth",
           "depth_draft", "validate_draft", "accept_greedy",
           "SpecState"]

# the draft window when the caller gives none and the tune cache has no
# op=spec_decode entry for the engine's shape
DEFAULT_SPEC_K = 4


def spec_enabled():
    """The ``PADDLE_TPU_SPEC`` kill switch: False for ``0`` / ``off`` /
    ``false`` / ``no``; default True.  Read at engine construction."""
    v = os.environ.get("PADDLE_TPU_SPEC", "1").strip().lower()
    return v not in ("0", "off", "false", "no")


def draft_depth(params):
    """Number of transformer blocks a parameter dict carries (the
    ``block{i}_*`` naming of ``transformer.build``)."""
    depth = 0
    for k in params:
        if k.startswith("block") and "_" in k:
            head = k[len("block"):k.index("_")]
            if head.isdigit():
                depth = max(depth, int(head) + 1)
    return depth


def depth_draft(params, n_layers):
    """A depth-pruned draft from target params: the first ``n_layers``
    transformer blocks plus the shared embeddings / final LN / LM head —
    same vocab, width and head geometry by construction."""
    if not 1 <= int(n_layers) <= draft_depth(params):
        raise ValueError(
            f"depth_draft: n_layers {n_layers} outside [1, "
            f"{draft_depth(params)}]")
    out = {}
    for k, v in params.items():
        if k.startswith("block") and "_" in k:
            head = k[len("block"):k.index("_")]
            if head.isdigit() and int(head) >= int(n_layers):
                continue
        out[k] = v
    return out


def validate_draft(params, draft_params, n_layer, n_head, d_model,
                   max_len, draft_n_layer=None, draft_n_head=None):
    """Geometry checks at engine construction — the draft shares the
    target's paged pool tensors and tokenizer, so mismatches fail LOUDLY
    here, not as garbage tokens at serve time.  Returns the validated
    ``draft_n_layer``."""
    t_vocab = int(params["tok_emb.w"].shape[0])
    d_vocab = int(draft_params["tok_emb.w"].shape[0])
    if t_vocab != d_vocab:
        raise ValueError(
            f"speculative draft/target vocab mismatch: draft tok_emb "
            f"has {d_vocab} entries, target has {t_vocab} — the models "
            f"must share one tokenizer for acceptance to compare tokens")
    d_head_vocab = int(draft_params["lm_head.w"].shape[1])
    if d_head_vocab != t_vocab:
        raise ValueError(
            f"speculative draft lm_head emits {d_head_vocab} logits, "
            f"target vocab is {t_vocab} — shared tokenizer required")
    d_width = int(draft_params["tok_emb.w"].shape[1])
    if d_width != d_model:
        raise ValueError(
            f"speculative draft d_model {d_width} != target d_model "
            f"{d_model}: the draft writes its K/V into the target's "
            f"paged pool tensors, so the widths must match")
    dnh = n_head if draft_n_head is None else int(draft_n_head)
    if dnh != n_head:
        raise ValueError(
            f"speculative draft d_head {d_model // dnh} (n_head {dnh}) "
            f"!= target d_head {d_model // n_head} (n_head {n_head}): "
            f"the shared pool block shape is [B, n_head, d_head]")
    depth = draft_depth(draft_params)
    dnl = depth if draft_n_layer is None else int(draft_n_layer)
    if not 1 <= dnl <= depth:
        raise ValueError(
            f"speculative draft_n_layer {dnl} outside [1, {depth}] "
            f"(layers present in draft_params)")
    if dnl > n_layer:
        raise ValueError(
            f"speculative draft has {dnl} layers, target has {n_layer}: "
            f"the draft rides the first {n_layer} pool tensors, so it "
            f"cannot be deeper than the target")
    d_pos = int(draft_params["pos_emb.w.w"].shape[0])
    if max_len > d_pos:
        raise ValueError(
            f"max_len {max_len} exceeds the draft's position-embedding "
            f"table ({d_pos} positions)")
    return dnl


def accept_greedy(drafts, target_greedy, max_commit):
    """The acceptance walk for one slot: ``drafts`` are the k proposed
    tokens, ``target_greedy`` the target's k+1 window argmaxes
    (``target_greedy[j]`` = greedy token after the prefix extended by
    ``drafts[:j]``).  Returns ``(tokens, n_matched)``: the committed
    tokens — the longest agreeing prefix plus the bonus token at the
    divergence, capped at ``max_commit`` — and how many draft proposals
    they contain.  At least one token commits."""
    n = 0
    while (n < len(drafts) and n + 1 < max_commit
           and int(drafts[n]) == int(target_greedy[n])):
        n += 1
    commit = [int(t) for t in target_greedy[:n + 1]][:max_commit]
    return commit, min(n, len(commit))


class SpecState:
    """Per-engine speculative state: the draft params on the engine's
    device, the draft's scratch block table and chains, its own
    ``last``/``pos`` scratch tensors, and the draft and verify callables
    (one prefill per suffix bucket, one ``k + 1``-step propose chunk,
    one verify window).  All block accounting flows through the engine's
    :class:`BlockPool`; the engine's ``_release_slot`` / ``_abort`` call
    :meth:`release`, so scratch chains obey the same zero-leak
    discipline as real chains."""

    def __init__(self, engine, draft_params, draft_n_layer, k):
        if int(k) < 1:
            raise ValueError(f"spec_k must be >= 1: {k}")
        self.k = int(k)
        self.n_layer = int(draft_n_layer)
        self.p = params_from_numpy(draft_params, engine.device,
                                   engine.compute_dtype)
        self.table = np.zeros((engine.max_slots, engine.blocks_per_slot),
                              np.int32)
        self.chains = [None] * engine.max_slots
        # the draft's slot state: scratch, never the engine's _last/_pos
        self.last = torch.zeros(engine.max_slots, dtype=torch.int32,
                                device=engine.device)
        self.pos = torch.zeros_like(self.last)
        self._prefill_fns = {}
        self._chunk_fn = None
        self._verify_fn = None
        # cumulative accept accounting for serving.spec_accept_rate
        # (reset with the goodput window)
        self.proposed = 0
        self.accepted = 0

    # -- callables ----------------------------------------------------------
    def _built(self, engine, fn, label):
        engine._record_spelling(fn, label)
        engine._reg.counter(
            "serving.spec_compiles",
            help="speculative step callables built (draft prefill "
                 "buckets + draft chunk + verify window)").inc()
        return fn

    def chunk_fn(self, engine):
        """The draft PROPOSE callable: ``k + 1`` greedy draft steps (the
        extra step writes the k-th proposal's K/V, so a fully accepted
        round leaves the draft cache current)."""
        if self._chunk_fn is None:
            self._chunk_fn = self._built(engine, _bd.make_decode_chunk(
                self.n_layer, engine.n_head, engine.d_model, self.k + 1,
                eps=engine._eps, splits=engine.attn_splits,
                **engine._attn_kw()), "spec_draft")
        return self._chunk_fn

    def verify_fn(self, engine):
        if self._verify_fn is None:
            self._verify_fn = self._built(engine, _bd.make_verify_window(
                engine.n_layer, engine.n_head, engine.d_model, self.k,
                eps=engine._eps, **engine._attn_kw()), "spec_verify")
        return self._verify_fn

    def prefill_fn(self, engine, bucket):
        fn = self._prefill_fns.get(bucket)
        if fn is None:
            fn = self._built(engine, _bd.make_prefill(
                self.n_layer, engine.n_head, engine.d_model, bucket,
                eps=engine._eps, **engine._attn_kw()),
                f"spec_prefill_{bucket}")
            self._prefill_fns[bucket] = fn
        return fn

    # -- scratch-chain accounting -------------------------------------------
    def ensure_chain(self, engine, slot, n_blocks):
        """Extend slot's scratch chain to ``n_blocks`` blocks (LRU-
        evicting cached prefix chains under pressure, like admission)."""
        chain = self.chains[slot] or []
        need = n_blocks - len(chain)
        if need <= 0:
            return
        pool, trie = engine.kv_pool, engine.prefix_trie
        if need > pool.free_blocks and trie is not None:
            trie.evict_lru(need - pool.free_blocks)
        fresh = pool.alloc(need)
        chain.extend(fresh)
        self.chains[slot] = chain
        self.table[slot, :len(chain)] = chain
        engine._reg.gauge("serving.blocks_in_use").set(pool.blocks_in_use)

    def rollback(self, engine, slot, keep_blocks):
        """Return scratch blocks past the committed frontier to the pool;
        their K/V came from REJECTED tokens and is never attended."""
        chain = self.chains[slot]
        if chain is None or len(chain) <= keep_blocks:
            return 0
        dropped = chain[keep_blocks:]
        del chain[keep_blocks:]
        for b in dropped:
            engine.kv_pool.deref(b)
        self.table[slot, len(chain):] = 0
        engine._reg.counter(
            "serving.spec_rollback_blocks",
            help="draft scratch blocks rolled back to the pool after "
                 "rejection").inc(len(dropped))
        return len(dropped)

    def release(self, engine, slot):
        """Drop slot's whole scratch chain (finish, injected death and
        abort all land here)."""
        for b in self.chains[slot] or ():
            engine.kv_pool.deref(b)
        self.chains[slot] = None
        self.table[slot] = 0

    # -- draft forward passes -----------------------------------------------
    def prefill(self, engine, slot, req):
        """Run the draft over the full prompt into the scratch chain so
        the first propose round has a complete draft KV.  No prefix reuse
        on the draft side.  The draft's own first token and its
        ``last``/``pos`` writes are discarded: propose refills both from
        the committed (TARGET) frontier."""
        p_len = req.prompt.shape[0]
        self.ensure_chain(engine, slot, -(-p_len // engine.block_tokens))
        bucket = engine.bucket_for(p_len)
        padded = np.zeros(bucket, np.int32)
        padded[:p_len] = req.prompt
        nl = self.n_layer
        self.prefill_fn(engine, bucket)(
            self.p, engine._pk[:nl], engine._pv[:nl], self.last, self.pos,
            slot, torch.from_numpy(self.table[slot]).to(engine.device),
            torch.from_numpy(padded).to(engine.device), 0, p_len, 0, 0)

    def propose(self, engine, last_h, pos_h):
        """One draft chunk: ``k + 1`` greedy steps per slot from the
        committed frontier.  Returns the proposals ``[k, S]`` on the host
        (step j's output is the j+1'th draft token; the final step only
        writes the k-th proposal's K/V)."""
        self.last.copy_(torch.from_numpy(last_h))
        self.pos.copy_(torch.from_numpy(pos_h))
        nl = self.n_layer
        toks = self.chunk_fn(engine)(
            self.p, engine._pk[:nl], engine._pv[:nl], self.last, self.pos,
            torch.from_numpy(self.table).to(engine.device))
        return toks.cpu().numpy()[:self.k]
