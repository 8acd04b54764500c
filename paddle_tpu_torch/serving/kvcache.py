"""Paged KV cache — a physical block pool plus a reference-counted
prefix trie, the serving memory subsystem under ``ServingEngine``.

The port's own copy of ``paddle_tpu/serving/kvcache.py`` (numpy only;
the port imports nothing of the JAX package).  The host-side
accounting is identical; the device pools it names are torch tensors
updated in place (``serving/batched_decode.py``).

A contiguous engine would give every slot a ``[max_len, h, dh]`` cache
row: capacity would be ``max_slots x max_len`` whether a request used
8 tokens or 500, and two requests sharing a system prompt would pay
full prefill twice.  This module splits the cache TVM-style into a logical
and a physical layer (PAPERS.md — portable schedule over a tuned
layout):

* **Physical** — ``BlockPool``: ``num_blocks`` fixed-size blocks of
  ``block_tokens`` token positions each, one pool per layer
  (``[num_blocks, block_tokens, n_head, d_head]`` device arrays managed
  by the engine; this class owns the host-side accounting — free list
  and per-block reference counts).  Physical block id 0 is the
  **trash block**: never allocated, permanently referenced, the safe
  landing zone every unused block-table entry points at (overrun decode
  steps write garbage there; no live slot ever attends it).
* **Logical** — each slot's sequence is a chain of block ids in a
  per-slot block table row; position ``t`` lives at
  ``(table[t // B], t % B)``.  Decode attends through the table
  (``batched_decode``) — the table is data, not shape.
* **Prefix reuse** — ``PrefixTrie``: a trie over FULL-block token
  chunks.  A request whose prompt starts with an already-cached chain
  shares those physical blocks (refcount, zero copy, zero prefill
  compute for the shared span); a prompt that diverges INSIDE a cached
  block forks it copy-on-write (one private block copy, the shared
  tokens still skipped).  Blocks are freed when their refcount hits
  zero; cached chains nobody references are evicted LRU under an
  explicit capacity budget.

Refcount invariants (pinned by ``tests/test_kvcache.py``):

- a block referenced by ``k`` slots and present in the trie has
  refcount ``k + 1``; a trie-only block has refcount 1; refcount 0
  means the block is on the free list — exactly one of these states
  holds for every non-trash block at every serving-loop quiescent
  point;
- the trie never holds a block the pool considers free, and eviction
  only ever touches refcount-1 (trie-only) leaf nodes, so a chain
  shared with a live slot can never be yanked out from under it;
- ``alloc`` after ``evict_lru`` always succeeds when the engine uses
  the default pool sizing (``max_slots`` full chains + the cache
  budget + trash), because slot-held blocks are bounded by the slot
  count.

Why full-block granularity is bit-exact: KV at position ``t`` is a
deterministic function of the token prefix ``tokens[:t+1]`` alone
(absolute position embeddings, greedy decode, no dropout).  A trie node
at depth ``d`` is keyed by the exact ``(d+1) * block_tokens``-token
prefix that produced its block, so a match guarantees the cached bytes
equal what prefill would recompute — the engine's served-equals-
single-stream identity survives reuse (the acceptance gate).
"""

import numpy as np

__all__ = ["BlockPool", "PoolExhausted", "PrefixTrie"]


class PoolExhausted(RuntimeError):
    """Not enough free blocks to satisfy an allocation (after LRU
    eviction of every unreferenced cached chain)."""


class BlockPool:
    """Host-side accounting for the physical block pool: free list +
    per-block refcounts.  Block 0 is the trash block — permanently
    referenced, never handed out, the target of every unused block-table
    entry."""

    TRASH = 0

    def __init__(self, num_blocks, block_tokens):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (trash + one real): {num_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1: {block_tokens}")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self._ref = np.zeros(self.num_blocks, np.int64)
        self._ref[self.TRASH] = 1  # pinned forever
        # LIFO free list: recently-freed blocks are re-handed first
        # (their pool rows are hot)
        self._free = list(range(self.num_blocks - 1, self.TRASH, -1))

    # -- accounting views ------------------------------------------------
    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        """Non-trash blocks currently referenced (slots and/or trie)."""
        return self.num_blocks - 1 - len(self._free)

    def refcount(self, bid):
        return int(self._ref[bid])

    # -- lifecycle -------------------------------------------------------
    def alloc(self, n):
        """``n`` fresh blocks at refcount 1, or :class:`PoolExhausted`
        (nothing allocated on failure — all-or-nothing, so a failed
        admission never leaks a partial chain)."""
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free "
                f"of {self.num_blocks - 1}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def ref(self, bid):
        """Add one reference to a live block (sharing an existing
        chain)."""
        if bid == self.TRASH:
            return
        if self._ref[bid] <= 0:
            raise ValueError(f"ref of free block {bid}")
        self._ref[bid] += 1

    def deref(self, bid):
        """Drop one reference; a block hitting zero returns to the free
        list immediately (no deferred sweep — the leak test is exact)."""
        if bid == self.TRASH:
            return
        if self._ref[bid] <= 0:
            raise ValueError(f"deref of free block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)


class _Node:
    """One cached full block: the exact token chunk it encodes, the
    physical block id, children keyed by their chunk tuple, and the LRU
    clock."""

    __slots__ = ("chunk", "block", "children", "parent", "last_used")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk          # tuple of block_tokens ints
        self.block = block          # physical block id
        self.children = {}          # chunk tuple -> _Node
        self.parent = parent        # _Node or the trie root sentinel
        self.last_used = 0


class PrefixTrie:
    """Prefix-reuse index: maps identical prompt prefixes to shared,
    reference-counted block chains.

    Edges are FULL ``block_tokens``-token chunks.  ``match`` walks exact
    chunk matches (share, refcount) and then finds the longest common
    prefix into one more cached chunk (copy-on-write fork material).
    ``insert`` registers a finished prefill's full prompt blocks.
    ``evict_lru``/``enforce_budget`` drop least-recently-used
    UNREFERENCED leaves (refcount 1 — held by nobody but the trie);
    chains shared with live slots are never evicted."""

    def __init__(self, pool, capacity_blocks):
        self.pool = pool
        self.capacity_blocks = int(capacity_blocks)
        self._root = _Node(None, None, None)
        self._clock = 0
        self._nodes = 0

    def __len__(self):
        return self._nodes

    def _tick(self):
        self._clock += 1
        return self._clock

    @staticmethod
    def _chunks(tokens, block_tokens):
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + block_tokens])
                for i in range(0, len(toks) - block_tokens + 1,
                               block_tokens)]

    def match(self, tokens, limit):
        """Longest cached prefix of ``tokens`` usable within ``limit``
        tokens (the engine passes ``p_len - 1``: the last prompt
        position is always recomputed, so its logits exist).

        Returns ``(shared_bids, cow, hit_tokens)``:

        - ``shared_bids`` — block ids fully covered by the match, to be
          referenced as-is (the caller must ``pool.ref`` each);
        - ``cow`` — ``(src_bid, j)`` when the NEXT cached chunk agrees
          on its first ``j > 0`` tokens: fork material (copy the block,
          keep ``j`` positions) — or None;
        - ``hit_tokens`` — total prompt tokens whose prefill is skipped
          (``len(shared_bids) * B + j``).

        Touches every node on the path (LRU)."""
        B = self.pool.block_tokens
        toks = [int(t) for t in tokens]
        node = self._root
        shared = []
        i = 0
        now = self._tick()
        while (i + B <= limit and i + B <= len(toks)):
            child = node.children.get(tuple(toks[i:i + B]))
            if child is None:
                break
            child.last_used = now
            shared.append(child.block)
            node = child
            i += B
        # partial tail: the longest common prefix into one more cached
        # chunk, capped so the total stays within ``limit``
        cow = None
        tail = toks[i:min(len(toks), i + B)]
        room = limit - i
        best_j = 0
        best = None
        if tail and room > 0:
            for chunk, child in node.children.items():
                j = 0
                for a, b in zip(tail, chunk):
                    if a != b:
                        break
                    j += 1
                j = min(j, room)
                if j > best_j:
                    best_j, best = j, child
        if best is not None:
            best.last_used = now
            cow = (best.block, best_j)
        return shared, cow, len(shared) * B + best_j

    def peek_hit(self, tokens, limit):
        """Prompt tokens a :meth:`match` would serve from the cache,
        WITHOUT touching LRU clocks or returning block references — the
        scheduler's prediction probe (estimating a queued request's
        prefill must not distort eviction order)."""
        B = self.pool.block_tokens
        toks = [int(t) for t in tokens]
        node = self._root
        i = 0
        while i + B <= limit and i + B <= len(toks):
            child = node.children.get(tuple(toks[i:i + B]))
            if child is None:
                break
            node = child
            i += B
        tail = toks[i:min(len(toks), i + B)]
        room = limit - i
        best_j = 0
        if tail and room > 0:
            for chunk in node.children:
                j = 0
                for a, b in zip(tail, chunk):
                    if a != b:
                        break
                    j += 1
                best_j = max(best_j, min(j, room))
        return i + best_j

    def insert(self, tokens, block_ids):
        """Register a prompt's FULL blocks: ``block_ids[c]`` holds KV
        for ``tokens[c*B:(c+1)*B]``.  Only whole chunks are inserted
        (``len(block_ids)`` of them); chunks already cached are skipped
        (the caller's private duplicate stays private).  Each inserted
        block gains one trie reference.  Returns the number of blocks
        newly cached."""
        B = self.pool.block_tokens
        chunks = self._chunks(tokens, B)[:len(block_ids)]
        node = self._root
        now = self._tick()
        added = 0
        for chunk, bid in zip(chunks, block_ids):
            child = node.children.get(chunk)
            if child is None:
                self.pool.ref(bid)
                child = _Node(chunk, bid, node)
                node.children[chunk] = child
                self._nodes += 1
                added += 1
            child.last_used = now
            node = child
        if added:
            self.enforce_budget()
        return added

    # -- eviction --------------------------------------------------------
    def _evictable_leaves(self):
        """Leaves held by nobody but the trie (refcount exactly 1) —
        the only nodes LRU eviction may touch.  Depth-first walk; the
        trie is small (bounded by the capacity budget)."""
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.pool.refcount(n.block) == 1:
                out.append(n)
        return out

    def _evict_node(self, node):
        del node.parent.children[node.chunk]
        self._nodes -= 1
        self.pool.deref(node.block)  # -> free list (refcount was 1)

    def evict_lru(self, need_blocks):
        """Free at least ``need_blocks`` blocks by evicting
        least-recently-used unreferenced leaves (a freed leaf may expose
        its parent as the next candidate — chains unwind tail-first).
        Returns the number of blocks actually freed (may be short when
        every cached chain is pinned by a live slot)."""
        freed = 0
        while freed < need_blocks:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            self._evict_node(victim)
            freed += 1
        return freed

    def enforce_budget(self):
        """LRU-evict unreferenced cached blocks down to the capacity
        budget.  Only trie-ONLY blocks count against the budget (a
        block also referenced by a live slot is the slot's memory, not
        cache overhead) and only those are evictable."""
        while True:
            only = self._trie_only_count()
            if only <= self.capacity_blocks:
                return
            leaves = self._evictable_leaves()
            if not leaves:
                return
            self._evict_node(min(leaves, key=lambda n: n.last_used))

    def _trie_only_count(self):
        n = 0
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if self.pool.refcount(nd.block) == 1:
                n += 1
        return n

    def clear(self):
        """Drop every cached chain (deref all trie-held blocks)."""
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self.pool.deref(nd.block)
        self._root.children.clear()
        self._nodes = 0
