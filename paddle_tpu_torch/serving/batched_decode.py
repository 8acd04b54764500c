"""Paged slot-batched KV-cache decode — the PyTorch compute under
``paddle_tpu_torch.serving``; the counterpart of
``paddle_tpu/serving/batched_decode.py``.

KV lives in a physical block pool: per layer one
``[num_blocks, block_tokens, h, dh]`` tensor, and each slot's logical
sequence is a chain of block ids in a per-slot BLOCK TABLE row
(``[max_slots, blocks_per_slot]`` int32, host-managed by
``serving.kvcache``).  Position ``t`` of slot ``s`` lives at
``(table[s, t // B], t % B)``.  Unused table entries point at physical
block 0, the trash block: overrun steps (a finished slot riding out
the chunk, prefill bucket padding) write garbage there and nowhere
else.

Where the JAX version builds jitted executables whose ``lax.scan``
carries the pools and donates them, these builders return plain Python
callables that loop over the chunk / the bucket and update the pools
and the slot state IN PLACE (``pool[blk, off] = kh``; ``pool[dst] =
pool[src]`` for the copy-on-write fork).  Callers keep their
references; nothing is returned for the pools.

Attention goes THROUGH the table via ``kernels.paged_attention`` (the
hand-written CUDA kernel on the card, its plain version on the CPU), so
the ``[S, T, h, dh]`` gathered view never exists.
``PADDLE_TPU_PAGED_ATTN=0`` selects the reference's kill-switch and
oracle spelling instead: each slot's view is gathered through the
``kernels.decode_gather`` kernel and attended with a dense softmax.  The
switch is read when a factory (``make_decode_chunk``, ``make_prefill``,
``make_verify_window``) makes its callable — the JAX package reads it
at trace time — so a callable keeps the spelling it was built with; the
callable's ``paged`` attribute records which.

Three factories: the decode chunk, the prefill per suffix bucket, and
the speculative VERIFY window (``make_verify_window``): one
teacher-forced forward over a ``k + 1``-token window per slot.

Correctness discipline (the JAX module's): every op is row-wise per
slot, each step writes position ``t`` BEFORE attending with mask
``<= t``, and garbage (trash-block content, bucket padding, CoW tail
beyond the shared span) is either overwritten before it is attended or
never read — so greedy decode through the engine matches single-stream
``transformer.generate``, prefix reuse on or off.
"""

import math
import os

import torch
import torch.nn.functional as F

from ..kernels.decode_gather import decode_gather
from ..kernels.paged_attention import NEG_INF, paged_attention
from ..models.transformer import layer_norm, logits_f32

__all__ = ["paged_step_logits", "make_decode_chunk", "make_prefill",
           "make_verify_window"]


def _paged_attn_on():
    """The ``PADDLE_TPU_PAGED_ATTN`` kill switch (default on).  Read by
    the factories, once per callable."""
    return os.environ.get("PADDLE_TPU_PAGED_ATTN", "1").lower() not in (
        "0", "", "false", "off", "no")


def _gather_kv(pool, table):
    """The kill-switch spelling's block-table gather: each slot's logical
    view ``[S, T, h, dh]`` through ``kernels.decode_gather`` (the CUDA
    kernel on the card, its plain version on the CPU).  Bit-exact."""
    return decode_gather(pool, table)


def _dense_attention(qh, pool_k, pool_v, table, P):
    """Attention over the gathered view with a dense softmax —
    ``batched_decode.py``'s kill-switch branch of the JAX package:
    ``qh [S, W, h, dh]``, ``P [S, W]`` positions (key ``j`` counts iff
    ``j <= P``) -> ``[S, W, h, dh]``.  Scores in f32 (upcast before the
    product, as ``preferred_element_type=f32``), scaled by
    ``1/sqrt(dh)``, masked with ``-1e30``, softmax in f32, the weights
    cast to the pool dtype for the second product."""
    ck = _gather_kv(pool_k, table)                       # [S, T, h, dh]
    cv = _gather_kv(pool_v, table)
    T = ck.shape[1]
    s = torch.einsum("swhd,sThd->swhT", qh.float(), ck.float())
    s = s / math.sqrt(qh.shape[-1])
    mask = (torch.arange(T, device=qh.device)[None, None, None, :]
            <= P[:, :, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1).to(ck.dtype)
    return torch.einsum("swhT,sThd->swhd", a, cv)


def _attend(paged, qh, pool_k, pool_v, table, P):
    """One layer's attention in the callable's spelling."""
    if paged:
        return paged_attention(qh, pool_k, pool_v, table, P)
    return _dense_attention(qh, pool_k, pool_v, table, P)


def paged_step_logits(p, tok, t, pool_k, pool_v, table, n_layer, n_head,
                      d_model, eps=1e-5, paged=None):
    """One decode step for S independent slots through the block table.

    tok [S] int32 current tokens, t [S] int32 per-slot positions,
    pool_k/pool_v sequences of n_layer ``[num_blocks, B, h, dh]``
    tensors, table [S, NB] int32 block ids (capacity ``T = NB * B``).
    Writes each slot's K/V at ``(table[s, t_s // B], t_s % B)`` in place
    (``t`` clamped — overrun slots land in whatever their last table
    entry maps to, by construction the trash block or an already-consumed
    position), attends over the chain masked ``<= t_s``, and returns
    ``logits [S, vocab]`` in f32.  ``paged`` picks the spelling (True:
    the paged-attention kernel; False: gather + dense softmax; None:
    ``PADDLE_TPU_PAGED_ATTN`` now)."""
    if paged is None:
        paged = _paged_attn_on()
    S = tok.shape[0]
    NB = table.shape[1]
    B = pool_k[0].shape[1]
    T = NB * B
    dh = d_model // n_head
    rows = torch.arange(S, device=tok.device)
    tw = t.clamp(0, T - 1).long()
    blk = table[rows, tw // B].long()       # [S] physical write block
    off = tw % B
    x = p["tok_emb.w"][tok.long()] + p["pos_emb.w.w"][tw]       # [S, d]
    pos = t[:, None].contiguous()
    for i in range(n_layer):
        w = lambda nm: p[f"block{i}_{nm}"]  # noqa: E731
        h = layer_norm(x, w("ln1.scale"), w("ln1.bias"), eps)
        qh = torch.addmm(w("att_q.b"), h, w("att_q.w")).reshape(
            S, 1, n_head, dh)
        # per-slot scatter through the table: distinct live slots own
        # distinct blocks, so the only possible collision is overrun
        # garbage in the trash block — content nobody ever reads
        pool_k[i][blk, off] = torch.addmm(
            w("att_k.b"), h, w("att_k.w")).reshape(S, n_head, dh)
        pool_v[i][blk, off] = torch.addmm(
            w("att_v.b"), h, w("att_v.w")).reshape(S, n_head, dh)
        ctx = _attend(paged, qh, pool_k[i], pool_v[i], table,
                      pos).reshape(S, d_model)
        x = x + torch.addmm(w("att_out.b"), ctx, w("att_out.w"))
        h2 = layer_norm(x, w("ln2.scale"), w("ln2.bias"), eps)
        # exact erf gelu, matching transformer.generate and the gelu op
        ff = F.gelu(torch.addmm(w("ffn1.b"), h2, w("ffn1.w")),
                    approximate="none")
        x = x + torch.addmm(w("ffn2.b"), ff, w("ffn2.w"))
    x = layer_norm(x, p["ln_f.scale"], p["ln_f.bias"], eps)
    return logits_f32(x, p["lm_head.w"])


def make_decode_chunk(n_layer, n_head, d_model, chunk, eps=1e-5):
    """Build the batched decode step: ``chunk`` greedy steps for every
    slot per call.

    ``fn(params, pool_k, pool_v, last_tok, pos, table) -> toks [chunk, S]
    int32`` — ``toks[j]`` is the token each slot emitted at its
    ``pos+j``'th position.  The pools, ``last_tok`` and ``pos`` are
    updated in place (the JAX version donates them); ``table`` is a
    small host-fed int32 tensor on the pools' device."""
    paged = _paged_attn_on()

    @torch.no_grad()
    def decode_chunk(p, pool_k, pool_v, last_tok, pos, table):
        toks = torch.empty((chunk, last_tok.shape[0]), dtype=torch.int32,
                           device=last_tok.device)
        for j in range(chunk):
            logits = paged_step_logits(p, last_tok, pos, pool_k, pool_v,
                                       table, n_layer, n_head, d_model, eps,
                                       paged)
            toks[j] = torch.argmax(logits, dim=-1)
            last_tok.copy_(toks[j])
            pos.add_(1)
        return toks

    decode_chunk.paged = paged
    return decode_chunk


def make_prefill(n_layer, n_head, d_model, bucket, eps=1e-5):
    """Build the prefill step for one SUFFIX-length bucket.

    ``fn(params, pool_k, pool_v, last_tok, pos, slot, table_row [NB],
    toks [bucket], start, length, cow_src, cow_dst) -> first_tok`` (a
    0-d int32 tensor) — first copies block ``cow_src`` onto ``cow_dst``
    whole (the copy-on-write fork; ``0, 0`` copies trash onto trash),
    then runs the padded prompt SUFFIX through the step math at
    positions ``start + i``, writing K/V through ``table_row`` and
    attending the slot's cached chain (positions ``< start`` were shared
    from the prefix trie and are read, never recomputed).  Seeds
    ``last_tok[slot]`` with the greedy token at the last real prompt
    position (step ``length - 1``) and ``pos[slot]`` with ``start +
    length``, in place.

    All ``bucket`` steps run, as in the JAX executable: steps past
    ``length`` write garbage at positions ``>= start + length``, which
    decode overwrites before it ever attends them."""
    paged = _paged_attn_on()

    @torch.no_grad()
    def prefill(p, pool_k, pool_v, last_tok, pos, slot, table_row, toks,
                start, length, cow_src, cow_dst):
        # copy-on-write fork: duplicate the whole source block; the
        # shared tokens are the live prefix, the tail is garbage the
        # suffix steps / decode overwrite before ever attending it
        for c in list(pool_k) + list(pool_v):
            c[cow_dst] = c[cow_src]
        dev = last_tok.device
        tbl = table_row[None]
        steps = torch.arange(start, start + bucket, dtype=torch.int32,
                             device=dev)
        first = None
        for i in range(bucket):
            logits = paged_step_logits(p, toks[i:i + 1], steps[i:i + 1],
                                       pool_k, pool_v, tbl, n_layer,
                                       n_head, d_model, eps, paged)
            if i == length - 1:
                first = torch.argmax(logits[0]).to(torch.int32)
        last_tok[slot] = first
        pos[slot] = start + length
        return first

    prefill.paged = paged
    return prefill


def make_verify_window(n_layer, n_head, d_model, k, eps=1e-5):
    """Build the speculative VERIFY step: one teacher-forced target
    forward over a ``W = k + 1``-token window for every slot.

    ``fn(params, pool_k, pool_v, toks [S, W], pos [S], limit [S],
    table [S, NB]) -> greedy [S, W] int32`` — ``toks[s] = [last_s, d_1
    .. d_k]`` (the committed last token followed by the slot's draft
    proposals), window position ``j`` lives at logical position
    ``pos_s + j``, and ``greedy[s, j]`` is the target's argmax after
    consuming ``toks[s, j]`` there: the token sequential greedy decode
    would emit after the prefix extended by ``toks[s, :j]``.  All W
    positions' K/V are written (in place) before any is attended, and
    position ``j`` attends ``<= pos_s + j``.

    ``limit[s]`` is the last logical position slot ``s`` may ever write
    (``p_len + max_new - 1``; ``-1`` for a dead slot): window positions
    beyond it write to the trash block 0, so a window overhanging the
    end of a request, or a slot killed mid-round, never scatters into a
    live block.  Duplicate indices of one scatter land only there (which
    write wins is arbitrary on the card; block 0 is never attended).
    Greedy outputs past ``limit`` are garbage the caller never commits.
    The projections run as ``[S * W, d]`` products."""
    W = k + 1
    paged = _paged_attn_on()

    @torch.no_grad()
    def verify(p, pool_k, pool_v, toks, pos, limit, table):
        S = toks.shape[0]
        NB = table.shape[1]
        B = pool_k[0].shape[1]
        T = NB * B
        dh = d_model // n_head
        dev = toks.device
        rows = torch.arange(S, device=dev)
        P = pos[:, None] + torch.arange(W, dtype=torch.int32,
                                        device=dev)[None, :]    # [S, W]
        Pw = P.clamp(0, T - 1).long()
        writable = P <= limit[:, None]
        blk = torch.where(writable, table[rows[:, None], Pw // B].long(),
                          torch.zeros_like(Pw))
        off = Pw % B
        P = P.contiguous()
        x = (p["tok_emb.w"][toks.long()]
             + p["pos_emb.w.w"][Pw]).reshape(S * W, d_model)
        for i in range(n_layer):
            w = lambda nm: p[f"block{i}_{nm}"]  # noqa: E731
            h = layer_norm(x, w("ln1.scale"), w("ln1.bias"), eps)
            qh = torch.addmm(w("att_q.b"), h, w("att_q.w")).reshape(
                S, W, n_head, dh)
            pool_k[i][blk, off] = torch.addmm(
                w("att_k.b"), h, w("att_k.w")).reshape(S, W, n_head, dh)
            pool_v[i][blk, off] = torch.addmm(
                w("att_v.b"), h, w("att_v.w")).reshape(S, W, n_head, dh)
            ctx = _attend(paged, qh, pool_k[i], pool_v[i], table,
                          P).reshape(S * W, d_model)
            x = x + torch.addmm(w("att_out.b"), ctx, w("att_out.w"))
            h2 = layer_norm(x, w("ln2.scale"), w("ln2.bias"), eps)
            ff = F.gelu(torch.addmm(w("ffn1.b"), h2, w("ffn1.w")),
                        approximate="none")
            x = x + torch.addmm(w("ffn2.b"), ff, w("ffn2.w"))
        x = layer_norm(x, p["ln_f.scale"], p["ln_f.bias"], eps)
        logits = logits_f32(x, p["lm_head.w"])
        return torch.argmax(logits, dim=-1).to(torch.int32).reshape(S, W)

    verify.paged = paged
    return verify
