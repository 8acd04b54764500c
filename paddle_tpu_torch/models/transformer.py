"""The GPT language model — the port's counterpart of
``paddle_tpu/models/transformer.py``: the training program
(``transformer_block``, ``gpt_trunk``, ``gpt``, ``build``,
``extract_params``), the serving-side math (``infer_compute_dtype``,
``generate``) and :func:`params_from_numpy`, which carries weights across
from the JAX package.

Parameters keep the JAX package's names and its ``[in, out]`` weight
layout (``h @ W`` reads the same in both):

    tok_emb.w [vocab, d]       pos_emb.w.w [max_len, d]
    block{i}_ln1.{scale,bias}  block{i}_ln2.{scale,bias}         [d]
    block{i}_att_{q,k,v,out}.w [d, d]     .b [d]
    block{i}_ffn1.w [d, d_ff]  .b [d_ff]  block{i}_ffn2.w [d_ff, d]  .b [d]
    ln_f.{scale,bias} [d]      lm_head.w [d, vocab]

Numerics follow the JAX spelling: LayerNorm statistics in f32, cast
back to the compute dtype before ``* scale + bias``; exact erf gelu;
attention scores and softmax in f32; logits in f32 (in bf16 the LM-head
product accumulates and returns f32, so 32768-wide argmaxes do not tie
on bf16 rounding).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import layers, optimizer as opt
from ..core.place import resolve_device
from ..core.scope import tensor_from_numpy as _to_tensor
from ..layers import tensor as ltensor
from ..ops.random_ops import categorical

__all__ = ["transformer_block", "gpt_trunk", "gpt", "build",
           "extract_params", "infer_compute_dtype", "generate",
           "params_from_numpy", "as_torch_dtype", "layer_norm",
           "logits_f32"]

_FLOAT_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32, "float64": torch.float64}


def as_torch_dtype(dtype):
    """``torch.dtype`` for a torch dtype, a numpy dtype (``bfloat16``
    included) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in _FLOAT_DTYPES:
        name = np.dtype(dtype).name
    return _FLOAT_DTYPES[name]


def params_from_numpy(params, device=None, dtype=None):
    """Carry a name->array dict (``paddle_tpu.models.transformer.
    extract_params()``) into torch tensors on ``device`` (default: the
    card; ``"cpu"`` must be asked for), cast to ``dtype`` when given.
    Names and the ``[in, out]`` layout are kept as they are."""
    dev = resolve_device(device)
    dt = None if dtype is None else as_torch_dtype(dtype)
    out = {}
    for k, v in params.items():
        t = _to_tensor(v).to(dev)
        out[k] = t if dt is None else t.to(dt)
    return out


def infer_compute_dtype(params):
    """The serving dtype the weights imply: the narrowest floating dtype
    among the transformer-block / lm_head MATMUL weights (``block*.w`` /
    ``lm_head.w``), so f32 embedding tables do not promote the decode and
    a stray low-precision matrix elsewhere does not downgrade it.  Falls
    back to any >= 2-D floating weight, then float32.  Accepts numpy
    arrays or tensors; returns a ``torch.dtype``."""

    def _mats(keys):
        out = []
        for k in keys:
            v = params[k]
            if not (hasattr(v, "dtype") and hasattr(v, "shape")):
                v = np.asarray(v)
            if len(v.shape) < 2:
                continue
            try:
                dt = as_torch_dtype(v.dtype)
            except (KeyError, TypeError):
                continue  # integer or other non-floating table
            out.append(dt)
        return out

    mats = _mats([k for k in params
                  if (k.startswith("block") or k.startswith("lm_head"))
                  and k.endswith(".w")])
    if not mats:
        mats = _mats(list(params))
    return (min(mats, key=lambda d: d.itemsize) if mats else torch.float32)


def layer_norm(x, scale, bias, eps):
    """Statistics in f32 even under bf16 compute, normalised row cast
    back to ``x.dtype`` before the affine — the JAX spelling exactly."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    xn = ((x32 - mu) / torch.sqrt(var + eps)).to(x.dtype)
    return xn * scale + bias


def logits_f32(x, w):
    """``x [n, d] @ w [d, vocab]`` returned in f32
    (``preferred_element_type=float32``).  On the card a bf16 product
    accumulates into an f32 output directly; the CPU has no such kernel,
    so there the operands are upcast (bf16 products are exact in f32)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def generate(params, prompt, max_len, n_layer, n_head, d_model,
             temperature=0.0, key=None, eps=1e-5, compute_dtype=None,
             return_logits=True, device=None):
    """Single-stream decoding with a dense KV cache — the reference the
    serving engine is held against.

    params   name->array dict (numpy, or tensors); cast once to
             ``compute_dtype`` (default :func:`infer_compute_dtype`),
             embeddings included.
    prompt   [batch, p_len] int tokens (p_len >= 1).
    max_len  total sequence length to produce (>= p_len).
    temperature  0 = greedy argmax; otherwise each new token is drawn
             from ``softmax(logits / temperature)``
             (``ops.random_ops.categorical``).
    key      the draws' generator, required when ``temperature > 0``
             (``ValueError`` without it, as in the JAX package): a
             ``torch.Generator`` on ``device``, advanced by the call, or
             an int that seeds a fresh one there, so the same int gives
             the same tokens.  The JAX package draws from a threefry
             key: the same seed gives other tokens from the same
             distribution.  Greedy decoding draws nothing and ignores it.
    device   default the card; ``"cpu"`` must be asked for.

    Returns ``(tokens [batch, max_len] int32, logits [batch, max_len,
    vocab] f32 or None)`` on ``device``: position ``t``'s logits are the
    next-token distribution after ``tokens[:, :t+1]``; positions inside
    the prompt keep the prompt."""
    if temperature and key is None:
        raise ValueError("temperature > 0 sampling requires a PRNG `key`")
    dev = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = infer_compute_dtype(params)
    dt = as_torch_dtype(compute_dtype)
    p = params_from_numpy(params, dev, dt)
    gen = None
    if temperature:
        gen = key
        if not isinstance(key, torch.Generator):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(key))
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    b, p_len = prompt.shape
    dh = d_model // n_head
    table_len = p["pos_emb.w.w"].shape[0]
    if max_len > table_len:
        raise ValueError(
            f"max_len {max_len} exceeds the trained position-embedding "
            f"table ({table_len} positions)")
    pos_emb = p["pos_emb.w.w"][:max_len]
    tokens = torch.zeros((b, max_len), dtype=torch.int64, device=dev)
    tokens[:, :p_len] = prompt.to(dev)
    cache_k = [torch.zeros((b, max_len, n_head, dh), dtype=dt, device=dev)
               for _ in range(n_layer)]
    cache_v = [torch.zeros_like(c) for c in cache_k]
    keep_t = torch.arange(max_len, device=dev)
    logits_all = None
    if return_logits:
        logits_all = torch.empty(
            (b, max_len, p["lm_head.w"].shape[1]), dtype=torch.float32,
            device=dev)

    with torch.no_grad():
        for t in range(max_len):
            x = p["tok_emb.w"][tokens[:, t]] + pos_emb[t]       # [b, d]
            mask = (keep_t <= t)[None, None, :]
            for i in range(n_layer):
                w = lambda nm: p[f"block{i}_{nm}"]  # noqa: E731
                h = layer_norm(x, w("ln1.scale"), w("ln1.bias"), eps)
                qh = torch.addmm(w("att_q.b"), h, w("att_q.w")).reshape(
                    b, n_head, dh)
                cache_k[i][:, t] = torch.addmm(
                    w("att_k.b"), h, w("att_k.w")).reshape(b, n_head, dh)
                cache_v[i][:, t] = torch.addmm(
                    w("att_v.b"), h, w("att_v.w")).reshape(b, n_head, dh)
                s = torch.einsum("bhd,bThd->bhT", qh.float(),
                                 cache_k[i].float())
                s = s / float(dh) ** 0.5
                s = torch.where(mask, s, torch.full_like(s, -1e30))
                a = torch.softmax(s, dim=-1).to(dt)
                ctx = torch.einsum("bhT,bThd->bhd", a,
                                   cache_v[i]).reshape(b, d_model)
                x = x + torch.addmm(w("att_out.b"), ctx, w("att_out.w"))
                h2 = layer_norm(x, w("ln2.scale"), w("ln2.bias"), eps)
                ff = F.gelu(torch.addmm(w("ffn1.b"), h2, w("ffn1.w")),
                            approximate="none")
                x = x + torch.addmm(w("ffn2.b"), ff, w("ffn2.w"))
            x = layer_norm(x, p["ln_f.scale"], p["ln_f.bias"], eps)
            logits = logits_f32(x, p["lm_head.w"])
            if return_logits:
                logits_all[:, t] = logits
            # positions < p_len keep the prompt; after that, append
            if p_len <= t + 1 < max_len:
                if temperature:
                    tokens[:, t + 1] = categorical(logits / temperature, gen)
                else:
                    tokens[:, t + 1] = torch.argmax(logits, dim=-1)
    return tokens.to(torch.int32), logits_all


# -- the training program ------------------------------------------------------

def transformer_block(x, d_model, n_head, d_ff, dropout_rate, is_test,
                      name, attn_block_q=None, attn_block_k=None,
                      attn_packed=None):
    """Pre-LN block: x + MHA(LN(x)) then x + FFN(LN(x))."""
    ln1 = layers.layer_norm(x, begin_norm_axis=2, name=name + "_ln1")
    att = layers.multi_head_attention(
        ln1, ln1, ln1, d_model=d_model, n_head=n_head,
        dropout_rate=dropout_rate, causal=True, is_test=is_test,
        block_q=attn_block_q, block_k=attn_block_k, packed=attn_packed,
        name=name + "_att")
    x = x + att
    ln2 = layers.layer_norm(x, begin_norm_axis=2, name=name + "_ln2")
    ff = layers.fc(ln2, d_ff, num_flatten_dims=2, act="gelu",
                   name=name + "_ffn1")
    ff = layers.fc(ff, d_model, num_flatten_dims=2, name=name + "_ffn2")
    if dropout_rate:
        ff = layers.dropout(ff, dropout_rate, is_test=is_test)
    return x + ff


def gpt_trunk(tokens, vocab_size, n_layer=4, n_head=8, d_model=256,
              d_ff=None, max_len=128, dropout_rate=0.1, is_test=False,
              dtype="bfloat16", attn_block_q=None, attn_block_k=None,
              attn_packed=None):
    """Causal LM trunk up to the final layer norm: [batch, time, d_model]
    hidden states in ``dtype`` (the head is attached by the caller).  The
    embedding tables stay float32 (master-precision rows, cast after the
    gather)."""
    d_ff = d_ff or 4 * d_model
    t = tokens.shape[1]
    emb = layers.embedding(tokens, size=[vocab_size, d_model],
                           param_attr="tok_emb.w")
    pos = ltensor.create_parameter([t, d_model], dtype="float32",
                                   name="pos_emb.w")
    x = emb + pos
    x = ltensor.cast(x, dtype)
    if dropout_rate:
        x = layers.dropout(x, dropout_rate, is_test=is_test)
    for i in range(n_layer):
        x = transformer_block(x, d_model, n_head, d_ff, dropout_rate,
                              is_test, name=f"block{i}",
                              attn_block_q=attn_block_q,
                              attn_block_k=attn_block_k,
                              attn_packed=attn_packed)
    return layers.layer_norm(x, begin_norm_axis=2, name="ln_f")


def gpt(tokens, vocab_size, n_layer=4, n_head=8, d_model=256, d_ff=None,
        max_len=128, dropout_rate=0.1, is_test=False, dtype="bfloat16",
        attn_block_q=None, attn_block_k=None, attn_packed=None):
    """Causal LM: returns [batch, time, vocab] logits (float32)."""
    x = gpt_trunk(tokens, vocab_size, n_layer=n_layer, n_head=n_head,
                  d_model=d_model, d_ff=d_ff, max_len=max_len,
                  dropout_rate=dropout_rate, is_test=is_test, dtype=dtype,
                  attn_block_q=attn_block_q, attn_block_k=attn_block_k,
                  attn_packed=attn_packed)
    logits = layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False,
                       name="lm_head")
    return ltensor.cast(logits, "float32")


def tp_rules():
    """Tensor-parallel sharding rules for the flagship transformer (the
    reference's ``tp_rules``; apply with
    ``parallel.shard_parameters_by_rule`` on a mesh with a 'tp' axis;
    requires n_head % tp == 0 and vocab % tp == 0): the q/k/v projections
    and FFN1 column-shard (whole heads per rank: the flash kernels run on
    local heads), the attention out-projection and FFN2 row-shard (one
    all-reduce each), the LM head vocab-shards (the fused CE head merges
    the shards by logsumexp); everything else replicates."""
    from ..parallel.api import P

    return [
        (r"_att_(q|k|v)\.w$", P(None, "tp")),
        (r"_att_(q|k|v)\.b$", P("tp")),
        (r"_att_out\.w$", P("tp", None)),
        (r"_ffn1\.w$", P(None, "tp")),
        (r"_ffn1\.b$", P("tp")),
        (r"_ffn2\.w$", P("tp", None)),
        (r"^lm_head\.w$", P(None, "tp")),
    ]


def extract_params(scope=None, program=None):
    """Pull the model weights (not optimizer state) out of a scope as the
    name->array dict ``generate`` and the serving engine consume (numpy;
    bfloat16 weights are widened to float32, which numpy can hold)."""
    from ..core.program import default_main_program
    from ..core.scope import global_scope

    scope = scope or global_scope()
    program = program or default_main_program()
    # weights are Parameter instances; optimizer accumulators are plain
    # persistable vars — all_parameters() is exactly the model weights.
    return {
        p.name: scope.numpy(p.name)
        for p in program.all_parameters()
        if scope.find_var(p.name) is not None
    }


def build(vocab_size=1000, n_layer=4, n_head=8, d_model=256, d_ff=None,
          max_len=128, dropout_rate=0.1, is_test=False,
          learning_rate=1e-3, dtype="bfloat16", fused_head=False,
          attn_block_q=None, attn_block_k=None, attn_packed=None):
    """Next-token-prediction training program.

    Feeds: tokens [batch, max_len] int64, labels [batch, max_len] int64
    (tokens shifted left by one, label -1 = padding, masked out of the
    loss).

    The head is ``fc`` + ``softmax_with_cross_entropy``, or with
    ``fused_head=True`` the fused head (``layers.fused_softmax_ce_head``,
    the CE kernels of ``kernels/fused_ce.py``): no ``[b, t, vocab]``
    logits ever reach device memory.  The head weight keeps the name and
    shape ``lm_head.w [d_model, vocab]`` either way, so ``generate`` and
    the serving engine serve both.  With the fused head ``logits`` is None
    (not materialising them is the point)."""
    tokens = layers.data("tokens", shape=[max_len], dtype="int64")
    labels = layers.data("labels", shape=[max_len], dtype="int64")
    mask2d = ltensor.cast(
        layers.greater_equal(labels, ltensor.fill_constant(
            shape=[1], dtype="int64", value=0)), "float32")
    safe2d = layers.elementwise_max(
        labels, ltensor.fill_constant(shape=[1], dtype="int64", value=0))
    logits = None
    if fused_head:
        x = gpt_trunk(tokens, vocab_size, n_layer=n_layer, n_head=n_head,
                      d_model=d_model, d_ff=d_ff, max_len=max_len,
                      dropout_rate=dropout_rate, is_test=is_test,
                      dtype=dtype, attn_block_q=attn_block_q,
                      attn_block_k=attn_block_k, attn_packed=attn_packed)
        loss = layers.fused_softmax_ce_head(x, safe2d, vocab_size,
                                            name="lm_head")
        masked = ltensor.reshape(loss, [-1, 1]) * ltensor.reshape(
            mask2d, [-1, 1])
    else:
        logits = gpt(tokens, vocab_size, n_layer=n_layer, n_head=n_head,
                     d_model=d_model, d_ff=d_ff, max_len=max_len,
                     dropout_rate=dropout_rate, is_test=is_test,
                     dtype=dtype, attn_block_q=attn_block_q,
                     attn_block_k=attn_block_k, attn_packed=attn_packed)
        flat_logits = ltensor.reshape(logits, [-1, vocab_size])
        flat_labels = ltensor.reshape(safe2d, [-1, 1])
        loss = layers.softmax_with_cross_entropy(flat_logits, flat_labels)
        masked = loss * ltensor.reshape(mask2d, [-1, 1])
    mask = ltensor.reshape(mask2d, [-1, 1])
    avg_cost = layers.reduce_sum(masked) / (
        layers.reduce_sum(mask) + 1e-8)
    optimizer = opt.Adam(learning_rate=learning_rate)
    optimizer.minimize(avg_cost)
    return {"feed": [tokens, labels], "logits": logits,
            "avg_cost": avg_cost}
