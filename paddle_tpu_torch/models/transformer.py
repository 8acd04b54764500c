"""The GPT language model's serving-side math — the port's counterpart
of ``paddle_tpu/models/transformer.py`` (``infer_compute_dtype``,
``generate``) plus :func:`params_from_numpy`, which carries weights
across from the JAX package.

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

from ..core.place import resolve_device

__all__ = ["infer_compute_dtype", "generate", "params_from_numpy",
           "as_torch_dtype", "layer_norm", "logits_f32"]

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


def _to_tensor(v):
    """A CPU tensor holding a copy of ``v`` (numpy array, JAX array via
    ``np.asarray``, or tensor).  numpy has no bfloat16 of its own; arrays
    of the ``bfloat16`` extension type cross as raw 16-bit words."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a.view(np.uint16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


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
             temperature=0.0, eps=1e-5, compute_dtype=None,
             return_logits=True, device=None):
    """Single-stream greedy decoding with a dense KV cache — the
    reference the serving engine is held against.

    params   name->array dict (numpy, or tensors); cast once to
             ``compute_dtype`` (default :func:`infer_compute_dtype`),
             embeddings included.
    prompt   [batch, p_len] int tokens (p_len >= 1).
    max_len  total sequence length to produce (>= p_len).
    device   default the card; ``"cpu"`` must be asked for.

    Returns ``(tokens [batch, max_len] int32, logits [batch, max_len,
    vocab] f32 or None)`` on ``device``: position ``t``'s logits are the
    next-token distribution after ``tokens[:, :t+1]``.  Only greedy
    decoding is ported (``temperature`` must be 0)."""
    if temperature:
        raise NotImplementedError(
            "temperature sampling is not ported yet; greedy only")
    dev = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = infer_compute_dtype(params)
    dt = as_torch_dtype(compute_dtype)
    p = params_from_numpy(params, dev, dt)
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
                tokens[:, t + 1] = torch.argmax(logits, dim=-1)
    return tokens.to(torch.int32), logits_all
