#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
GPU — the quickest proof that the port builds, is right, serves and trains.

    python3 chip_smoke.py [--seed N]

Phases, in order; each raises on failure and the script then exits
non-zero (no phase is wrapped in a ``try`` that carries on):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: every ``paddle_tpu_torch/csrc/*.cu`` by ``nvcc`` for
   ``sm_90a`` (one process per source, in parallel), timed;
3. each kernel against its plain PyTorch version on the card, within
   ORACLE_TOL, then its time, the plain version's, one PyTorch library
   call's (a yardstick the port never calls) and the bound:
   a. paged attention at the serving path's shapes (decode S=32 W=1,
      prefill S=1 W=1, and W=4), bf16 and f32; timed at the decode shape
      in bf16 (library: ``scaled_dot_product_attention`` on the gathered
      view; bound: bytes over 3.35 TB/s);
   b. flash attention forward (``o``, ``lse``) and fused backward
      (``dq, dk, dv``, with and without ``dlse``) at the training path's
      shape (b=8, t=4096, h=6, d=128, bf16, causal), plus f32, d=64,
      non-causal and ragged lengths; the plain version materialises
      ``[b, h, t, t]`` scores, so it runs over the batch two rows at a
      time; timed at the path shape (library: SDPA forward, and forward
      plus backward; bound: causal flops over 989 TFLOP/s, or bytes);
   c. the fused cross-entropy head's forward (``loss``, ``lse``), dx and
      dW kernels at the training path's shape (N = 32768 rows, d=768,
      V=32768, bf16), at phase 6's f32 shape (N=512) and at a ragged shape
      (N=1000, d=200, V=5000, bf16 and f32), with labels -1 and V in some
      rows and a loss cotangent with zeros; timed at the path shape
      (library: ``torch.matmul`` + ``F.cross_entropy`` forward, and that
      composition's backward by autograd for x alone and for w alone —
      no single PyTorch call computes the head; bound: 2 N d V flops a
      product over 989 TFLOP/s);
4. serving correctness at full width in f32: the 12-layer d768 h6 v32768
   GPT with seeded random weights serves 8 shared-prefix requests through
   the engine's background thread, each compared with the port's
   single-stream ``generate``; they must agree token for token except
   where ``generate``'s top-2 logit gap is below 1e-4 * max|logit| (a
   genuine near-tie that reassociating the f32 softmax can flip);
5. serving at full width in bf16 (a main path): the 64-request
   shared-prefix load of ``benchmarks/serving.py`` (32 slots, decode chunk
   16, min bucket 16, 32-token blocks), submitted at once after a warm
   pass, run until idle; every request must be served in full, and every
   attention call of the pass must have gone through the CUDA kernel
   (launch count == layers x (decode steps + prefill steps), all counts
   zeroed just before the pass); then a few steady decode chunks traced
   with ``torch.profiler``;
6. training correctness at full width in f32: the same 12-layer model
   (t=256, b=2) takes two Adam steps through ``Program`` -> ``Executor``
   three times from one startup state: unfused head with attention in the
   CUDA kernels, the same with attention routed to the plain versions (a
   switch that lives in this script only), and the fused head through the
   CE kernels; losses must agree within 1e-3 relative and every
   parameter's step-1 gradient within the flash (kernels vs plain) and
   the fused_ce (fused vs unfused head) grad tolerance;
7. training at full width in bf16 (the main path, ``bench.py``'s
   flagship): ``transformer.build(vocab 32768, 12 layers, 6 heads,
   d_model 768, max_len 4096, dropout 0, bf16, fused_head=True)``, batch
   8, synthetic next = tok + 1 tokens on a 512-token cycle from
   ``--seed``, five Adam steps on the card: the loss must be finite and
   fall from about ln(32768), the parameters must change, and every
   attention and head call must have gone through the kernels (12 flash
   forward, 12 flash backward and one launch of each CE kernel a step,
   all counts zeroed just before the steps); prints step wall, tokens/s
   and peak memory, then where one more step's device time goes
   (``torch.profiler`` by kernel family, CUDA events by op type);
   b. the same five steps with ``fused_head=False`` (full depth), for the
   unfused head's peak memory: the fused step's peak must lie at least
   10 GB below it;
8. one JSON line ``{"kernels": [...]}`` with each of the six kernels'
   launches on its main path (phase 5 or 7), error, times and bound;
9. the last line: ``{"ok": true, "device": {...}}``.

Without a CUDA device, or run from a directory that holds only this
file, it exits non-zero and prints no result.  The weights, the tokens
and the traffic are made from ``--seed``; nothing is read from the
network.
"""

import argparse
import json
import subprocess
import sys
import time

# the full-width configuration: benchmarks/serving.py's load config
VOCAB, N_LAYER, N_HEAD, D_MODEL, MAX_LEN = 32768, 12, 6, 768, 512
SLOTS, CHUNK, MIN_BUCKET, BLOCK_TOKENS, PREFIX_LEN = 32, 16, 16, 32, 64
CLASSES = [(16, 96), (32, 192), (64, 256), (24, 320)]
REQUESTS = 64
D_HEAD = D_MODEL // N_HEAD
# the training path: tune/search.py flagship_dims at bench.py's sequence
TRAIN_T, TRAIN_B, TRAIN_STEPS, TRAIN_LR = 4096, 8, 5, 1e-3
CHECK_T, CHECK_B = 256, 2          # phase 6's short f32 comparison
PATTERN = 512                      # the synthetic tokens cycle through 0..511

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg):
    print(msg, flush=True)


def make_params(rng):
    """Seeded random weights at full width, under the JAX package's
    names and [in, out] layout: matrices and embeddings N(0, 0.02),
    LayerNorm scales 1, every bias 0."""
    import numpy as np

    def normal(*shape):
        return (0.02 * rng.standard_normal(shape, dtype=np.float32))

    d, f = D_MODEL, 4 * D_MODEL
    p = {"tok_emb.w": normal(VOCAB, d), "pos_emb.w.w": normal(MAX_LEN, d)}
    for i in range(N_LAYER):
        b = f"block{i}_"
        for ln in ("ln1", "ln2"):
            p[b + ln + ".scale"] = np.ones(d, np.float32)
            p[b + ln + ".bias"] = np.zeros(d, np.float32)
        for nm in ("att_q", "att_k", "att_v", "att_out"):
            p[b + nm + ".w"] = normal(d, d)
            p[b + nm + ".b"] = np.zeros(d, np.float32)
        p[b + "ffn1.w"] = normal(d, f)
        p[b + "ffn1.b"] = np.zeros(f, np.float32)
        p[b + "ffn2.w"] = normal(f, d)
        p[b + "ffn2.b"] = np.zeros(d, np.float32)
    p["ln_f.scale"] = np.ones(d, np.float32)
    p["ln_f.bias"] = np.zeros(d, np.float32)
    p["lm_head.w"] = normal(d, VOCAB)
    return p


def make_workload(rng, n, classes, vocab, prefix_len):
    """n requests cycling through traffic classes; every class shares ONE
    ``prefix_len``-token system prompt ahead of a per-request unique tail
    (``benchmarks/serving.py: make_workload``).  Classes are
    ``(tail_len, max_new)``."""
    import numpy as np

    prefixes = [rng.integers(1, vocab, (prefix_len,)).astype(np.int32)
                for _ in classes]
    work = []
    for i in range(n):
        c = i % len(classes)
        tail, max_new = classes[c]
        prompt = np.concatenate(
            [prefixes[c], rng.integers(1, vocab, (tail,)).astype(np.int32)])
        work.append((prompt, max_new))
    return work


# -- phase 3: the kernel against its plain version ---------------------------

def paged_case(torch, gen, S, W, dtype, nb=16, num_blocks=545):
    """Decode-geometry inputs on the card: distinct random blocks per
    chain, ``pos`` random in [0, 511], chain entries past ``pos`` naming
    the trash block 0, which holds large random garbage."""
    dev = "cuda"
    shape = (num_blocks, BLOCK_TOKENS, N_HEAD, D_HEAD)
    pk = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pv = torch.randn(shape, generator=gen, device=dev).to(dtype)
    pk[0] = 100 * torch.randn(shape[1:], generator=gen, device=dev)
    pv[0] = 100 * torch.randn(shape[1:], generator=gen, device=dev)
    q = torch.randn((S, W, N_HEAD, D_HEAD), generator=gen,
                    device=dev).to(dtype)
    base = torch.randint(0, MAX_LEN - W + 1, (S, 1), generator=gen,
                         device=dev)
    pos = (base + torch.arange(W, device=dev)).to(torch.int32)
    perm = torch.randperm(num_blocks - 1, generator=gen, device=dev) + 1
    table = perm[: S * nb].reshape(S, nb).to(torch.int32)
    live = pos.max(dim=1).values // BLOCK_TOKENS              # last entry
    table[torch.arange(nb, device=dev)[None, :] > live[:, None]] = 0
    return q, pk, pv, table.contiguous(), pos.contiguous()


def rel_err(torch, got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def device_ms(torch, fn, n, reps=3):
    """Device time of ``n`` queued calls of ``fn(i)``, per call, median of
    ``reps``: a long sleep kernel holds the stream while the host
    enqueues, so the events bracket device execution, not Python."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000_000)
        e0.record()
        for i in range(n):
            fn(i)
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    return sorted(out)[len(out) // 2]


def kernel_phase(torch, pa):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        tol = pa.oracle_tol(dtype)
        for label, S, W in (("decode", 32, 1), ("prefill", 1, 1),
                            ("window", 32, 4)):
            args = paged_case(torch, gen, S, W, dtype)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            ref = pa.paged_attention_ref(*args)
            ab, rel = rel_err(torch, got, ref)
            ok = bool(torch.isfinite(got.float()).all()) and rel <= tol
            log(f"kernel paged_attention {label:7s} S={S:2d} W={W} {dname:8s}"
                f" max_abs_err {ab:.3e} rel {rel:.3e} (tol {tol:g})"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"paged_attention kernel disagrees with its plain "
                    f"version at {label} {dname}: rel {rel:.3e} > {tol}")
            errs[(label, dname)] = ab

    # timing at the decode shape, bf16: one pool pair per layer, so each
    # call finds its K/V cold in L2 as the 12-layer decode step does
    dtype = torch.bfloat16
    q, _, _, table, pos = paged_case(torch, gen, 32, 1, dtype)
    layers = []
    for _ in range(N_LAYER):
        _, pk, pv, _, _ = paged_case(torch, gen, 32, 1, dtype)
        layers.append((pk, pv))
    reps = 8
    n = reps * N_LAYER
    kernel_ms = device_ms(torch, lambda i: pa.paged_attention(
        q, *layers[i % N_LAYER], table, pos), n)
    plain_ms = device_ms(torch, lambda i: pa.paged_attention_ref(
        q, *layers[i % N_LAYER], table, pos), N_LAYER)
    # the yardstick: one SDPA call over each slot's gathered [S, T, h, dh]
    # view with the j <= pos mask (the gather is set-up, not timed)
    S, NB = table.shape
    T = NB * BLOCK_TOKENS
    idx = table.long()
    gathered = [(pk[idx].reshape(S, T, N_HEAD, D_HEAD).transpose(1, 2),
                 pv[idx].reshape(S, T, N_HEAD, D_HEAD).transpose(1, 2))
                for pk, pv in layers]
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos[:, :1].long())[:, None, None, :]             # [S,1,1,T]
    q4 = q.transpose(1, 2)                                      # [S,h,1,dh]
    lib_out = F.scaled_dot_product_attention(q4, *gathered[0],
                                             attn_mask=mask)
    _, lib_rel = rel_err(torch, lib_out.transpose(1, 2),
                         pa.paged_attention_ref(q, *layers[0], table, pos))
    library_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q4, *gathered[i % N_LAYER], attn_mask=mask), n)
    # the bound: live K/V read once, q read once, ctx written once, the
    # chain entries and positions read once; 4 flops per live element
    live = int((pos.long() + 1).sum().item())
    esize = q.element_size()
    entries = int((pos.max(dim=1).values // BLOCK_TOKENS + 1).sum().item())
    nbytes = (2 * live * N_HEAD * D_HEAD * esize + 2 * q.numel() * esize
              + 4 * entries + 4 * pos.numel())
    flops = 4 * live * N_HEAD * D_HEAD
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"paged_attention decode bf16 (S=32 W=1 h=6 dh=128 B=32 NB=16, "
        f"{live} live tokens, {nbytes} bytes): kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (sdpa, rel err {lib_rel:.2e}) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/kernels/paged_attention.py:161",
            "max_abs_err": errs[("decode", "bfloat16")],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


# -- phase 3b: the flash kernels against their plain versions ----------------

def _chunked(fn, args, rows=2):
    """The plain version over the batch ``rows`` at a time (it
    materialises [b, h, t, t] scores); same function, same inputs.
    Outputs are batch-major ([b, ...] or [b*h, t]), so they concatenate."""
    import torch

    b = args[0].shape[0]
    outs = [fn(*[a[i:i + rows] for a in args]) for i in range(0, b, rows)]
    return tuple(torch.cat(o) for o in zip(*outs))


def flash_inputs(torch, gen, b, t, h, d, dtype):
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)  # noqa: E731
    return mk(b, t, h, d), mk(b, t, h, d), mk(b, t, h, d), mk(b, t, h, d)


def flash_plain(torch, fa, q, k, v, do, dlse, causal):
    """Plain forward and backward, two batch rows at a time: o, lse
    [b*h, t], dq, dk, dv (and the same with the lse cotangent)."""
    b, t, h, _ = q.shape
    o, lse = _chunked(
        lambda a, b_, c: fa.flash_attention_ref(a, b_, c, causal), (q, k, v))
    l3 = lse.reshape(b, h, t)
    grads = _chunked(
        lambda a, b_, c, o_, l_, d_: fa.flash_attention_bwd_ref(
            a, b_, c, o_, l_.reshape(-1, t), d_, None, causal),
        (q, k, v, o, l3, do))
    grads_l = _chunked(
        lambda a, b_, c, o_, l_, d_, dl: fa.flash_attention_bwd_ref(
            a, b_, c, o_, l_.reshape(-1, t), d_, dl.reshape(-1, t), causal),
        (q, k, v, o, l3, do, dlse.reshape(b, h, t)))
    return o, lse, grads, grads_l


def flash_phase(torch, fa):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("path", TRAIN_B, TRAIN_T, N_HEAD, D_HEAD, bf16, True),
             ("f32", 1, 1024, N_HEAD, D_HEAD, f32, True),
             ("d64", 2, 1024, 4, 64, bf16, True),
             ("non-causal", 1, 1024, N_HEAD, D_HEAD, bf16, False),
             ("ragged", 1, 1000, N_HEAD, D_HEAD, bf16, True),
             ("ragged f32 d64", 1, 333, 2, 64, f32, False)]
    errs = {}
    for label, b, t, h, d, dtype, causal in cases:
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = flash_inputs(torch, gen, b, t, h, d, dtype)
        dlse = torch.randn((b * h, t), generator=gen, device="cuda")
        o, lse = fa.flash_fwd(q, k, v, causal)
        dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, None, causal)
        dq2, dk2, dv2 = fa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
        torch.cuda.synchronize()
        ro, rlse, rg, rgl = flash_plain(torch, fa, q, k, v, do, dlse, causal)
        pairs = [("o", o, ro, "fwd"), ("lse", lse, rlse, "fwd"),
                 ("dq", dq, rg[0], "grad"), ("dk", dk, rg[1], "grad"),
                 ("dv", dv, rg[2], "grad"), ("dq+dlse", dq2, rgl[0], "grad"),
                 ("dk+dlse", dk2, rgl[1], "grad"),
                 ("dv+dlse", dv2, rgl[2], "grad")]
        worst = {"fwd": (0.0, 0.0), "grad": (0.0, 0.0)}
        for name, got, ref, kind in pairs:
            tol = fa.oracle_tol(dtype, kind)
            ab, rel = rel_err(torch, got, ref)
            if not (bool(torch.isfinite(got.float()).all()) and rel <= tol):
                raise AssertionError(
                    f"flash attention {name} disagrees with its plain "
                    f"version at {label} {dname}: rel {rel:.3e} > {tol}")
            if rel >= worst[kind][1]:
                worst[kind] = (ab, rel)
        log(f"kernel flash_attention {label:14s} b={b} t={t} h={h} d={d} "
            f"{dname:8s} {'causal' if causal else 'full  '} fwd rel "
            f"{worst['fwd'][1]:.3e} (tol {fa.oracle_tol(dtype, 'fwd'):g}) "
            f"grad rel {worst['grad'][1]:.3e} (tol "
            f"{fa.oracle_tol(dtype, 'grad'):g}) ok")
        errs[label] = (worst["fwd"][0], worst["grad"][0])
        del q, k, v, do, dlse, o, lse, ro, rlse, rg, rgl
        torch.cuda.empty_cache()

    # timing at the training path's shape
    b, t, h, d = TRAIN_B, TRAIN_T, N_HEAD, D_HEAD
    q, k, v, do = flash_inputs(torch, gen, b, t, h, d, bf16)
    o, lse = fa.flash_fwd(q, k, v, True)
    fwd_ms = device_ms(torch, lambda i: fa.flash_fwd(q, k, v, True), 4)
    bwd_ms = device_ms(
        torch, lambda i: fa.flash_bwd(q, k, v, o, lse, do, None, True), 4)
    plain_fwd_ms = device_ms(torch, lambda i: _chunked(
        lambda a, b_, c: fa.flash_attention_ref(a, b_, c, True),
        (q, k, v)), 1)
    l3 = lse.reshape(b, h, t)
    plain_bwd_ms = device_ms(torch, lambda i: _chunked(
        lambda a, b_, c, o_, l_, d_: fa.flash_attention_bwd_ref(
            a, b_, c, o_, l_.reshape(-1, t), d_, None, True),
        (q, k, v, o, l3, do)), 1)
    # the yardstick: SDPA on the [b, h, t, d] views of the same tensors
    q4, k4, v4 = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = do.transpose(1, 2)
    lib_o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    _, lib_rel = rel_err(torch, lib_o.transpose(1, 2), o)

    def lib_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def lib_both(i):
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        torch.autograd.grad(out, (q4, k4, v4), do4)

    lib_fwd_ms = device_ms(torch, lib_fwd, 4)
    lib_bwd_ms = device_ms(torch, lib_both, 4) - lib_fwd_ms
    # bounds: the causal score entries are t (t + 1) / 2 a head; forward
    # q.k^T and p.v (4 d flops an entry), backward five products (10 d)
    entries = b * h * t * (t + 1) // 2
    es = q.element_size()
    fwd_flops, bwd_flops = 4 * d * entries, 10 * d * entries
    fwd_bytes = 4 * q.numel() * es + 4 * lse.numel()
    bwd_bytes = 8 * q.numel() * es + 4 * lse.numel()
    rows = []
    for name, line, ms, plain, lib, flops, nbytes, err in (
            ("flash_attention_fwd", 363, fwd_ms, plain_fwd_ms, lib_fwd_ms,
             fwd_flops, fwd_bytes, errs["path"][0]),
            ("flash_attention_bwd", 843, bwd_ms, plain_bwd_ms, lib_bwd_ms,
             bwd_flops, bwd_bytes, errs["path"][1])):
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"{name} bf16 causal (b={b} t={t} h={h} d={d}, "
            f"{flops / 1e12:.4f} TFLOP, {nbytes} bytes): kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
            f"library (sdpa, fwd rel err {lib_rel:.2e}) {lib:.4f} ms, bound "
            f"{bound_ms:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                     "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "library_ms": lib})
    return rows


# -- phase 3c: the fused cross-entropy kernels against their plain versions --

def ce_inputs(torch, gen, n, d, v, dtype, out_of_range=True):
    """Seeded inputs on the card: logits of unit scale; labels -1 and V in
    some rows (out of range: loss = lse, no onehot term), or only -1 (the
    training path's padding, which the library's ``ignore_index`` takes);
    a loss cotangent with zeros, as masked rows give."""
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((d, v), generator=gen, device="cuda")
         * d ** -0.5).to(dtype)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    y[1::7] = -1
    if out_of_range:
        y[3::11] = v
    g = torch.randn((n,), generator=gen, device="cuda")
    g[2::5] = 0.0
    return x, w, y, g


def ce_phase(torch, ce):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5678)
    bf16, f32 = torch.bfloat16, torch.float32
    tokens = TRAIN_B * TRAIN_T
    cases = [("path", tokens, D_MODEL, VOCAB, bf16),
             ("f32", CHECK_B * CHECK_T, D_MODEL, VOCAB, f32),
             ("ragged", 1000, 200, 5000, bf16),
             ("ragged f32", 1000, 200, 5000, f32)]
    errs = {}
    for label, n, d, v, dtype in cases:
        dname = str(dtype).replace("torch.", "")
        x, w, y, g = ce_inputs(torch, gen, n, d, v, dtype)
        loss, lse = ce.ce_fwd(x, w, y)
        dx = ce.ce_dx(x, w, y, lse, g)
        dw = ce.ce_dw(x, w, y, lse, g)
        torch.cuda.synchronize()
        rloss, rlse = ce.fused_ce_ref(x, w, y)
        rdx, rdw = ce.fused_ce_bwd_ref(x, w, y, rlse, g)
        worst = {"fwd": (0.0, 0.0), "grad": (0.0, 0.0)}
        for name, got, ref, kind in (("loss", loss, rloss, "fwd"),
                                     ("lse", lse, rlse, "fwd"),
                                     ("dx", dx, rdx, "grad"),
                                     ("dW", dw, rdw, "grad")):
            tol = ce.oracle_tol(dtype, kind)
            ab, rel = rel_err(torch, got, ref)
            if not (bool(torch.isfinite(got.float()).all()) and rel <= tol):
                raise AssertionError(
                    f"fused CE {name} disagrees with its plain version at "
                    f"{label} {dname}: rel {rel:.3e} > {tol}")
            if rel >= worst[kind][1]:
                worst[kind] = (ab, rel)
        out = (y < 0) | (y >= v)
        if not torch.equal(loss[out], lse[out]):
            raise AssertionError("an out-of-range label changed the loss")
        log(f"kernel fused_ce {label:10s} N={n} d={d} V={v} {dname:8s} "
            f"fwd rel {worst['fwd'][1]:.3e} (tol {ce.oracle_tol(dtype):g}) "
            f"grad rel {worst['grad'][1]:.3e} (tol "
            f"{ce.oracle_tol(dtype, 'grad'):g}) ok")
        errs[label] = (worst["fwd"][0], worst["grad"][0])
        del x, w, y, g, loss, lse, dx, dw, rloss, rlse, rdx, rdw
        torch.cuda.empty_cache()

    # timing at the training path's shape, labels in range but for the
    # -1 padding (the library call's ignore_index)
    n, d, v = tokens, D_MODEL, VOCAB
    x, w, y, g = ce_inputs(torch, gen, n, d, v, bf16, out_of_range=False)
    loss, lse = ce.ce_fwd(x, w, y)
    fwd_ms = device_ms(torch, lambda i: ce.ce_fwd(x, w, y), 4)
    dx_ms = device_ms(torch, lambda i: ce.ce_dx(x, w, y, lse, g), 3)
    dw_ms = device_ms(torch, lambda i: ce.ce_dw(x, w, y, lse, g), 3)
    plain_fwd_ms = device_ms(torch, lambda i: ce.fused_ce_ref(x, w, y), 1)
    plain_dx_ms = device_ms(
        torch, lambda i: ce.fused_ce_dx_ref(x, w, y, lse, g), 1)
    plain_dw_ms = device_ms(
        torch, lambda i: ce.fused_ce_dw_ref(x, w, y, lse, g), 1)
    torch.cuda.empty_cache()
    # the yardstick: torch.matmul (bf16 logits) + F.cross_entropy on the
    # f32 logits, reduction "none"; its backward by autograd, for x alone
    # (dx) and for w alone (dW).  No single PyTorch call computes the head.
    yl = y.long()

    def lib_loss(a, b):
        return F.cross_entropy(torch.matmul(a, b).float(), yl,
                               reduction="none", ignore_index=-1)

    with torch.no_grad():
        lib_out = lib_loss(x, w)
    keep = yl >= 0
    _, lib_rel = rel_err(torch, lib_out[keep], loss[keep])
    del lib_out

    def lib_fwd(i):
        with torch.no_grad():
            lib_loss(x, w)

    lib_fwd_ms = device_ms(torch, lib_fwd, 3)
    lib_bwd = []
    for which in (0, 1):
        xr = x.detach().requires_grad_(which == 0)
        wr = w.detach().requires_grad_(which == 1)
        out = lib_loss(xr, wr)
        wrt = xr if which == 0 else wr
        lib_bwd.append(device_ms(torch, lambda i: torch.autograd.grad(
            out, wrt, g, retain_graph=True), 3))
        del out, xr, wr, wrt
        torch.cuda.empty_cache()
    # bounds: 2 N d V flops a product (one forward, two in dx and dW);
    # each input read once, each output written once
    prod = 2 * n * d * v
    es = x.element_size()
    io = x.numel() * es + w.numel() * es + 4 * n        # x, w, y
    rows = []
    for name, line, ms, plain, lib, flops, nbytes, err in (
            ("fused_ce_fwd", 153, fwd_ms, plain_fwd_ms, lib_fwd_ms, prod,
             io + 8 * n, errs["path"][0]),
            ("fused_ce_dx", 198, dx_ms, plain_dx_ms, lib_bwd[0], 2 * prod,
             io + 8 * n + x.numel() * es, errs["path"][1]),
            ("fused_ce_dw", 211, dw_ms, plain_dw_ms, lib_bwd[1], 2 * prod,
             io + 8 * n + w.numel() * es, errs["path"][1])):
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bytes_ms = nbytes / HBM_BYTES_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        log(f"{name} bf16 (N={n} d={d} V={v}, {flops / 1e12:.4f} TFLOP, "
            f"{nbytes} bytes): kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
            f"library (matmul + cross_entropy{'' if line == 153 else ' backward'}"
            f", loss rel err {lib_rel:.2e}) {lib:.4f} ms, bound "
            f"{bound_ms:.4f} ms "
            f"({'operations' if ops_ms >= bytes_ms else 'bytes'})")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/fused_ce.cu",
                     "replaces": f"paddle_tpu/ops/pallas_ce.py:{line}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bound_ms,
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes"),
                     "library_ms": lib})
    return rows


# -- phase 4: full-width f32 served vs single-stream -------------------------

def correctness_phase(torch, np, params, work):
    from paddle_tpu_torch.models.transformer import (generate,
                                                     params_from_numpy)
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.serving import ServingEngine

    obs.get_registry().clear(prefix="serving.")
    eng = ServingEngine(params, N_LAYER, N_HEAD, D_MODEL, max_len=MAX_LEN,
                        max_slots=SLOTS, decode_chunk=CHUNK,
                        min_bucket=MIN_BUCKET, block_tokens=BLOCK_TOKENS,
                        compute_dtype="float32", prefix_reuse=True)
    eng.start()
    try:
        reqs = [eng.submit(p, m) for p, m in work]
        outs = [r.result(timeout=900) for r in reqs]
    finally:
        eng.stop()
    hit = eng.stats().get("serving.prefix_hit_rate", 0.0)
    del eng
    p32 = params_from_numpy(params, "cuda", torch.float32)
    full = 0
    for k, ((prompt, max_new), out) in enumerate(zip(work, outs)):
        n = len(prompt) + max_new
        toks, logits = generate(p32, prompt[None], max_len=n,
                                n_layer=N_LAYER, n_head=N_HEAD,
                                d_model=D_MODEL, device="cuda")
        ref = toks[0].cpu().numpy()
        if out.shape != ref.shape:
            raise AssertionError(f"request {k}: {out.shape} vs {ref.shape}")
        diff = np.nonzero(out != ref)[0]
        if diff.size == 0:
            full += 1
            continue
        i = int(diff[0])
        lg = logits[0, i - 1]
        top = torch.topk(lg, 2).values
        gap = (top[0] - top[1]).item()
        limit = 1e-4 * lg.abs().max().item()
        log(f"  request {k}: served and generate diverge at position {i} "
            f"(prompt {len(prompt)}), top-2 gap {gap:.3e} vs near-tie "
            f"limit {limit:.3e}")
        if not gap < limit:
            raise AssertionError(
                f"request {k} diverges from generate at position {i} "
                f"where generate's top-2 gap {gap:.3e} is no near-tie")
    log(f"f32 full width: {full}/{len(work)} requests token-identical to "
        f"generate, the rest diverge only at near-ties "
        f"(prefix hit rate {hit:.3f})")
    del p32


# -- phase 5: full-width bf16 serving ----------------------------------------

def serving_phase(torch, np, params, work, kernels):
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.serving import ServingEngine

    reg = obs.get_registry()
    reg.clear(prefix="serving.")
    eng = ServingEngine(params, N_LAYER, N_HEAD, D_MODEL, max_len=MAX_LEN,
                        max_slots=SLOTS, decode_chunk=CHUNK,
                        min_bucket=MIN_BUCKET, block_tokens=BLOCK_TOKENS,
                        compute_dtype="bfloat16", prefix_reuse=True)
    # warm: the first two requests of each class, one at a time — the
    # first pays a full prefill, the second its prefix-hit suffix bucket
    for prompt, _ in work[: 2 * len(CLASSES)]:
        eng.generate_many([prompt], max_new_tokens=2)
    for nm in ("serving.queue_wait", "serving.decode_chunk",
               "serving.prefill_seconds", "serving.ttft_seconds",
               "serving.e2e_seconds", "serving.step_seconds"):
        h = reg.get(nm)
        if h is not None:
            h.reset()
    eng.reset_slo_accounting()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                     # counts start at 0 here
    t0 = time.perf_counter()
    reqs = [eng.submit(p, m) for p, m in work]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {nm: fn.launches for nm, fn in kernels.WRAPPERS.items()}
    st = eng.stats()
    for r, (prompt, max_new) in zip(reqs, work):
        out = r.result(timeout=0)
        gen = out[len(prompt):]
        if len(gen) != max_new or gen.min() < 0 or gen.max() >= VOCAB:
            raise AssertionError(f"request {r.rid}: bad output {gen}")
    emitted = sum(len(r.tokens) for r in reqs)
    chunks = st["serving.decode_chunk"]["count"]
    prefill_steps = int(st["serving.prefill_tokens"])
    expect = N_LAYER * (CHUNK * chunks + prefill_steps)
    ttft = st["serving.ttft_seconds"]
    log(f"bf16 full width: {len(reqs)} requests, {emitted} tokens in "
        f"{wall:.3f} s = {emitted / wall:.1f} tok/s; TTFT p50 "
        f"{ttft['p50'] * 1e3:.1f} ms p99 {ttft['p99'] * 1e3:.1f} ms; "
        f"decode_chunk p50 {st['serving.decode_chunk']['p50'] * 1e3:.2f} ms "
        f"({chunks} chunks); prefill steps {prefill_steps}; prefix hit rate "
        f"{st['serving.prefix_hit_rate']:.3f}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    log(f"paged_attention.launches {launches['paged_attention']} during the "
        f"pass (layers x (decode steps + prefill steps) = {expect}; "
        f"{N_LAYER * CHUNK} per decode chunk)")
    if launches["paged_attention"] <= 0:
        raise AssertionError("the serving pass never launched the kernel")
    if launches["paged_attention"] != expect:
        raise AssertionError(
            f"{launches['paged_attention']} kernel launches, expected "
            f"{expect}: some attention did not go through the kernel")
    profile_decode(torch, eng, work)
    del eng
    return launches


def profile_decode(torch, eng, work, chunks=3):
    """Where a decode chunk's time goes (measured, not judged): fill
    every slot, then trace ``chunks`` steady decode chunks with
    ``torch.profiler`` and print the device's kernel time per chunk
    against the chunk's wall, kernels per decode step, and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # enough tokens that every slot stays live through the admission
    # chunk, the unprofiled chunks and the profiled ones
    reqs = [eng.submit(p, CHUNK * (2 * chunks + 2)) for p, _ in
            work[:SLOTS]]
    eng.step()                        # admissions (prefills) + one chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / chunks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    if any(r.error is not None for r in reqs):
        raise AssertionError("a profiled request failed")
    # device-side rows only (kernels, memcpys, memsets): the CPU op rows
    # above them repeat the same device time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log("profile: the profiler recorded no device time")
        return
    dev_ms = sum(r[0] for r in rows) / 1e3 / chunks
    kernels_per_step = sum(r[1] for r in rows) / (chunks * CHUNK)
    log(f"profile: decode chunk wall {plain_wall * 1e3:.2f} ms unprofiled, "
        f"device kernel time {dev_ms:.2f} ms per chunk (busy share "
        f"{dev_ms / (plain_wall * 1e3):.3f}), {kernels_per_step:.1f} "
        f"kernels per decode step ({kernels_per_step / N_LAYER:.1f} per "
        f"layer-step)")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3 / chunks:8.3f} ms/chunk {count // chunks:6d} "
            f"calls/chunk  {key[:90]}")


# -- phases 6 and 7: training through Program -> Executor --------------------

def build_training(pt, seed, max_len, dtype, fused_head):
    """The flagship training program at full width and its startup
    program, seeded; names restart so every build names alike."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
            d_model=D_MODEL, max_len=max_len, dropout_rate=0.0, dtype=dtype,
            fused_head=fused_head, learning_rate=TRAIN_LR)
    return main, startup, model


def make_batch(torch, rng, batch, t):
    """A learnable pattern: next = tok + 1 on a cycle of ``PATTERN``
    tokens, from a random start per row (over the whole 32768-token
    vocabulary a handful of steps sees each token once and learns
    nothing measurable); labels are the tokens shifted left, the last one
    padding."""
    start = torch.as_tensor(rng.integers(0, PATTERN, (batch, 1)),
                            device="cuda")
    toks = (start + torch.arange(t, device="cuda")[None, :]) % PATTERN
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1)
    return {"tokens": toks, "labels": labels}


def launch_counts(kernels):
    return {nm: fn.launches for nm, fn in kernels.WRAPPERS.items()}


def grads_agree(params, got, want, tol, what):
    """Every step-1 gradient of ``got`` within ``tol`` of ``want``, max
    |a - b| / max |b|; the key biases' gradient is zero analytically
    (softmax ignores a shift of every key) and roundoff on both sides, so
    it is held to the largest gradient entry of the model, not to itself.
    Returns the worst (name, rel)."""
    biggest = max(g.abs().max().item() for g in want)
    worst = ("", 0.0)
    for name, ga, gb in zip(params, got, want):
        scale = biggest if "_att_k.b" in name else gb.abs().max().item()
        rel = (ga.float() - gb.float()).abs().max().item() / scale
        if rel > worst[1]:
            worst = (name, rel)
        if not rel <= tol:
            raise AssertionError(
                f"f32 step-1 gradient of {name} ({what}): rel {rel:.3e} > "
                f"{tol}")
    return worst


def training_check_phase(torch, np, pt, kernels, fa, ce, seed):
    """f32, full width, short sequence, two Adam steps from one startup
    state each: (a) unfused head, attention through the kernels, against
    the same with attention routed to the plain versions; (b) the fused
    head through the CE kernels against the unfused head (cuBLAS and
    softmax), both with attention in the kernels."""
    main, startup, model = build_training(pt, seed, CHECK_T, "float32",
                                          False)
    fmain, _, fmodel = build_training(pt, seed, CHECK_T, "float32", True)
    exe = pt.Executor()
    base = pt.Scope()
    exe.run(startup, scope=base)
    names = {v.name for v in main.persistable_vars()}
    if {v.name for v in fmain.persistable_vars()} != names:
        raise AssertionError("the fused and unfused programs hold other state")
    params = [p.name for p in main.all_parameters()]
    if [p.name for p in fmain.all_parameters()] != params:
        raise AssertionError("the fused and unfused programs order their "
                             "parameters differently")
    rng = np.random.default_rng(seed)
    batches = [make_batch(torch, rng, CHECK_B, CHECK_T) for _ in range(2)]

    def two_steps(prog, loss_var):
        fetch = [loss_var.name] + [p + "@GRAD" for p in params]
        scope = pt.Scope()
        for n in base.var_names():
            scope.set(n, base.get(n).clone())
        out = []
        for feed in batches:
            out.append(exe.run(prog, feed=feed, fetch_list=fetch,
                               scope=scope, return_numpy=False))
        torch.cuda.synchronize()
        return out

    def delta(c0):
        c1 = launch_counts(kernels)
        return {k: c1[k] - c0[k] for k in c1}

    c0 = launch_counts(kernels)
    with_kernels = two_steps(main, model["avg_cost"])
    d = delta(c0)
    if (d["flash_attention_fwd"], d["flash_attention_bwd"]) != (
            2 * N_LAYER, 2 * N_LAYER) or d["fused_ce_fwd"]:
        raise AssertionError(f"the f32 unfused steps missed the kernels: {d}")
    # the test-only switch: the autograd Function finds its wrappers by
    # name in the module, so the plain versions stand in for both
    real = fa.flash_fwd, fa.flash_bwd
    fa.flash_fwd = lambda q, k, v, causal=False, sm_scale=None: (
        fa.flash_attention_ref(q, k, v, causal, sm_scale))
    fa.flash_bwd = fa.flash_attention_bwd_ref
    try:
        c0 = launch_counts(kernels)
        with_plain = two_steps(main, model["avg_cost"])
    finally:
        fa.flash_fwd, fa.flash_bwd = real
    if any(delta(c0).values()):
        raise AssertionError("the plain-version steps launched a kernel")
    c0 = launch_counts(kernels)
    fused = two_steps(fmain, fmodel["avg_cost"])
    d = delta(c0)
    if (d["flash_attention_fwd"], d["flash_attention_bwd"], d["fused_ce_fwd"],
            d["fused_ce_dx"], d["fused_ce_dw"]) != (
            2 * N_LAYER, 2 * N_LAYER, 2, 2, 2):
        raise AssertionError(f"the f32 fused-head steps missed a kernel: {d}")

    for what, a_run, b_run, tol in (
            ("flash kernels vs plain attention", with_kernels, with_plain,
             fa.oracle_tol(torch.float32, "grad")),
            ("fused CE head vs unfused head", fused, with_kernels,
             ce.oracle_tol(torch.float32, "grad"))):
        losses = []
        for a, b in zip(a_run, b_run):
            la, lb = a[0].item(), b[0].item()
            losses.append((la, lb))
            if not (np.isfinite(la) and abs(la - lb) <= 1e-3 * abs(lb)):
                raise AssertionError(f"f32 training loss {la} vs {lb} ({what})")
        worst = grads_agree(params, a_run[0][1:], b_run[0][1:], tol,
                            what)
        log(f"f32 training, full width (t={CHECK_T}, b={CHECK_B}, 2 steps), "
            f"{what}: loss "
            + ", ".join(f"{a:.6f} vs {b:.6f}" for a, b in losses)
            + f"; step-1 gradients of {len(params)} parameters within "
            f"{tol:g} (worst {worst[0]} rel {worst[1]:.3e})")


def training_phase(torch, np, pt, kernels, seed, fused_head):
    """A training path at full width: bf16, t=4096, batch 8, the fused
    head (the main path) or the unfused one.  Returns the launch counts of
    the counted steps and the peak device memory."""
    tokens = TRAIN_B * TRAIN_T
    head = "fused" if fused_head else "unfused"
    n_params = (VOCAB * D_MODEL * 2 + TRAIN_T * D_MODEL
                + N_LAYER * 12 * D_MODEL * D_MODEL)
    # reckoned before running: f32 master copies do not exist (weights are
    # bf16, moments f32); each layer holds about 30 [tokens, d] bf16
    # tensors' worth of residuals, the f32 LayerNorm inputs included; the
    # unfused head adds logits in bf16 and f32 plus log-softmax, and
    # transiently their gradients; the fused head adds only O(tokens)
    est = (n_params * (2 + 2 + 8) + N_LAYER * 30 * tokens * D_MODEL * 2)
    if not fused_head:
        est += tokens * VOCAB * (2 + 4 + 4 + 4 + 2)
    log(f"training, {head} head: {n_params} parameters, {tokens} tokens a "
        f"step; memory reckoned before the run: about {est / 2**30:.1f} GiB")
    main, startup, model = build_training(pt, seed, TRAIN_T, "bfloat16",
                                          fused_head)
    exe = pt.Executor()
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    watched = ("lm_head.w", "tok_emb.w", "block0_att_q.w", "block11_ffn2.b")
    before = {n: scope.get(n).clone() for n in watched}
    fetch = [model["avg_cost"].name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                     # counts start at 0 here
    losses, walls = [], []
    for _ in range(TRAIN_STEPS):
        feed = make_batch(torch, rng, TRAIN_B, TRAIN_T)
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_numpy=False)
        losses.append(loss.item())               # ends in a device sync
        walls.append(time.perf_counter() - t0)
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"bf16 training, {head} head, full width (t={TRAIN_T}, "
        f"b={TRAIN_B}): loss " + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step wall first {walls[0]:.3f} s, then median {steady:.3f} s = "
        f"{tokens / steady:.0f} tok/s; grad norm "
        f"{scope.get('@GRAD_NORM@').item():.4f}; max_memory_allocated "
        f"{peak} B")
    log(f"launches during the {TRAIN_STEPS} steps: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" (expected {N_LAYER} + {N_LAYER} flash a step"
        + (", 1 of each CE kernel a step)" if fused_head else ", no CE)"))
    if not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if abs(losses[0] - np.log(VOCAB)) > 0.5:
        raise AssertionError(
            f"first loss {losses[0]} is not near ln({VOCAB}) = "
            f"{np.log(VOCAB):.3f}")
    if not losses[-1] < losses[0] - 0.05:
        raise AssertionError(f"the loss did not fall: {losses}")
    want = N_LAYER * TRAIN_STEPS
    ce_want = TRAIN_STEPS if fused_head else 0
    expect = {"paged_attention": 0, "flash_attention_fwd": want,
              "flash_attention_bwd": want, "fused_ce_fwd": ce_want,
              "fused_ce_dx": ce_want, "fused_ce_dw": ce_want}
    if launches != expect:
        raise AssertionError(
            f"launches {launches}, expected {expect}: some attention or "
            f"head call did not go through its kernel")
    for n, old in before.items():
        if torch.equal(scope.get(n), old):
            raise AssertionError(f"parameter {n} did not change")
        if not torch.isfinite(scope.get(n).float()).all():
            raise AssertionError(f"parameter {n} is not finite")
    profile_training(torch, pt, exe, main, scope, fetch,
                     make_batch(torch, rng, TRAIN_B, TRAIN_T), steady)
    del exe, scope, before
    return launches, peak


def profile_training(torch, pt, exe, main, scope, fetch, feed, steady):
    """Where one training step's time goes (measured, not judged): the
    device's kernel time by kernel family under ``torch.profiler``, then
    the device time of each forward and optimizer op type by CUDA events
    around the op implementations (what is left is autograd's backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core import registry

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log("profile: the profiler recorded no device time")
    else:
        families = (("flash forward", ("flash_fwd_kernel",)),
                    ("flash backward", ("flash_bwd_kernel",)),
                    ("CE forward", ("ce_fwd_kernel",)),
                    ("CE dx", ("ce_dx_kernel",)),
                    ("CE dW", ("ce_dw_kernel",)),
                    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                    ("softmax / log-softmax", ("softmax",)),
                    ("LayerNorm", ("layer_norm", "LayerNorm")),
                    ("memcpy / memset", ("Memcpy", "Memset")))
        total = sum(r[0] for r in rows) / 1e3
        sums = {}
        for us, count, key in rows:
            fam = next((f for f, pats in families
                        if any(p_ in key for p_ in pats)),
                       "elementwise, reductions, other")
            ms, n = sums.get(fam, (0.0, 0))
            sums[fam] = (ms + us / 1e3, n + count)
        log(f"profile: training step wall {steady * 1e3:.1f} ms unprofiled, "
            f"device kernel time {total:.1f} ms (busy share "
            f"{total / (steady * 1e3):.3f}), {sum(r[1] for r in rows)} "
            f"kernels")
        for fam, (ms, n) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
            log(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% {n:6d} calls  {fam}")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            log(f"    top kernel {us / 1e3:9.3f} ms {count:5d} calls  "
                f"{key[:80]}")
    # by op type: events around every op implementation of one more step
    spans = []
    real_call = registry.OpImpl.call

    def timed_call(self, ins, attrs, ctx, live=None):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_call(self, ins, attrs, ctx, live)
        e1.record()
        spans.append((self.type, e0, e1))
        return out

    registry.OpImpl.call = timed_call
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    try:
        s0.record()
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
        s1.record()
        torch.cuda.synchronize()
    finally:
        registry.OpImpl.call = real_call
    by_type = {}
    for typ, e0, e1 in spans:
        ms, n = by_type.get(typ, (0.0, 0))
        by_type[typ] = (ms + e0.elapsed_time(e1), n + 1)
    step_ms = s0.elapsed_time(s1)
    op_ms = sum(v[0] for v in by_type.values())
    log(f"by op type (CUDA events, one step of {step_ms:.1f} ms): forward "
        f"and optimizer ops {op_ms:.1f} ms, the rest — autograd's backward "
        f"and the gradient norm — {step_ms - op_ms:.1f} ms")
    for typ, (ms, n) in sorted(by_type.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:9.3f} ms {n:5d} calls  {typ}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as ce
    from paddle_tpu_torch.kernels import paged_attention as pa

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device {torch.cuda.get_device_name(0)} (count "
        f"{torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. the build
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(_build.sources())} (nvcc "
        + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items())
        + ")")
    for name in _build.sources():
        with open(_build.log_path(name)) as f:
            for line in f:
                if "Compiling entry" in line or "registers" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # 3. each kernel against its plain version, and its times
    row = kernel_phase(torch, pa)
    flash_rows = flash_phase(torch, fa)
    torch.cuda.empty_cache()
    ce_rows = ce_phase(torch, ce)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    params = make_params(rng)
    work = make_workload(rng, REQUESTS, CLASSES, VOCAB, PREFIX_LEN)
    log(f"weights: {sum(v.size for v in params.values())} parameters, "
        f"made in {time.perf_counter() - t0:.1f} s")

    # 4. correctness at full width, f32
    correctness_phase(torch, np, params, work[:8])
    torch.cuda.empty_cache()

    # 5. the main path: serving at full width, bf16
    launches = serving_phase(torch, np, params, work, kernels)

    del params, work
    torch.cuda.empty_cache()

    # 6. training correctness at full width, f32: kernels vs plain, fused
    #    head vs unfused head
    training_check_phase(torch, np, pt, kernels, fa, ce, args.seed)
    torch.cuda.empty_cache()

    # 7. the other main path: training at full width, bf16, fused head;
    #    7b. the unfused head, the same steps, for its peak memory
    train_launches, fused_peak = training_phase(torch, np, pt, kernels,
                                                args.seed, fused_head=True)
    torch.cuda.empty_cache()
    _, unfused_peak = training_phase(torch, np, pt, kernels, args.seed,
                                     fused_head=False)
    log(f"peak memory: fused head {fused_peak} B, unfused head "
        f"{unfused_peak} B, {(unfused_peak - fused_peak) / 1e9:.3f} GB less")
    if not fused_peak <= unfused_peak - 10e9:
        raise AssertionError(
            f"the fused head's peak {fused_peak} B is not 10 GB below the "
            f"unfused head's {unfused_peak} B")

    # 8. the kernels line, 9. the result
    row["launches"] = launches["paged_attention"]
    for r in flash_rows + ce_rows:
        r["launches"] = train_launches[r["name"]]
    print(json.dumps({"kernels": [row] + flash_rows + ce_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
