#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
GPU — the quickest proof that the port builds, is right and serves.

    python3 chip_smoke.py [--seed N]

Phases, in order; each raises on failure and the script then exits
non-zero (no phase is wrapped in a ``try`` that carries on):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: every ``paddle_tpu_torch/csrc/*.cu`` by ``nvcc`` for
   ``sm_90a`` (one process per source, in parallel), timed;
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (decode S=32 W=1, prefill S=1 W=1, and W=4),
   bf16 and f32, within ORACLE_TOL; then, at the decode shape in bf16,
   the kernel's time, the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention`` on the gathered view, a yardstick
   the port never calls) and the bound (bytes over 3.35 TB/s);
4. correctness at full width in f32: the 12-layer d768 h6 v32768 GPT with
   seeded random weights serves 8 shared-prefix requests through the
   engine's background thread, each compared with the port's single-stream
   ``generate``; they must agree token for token except where
   ``generate``'s top-2 logit gap is below 1e-4 * max|logit| (a genuine
   near-tie that reassociating the f32 softmax can flip);
5. serving at full width in bf16: the 64-request shared-prefix load of
   ``benchmarks/serving.py`` (32 slots, decode chunk 16, min bucket 16,
   32-token blocks), submitted at once after a warm pass, run until
   idle; every request must be served in full, and every attention call
   of the pass must have gone through the CUDA kernel (launch count ==
   layers x (decode steps + prefill steps), all counts zeroed just
   before the pass); then, with every slot live, a few decode chunks
   traced with ``torch.profiler``: the card's busy share of a chunk and
   the kernels that take its device time;
6. one JSON line ``{"kernels": [...]}`` with each kernel's launches on
   the main path (phase 5), error, times and bound;
7. the last line: ``{"ok": true, "device": {...}}``.

Without a CUDA device, or run from a directory that holds only this
file, it exits non-zero and prints no result.  The weights and the
traffic are made from ``--seed``; nothing is read from the network.
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

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import _build
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

    # 6. the kernels line, 7. the result
    row["launches"] = launches["paged_attention"]
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
