"""``python -m paddle_tpu_torch --kernels-selftest [--device=cpu]`` — the
kernel registry's gate, the counterpart of
``paddle_tpu/kernels/selftest.py``.  Runs on the card unless
``--device=cpu`` is given.

What it proves on the device, card or not:

1. resolution — every op class resolves under auto (on a card to
   ``cuda``, never ``torch_ref``; on the CPU to ``torch_ref``), each
   backend's availability is listed with its reason, and the precedence
   holds (explicit argument > forced > per-op env > global env > auto):
   unknown names raise, an explicit or per-op request for an unavailable
   backend raises with the probe's reason, a global-env or forced request
   the op cannot serve falls back to auto and is counted once;
2. flash and CE parity — every flash backend that runs here (the
   available ones; on the CPU the ``cuda`` and ``triton`` wrappers, which
   take their plain versions for CPU tensors) against ``torch_ref``
   within ``ORACLE_TOL``: f32 and bf16, causal and not, ``d_head`` 64 and
   128, gradients through the one ``autograd.Function``; the fused CE
   head likewise; ``decode_gather`` bit-exact; and each backend the same
   bits run to run (under deterministic algorithms, which send the
   ``cuda`` backward to its split route: the fused route adds ``dq`` with
   atomics);
3. paged parity — every paged backend that runs here against a dense
   gather-and-softmax spelling over ragged chains (a full chain, a
   cached one-token prefill, a copy-on-write fork, a trash-block chain
   tail holding garbage) for ``W`` 1 and 3, bit-exact run to run, and the
   ``PADDLE_TPU_PAGED_ATTN`` kill switch: ``=0`` builds the decode chunk
   on ``decode_gather``, ``=1`` on ``paged_attention``, same tokens;
4. the ``torch_ref`` bar — ``PADDLE_TPU_KERNEL_BACKEND=torch_ref`` runs
   the GPT trainer under every ``memory_optimize`` policy with no
   hand-written kernel launched (the CUDA wrappers' and the Triton
   wrappers' counters), a finite loss, and ``torch_ref`` in the step's
   ``kernel_backends``;
5. the timed-run lint — a ``torch_ref``-routed step inside
   ``timed_run()`` is a ``jaxpr.kernel-backend`` error; an auto-routed
   one is quiet on a card (on the CPU auto is ``torch_ref`` and the lint
   fires too), and outside a timed run the lint stays quiet.
"""

import contextlib
import os

import numpy as np

__all__ = ["run_selftest"]

_GLOBAL = "PADDLE_TPU_KERNEL_BACKEND"
_FLASH_ENV = "PADDLE_TPU_KERNEL_BACKEND_FLASH_ATTENTION"
_POLICIES = (None, "selective", "offload", "compact", "full")


@contextlib.contextmanager
def _env(**values):
    """Set (a value) or clear (None) environment variables inside."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rel_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def check_registry(check, device):
    from . import (AUTO_ORDER, KernelUnavailable, available_backends,
                   forced_backend, registered_op_classes, resolve_name)
    from ..observability import get_registry

    plat = device.type
    ops = registered_op_classes()
    check(ops == ["decode_gather", "flash_attention", "fused_ce",
                  "paged_attention"], f"op classes {ops}")
    want_auto = "cuda" if plat == "cuda" else "torch_ref"
    with _env(**{_GLOBAL: None, _FLASH_ENV: None}):
        for op in ops:
            auto = resolve_name(op, platform=plat)
            rows = available_backends(op)
            print(f"  {op}: auto -> {auto}; " + "; ".join(
                f"{b}={'ok' if ok else 'unavailable'}"
                + (f" ({r})" if r and not ok else "")
                for b, ok, r in rows), flush=True)
            check(auto == want_auto, f"{op}: auto resolves {auto} on "
                                     f"{plat} (want {want_auto})")
    check("torch_ref" not in AUTO_ORDER["cuda"],
          "auto on a card never picks torch_ref")
    unavailable = [b for b, ok, _ in available_backends("flash_attention")
                   if not ok]
    for b in unavailable:
        try:
            resolve_name("flash_attention", b, platform=plat)
            check(False, f"explicit unavailable {b} raised")
        except KernelUnavailable as e:
            check(bool(e.reason), f"explicit unavailable {b} raises with "
                                  f"its reason ({e.reason})")
    try:
        resolve_name("flash_attention", "cuda_graphs", platform=plat)
        check(False, "an unknown backend raised ValueError")
    except ValueError:
        check(True, "an unknown backend raised ValueError")
    # the explicit argument beats a per-op env: here the per-op env names
    # a backend that would raise (or a different one) and the argument
    # still resolves
    pin = unavailable[0] if unavailable else "triton"
    with _env(**{_FLASH_ENV: pin}):
        check(resolve_name("flash_attention", "torch_ref", platform=plat)
              == "torch_ref", f"explicit torch_ref beats per-op env {pin}")
    # the per-op env beats the global env, and is strict
    with _env(**{_GLOBAL: "torch_ref", _FLASH_ENV: want_auto}):
        check(resolve_name("flash_attention", platform=plat) == want_auto,
              f"per-op env {want_auto} beats global torch_ref")
        check(resolve_name("fused_ce", platform=plat) == "torch_ref",
              "the per-op env does not leak to fused_ce")
    if unavailable:
        with _env(**{_FLASH_ENV: unavailable[0]}):
            try:
                resolve_name("flash_attention", platform=plat)
                check(False, "a per-op env naming an unavailable backend "
                             "raised")
            except KernelUnavailable:
                check(True, f"per-op env {unavailable[0]} (unavailable) "
                            f"is strict: it raised")
    # a global pin the op cannot serve falls back to auto, counted once
    reg = get_registry()
    n0 = int(reg.value("kernels.env_fallbacks") or 0)
    with _env(**{_GLOBAL: "triton", _FLASH_ENV: None}):
        got = resolve_name("decode_gather", platform=plat)
    check(got == want_auto and int(reg.value("kernels.env_fallbacks")
                                   or 0) == n0 + 1,
          f"global triton falls back to auto for decode_gather ({got}), "
          f"counted once")
    with forced_backend("torch_ref"):
        check(resolve_name("fused_ce", platform=plat) == "torch_ref",
              "forced_backend routes fused_ce")
        check(resolve_name("fused_ce", want_auto, platform=plat)
              == want_auto, "an explicit argument beats forced_backend")
    with forced_backend("triton", op_class="decode_gather"):
        check(resolve_name("decode_gather", platform=plat) == want_auto,
              "forced triton (not registered for decode_gather) falls "
              "back to auto")


def _flash_runnable(device):
    """``[(name, impl, blocks)]``: every flash backend whose wrappers run
    on ``device`` — the available ones, and on the CPU the cuda and triton
    wrappers (which take their plain versions for CPU tensors)."""
    from . import available_backends, get_kernel

    out = []
    for b, ok, _ in available_backends("flash_attention"):
        if b == "torch_ref" or not (ok or device.type == "cpu"):
            continue
        name = b if ok else f"{b}(cpu tensors)"
        # 64-wide hints: several tiles a row even at t=128 for the Triton
        # kernels; the cuda backward's route at block_k 64 is the fused one
        out.append((name, get_kernel("flash_attention", b).impl,
                    {"block_q": 64, "block_k": 64}))
    return out


def _check_flash(check, device):
    import torch

    from . import get_kernel
    from .flash_attention import oracle_tol

    ref = get_kernel("flash_attention", "torch_ref").impl
    impls = _flash_runnable(device)
    print(f"flash parity: {[n for n, _i, _b in impls]} vs torch_ref",
          flush=True)
    gen = torch.Generator().manual_seed(11)

    def rand(*shape, dt, s=0.5):
        return (torch.randn(*shape, generator=gen) * s).to(device, dt)

    for dt in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            for d in (64, 128):
                q, k, v = (rand(2, 128, 2, d, dt=dt) for _ in range(3))
                want = ref.call(q, k, v, causal=causal)
                for name, impl, blk in impls:
                    err = _rel_err(impl.call(q, k, v, causal=causal, **blk),
                                   want)
                    tol = oracle_tol(dt, "fwd")
                    check(err <= tol, f"flash {name} {dt} causal={causal} "
                                      f"d={d}: fwd err {err:.2e} <= {tol}")
        # gradients through the autograd Function, with an lse cotangent
        q0, k0, v0 = (rand(1, 128, 2, 64, dt=dt) for _ in range(3))
        w_o = rand(1, 128, 2, 64, dt=torch.float32, s=1.0)
        w_l = rand(1, 2, 128, dt=torch.float32, s=1.0)

        def grads(impl, blk):
            q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
            o, lse = impl.call_with_lse(q, k, v, causal=True, **blk)
            ((o.float() * w_o).sum() + (lse * w_l).sum()).backward()
            return q.grad, k.grad, v.grad

        want = grads(ref, {})
        for name, impl, blk in impls:
            tol = oracle_tol(dt, "grad")
            for which, a, r in zip("qkv", grads(impl, blk), want):
                err = _rel_err(a, r)
                check(err <= tol, f"flash {name} {dt} d{which}: grad err "
                                  f"{err:.2e} <= {tol}")
    # the same bits run to run within each backend (deterministic
    # algorithms: the cuda backward on its split route, no atomics)
    q0, k0, v0 = (rand(1, 256, 2, 64, dt=torch.bfloat16) for _ in range(3))
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, impl, blk in impls + [("torch_ref", ref, {})]:
            runs = []
            for _ in range(2):
                q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
                o = impl.call(q, k, v, causal=True, **blk)
                o.float().sum().backward()
                runs.append((o, q.grad, k.grad, v.grad))
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"flash {name}: the same bits run to run (o, dq, dk, dv)")
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def _check_ce_and_gather(check, device):
    import torch

    from . import available_backends, get_kernel
    from .fused_ce import oracle_tol

    ref = get_kernel("fused_ce", "torch_ref").impl
    impls = [(b if ok else f"{b}(cpu tensors)",
              get_kernel("fused_ce", b).impl)
             for b, ok, _ in available_backends("fused_ce")
             if b != "torch_ref" and (ok or device.type == "cpu")]
    gen = torch.Generator().manual_seed(13)
    for dt in (torch.float32, torch.bfloat16):
        x0 = (torch.randn(128, 64, generator=gen) * 0.3).to(device, dt)
        w0 = (torch.randn(64, 512, generator=gen) * 0.05).to(device, dt)
        y = torch.randint(0, 512, (128,), generator=gen).to(device)
        g = torch.randn(128, generator=gen).to(device)

        def run(impl):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            loss = impl.call(x, w, y)
            (loss * g).sum().backward()
            return loss, x.grad, w.grad

        want = run(ref)
        for name, impl in impls:
            got = run(impl)
            err = _rel_err(got[0], want[0])
            check(err <= oracle_tol(dt, "fwd"),
                  f"ce {name} {dt}: fwd err {err:.2e}")
            for which, a, r in zip(("x", "w"), got[1:], want[1:]):
                err = _rel_err(a, r)
                check(err <= oracle_tol(dt, "grad"),
                      f"ce {name} {dt} d{which}: grad err {err:.2e}")
    gref = get_kernel("decode_gather", "torch_ref").impl
    pool = torch.randn(7, 4, 2, 8, generator=gen).to(device)
    table = torch.randint(0, 7, (3, 5), generator=gen,
                          dtype=torch.int32).to(device)
    for b, ok, _ in available_backends("decode_gather"):
        if b != "torch_ref" and (ok or device.type == "cpu"):
            got = get_kernel("decode_gather", b).impl.call(pool, table)
            check(torch.equal(got, gref.call(pool, table)),
                  f"decode_gather {b}: bit-exact")


def _paged_dense(q, pool_k, pool_v, table, pos):
    """The independent spelling the paged backends are held to: the
    gathered ``[S, T, h, dh]`` view (what paged attention exists to
    avoid), a dense mask past ``pos``, one softmax, all in f32."""
    import torch

    from .decode_gather import decode_gather_ref
    from .paged_attention import NEG_INF

    S, NB = table.shape
    B, dh = pool_k.shape[1], q.shape[-1]
    kg = decode_gather_ref(pool_k, table).float()
    vg = decode_gather_ref(pool_v, table).float()
    s = torch.einsum("swhd,sthd->swht", q.float(), kg) / dh ** 0.5
    tok = torch.arange(NB * B, device=q.device)
    keep = tok[None, None, None, :] <= pos.long()[:, :, None, None]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("swht,sthd->swhd", p, vg).to(q.dtype)


def _check_paged(check, device):
    import torch

    from . import available_backends, get_kernel
    from .paged_attention import oracle_tol

    impls = [(b if ok or b == "torch_ref" else f"{b}(cpu tensors)",
              get_kernel("paged_attention", b).impl)
             for b, ok, _ in available_backends("paged_attention")
             if ok or device.type == "cpu"]
    print(f"paged parity: {[n for n, _i in impls]} vs dense "
          f"gather+softmax", flush=True)
    gen = torch.Generator().manual_seed(23)
    S, NB, B, h, dh = 4, 3, 4, 2, 16
    nblk = 1 + S * NB
    table = torch.arange(1, 1 + S * NB, dtype=torch.int32).reshape(S, NB)
    table[3, 0] = table[0, 0]          # a CoW fork shares slot 0's block
    table[2, 2] = 0                    # an unused tail -> the trash block
    table = table.to(device)
    cases = (("decode", [[NB * B - 1], [5], [7], [9]]),
             ("cached-prefill", [[3], [0], [6], [4]]),
             ("verify-window", [[4, 5, 6], [1, 2, 3], [5, 6, 7],
                                [8, 9, 10]]))
    for dt in (torch.float32, torch.bfloat16):
        pk = (torch.randn(nblk, B, h, dh, generator=gen) * 0.5).to(dt)
        pv = (torch.randn(nblk, B, h, dh, generator=gen) * 0.5).to(dt)
        pk[0], pv[0] = 1e3, 1e3        # trash-block garbage: masked
        pk, pv = pk.to(device), pv.to(device)
        for case, pos in cases:
            pos = torch.tensor(pos, dtype=torch.int32, device=device)
            q = (torch.randn(S, pos.shape[1], h, dh, generator=gen)
                 * 0.5).to(device, dt)
            want = _paged_dense(q, pk, pv, table, pos)
            for name, impl in impls:
                err = _rel_err(impl.call(q, pk, pv, table, pos), want)
                tol = oracle_tol(dt)
                check(err <= tol, f"paged {name} {dt} {case}: err "
                                  f"{err:.2e} <= {tol}")
                again = (impl.call(q, pk, pv, table, pos),
                         impl.call(q, pk, pv, table, pos))
                check(torch.equal(*again),
                      f"paged {name} {dt} {case}: the same bits twice")


def _gpt(pt, n_layer, max_len, policy=None):
    from ..models import transformer

    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 7
    with pt.program_guard(main, startup):
        outs = transformer.build(
            vocab_size=128, n_layer=n_layer, n_head=2, d_model=32,
            max_len=max_len, dropout_rate=0.0, dtype="float32",
            fused_head=True)
        if policy:
            pt.memory_optimize(main, policy=policy)
    return main, startup, outs


def _check_kill_switch(check, device):
    import torch

    import paddle_tpu_torch as pt

    from ..models import transformer
    from ..serving import batched_decode as bd

    main, startup, _ = _gpt(pt, 1, 16)
    scope = pt.Scope()
    pt.Executor(device).run(startup, scope=scope)
    params = transformer.params_from_numpy(
        transformer.extract_params(scope=scope, program=main), device)
    gen = torch.Generator().manual_seed(29)
    S, NB, B = 2, 4, 4
    pools = [(torch.randn(1 + S * NB, B, 2, 16, generator=gen) * 0.1).to(
        device) for _ in range(2)]
    table = (1 + torch.arange(S * NB, dtype=torch.int32)).reshape(
        S, NB).to(device)
    toks = {}
    for switch, op in (("0", "decode_gather"), ("1", "paged_attention")):
        with _env(PADDLE_TPU_PAGED_ATTN=switch):
            fn = bd.make_decode_chunk(1, 2, 32, 2, device=device)
        check(fn.attn.op == op, f"PADDLE_TPU_PAGED_ATTN={switch} builds "
                                f"the decode chunk on {fn.attn.op} "
                                f"({fn.attn.backend})")
        runs = []
        for _ in range(2):
            pk, pv = ([c.clone()] for c in pools)
            last = torch.tensor([3, 5], dtype=torch.int32, device=device)
            pos = torch.tensor([6, 9], dtype=torch.int32, device=device)
            runs.append(fn(params, pk, pv, last, pos, table))
        check(torch.equal(*runs), f"PADDLE_TPU_PAGED_ATTN={switch}: the "
                                  f"decode chunk is the same bits twice")
        toks[switch] = runs[0]
    check(torch.equal(toks["0"], toks["1"]),
          "kill switch: the gather and paged spellings sample the same "
          "tokens")


def _check_torch_ref_trainer(check, device):
    import paddle_tpu_torch as pt

    from .. import kernels

    rng = np.random.default_rng(3)
    toks = rng.integers(0, 128, (2, 64)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    with _env(**{_GLOBAL: "torch_ref"}):
        for policy in _POLICIES:
            main, startup, outs = _gpt(pt, 3, 64, policy)
            scope = pt.Scope()
            exe = pt.Executor(device)
            exe.run(startup, scope=scope)
            before = kernels.launch_counts()
            loss = exe.run(main, feed=feed, fetch_list=[outs["avg_cost"]],
                           scope=scope)[0]
            launched = {k: v - before[k]
                        for k, v in kernels.launch_counts().items()
                        if v != before[k]}
            kb = (exe.last_step_cost or {}).get("kernel_backends")
            check(np.isfinite(np.asarray(loss)).all() and not launched
                  and kb == {"flash_attention": "torch_ref",
                             "fused_ce": "torch_ref"},
                  f"torch_ref trainer policy={policy}: loss "
                  f"{float(np.asarray(loss).ravel()[0]):.4f}, kernel "
                  f"launches {launched or 0}, backends {kb}")


def _check_timed_run_lint(check, device):
    import paddle_tpu_torch as pt

    from . import timed_run

    toks = np.zeros((2, 16), np.int64)

    def lint_checks(backend, timed=True):
        main, startup, outs = _gpt(pt, 2, 16)
        scope = pt.Scope()
        exe = pt.Executor(device)
        with _env(**{_GLOBAL: backend}):
            with timed_run() if timed else contextlib.nullcontext():
                exe.run(startup, scope=scope)
                exe.run(main, feed={"tokens": toks, "labels": toks},
                        fetch_list=[outs["avg_cost"]], scope=scope)
        return (exe.last_step_cost or {}).get("lint_checks") or []

    check("jaxpr.kernel-backend" in lint_checks("torch_ref"),
          "timed-run lint fires on a torch_ref-routed step")
    auto = lint_checks(None)
    if device.type == "cuda":
        check("jaxpr.kernel-backend" not in auto,
              "timed-run lint is quiet on an auto-routed step (cuda)")
    else:
        check("jaxpr.kernel-backend" in auto,
              "timed-run lint fires on an auto-routed CPU step (torch_ref: "
              "the CPU is never a measurement)")
    check("jaxpr.kernel-backend" not in lint_checks("torch_ref", False),
          "outside a timed run the lint stays quiet")


def run_selftest(device=None):
    import traceback

    import paddle_tpu_torch as pt

    device = pt.resolve_device(device)
    failures = []

    def check(cond, what):
        (failures.append(what) if not cond else None)
        print(("ok   " if cond else "FAIL ") + what, flush=True)

    print(f"kernels selftest on {device}", flush=True)
    with _env(**{_GLOBAL: None, _FLASH_ENV: None}):
        for part in (check_registry, _check_flash, _check_ce_and_gather,
                     _check_paged, _check_kill_switch,
                     _check_torch_ref_trainer, _check_timed_run_lint):
            try:
                part(check, device)
            except Exception as e:  # noqa: BLE001 — report every part
                traceback.print_exc()
                check(False, f"{part.__name__}: {type(e).__name__}: {e}")
    print("kernels selftest " + ("FAILED" if failures else "PASSED"),
          flush=True)
    return 1 if failures else 0
