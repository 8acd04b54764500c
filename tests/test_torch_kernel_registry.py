"""The port's kernel registry (``paddle_tpu_torch/kernels/registry.py``)
on the CPU, against the JAX package's where they meet:

* resolution and its precedence (explicit argument > forced > per-op env
  > global env > auto), unknown names, unavailable backends with their
  reasons, the global-env fallback counted once, ``forced_backend``'s
  scope, and auto on a card never taking ``torch_ref``;
* the Executor's record of a lowered step (``kernel_backends`` from the
  registry, ``kernel_families`` the family record) and a strict
  ``backend`` attr;
* the tuner's backend dimension (candidates, the ``|kb=`` token, the
  cache fingerprint, a forced candidate measured and recorded, a tuned
  backend reaching the flash op);
* ``--kernels-selftest --device=cpu`` in a subprocess;
* parity: the ``torch_ref`` flash backend (forward, lse, packed,
  gradients) and paged backend (W = 1 and 5, ragged tables) against the
  JAX package's oracle, ``kernels/xla_ref.py`` and ``paged_attention_ref``,
  on the same numpy inputs, under its ``ORACLE_TOL``.

The Triton and CUDA kernels themselves run on the card:
``tests/test_torch_cuda_triton.py``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.kernels import xla_ref
from paddle_tpu_torch import kernels, tune
from paddle_tpu_torch.kernels import (KernelUnavailable, available_backends,
                                      forced_backend, get_kernel, registry,
                                      resolve_name)
from paddle_tpu_torch.observability import get_registry

GLOBAL, FLASH = "PADDLE_TPU_KERNEL_BACKEND", \
    "PADDLE_TPU_KERNEL_BACKEND_FLASH_ATTENTION"


def _triton_reason():
    """Why the Triton backend is out here (no card, or no package)."""
    return registry.triton_availability()[1]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith(GLOBAL):
            monkeypatch.delenv(k)


# -- resolution ----------------------------------------------------------------

def test_op_classes_and_availability_with_reasons():
    assert registry.registered_op_classes() == [
        "decode_gather", "flash_attention", "fused_ce", "paged_attention"]
    rows = {op: {b: (ok, r) for b, ok, r in available_backends(op)}
            for op in registry.registered_op_classes()}
    for op, row in rows.items():
        assert row["torch_ref"] == (True, "")
        assert row["cuda"] == (False, "no CUDA device")
        assert resolve_name(op, platform="cpu") == "torch_ref"
    # without a card the Triton backend is out whether or not the package
    # is installed; the probe says which
    for op in ("flash_attention", "paged_attention"):
        assert rows[op]["triton"] == (False, _triton_reason())
    assert _triton_reason() in ("no CUDA device", "triton is not importable: "
                                               "no module named 'triton'")
    assert "triton" not in rows["fused_ce"] and "triton" not in rows[
        "decode_gather"]


def test_precedence_explicit_arg_beats_env(monkeypatch):
    monkeypatch.setenv(GLOBAL, "torch_ref")
    monkeypatch.setenv(FLASH, "cuda")          # strict: would raise here
    assert resolve_name("flash_attention", "torch_ref") == "torch_ref"
    with pytest.raises(KernelUnavailable):
        resolve_name("flash_attention")


def test_precedence_per_op_env_beats_global(monkeypatch):
    monkeypatch.setenv(GLOBAL, "cuda")          # not strict: falls back
    monkeypatch.setenv(FLASH, "torch_ref")
    assert resolve_name("flash_attention") == "torch_ref"
    assert resolve_name("fused_ce") == "torch_ref"
    monkeypatch.setenv(FLASH, "triton")
    with pytest.raises(KernelUnavailable) as ei:
        resolve_name("flash_attention")
    assert ei.value.reason == _triton_reason()
    # the per-op pin does not leak to other op classes
    assert resolve_name("paged_attention") == "torch_ref"


def test_unknown_backend_raises(monkeypatch):
    with pytest.raises(ValueError, match="unknown kernel backend"):
        resolve_name("flash_attention", "xla_ref")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        with forced_backend("pallas_tpu"):
            pass
    monkeypatch.setenv(GLOBAL, "cuda_graphs")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        resolve_name("fused_ce")


def test_unavailable_backend_raises_with_reason():
    for b in ("cuda", "triton"):
        with pytest.raises(KernelUnavailable) as ei:
            resolve_name("flash_attention", b)
        assert ei.value.reason and ei.value.backend == b
    with pytest.raises(KernelUnavailable, match="not registered"):
        resolve_name("decode_gather", "triton")


def test_global_env_fallback_counted_once_per_resolution(monkeypatch):
    reg = get_registry()

    def count():
        return int(reg.value("kernels.env_fallbacks") or 0)

    monkeypatch.setenv(GLOBAL, "triton")
    c0 = count()
    assert resolve_name("decode_gather") == "torch_ref"
    assert count() == c0 + 1
    assert resolve_name("decode_gather") == "torch_ref"
    assert count() == c0 + 2
    # a pin the op serves resolves directly; a strict request raises:
    # neither counts
    monkeypatch.setenv(GLOBAL, "torch_ref")
    assert resolve_name("decode_gather") == "torch_ref"
    monkeypatch.delenv(GLOBAL)
    with pytest.raises(KernelUnavailable):
        resolve_name("decode_gather", "triton")
    assert count() == c0 + 2


def test_forced_backend_scopes_and_restores():
    with forced_backend("cuda"):                # unavailable: auto, counted
        assert resolve_name("fused_ce") == "torch_ref"
        assert resolve_name("fused_ce", "torch_ref") == "torch_ref"
    with forced_backend("torch_ref", op_class="fused_ce"):
        assert resolve_name("fused_ce") == "torch_ref"
        with forced_backend("triton", op_class="flash_attention"):
            assert resolve_name("flash_attention") == "torch_ref"
    assert registry._FORCED == []


def test_auto_on_a_card_never_takes_torch_ref(monkeypatch):
    """The card's order is cuda then triton: with neither available the
    resolution raises, naming both, rather than falling back to the plain
    version; the cuda probe is the card and nothing more."""
    assert registry.AUTO_ORDER == {"cuda": ("cuda", "triton"),
                                   "cpu": ("torch_ref",)}
    with pytest.raises(KernelUnavailable) as ei:
        resolve_name("flash_attention", platform="cuda")
    assert "cuda: no CUDA device" in ei.value.reason
    assert f"triton: {_triton_reason()}" in ei.value.reason
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for op in registry.registered_op_classes():
        assert resolve_name(op, platform="cuda") == "cuda"
    assert resolve_name("paged_attention") == "cuda"   # the default device
    monkeypatch.setenv(GLOBAL, "torch_ref")
    assert resolve_name("fused_ce", platform="cuda") == "torch_ref"


def test_a_probe_error_is_not_absence():
    """A probe that raises propagates: a kernel fault never becomes a
    silent change of backend."""
    k = registry._Kernel("x", "cuda", None, lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        k.availability()


def _gpt(vocab=61, t=16, backend=None, fused_head=True):
    from paddle_tpu_torch.models import transformer

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        outs = transformer.build(vocab_size=vocab, n_layer=1, n_head=2,
                                 d_model=32, max_len=t, dropout_rate=0.0,
                                 dtype="float32", fused_head=fused_head)
    if backend:
        for op in main.global_block().ops:
            if op.type.startswith("flash_attention") or \
                    op.type == "fused_softmax_ce_head":
                op.attrs["backend"] = backend
    return main, startup, outs


def _step(main, startup, outs, t=16):
    exe, scope = tpt.Executor(tpt.CPUPlace()), tpt.Scope()
    exe.run(startup, scope=scope)
    toks = np.arange(2 * t).reshape(2, t) % 61
    exe.run(main, feed={"tokens": toks, "labels": np.roll(toks, -1, 1)},
            fetch_list=[outs["avg_cost"]], scope=scope)
    return exe


def test_selected_backends_recorded_per_lowered_step():
    exe = _step(*_gpt())
    cost = exe.last_step_cost
    assert cost["kernel_backends"] == {"flash_attention": "torch_ref",
                                       "fused_ce": "torch_ref"}
    assert cost["kernel_families"] == {"flash_attention": "plain",
                                       "fused_ce": "plain"}
    assert registry.selected_backends()["flash_attention"] == "torch_ref"


def test_backend_attr_is_a_strict_request():
    exe = _step(*_gpt(backend="torch_ref"))
    assert exe.last_step_cost["kernel_backends"]["fused_ce"] == "torch_ref"
    with pytest.raises(RuntimeError, match="triton"):
        _step(*_gpt(backend="triton"))


# -- the tuner's backend dimension ---------------------------------------------

def test_attention_candidates_backend_dimension():
    plain = tune.attention_candidates(256, 64, 2)
    assert all("backend" not in c for c in plain)
    cands = tune.attention_candidates(256, 64, 2,
                                      backends=("cuda", "triton",
                                                "torch_ref"))
    by = {}
    for c in cands:
        by.setdefault(c["backend"], []).append(c)
    assert [dict(c, backend=None) for c in by["cuda"]] == [
        dict(c, backend=None) for c in plain]
    assert by["triton"] and all(
        c["block_q"] <= 128 and c["block_k"] <= 128 and c["packed"] is None
        for c in by["triton"])
    assert len({(c["block_q"], c["block_k"]) for c in by["triton"]}) == len(
        by["triton"])
    assert len(by["torch_ref"]) == 1
    surv, _ = tune.prune_static(256, 64, 2, cands)
    assert {c["backend"] for c in surv} == {"cuda", "triton", "torch_ref"}
    paged = tune.paged_attention_candidates(
        8, backends=("cuda", "triton", "torch_ref"))
    assert [c for c in paged if c["backend"] != "cuda"] == [
        {"splits": None, "backend": "triton"},
        {"splits": None, "backend": "torch_ref"}]
    assert [c["splits"] for c in paged if c["backend"] == "cuda"] == [
        c["splits"] for c in tune.paged_attention_candidates(8)]


def test_workload_key_backend_token():
    plain = tune.WorkloadKey("flash", 256, 64, 2, "bfloat16", "gpu",
                             remat="-")
    keyed = tune.WorkloadKey("flash", 256, 64, 2, "bfloat16", "gpu",
                             remat="-", backend="triton")
    assert "kb=" not in plain.s and keyed.s == plain.s + "|kb=triton"


def test_cache_fingerprint_covers_the_registry(monkeypatch):
    base = tune.geometry_fingerprint()
    monkeypatch.setitem(registry.AUTO_ORDER, "cuda", ("triton", "cuda"))
    assert tune.geometry_fingerprint() != base


def test_tuned_backend_reaches_the_flash_op():
    from paddle_tpu_torch import layers

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        with tune.forced_attention_config({"block_q": 128, "block_k": 128,
                                           "backend": "torch_ref"}):
            x = layers.data("x", shape=[2, 256, 64], dtype="float32")
            layers.multi_head_attention(x, x, x, d_model=64, n_head=1,
                                        causal=True)
    op, = [op for op in main.global_block().ops
           if op.type.startswith("flash_attention")]
    assert op.attrs["backend"] == "torch_ref" and op.attrs["block_q"] == 128


def test_tune_search_measures_a_forced_backend(tmp_path, monkeypatch):
    """A backend candidate is measured under ``forced_backend``; without
    a card a triton request measures auto's torch_ref, so its record
    names what ran (``|kb=torch_ref``) and the request beside it."""
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "t.json"))
    tune.reset_cache()
    try:
        rep = tune.tune_gpt_step(
            seq_len=32, n_layer=1, d_model=32, n_head=2, vocab=61,
            batch=4, dtype="float32", steps=1, warmup=0, repeats=1,
            block_caps=(32,), policies=("none",), accums=(1,),
            backends=("triton", "torch_ref"), max_measure=1,
            mode="search", force=True, device="cpu")
    finally:
        tune.reset_cache()
    measured = [m for m in rep["measured"] if m["verdict"] == "measured"]
    assert rep["source"] == "search" and len(measured) == 2
    tr = [m for m in measured if m.get("backend_requested") == "triton"]
    assert tr and tr[0]["backend"] == "torch_ref"
    assert all(m["workload"].endswith("|kb=torch_ref") for m in measured)
    assert rep["entry"]["config"]["backend"] == "torch_ref"


def test_truncate_survivors_keeps_every_backend():
    from paddle_tpu_torch.tune.search import _truncate_survivors

    survivors = ([{"block_q": 64, "backend": "cuda"}] * 5
                 + [{"block_q": 64, "backend": "torch_ref"}])
    report = {}
    keep = _truncate_survivors(list(survivors), 3, report)
    assert [c["backend"] for c in keep] == ["cuda"] * 3 + ["torch_ref"]
    assert report["truncated_to"] == 4


def test_kernels_selftest_flag_exits_zero_on_the_cpu():
    env = dict(os.environ)
    env.pop(GLOBAL, None)
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch",
                        "--kernels-selftest", "--device=cpu"],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = r.stdout
    assert "kernels selftest PASSED" in out and "FAIL" not in out
    assert "cuda=unavailable (no CUDA device)" in out
    assert f"triton=unavailable ({_triton_reason()})" in out
    for op in ("decode_gather", "flash_attention", "fused_ce",
               "paged_attention"):
        assert f"{op}: auto -> torch_ref" in out


# -- parity against the JAX package's oracle -----------------------------------

def _np_to(x, dt):
    return torch.from_numpy(x).to(dt)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tol(op, dt, kind):
    return xla_ref.oracle_tol(op, dt, kind)


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_torch_ref_flash_matches_xla_ref(dt, d, causal):
    rng = np.random.default_rng(d + causal)
    b, t, h = 1, 192, 2
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    impl = get_kernel("flash_attention", "torch_ref").impl
    o, lse = impl.call_with_lse(*(_np_to(x, dt) for x in (q, k, v)),
                                causal=causal)
    jq, jk, jv = (jnp.asarray(x, _JDT[dt]) for x in (q, k, v))
    jo, jlse = xla_ref.flash_attention_with_lse(jq, jk, jv, causal=causal)
    name = str(dt).replace("torch.", "")
    assert _rel(o.float(), np.asarray(jo, np.float32)) <= _tol(
        "flash_attention", name, "fwd")
    assert _rel(lse, np.asarray(jlse)) <= _tol("flash_attention", name,
                                               "fwd")
    packed = impl.call_packed(*(_np_to(x.reshape(b, t, h * d), dt)
                                for x in (q, k, v)), h, causal=causal)
    assert torch.equal(packed.reshape(b, t, h, d), o)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_torch_ref_flash_gradients_match_xla_ref(dt):
    rng = np.random.default_rng(5)
    b, t, h, d = 1, 128, 2, 64
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    w_o = rng.standard_normal((b, t, h, d)).astype(np.float32)
    w_l = rng.standard_normal((b, h, t)).astype(np.float32)
    impl = get_kernel("flash_attention", "torch_ref").impl
    ts = [_np_to(x, dt).requires_grad_() for x in (q, k, v)]
    o, lse = impl.call_with_lse(*ts, causal=True)
    ((o.float() * torch.from_numpy(w_o)).sum()
     + (lse * torch.from_numpy(w_l)).sum()).backward()

    def loss(q, k, v):
        o, lse = xla_ref.flash_attention_with_lse(q, k, v, causal=True)
        return jnp.sum(o.astype(jnp.float32) * w_o) + jnp.sum(lse * w_l)

    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x, _JDT[dt])
                                       for x in (q, k, v)))
    tol = _tol("flash_attention", str(dt).replace("torch.", ""), "grad")
    for name, got, w in zip("qkv", ts, want):
        assert _rel(got.grad.float(), np.asarray(w, np.float32)) <= tol, name


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("W", [1, 5])
def test_torch_ref_paged_matches_the_jax_oracle(dt, W):
    """Ragged tables: chains of different live lengths, a copy-on-write
    fork, unused entries naming the trash block 0 (which holds
    garbage)."""
    rng = np.random.default_rng(W)
    S, NB, B, h, dh = 3, 4, 8, 2, 64
    nblk = 1 + S * NB
    pk, pv = (rng.standard_normal((nblk, B, h, dh)).astype(np.float32)
              for _ in range(2))
    pk[0], pv[0] = 1e3, -1e3
    table = np.arange(1, nblk, dtype=np.int32).reshape(S, NB)
    table[2, 0] = table[0, 0]
    last = np.array([NB * B - 1, 11, 20])
    pos = (last[:, None] - W + 1 + np.arange(W)[None, :]).astype(np.int32)
    for s in range(S):
        table[s, last[s] // B + 1:] = 0
    q = rng.standard_normal((S, W, h, dh)).astype(np.float32)
    impl = get_kernel("paged_attention", "torch_ref").impl
    got = impl.call(_np_to(q, dt), _np_to(pk, dt), _np_to(pv, dt),
                    torch.from_numpy(table), torch.from_numpy(pos))
    want = jpa.paged_attention_ref(
        jnp.asarray(q, _JDT[dt]), jnp.asarray(pk, _JDT[dt]),
        jnp.asarray(pv, _JDT[dt]), jnp.asarray(table), jnp.asarray(pos))
    assert _rel(got.float(), np.asarray(want, np.float32)) <= _tol(
        "paged_attention", str(dt).replace("torch.", ""), "fwd")
