"""The port's autotuner (``paddle_tpu_torch/tune``) against the JAX
package's ``paddle_tpu.tune``, on the CPU, and its own contract.

Held against the reference (same inputs, tolerances stated per test):
``WorkloadKey.s``, ``estimate_gpt_step_hbm`` and the candidate spaces
exactly (the reference's ``diag_w`` dropped: a TPU-only knob);
``fit_cost_model`` and its predictions within 1e-9 relative on seeded
synthetic rows; ``memory_optimize(policy="auto")``'s segments on a hit
(each package's cache in its own tmp file, holding the same entry), on a
miss and for a tuned ``"none"``; ``multi_head_attention``'s op and
attributes under ``forced_attention_config``; a ``ServingEngine`` taking
a tuned decode geometry, token for token.

The port's own: the cache's round trip and its counted, never-raised
rejections; cached mode never searches; the kill switch is bit-exact;
the paged split count's plain spelling within tolerance at tuned counts
and the wrapper's bounds; a toy ``tune_gpt_step`` persists its winner and
a second call runs nothing.  Every test points ``PADDLE_TPU_TUNE_CACHE``
(and with it the cost model's file) at a tmp path.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu import tune as jtune
from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch import kernels, tune
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.tune import costmodel as tcm
from paddle_tpu_torch.tune import selftest as tst
from torch_ref_gauges import restore_reference_gauges  # noqa: F401


@pytest.fixture(autouse=True)
def cache_file(tmp_path, monkeypatch):
    """A fresh tmp cache for each test, both packages' singletons
    re-read, the tuner in its default mode and the cost model on."""
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(path))
    for k in ("PADDLE_TPU_TUNE", "PADDLE_TPU_COSTMODEL",
              "PADDLE_TPU_COSTMODEL_PATH"):
        monkeypatch.delenv(k, raising=False)
    for pkg in (tune, jtune):
        pkg.reset_cache()
        pkg.reset_model()
    yield path
    for pkg in (tune, jtune):
        pkg.reset_cache()
        pkg.reset_model()


def _use(monkeypatch, path):
    """Point both packages at ``path`` (re-read on the next lookup)."""
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(path))
    tune.reset_cache()
    jtune.reset_cache()


def _put(pkg, path, entries):
    """Write ``{key: config}`` through ``pkg``'s own cache class, so the
    file carries that package's fingerprint."""
    c = pkg.TuneCache(str(path))
    for k, cfg in entries.items():
        c.put(k, cfg)
    c.save()


# -- parity with the reference --------------------------------------------

@pytest.mark.parametrize("fields", [
    ("flash", 4096, 128, 6, "bfloat16", "gpu", "-", None),
    ("gpt_step", 16384, 64, 8, "float32", "cpu", "auto", None),
    ("paged_attention", 512, 128, 6, "bfloat16", "gpu", "-", "triton"),
    ("spec_decode", 96, 64, 8, "float32", "cpu", "-", None),
])
def test_workload_key_string_is_the_references(fields):
    op, t, dh, h, dt, plat, remat, kb = fields
    want = jtune.WorkloadKey(op, t, dh, h, np.dtype(dt) if dt == "float32"
                             else dt, plat, remat=remat, backend=kb).s
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dt]
    for dtype in (dt, tdt):
        assert tune.WorkloadKey(op, t, dh, h, dtype, plat, remat=remat,
                                backend=kb).s == want


def test_workload_key_call_field_extends_the_references_string():
    """The port's ``call`` field (``op=paged_attention``'s kernel call)
    appends to the reference's string for the same other fields."""
    base = jtune.WorkloadKey("paged_attention", 512, 128, 6, "bfloat16",
                             "gpu", remat="-").s
    key = tune.WorkloadKey("paged_attention", 512, 128, 6, torch.bfloat16,
                           "gpu", remat="-", call=(32, 1, 32))
    assert key.s == base + "|slots=32|w=1|bt=32"
    assert key != tune.WorkloadKey("paged_attention", 512, 128, 6,
                                   "bfloat16", "gpu", remat="-",
                                   call=(1, 1, 32))


def test_causal_flop_tiles_are_the_sm90_sources():
    """``causal_flash_flops`` counts the sm90 forward's tiles: its two
    constants are the sources' ``kRows`` and ``kFwdKT``."""
    import re

    from paddle_tpu_torch.kernels import flash_attention as tfa

    csrc = os.path.join(os.path.dirname(tfa.__file__), os.pardir, "csrc")

    def const(name, fname):
        with open(os.path.join(csrc, fname)) as f:
            m = re.search(rf"constexpr int {name} = (\d+);", f.read())
        return int(m.group(1))

    assert tfa.SM90_Q_ROWS == const("kRows", "sm90.cuh")
    assert tfa.SM90_K_TILE == const("kFwdKT", "flash_fwd_sm90.cu")


def test_estimate_gpt_step_hbm_is_the_references():
    """Exact integer equality over policies, accumulation, widths and
    element sizes (no model file: both scales are 1.0)."""
    n = 0
    for dims in ((12, 768, 6, 32768, 4096, 8), (3, 64, 2, 61, 128, 8),
                 (24, 1024, 16, 50000, 16384, 6)):
        for policy in tune.POLICY_ORDER:
            for accum in (1, 2, 3):
                for size in (2, 4):
                    got = tune.estimate_gpt_step_hbm(
                        *dims, policy=policy, accum=accum, dtype_size=size)
                    assert got == jtune.estimate_gpt_step_hbm(
                        *dims, policy=policy, accum=accum, dtype_size=size)
                    n += 1
    assert n == 90
    with pytest.raises(ValueError):
        tune.estimate_gpt_step_hbm(1, 8, 1, 8, 8, 1, policy="offloadish")


def _no_diag(cands):
    return [{k: v for k, v in c.items() if k != "diag_w"} for c in cands]


@pytest.mark.parametrize("args", [
    dict(seq_len=4096, d_head=128, n_head=6),
    dict(seq_len=96, d_head=64, n_head=8, block_caps=(32, 64)),
    dict(seq_len=16384, d_head=128, n_head=6, block_caps=(256, 512, 1024),
         accums=(1, 2), fsdp_opts=(False, True)),
])
def test_schedule_candidates_are_the_references(args):
    got = tune.schedule_candidates(**args)
    want = _no_diag(jtune.schedule_candidates(diag_ws=(256,), **args))
    assert got == want and got


def test_serving_and_spec_candidates_are_the_references():
    for max_len in (3, 8, 64):
        assert tune.serving_candidates(max_len) == \
            jtune.serving_candidates(max_len)
        assert tune.spec_candidates(max_len) == jtune.spec_candidates(max_len)


def test_backends_dimension_raises_naming_the_registry():
    """The backend dimension takes the port's registry names; the JAX
    package's ``xla_ref`` raises naming them (the dimension itself:
    ``tests/test_torch_kernel_registry.py``)."""
    with pytest.raises(ValueError, match="torch_ref"):
        tune.attention_candidates(64, 32, 2, backends=("xla_ref",))
    with pytest.raises(ValueError, match="torch_ref"):
        tune.paged_attention_candidates(8, backends=("xla_ref",))


def test_flagship_static_demo_is_the_references():
    """The t=16k static prune against the same explicit budget (the JAX
    package's 15.75 GiB; no device's) keeps and rejects the same
    schedules: only the estimate decides at this budget."""
    budget = int(15.75 * (1 << 30))
    got = tune.flagship_static_demo(budget_bytes=budget, device="cpu")
    assert got == jtune.flagship_static_demo(budget_bytes=budget)
    assert "hbm estimate" in got["gpt_t16k_rejected_r05_config"]
    with pytest.raises(ValueError, match="budget"):
        tune.flagship_static_demo(device="cpu")


def _synthetic_rows(seed, n=23):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        plat = ("cpu", "gpu")[i % 2]
        classes = {c: {"flops": float(rng.uniform(1e8, 1e11)),
                       "bytes": float(rng.uniform(1e6, 1e9)),
                       "ops": int(rng.integers(1, 40)),
                       "est_ms": float(rng.uniform(0.1, 20))}
                   for c in ("matmul", "pallas", "elementwise")[:1 + i % 3]}
        row = {"platform": plat, "workload": f"w{i % 5}", "run_id": f"r{i}",
               "step": i, "source": "trainer",
               "measured_ms": float(rng.uniform(1, 80)),
               "flops": float(rng.uniform(1e9, 1e12)),
               "bytes": float(rng.uniform(1e7, 1e10)),
               "est_ms": float(rng.uniform(0.5, 60))}
        if i % 4:
            row["classes"] = classes
        if i % 3 == 0:
            row["hbm_est_bytes"] = float(rng.uniform(1e9, 2e9))
            row["hbm_high_water_bytes"] = float(
                row["hbm_est_bytes"] * rng.uniform(0.8, 1.6))
        rows.append(row)
    rows.append({"platform": "cpu", "measured_ms": -1.0})   # skipped
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_cost_model_and_predictions_match_the_reference(seed):
    """The same rows fit to the same coefficients and predictions, within
    1e-9 relative (both are the same numpy IRLS; only summation order
    could differ)."""
    rows = _synthetic_rows(seed)
    got = tune.fit_cost_model(rows)
    want = jtune.fit_cost_model(rows)
    assert sorted(got) == sorted(want) == ["cpu", "gpu"]

    def close(a, b):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12)

    from paddle_tpu.tune import costmodel as jcm

    for plat in got:
        g, w = got[plat], want[plat]
        assert sorted(g) == sorted(w)
        for a, b in zip(g["total"], w["total"]):
            close(a, b)
        assert sorted(g["classes"]) == sorted(w["classes"])
        for c in g["classes"]:
            for a, b in zip(g["classes"][c], w["classes"][c]):
                close(a, b)
        for k in ("hbm_scale", "holdout_err_pct", "analytic_err_pct"):
            close(g[k], w[k])
        for r in rows[:-1]:
            close(tcm.predict_row_ms(g, r), jcm.predict_row_ms(w, r))
        close(tcm.predict_sched_ms(g, 3.7e10), jcm.predict_sched_ms(w, 3.7e10))
        close(tcm.predict_class_ms(g, "matmul", 2e9, 3e8, 7)[0],
              jcm.predict_class_ms(w, "matmul", 2e9, 3e8, 7)[0])


def test_cost_model_file_scales_the_estimate_and_the_kill_switch(
        cache_file, monkeypatch):
    """A fitted model next to the cache scales ``estimate_gpt_step_hbm``
    (clamped to [1, 2]); ``PADDLE_TPU_COSTMODEL=0`` and a corrupt file
    give the analytic figure, the corrupt one counted."""
    base = tune.estimate_gpt_step_hbm(3, 64, 2, 61, 128, 8)
    m = tune.fit_and_save(_synthetic_rows(0))
    scale = tcm.hbm_scale_for("cpu")
    assert os.path.dirname(m.path) == os.path.dirname(str(cache_file))
    assert 1.0 < scale <= 2.0
    assert tune.estimate_gpt_step_hbm(3, 64, 2, 61, 128, 8) == int(
        base * scale)
    assert tune.model_status()["mode"] == "fitted"
    monkeypatch.setenv("PADDLE_TPU_COSTMODEL", "0")
    assert tune.estimate_gpt_step_hbm(3, 64, 2, 61, 128, 8) == base
    monkeypatch.delenv("PADDLE_TPU_COSTMODEL")
    with open(m.path, "w") as f:
        f.write("{truncated")
    tune.reset_model()
    e0 = get_registry().value("tune.costmodel_errors")
    assert tune.estimate_gpt_step_hbm(3, 64, 2, 61, 128, 8) == base
    assert get_registry().value("tune.costmodel_errors") == e0 + 1


_T, _CFG = 16, dict(vocab_size=61, n_layer=2, n_head=2, d_model=32,
                    max_len=16, dropout_rate=0.0, dtype="float32",
                    fused_head=True, learning_rate=2e-3)
_STEP_KEY = "op=gpt_step|t=16|dh=16|h=2|dt=float32|plat=cpu|remat=auto"


def _program(pkg, model, **over):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        model.build(**dict(_CFG, **over))
    return main


@pytest.mark.parametrize("tuned", ["compact", "full", "none", None])
def test_auto_policy_gives_the_references_segments(tuned, tmp_path,
                                                   monkeypatch):
    """Each package's cache (its own tmp file) holds the same ``gpt_step``
    entry (``None``: no entry, a miss); ``auto`` resolves alike, to the
    same segments and label as the policy spelled out."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    if tuned is not None:
        cfg = {"policy": tuned, "accum": 1, "block_q": 16, "block_k": 16}
        _put(jtune, jpath, {_STEP_KEY: cfg})
        _put(tune, tpath, {_STEP_KEY: cfg})
    _use(monkeypatch, jpath)
    jmain = _program(pt, jtr)
    want = pt.memory_optimize(jmain, policy="auto")
    _use(monkeypatch, tpath)
    tmain = _program(tpt, ttr)
    h0 = get_registry().value("tune.cache_hits")
    got = tpt.memory_optimize(tmain, policy="auto")
    assert got == want and tmain._remat_segments == jmain._remat_segments
    assert tmain._remat_policy == jmain._remat_policy == (tuned
                                                          or "selective")
    assert get_registry().value("tune.cache_hits") == h0 + (tuned is not None)
    if tuned == "none":
        assert got == [] and not tmain._offload
    else:
        spelled = _program(tpt, ttr)
        assert got == tpt.memory_optimize(spelled, policy=tuned
                                          or "selective")


def test_auto_policy_kill_switch_ignores_a_populated_cache(cache_file,
                                                           monkeypatch):
    _put(tune, cache_file, {_STEP_KEY: {"policy": "full", "accum": 1,
                                        "block_q": 16, "block_k": 16}})
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    main = _program(tpt, ttr)
    h0 = get_registry().value("tune.cache_hits")
    tpt.memory_optimize(main, policy="auto")
    assert main._remat_policy == "selective"
    assert get_registry().value("tune.cache_hits") == h0


def _flash_op(main):
    return next(op for op in main.global_block().ops
                if op.type.startswith("flash_attention"))


@pytest.mark.parametrize("forced", [
    {"block_q": 8, "block_k": 16, "packed": False},
    {"block_q": 16, "block_k": 4, "packed": True},
    {"block_q": 4, "block_k": 8},
])
def test_forced_attention_config_emits_the_references_op(forced):
    """The same forced geometry through both packages'
    ``multi_head_attention`` (via ``transformer.build``): the same flash op
    type and the same attributes."""
    with jtune.forced_attention_config(forced):
        jop = _flash_op(_program(pt, jtr))
    with tune.forced_attention_config(forced):
        top = _flash_op(_program(tpt, ttr))
    assert top.type == jop.type
    assert top.attrs == jop.attrs
    assert (top.attrs["block_q"], top.attrs["block_k"]) == (
        forced["block_q"], forced["block_k"])
    with tune.forced_attention_config(forced):
        explicit = _program(tpt, ttr, attn_block_q=2, attn_block_k=2)
    assert _flash_op(explicit).attrs["block_k"] == 2   # explicit wins


def test_tuned_flash_entry_reaches_the_op_and_the_route(cache_file):
    """The companion ``op=flash`` entry a search writes sets the op's
    blocks when the build gives none; its ``block_k`` is what the
    backward route reads."""
    _put(tune, cache_file, {
        "op=flash|t=16|dh=16|h=2|dt=float32|plat=cpu|remat=-":
            {"block_q": 8, "block_k": 4, "packed": False}})
    op = _flash_op(_program(tpt, ttr))
    assert op.type == "flash_attention"
    assert (op.attrs["block_q"], op.attrs["block_k"]) == (8, 4)


VOCAB, NL, NH, DM, TS = 50, 2, 2, 32, 32
_SERVE_KEY = "op=serving_decode|t=32|dh=16|h=2|dt=float32|plat=cpu|remat=-"


@pytest.fixture(scope="module")
def params():
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        jtr.build(vocab_size=VOCAB, n_layer=NL, n_head=NH, d_model=DM,
                  max_len=TS, dropout_rate=0.0, dtype="float32")
    scope = pt.core.scope.Scope()
    pt.Executor().run(startup, scope=scope)
    return jtr.extract_params(scope=scope, program=main)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, VOCAB, (n,)).astype(np.int32)
            for n in (3, 9, 5, 12)]


def test_tuned_serving_engine_emits_the_references_tokens(params, tmp_path,
                                                          monkeypatch):
    """Both caches hold ``{"chunk": 3, "min_bucket": 2}``; engines given no
    geometry take it and serve the same tokens."""
    cfg = {"chunk": 3, "min_bucket": 2}
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    _put(jtune, jpath, {_SERVE_KEY: cfg})
    _put(tune, tpath, {_SERVE_KEY: cfg})
    _use(monkeypatch, jpath)
    jeng = JaxServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                            block_tokens=4)
    jouts = jeng.generate_many(_prompts(), max_new_tokens=8)
    _use(monkeypatch, tpath)
    eng = ServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                        block_tokens=4, device="cpu")
    outs = eng.generate_many(_prompts(), max_new_tokens=8)
    assert (eng.decode_chunk, eng.min_bucket) == (
        jeng.decode_chunk, jeng.min_bucket) == (3, 2)
    for o, jo in zip(outs, jouts):
        np.testing.assert_array_equal(o, np.asarray(jo))
    explicit = ServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                             block_tokens=4, decode_chunk=5, device="cpu")
    assert (explicit.decode_chunk, explicit.min_bucket) == (5, 2)


# the decode chunk's call of an engine at max_slots=3, block_tokens=4
_PAGED_KEY = ("op=paged_attention|t=32|dh=16|h=2|dt=float32|plat=cpu|"
              "remat=-|slots=3|w=1|bt=4")


def test_tuned_split_count_serves_the_untuned_tokens(params, cache_file,
                                                     monkeypatch):
    """An ``op=paged_attention`` entry sets the engine's split count, read
    once; decode through ``paged_attention_split_ref`` at that count gives
    the untuned engine's tokens; ``PADDLE_TPU_TUNE=0`` ignores it."""
    _put(tune, cache_file, {_PAGED_KEY: {"splits": 3}})
    h0 = get_registry().value("tune.cache_hits")
    eng = ServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                        block_tokens=4, device="cpu")
    assert eng.attn_splits == 3
    assert get_registry().value("tune.cache_hits") == h0 + 1
    tuned = eng.generate_many(_prompts(), max_new_tokens=8)
    assert get_registry().value("tune.cache_hits") == h0 + 1  # not per step
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    plain = ServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                          block_tokens=4, device="cpu")
    assert plain.attn_splits is None
    for a, b in zip(tuned, plain.generate_many(_prompts(), max_new_tokens=8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {"spec_k": 8}, {"spec_k": 3}, {}], ids=["spec_k8", "spec_k3", "plain"])
def test_tuned_split_count_reaches_only_the_call_it_was_measured_at(
        params, cache_file, monkeypatch, kw):
    """With an entry for the decode chunk's call present, only calls of
    that shape (``max_slots`` rows, one query token: the decode and draft
    chunks) take the tuned count, and each of them is one the split kernel
    takes on the card (``paged_family``); prefill (one row) and the verify
    window (``k + 1`` tokens, past the split family's 8 at k=8) keep the
    rule.  The speculative engine at k=8 serves the plain engine's
    tokens."""
    from paddle_tpu_torch.serving import speculative as tspec

    _put(tune, cache_file, {_PAGED_KEY: {"splits": 3}})
    calls = []
    # the CPU's paged_attention backend, which the kernel registry
    # resolves once a step callable
    impl = kernels.get_kernel("paged_attention", "torch_ref").impl
    real = impl.call

    def spy(q, pool_k, pool_v, table, pos, splits=None):
        calls.append((tuple(q.shape), pool_k.shape[1], splits))
        return real(q, pool_k, pool_v, table, pos, splits=splits)

    monkeypatch.setattr(impl, "call", staticmethod(spy))
    if kw:
        kw = dict(kw, draft_params=tspec.depth_draft(params, 1))
    eng = ServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                        block_tokens=4, device="cpu", **kw)
    assert eng.attn_splits == 3
    outs = eng.generate_many(_prompts(), max_new_tokens=8)
    if kw:
        assert eng._spec.proposed > 0
    shapes = {(q[0], q[1]) for q, _, _ in calls}
    want = {(3, 1), (1, 1)} | ({(3, kw["spec_k"] + 1)} if kw else set())
    assert shapes == want
    for (S, W, h, dh), B, splits in calls:
        assert (splits == 3) == ((S, W) == (3, 1))
        if splits is not None:
            assert tpa.paged_family(torch.float32, S, W, h, dh, B,
                                    ()) == "split"
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    plain = ServingEngine(params, NL, NH, DM, max_len=TS, max_slots=3,
                          block_tokens=4, device="cpu")
    for a, b in zip(outs, plain.generate_many(_prompts(), max_new_tokens=8)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("geom", [
    {"max_slots": 2, "block_tokens": 4}, {"max_slots": 3, "block_tokens": 8},
    {"max_slots": 3, "block_tokens": 16}], ids=["slots", "block8", "block16"])
def test_split_entry_misses_an_engine_of_another_call(params, cache_file,
                                                      geom):
    """The entry holds for its own ``(slots, window, block_tokens)``: an
    engine with other slots or another block size at the same ``max_len``
    (the same ``T``) misses and keeps the rule."""
    _put(tune, cache_file, {_PAGED_KEY: {"splits": 3}})
    m0 = get_registry().value("tune.cache_misses")
    eng = ServingEngine(params, NL, NH, DM, max_len=TS, device="cpu", **geom)
    assert eng.blocks_per_slot * eng.block_tokens == TS
    assert eng.attn_splits is None
    assert get_registry().value("tune.cache_misses") > m0


# -- the port's own contract ------------------------------------------------

def test_cache_round_trip(cache_file):
    c = tune.get_cache()
    assert c.entries == {} and c.stale_reason is None
    c.put("k1", {"splits": 4}, measured={"median_s": 1.5})
    c.save()
    tune.reset_cache()
    got = tune.get_cache()
    assert got.get("k1")["config"] == {"splits": 4}
    assert got.get("k1")["measured"] == {"median_s": 1.5}
    raw = json.loads(cache_file.read_text())
    assert raw["schema_version"] == tune.CACHE_SCHEMA_VERSION
    assert raw["fingerprint"] == tune.geometry_fingerprint()
    assert not [p for p in os.listdir(cache_file.parent)
                if p.startswith(".tuned.")]   # the temp file was renamed


def test_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TUNE_CACHE")
    path = tune.cache_path()
    assert path.endswith(os.path.join(".cache", "paddle_tpu_torch",
                                      "tuned.json"))
    assert path != jtune.cache_path()


@pytest.mark.parametrize("bad", ["corrupt", "truncated", "not_object",
                                 "schema", "fingerprint", "jax_file"])
def test_rejected_cache_files_count_and_never_raise(bad, cache_file):
    good = {"schema_version": tune.CACHE_SCHEMA_VERSION,
            "fingerprint": tune.geometry_fingerprint(),
            "entries": {_STEP_KEY: {"config": {"policy": "full"}}}}
    if bad == "jax_file":
        # a cache the JAX package wrote: its fingerprint is its TPU
        # geometry's, never the port's
        _put(jtune, cache_file, {_STEP_KEY: {"policy": "full"}})
    else:
        text = {"corrupt": "not json at all",
                "truncated": json.dumps(good)[:40],
                "not_object": "[1, 2, 3]",
                "schema": json.dumps(dict(good, schema_version=999)),
                "fingerprint": json.dumps(dict(good,
                                               fingerprint="000000000000")),
                }[bad]
        cache_file.write_text(text)
    e0 = get_registry().value("tune.cache_errors")
    c = tune.get_cache()
    assert c.entries == {} and c.stale_reason
    assert get_registry().value("tune.cache_errors") == e0 + 1
    assert tune.schedule_config_for(16, 16, 2, "float32") is None
    main = _program(tpt, ttr)
    tpt.memory_optimize(main, policy="auto")
    assert main._remat_policy == "selective"


def test_fingerprint_names_the_device_and_the_kernel_build(monkeypatch):
    from paddle_tpu_torch.kernels import _build

    fp = tune.geometry_fingerprint()
    assert fp == tune.geometry_fingerprint()
    from paddle_tpu_torch.tune import cache as tcache

    monkeypatch.setattr(tcache, "_device_name", lambda: "another card")
    assert tune.geometry_fingerprint() != fp
    monkeypatch.undo()
    monkeypatch.setattr(_build, "_digest", lambda name: "other build")
    assert tune.geometry_fingerprint() != fp


def test_cached_mode_miss_never_searches(cache_file):
    reg = get_registry()
    s0, c0 = reg.value("tune.searches"), reg.value("executor.compile_count")
    rep = tune.tune_gpt_step(16, 2, 32, 2, 61, 4, dtype="float32",
                             device="cpu")
    assert rep["source"] == "miss" and rep["entry"] is None
    assert reg.value("tune.searches") == s0
    assert reg.value("executor.compile_count") == c0
    for fn in (tune.tune_paged_attention,):
        assert fn(2, 16, 32, 4, device="cpu")["source"] == "miss"
    assert not cache_file.exists()


def test_toy_search_persists_its_winner_and_a_second_call_runs_nothing(
        cache_file, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNE", "search")
    reg = get_registry()
    args = dict(seq_len=16, n_layer=2, d_model=32, n_head=2, vocab=61,
                batch=4, dtype="float32", device="cpu")
    rep = tune.tune_gpt_step(**args, steps=1, warmup=1, repeats=1,
                             block_caps=(8, 16), block_q_caps=(16,),
                             policies=("selective", "full"), max_measure=3)
    assert rep["source"] == "search"
    measured = [m for m in rep["measured"] if m["verdict"] == "measured"]
    assert len(measured) == 3 and rep["truncated_to"] == 3
    assert all(m["route"] == "fused" and m["hbm_high_water_bytes"]
               == m["hbm_est_bytes"] for m in measured)   # CPU: the estimate
    win = rep["entry"]["config"]
    disk = json.loads(cache_file.read_text())["entries"]
    assert disk[_STEP_KEY]["config"] == win
    assert disk["op=flash|t=16|dh=16|h=2|dt=float32|plat=cpu|remat=-"][
        "config"] == {k: win[k] for k in ("block_q", "block_k")}
    monkeypatch.setenv("PADDLE_TPU_TUNE", "cached")
    tune.reset_cache()
    c0 = reg.value("executor.compile_count")
    m0 = reg.value("tune.candidates_measured")
    rep2 = tune.tune_gpt_step(**args)
    assert rep2["source"] == "cache" and rep2["entry"]["config"] == win
    assert reg.value("executor.compile_count") == c0
    assert reg.value("tune.candidates_measured") == m0


def test_kill_switch_is_bit_exact(cache_file, monkeypatch):
    """``PADDLE_TPU_TUNE=0`` with a populated cache: the toy's three loss
    bits are the untuned run's (an empty cache), and nothing is looked
    up; the cached run applies the entry."""
    key = "op=flash|t=128|dh=32|h=2|dt=float32|plat=cpu|remat=-"
    _put(tune, cache_file, {
        key: {"block_q": 64, "block_k": 32, "packed": False},
        "op=gpt_step|t=128|dh=32|h=2|dt=float32|plat=cpu|remat=auto":
            {"policy": "full", "accum": 1, "block_q": 64, "block_k": 32}})
    monkeypatch.setenv("PADDLE_TPU_TUNE", "0")
    reg = get_registry()
    looked = reg.value("tune.cache_hits") + reg.value("tune.cache_misses")
    bits_off, exe_off = tst.train_bits("cpu", steps=2)
    assert exe_off.last_step_cost.get("tune", {}).get("mode") in (None,
                                                                   "off")
    assert reg.value("tune.cache_hits") + reg.value(
        "tune.cache_misses") == looked
    monkeypatch.setenv("PADDLE_TPU_TUNE", "cached")
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE",
                       str(cache_file.parent / "empty" / "tuned.json"))
    tune.reset_cache()
    bits_default, _ = tst.train_bits("cpu", steps=2)
    assert bits_off == bits_default
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(cache_file))
    tune.reset_cache()
    main = tst._build_toy()[0]
    assert tst.flash_attrs(main) == (64, 32)
    assert main._remat_policy == "full"


@pytest.mark.parametrize("nb,splits", [(7, 1), (7, 2), (7, 3), (7, 4),
                                       (7, 7), (16, 5), (16, 16)])
def test_split_plain_version_at_tuned_counts(nb, splits):
    """``paged_attention_split_ref`` at any count from 1 to NB (a last run
    shorter than the rest included) within ORACLE_TOL f32 of the block
    scan, ragged positions and a trash-filled tail; the wrapper takes it
    on CPU tensors at that count."""
    g = torch.Generator().manual_seed(nb * 31 + splits)
    S, W, h, dh, B = 3, 2, 2, 16, 4
    nblk = 1 + S * nb
    q = torch.randn(S, W, h, dh, generator=g)
    pk = torch.randn(nblk, B, h, dh, generator=g)
    pv = torch.randn(nblk, B, h, dh, generator=g)
    table = (1 + torch.arange(S * nb, dtype=torch.int32)).reshape(S, nb)
    pos = torch.tensor([[0, 1], [nb * B // 2, nb * B // 2 + 1],
                        [nb * B - 2, nb * B - 1]], dtype=torch.int32)
    want = tpa.paged_attention_ref(q, pk, pv, table, pos)
    got = tpa.paged_attention(q, pk, pv, table, pos, splits=splits)
    assert torch.equal(got, tpa.paged_attention_split_ref(
        q, pk, pv, table, pos, splits))
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= tpa.oracle_tol(torch.float32)
    runs, entries = tpa.split_entries(nb, splits)
    assert runs <= splits and (runs - 1) * entries < nb <= runs * entries


def test_paged_wrapper_bounds_on_the_split_count():
    S, h, dh, B, nb = 2, 2, 16, 4, 5
    q = torch.zeros(S, 1, h, dh)
    pool = torch.zeros(1 + S * nb, B, h, dh)
    table = torch.ones(S, nb, dtype=torch.int32)
    pos = torch.zeros(S, 1, dtype=torch.int32)
    for bad in (0, -1, nb + 1):
        with pytest.raises(ValueError, match="splits"):
            tpa.paged_attention(q, pool, pool, table, pos, splits=bad)
    cands = tune.paged_attention_candidates(nb, slots=S, n_head=h)
    assert [c["splits"] for c in cands] == sorted(
        {tpa.split_entries(nb, n)[0] for n in (1, 2, 4, tpa.paged_splits(
            S, h, nb)[0])})


def test_paged_search_holds_each_count_and_persists(cache_file,
                                                    monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNE", "search")
    rep = tune.tune_paged_attention(2, 16, 32, 4, dtype="float32", slots=3,
                                    repeats=1, device="cpu")
    assert rep["source"] == "search"
    counts = [m["splits"] for m in rep["measured"]]
    assert counts == [1, 2, 4, 8]
    assert all(m["rel_err"] <= tpa.oracle_tol(torch.float32)
               for m in rep["measured"])
    disk = json.loads(cache_file.read_text())["entries"]
    key = ("op=paged_attention|t=32|dh=16|h=2|dt=float32|plat=cpu|"
           "remat=-|slots=3|w=1|bt=4")
    assert disk[key]["config"]["splits"] in counts


def test_step_cost_carries_tune_stats(cache_file):
    """``last_step_cost["tune"]`` mirrors ``tune_stats()`` once a lookup
    counted; ``causal_flash_flops`` counts the sm90 kernels' skipped
    tiles."""
    _put(tune, cache_file, {"op=flash|t=999|dh=1|h=1|dt=float32|plat=cpu|"
                                  "remat=-": {"block_q": 1, "block_k": 1}})
    _, exe = tst.train_bits("cpu", policy=None, steps=1)
    assert exe.last_step_cost["tune"] == tune.tune_stats()
    assert exe.last_step_cost["tune"]["cache_misses"] >= 1
    from paddle_tpu_torch.kernels.flash_attention import causal_flash_flops

    sched, useful = causal_flash_flops(256, 256, 64)
    # two 128-row blocks: their warpgroups run 1, 1, 2, 2 key tiles
    assert sched == 4 * 64 * 64 * 128 * 6
    assert useful == 4 * 64 * (256 * 257 // 2)
