"""The port's ``PADDLE_TPU_PAGED_ATTN=0`` serving spelling (decode gather
plus a dense softmax, ``serving/batched_decode.py``) against the paged
spelling and the JAX package's ``=0`` engine, on the CPU in f32: the
same tokens, plain and speculative, prefix reuse on and off, copy-on-
write forks included (mirrors tests/test_kvcache.py's kill-switch
test).  The spelling is asserted three ways: ``kernel_backends``,
``serving.paged_attn_compiles``, and spies on the two attention
routes.  Also: the engine's Chrome-trace export and its flight-recorder
dump on abort."""

import json

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.observability import metrics as jobs
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.observability import flight
from paddle_tpu_torch.observability import metrics as tobs
from paddle_tpu_torch.observability import trace
from paddle_tpu_torch.serving import ServingEngine, batched_decode
from paddle_tpu_torch.serving import speculative as spec


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """The reference reads tuned attention and serving geometry from its
    tune cache (``PADDLE_TPU_TUNE_CACHE``, else ``~/.cache/paddle_tpu``);
    the port reads none.  A cache path in a fresh directory holds no
    entry, so both packages build with their defaults whatever cache the
    host has."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


VOCAB, NL, NH, DM, T = 50, 2, 2, 32, 32
GEOM = dict(max_len=T, max_slots=3, decode_chunk=4, min_bucket=4,
            block_tokens=4)
MAX_NEW = 7


@pytest.fixture(scope="module")
def params():
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 21
    with pt.program_guard(main, startup):
        jtr.build(vocab_size=VOCAB, n_layer=NL, n_head=NH, d_model=DM,
                  max_len=T, dropout_rate=0.0, dtype="float32")
    pt.Executor().run(startup)
    return jtr.extract_params(program=main)


def _prompts():
    rng = np.random.default_rng(21)
    base = rng.integers(1, VOCAB, (11,)).astype(np.int32)
    return [
        base.copy(),
        np.concatenate([base[:6],                      # CoW fork at 6
                        rng.integers(1, VOCAB, (4,)).astype(np.int32)]),
        rng.integers(1, VOCAB, (8,)).astype(np.int32),
    ]


@pytest.fixture(autouse=True)
def fresh_serving_metrics():
    jobs.get_registry().clear(prefix="serving.")
    tobs.get_registry().clear(prefix="serving.")
    yield


@pytest.fixture
def spies(monkeypatch):
    """Counts of calls into each attention route of the port."""
    calls = {"paged_attention": 0, "gather": 0}
    paged, gather = batched_decode.paged_attention, batched_decode._gather_kv

    def spy_paged(*a):
        calls["paged_attention"] += 1
        return paged(*a)

    def spy_gather(*a):
        calls["gather"] += 1
        return gather(*a)

    monkeypatch.setattr(batched_decode, "paged_attention", spy_paged)
    monkeypatch.setattr(batched_decode, "_gather_kv", spy_gather)
    return calls


def _serve(monkeypatch, switch, engine_cls, params, **kw):
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", switch)
    jobs.get_registry().clear(prefix="serving.")
    tobs.get_registry().clear(prefix="serving.")
    eng = engine_cls(params, NL, NH, DM, **GEOM, **kw)
    # two waves: the second hits (and forks) what the first cached
    prompts = _prompts()
    outs = eng.generate_many(prompts[:1], max_new_tokens=MAX_NEW)
    outs += eng.generate_many(prompts[1:], max_new_tokens=MAX_NEW)
    return outs, eng


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("reuse", [True, False])
def test_gather_spelling_equals_paged_and_jax(params, monkeypatch, spies,
                                              reuse, draft):
    kw = dict(prefix_reuse=reuse)
    jkw = dict(kw)
    if draft:
        kw.update(draft_params=spec.depth_draft(params, 1), spec_k=3)
        jkw.update(draft_params=jspec.depth_draft(params, 1), spec_k=3)
    paged_outs, paged_eng = _serve(monkeypatch, "1", ServingEngine, params,
                                   device="cpu", **kw)
    assert spies == {"paged_attention": spies["paged_attention"],
                     "gather": 0} and spies["paged_attention"] > 0
    assert paged_eng.stats()["serving.paged_attn_compiles"] == len(
        paged_eng.kernel_backends) >= 1
    assert all(sel == {"paged_attention": "torch_ref"}
               for sel in paged_eng.kernel_backends.values())

    spies["paged_attention"] = 0
    gather_outs, gather_eng = _serve(monkeypatch, "0", ServingEngine,
                                     params, device="cpu", **kw)
    assert spies["paged_attention"] == 0 and spies["gather"] > 0
    gather_st = gather_eng.stats()
    assert "serving.paged_attn_compiles" not in gather_st
    assert gather_eng.kernel_backends and all(
        sel == {"decode_gather": "torch_ref"}
        for sel in gather_eng.kernel_backends.values())
    # an engine keeps the spelling it was built with
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "1")
    gather_eng.generate_many(_prompts()[2:], max_new_tokens=2)
    assert spies["paged_attention"] == 0

    jax_outs, jeng = _serve(monkeypatch, "0", JaxServingEngine, params,
                            **jkw)
    assert sorted(jeng.kernel_backends) == sorted(gather_eng.kernel_backends)
    assert all("decode_gather" in sel
               for sel in jeng.kernel_backends.values())
    for a, b, c in zip(paged_outs, gather_outs, jax_outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    if reuse:
        assert gather_st["serving.cow_copies"] >= 1
    if draft:
        assert gather_eng._spec.proposed > 0
        assert (gather_eng._spec.proposed, gather_eng._spec.accepted) == (
            jeng._spec.proposed, jeng._spec.accepted)


def test_step_logits_spellings_agree(params):
    """One step through both spellings on the same pools: the logits agree
    to f32 rounding and the pools are written identically."""
    import torch

    from paddle_tpu_torch.models.transformer import params_from_numpy

    rng = np.random.default_rng(4)
    p = params_from_numpy(params, "cpu")
    pools = [torch.tensor(rng.standard_normal((9, 4, NH, DM // NH)),
                          dtype=torch.float32) for _ in range(2 * NL)]
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0]], dtype=torch.int32)
    tok = torch.tensor([3, 7], dtype=torch.int32)
    t = torch.tensor([9, 5], dtype=torch.int32)
    out = {}
    for paged in (True, False):
        pk = [c.clone() for c in pools[:NL]]
        pv = [c.clone() for c in pools[NL:]]
        logits = batched_decode.paged_step_logits(
            p, tok, t, pk, pv, table, NL, NH, DM, paged=paged)
        out[paged] = (logits, pk + pv)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_trace_export_holds_the_engine_spans_and_request_lanes(
        params, tmp_path):
    prev = trace.set_tracer(trace.Tracer(enabled=True, registry=None))
    try:
        plain = ServingEngine(params, NL, NH, DM, device="cpu", **GEOM)
        plain.generate_many(_prompts(), max_new_tokens=MAX_NEW)
        eng = ServingEngine(params, NL, NH, DM, device="cpu",
                            draft_params=spec.depth_draft(params, 1),
                            spec_k=3, **GEOM)
        eng.generate_many(_prompts(), max_new_tokens=MAX_NEW)
        path = tmp_path / "serving_trace.json"
        n = trace.save(str(path))
    finally:
        trace.set_tracer(prev)
    obj = json.loads(path.read_text())
    events = obj["traceEvents"]
    assert n == sum(1 for e in events if e["ph"] != "M") > 0
    names = {e["name"] for e in events}
    for nm in ("serving.prefill", "serving.decode_chunk",
               "serving.spec_round", "serving.request", "serving.req.queue",
               "serving.req.prefill", "serving.req.decode_chunk",
               "serving.req.evict"):
        assert nm in names, nm
    lanes = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "serving req 0" in lanes
    reqs = [e for e in events if e["name"] == "serving.request"]
    assert len(reqs) == 2 * len(_prompts())
    assert any(e["args"].get("spec_proposed", 0) > 0 for e in reqs)
    # every request's span tree sits on its lane, inside its request span
    for r in reqs:
        kids = [e for e in events if e["tid"] == r["tid"]
                and e["name"].startswith("serving.req.")
                and e["args"].get("rid") == r["args"]["rid"]
                and r["ts"] <= e["ts"] <= r["ts"] + r["dur"] + 1e-3]
        assert {e["name"] for e in kids} >= {
            "serving.req.queue", "serving.req.prefill", "serving.req.evict"}


def test_abort_dumps_the_flight_recorder(params, tmp_path, monkeypatch):
    prev = flight.set_recorder(flight.FlightRecorder(out_dir=str(tmp_path)))
    try:
        eng = ServingEngine(params, NL, NH, DM, device="cpu", **GEOM)
        req = eng.submit(_prompts()[0], MAX_NEW)

        def boom():
            raise RuntimeError("device lost")

        monkeypatch.setattr(eng, "_decode", boom)
        with pytest.raises(RuntimeError, match="device lost"):
            eng.step()
        path = flight.get_recorder().last_dump_path
    finally:
        flight.set_recorder(prev)
    assert req.done and isinstance(req.error, RuntimeError)
    bundle = flight.load_bundle(path)
    assert bundle["reason"] == "serving_abort"
    assert "device lost" in bundle["context"]["error"]
    assert bundle["context"]["failed_requests"] == 1
    assert bundle["metrics"]["serving.aborted"] == 1
