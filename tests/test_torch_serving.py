"""The port's serving engine (paddle_tpu_torch/serving/) against the JAX
package's, on the CPU in f32: shared-prefix traffic (full-block hits and
copy-on-write forks) must come out token-identical to the JAX
``ServingEngine`` and to JAX ``generate`` run alone, prefix reuse on and
off, with the same prefill buckets and the same prefix accounting.
(f32 because the JAX package's own bf16 reuse-off served-equals-
single-stream test fails at the seed.)"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.observability import metrics as jobs
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.observability import metrics as tobs
from paddle_tpu_torch.serving import SheddedRequest, ServingEngine


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
GEOM = dict(max_len=T, max_slots=3, decode_chunk=5, min_bucket=4,
            block_tokens=4)
MAX_NEW = 8


def _make_params(seed=5):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        jtr.build(vocab_size=VOCAB, n_layer=NL, n_head=NH, d_model=DM,
                  max_len=T, dropout_rate=0.0, dtype="float32")
    pt.Executor().run(startup)
    params = jtr.extract_params(program=main)
    rng = np.random.default_rng(seed)
    for k, v in params.items():
        if v.ndim == 1:
            params[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return params


def _prompts():
    rng = np.random.default_rng(7)
    base = rng.integers(1, VOCAB, (12,)).astype(np.int32)
    return [
        base.copy(),                                   # cold
        base.copy(),                                   # full-block hits
        np.concatenate([base[:6],                      # CoW fork at 6
                        rng.integers(1, VOCAB, (5,)).astype(np.int32)]),
        rng.integers(1, VOCAB, (9,)).astype(np.int32),  # unrelated
        base[:10].copy(),                              # shorter re-serve
    ]


@pytest.fixture(scope="module")
def params():
    return _make_params()


@pytest.fixture(scope="module")
def single_stream(params):
    """JAX ``generate`` run alone on each prompt: the acceptance bar."""
    out = []
    for p in _prompts():
        ref, _ = jtr.generate(params, p[None], max_len=T, n_layer=NL,
                              n_head=NH, d_model=DM, return_logits=False)
        out.append(np.asarray(ref)[0][: len(p) + MAX_NEW])
    return out


@pytest.fixture(autouse=True)
def fresh_serving_metrics():
    jobs.get_registry().clear(prefix="serving.")
    tobs.get_registry().clear(prefix="serving.")
    yield


def _serve_two_waves(eng, prompts):
    # two waves so later requests hit chains the first wave cached
    outs = eng.generate_many(prompts[:2], max_new_tokens=MAX_NEW)
    return outs + eng.generate_many(prompts[2:], max_new_tokens=MAX_NEW)


@pytest.mark.parametrize("reuse", [True, False])
def test_served_equals_jax_engine_and_single_stream(params, single_stream,
                                                    reuse):
    prompts = _prompts()
    jeng = JaxServingEngine(params, NL, NH, DM, prefix_reuse=reuse, **GEOM)
    jouts = _serve_two_waves(jeng, prompts)
    jst = jeng.stats()
    launches = tpa.paged_attention.launches
    eng = ServingEngine(params, NL, NH, DM, prefix_reuse=reuse,
                        device="cpu", **GEOM)
    outs = _serve_two_waves(eng, prompts)
    st = eng.stats()
    for o, jo, ref in zip(outs, jouts, single_stream):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(o, ref)
    assert sorted(eng._prefill_fns) == sorted(jeng._prefill_fns)
    for nm in ("serving.admitted", "serving.completed", "serving.tokens",
               "serving.prefill_tokens", "serving.prefix_hit_rate",
               "serving.cow_copies", "serving.blocks_in_use"):
        assert st.get(nm) == jst.get(nm), nm
    assert tpa.paged_attention.launches == launches  # CPU: no kernel
    if reuse:
        assert st["serving.prefix_hit_rate"] > 0
        assert st["serving.cow_copies"] >= 1
        # no leak: after drain only the trie holds blocks
        assert st["serving.blocks_in_use"] == len(eng.prefix_trie)
        eng.prefix_trie.clear()
        assert eng.kv_pool.blocks_in_use == 0
    else:
        assert eng.prefix_trie is None
        assert st["serving.blocks_in_use"] == 0


def test_buckets_follow_suffix_lengths(params):
    eng = ServingEngine(params, NL, NH, DM, device="cpu", **GEOM)
    rng = np.random.default_rng(2)
    lens = [1, 3, 4, 5, 9, 13]
    eng.generate_many([rng.integers(1, VOCAB, (n,)) for n in lens],
                      max_new_tokens=2)
    assert sorted(eng._prefill_fns) == sorted({eng.bucket_for(n)
                                               for n in lens}) == [4, 8, 16]


def test_eos_evicts_slot_early(params, single_stream):
    prompt = _prompts()[3]
    full = single_stream[3]
    gen = full[len(prompt):]
    eos = int(gen[len(gen) // 2])
    cut = list(gen).index(eos)
    eng = ServingEngine(params, NL, NH, DM, device="cpu", **GEOM)
    out = eng.generate_many([prompt], max_new_tokens=MAX_NEW, eos_id=eos)[0]
    np.testing.assert_array_equal(out, full[: len(prompt) + cut + 1])
    assert eng.active_slots == 0 and eng.idle
    assert eng.stats()["serving.completed"] == 1


def test_background_thread_serves_concurrent_submits(params, single_stream):
    eng = ServingEngine(params, NL, NH, DM, device="cpu", **GEOM)
    eng.start()
    try:
        reqs = [eng.submit(p, MAX_NEW) for p in _prompts()]
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    assert not eng.driver_alive()
    for o, ref in zip(outs, single_stream):
        np.testing.assert_array_equal(o, ref)
    assert {r.rid for r in eng.results()} == {r.rid for r in reqs}


def test_slo_scheduler_sheds_doomed_request(params):
    eng = ServingEngine(params, NL, NH, DM, device="cpu", **GEOM)
    eng.generate_many([_prompts()[0]], max_new_tokens=MAX_NEW)  # warm
    assert eng.predictor.ready
    doomed = eng.submit(_prompts()[1], MAX_NEW, e2e_slo_s=1e-9)
    ok = eng.submit(_prompts()[3], MAX_NEW)
    eng.run_until_idle()
    assert doomed.shed
    with pytest.raises(SheddedRequest):
        doomed.result(timeout=0)
    assert len(ok.result(timeout=0)) == len(_prompts()[3]) + MAX_NEW
    assert eng.stats()["serving.shed_total"] == 1


def test_engine_needs_a_card_or_an_explicit_cpu(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, NL, NH, DM, **GEOM)
