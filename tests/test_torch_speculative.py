"""Speculative decoding in the port (paddle_tpu_torch/serving/
speculative.py, ``ServingEngine(draft_params=...)``,
``batched_decode.make_verify_window``) against the JAX package's, on the
CPU in f32 at a small geometry (2 layers, d 32, vocab 50): token-exact
against the JAX speculative engine and JAX ``generate``, reuse on and
off; an adversarial draft stays exact; geometry mismatches raise;
``depth_draft`` bounds; ``PADDLE_TPU_SPEC=0`` is the plain engine;
scratch blocks never leak, also after a slot death mid-verify
(``PADDLE_TPU_FAULT=slot_death:n``); ``accept_greedy`` agrees with the
JAX walk; and one verify window, fed the same pools, window, positions,
limits and table in both packages, gives the same greedy tokens and
writes the same pool positions, in both attention spellings.  Mirrors
tests/test_speculative.py."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.observability import metrics as jobs
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import batched_decode as jbd
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.observability import metrics as tobs
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import ServingEngine, batched_decode
from paddle_tpu_torch.serving import speculative as spec
from torch_ref_gauges import restore_reference_gauges  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """The reference reads tuned attention and serving geometry from its
    tune cache (``PADDLE_TPU_TUNE_CACHE``, else ``~/.cache/paddle_tpu``);
    the port reads its own (``~/.cache/paddle_tpu_torch``) under the same
    variable.  A cache path in a fresh directory holds no entry, so both
    packages build with their defaults whatever cache the host has."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


VOCAB, NL, NH, DM, T = 50, 2, 2, 32, 48
MAX_NEW = 10


def _make_params(seed=7, vocab=VOCAB, n_layer=NL, d_model=DM, max_len=T):
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    with pt.program_guard(main, startup):
        jtr.build(vocab_size=vocab, n_layer=n_layer, n_head=NH,
                  d_model=d_model, max_len=max_len, dropout_rate=0.0,
                  dtype="float32")
    pt.Executor().run(startup)
    return jtr.extract_params(program=main)


def _prompts(rng, n, lens=(3, 7, 5, 9, 4, 11)):
    return [rng.integers(1, VOCAB, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


PROMPTS = _prompts(np.random.default_rng(11), 6)


@pytest.fixture(scope="module")
def params():
    return _make_params()


@pytest.fixture(scope="module")
def refs(params):
    """JAX ``generate`` alone on each of ``PROMPTS``: the acceptance bar."""
    out = []
    for p in PROMPTS:
        toks, _ = jtr.generate(params, p[None], max_len=T, n_layer=NL,
                               n_head=NH, d_model=DM, return_logits=False)
        out.append(np.asarray(toks)[0][: len(p) + MAX_NEW])
    return out


@pytest.fixture(autouse=True)
def fresh_serving_metrics():
    jobs.get_registry().clear(prefix="serving.")
    tobs.get_registry().clear(prefix="serving.")
    yield


def _engine(params, **kw):
    kw.setdefault("max_len", T)
    kw.setdefault("max_slots", 4)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("min_bucket", 4)
    return ServingEngine(params, NL, NH, DM, device="cpu", **kw)


# -- token-exact parity ------------------------------------------------------

@pytest.mark.parametrize("reuse", [True, False])
def test_spec_equals_jax_spec_engine_and_generate(params, refs, reuse):
    kw = dict(max_len=T, max_slots=4, decode_chunk=4, min_bucket=4,
              prefix_reuse=reuse, spec_k=3)
    jeng = JaxServingEngine(params, NL, NH, DM,
                            draft_params=jspec.depth_draft(params, 1), **kw)
    jouts = jeng.generate_many(PROMPTS, max_new_tokens=MAX_NEW)
    jst = jeng.stats()
    eng = ServingEngine(params, NL, NH, DM, device="cpu",
                        draft_params=spec.depth_draft(params, 1), **kw)
    assert eng._spec is not None and eng.spec_k == 3
    outs = eng.generate_many(PROMPTS, max_new_tokens=MAX_NEW)
    for o, jo, ref in zip(outs, jouts, refs):
        np.testing.assert_array_equal(o, jo)
        np.testing.assert_array_equal(o, ref)
    assert eng._spec.proposed > 0
    assert (eng._spec.proposed, eng._spec.accepted) == (
        jeng._spec.proposed, jeng._spec.accepted)
    st = eng.stats()
    for nm in ("serving.spec_compiles", "serving.spec_accept_rate",
               "serving.tokens", "serving.completed",
               "serving.blocks_in_use", "serving.kv_blocks_total"):
        assert st.get(nm) == jst.get(nm), nm
    assert set(eng.kernel_backends) == set(jeng.kernel_backends)


def test_adversarial_draft_stays_exact(params, refs):
    """A draft with unrelated weights: acceptance collapses, every
    committed token is still exact, and rejected proposals cross block
    boundaries (4-token blocks) so blocks roll back."""
    adv = _make_params(seed=1234)
    eng = _engine(params, block_tokens=4,
                  draft_params=spec.depth_draft(adv, 1), spec_k=4)
    outs = eng.generate_many(PROMPTS[:5], max_new_tokens=MAX_NEW)
    for o, ref in zip(outs, refs):
        np.testing.assert_array_equal(o, ref)
    sp = eng._spec
    assert sp.proposed > 0
    assert sp.accepted / sp.proposed < 0.5
    assert eng.stats()["serving.spec_rollback_blocks"] > 0


# -- construction-time geometry validation -----------------------------------

def test_geometry_mismatches_rejected(params):
    draft = spec.depth_draft(params, 1)
    rng = np.random.default_rng(0)
    other_vocab = dict(draft, **{
        "tok_emb.w": rng.standard_normal((60, DM)).astype(np.float32)})
    with pytest.raises(ValueError, match="vocab mismatch"):
        _engine(params, draft_params=other_vocab)
    other_head = dict(draft, **{
        "lm_head.w": rng.standard_normal((DM, 60)).astype(np.float32)})
    with pytest.raises(ValueError, match="lm_head"):
        _engine(params, draft_params=other_head)
    other_width = _make_params(d_model=64)
    with pytest.raises(ValueError, match="d_model"):
        _engine(params, draft_params=other_width)
    with pytest.raises(ValueError, match="n_head"):
        _engine(params, draft_params=draft, draft_n_head=1)
    with pytest.raises(ValueError, match="outside"):
        _engine(params, draft_params=draft, draft_n_layer=0)
    with pytest.raises(ValueError, match="outside"):
        _engine(params, draft_params=draft, draft_n_layer=2)
    deep = _make_params(n_layer=3)
    with pytest.raises(ValueError, match="cannot be deeper"):
        _engine(params, draft_params=deep)
    short = _make_params(max_len=16)
    with pytest.raises(ValueError, match="position-embedding"):
        _engine(params, draft_params=short)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(params, draft_params=draft, spec_k=0)


def test_depth_draft_helper_bounds(params):
    assert spec.draft_depth(params) == NL == jspec.draft_depth(params)
    assert spec.draft_depth(spec.depth_draft(params, 1)) == 1
    assert (sorted(spec.depth_draft(params, 1))
            == sorted(jspec.depth_draft(params, 1)))
    for bad in (0, NL + 1):
        with pytest.raises(ValueError, match="outside"):
            spec.depth_draft(params, bad)
    assert spec.DEFAULT_SPEC_K == jspec.DEFAULT_SPEC_K


# -- kill switch -------------------------------------------------------------

def test_spec_kill_switch_is_the_plain_engine(params, monkeypatch):
    plain = _engine(params).generate_many(PROMPTS[:4], max_new_tokens=8)
    monkeypatch.setenv("PADDLE_TPU_SPEC", "0")
    tobs.get_registry().clear(prefix="serving.")
    eng = _engine(params, draft_params=spec.depth_draft(params, 1),
                  spec_k=3)
    assert eng._spec is None and eng.spec_k is None
    outs = eng.generate_many(PROMPTS[:4], max_new_tokens=8)
    for o, ref in zip(outs, plain):
        np.testing.assert_array_equal(o, ref)
    assert not any(k.startswith("serving.spec_") for k in eng.stats())


# -- zero-leak discipline ----------------------------------------------------

@pytest.mark.parametrize("reuse", [True, False])
def test_scratch_blocks_never_leak(params, reuse):
    plain = _engine(params, prefix_reuse=reuse)
    plain.generate_many(PROMPTS, max_new_tokens=8)
    base_in_use = plain.kv_pool.blocks_in_use
    tobs.get_registry().clear(prefix="serving.")
    eng = _engine(params, prefix_reuse=reuse,
                  draft_params=spec.depth_draft(params, 1), spec_k=3)
    eng.generate_many(PROMPTS, max_new_tokens=8)
    sp = eng._spec
    assert eng.kv_pool.blocks_in_use == base_in_use
    if not reuse:
        assert eng.kv_pool.blocks_in_use == 0
    assert all(not (c or ()) for c in sp.chains)
    assert not np.count_nonzero(sp.table)
    assert (eng._table == 0).all()


def test_slot_death_mid_verify_reclaims_scratch_and_real_chains(
        params, monkeypatch):
    eng = _engine(params, max_slots=3, prefix_reuse=False, block_tokens=4,
                  draft_params=spec.depth_draft(params, 1), spec_k=3)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(1, VOCAB, (5,)) for _ in range(6)]
    monkeypatch.setenv("PADDLE_TPU_FAULT", "slot_death:2")
    faults.reset()
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        for r in reqs:
            assert r.wait(timeout=120), "request did not finish"
    finally:
        eng.stop()
        monkeypatch.delenv("PADDLE_TPU_FAULT")
        faults.reset()
    dead = [r for r in reqs if r.error is not None]
    ok = [r for r in reqs if r.error is None]
    assert len(dead) == 1 and len(ok) == 5
    with pytest.raises(RuntimeError, match="injected slot death"):
        dead[0].result(timeout=0)
    for r in ok:
        ref, _ = jtr.generate(params, r.prompt[None], max_len=T,
                              n_layer=NL, n_head=NH, d_model=DM,
                              return_logits=False)
        np.testing.assert_array_equal(
            r.result(timeout=0), np.asarray(ref)[0][: 5 + MAX_NEW])
    assert eng.kv_pool.blocks_in_use == 0
    assert (eng._table == 0).all()
    assert not np.count_nonzero(eng._spec.table)
    assert all(not (c or ()) for c in eng._spec.chains)
    st = eng.stats()
    assert st["serving.slot_deaths"] == 1
    assert st["serving.completed"] == 5
    assert eng.idle and eng.driver_alive() is False


# -- the acceptance walk -------------------------------------------------------

@pytest.mark.parametrize("drafts,greedy,cap", [
    ([5, 6, 7], [5, 6, 7, 8], 10),       # all accepted + bonus
    ([5, 6, 7], [5, 9, 7, 8], 10),       # diverge at 1
    ([5, 6, 7], [1, 6, 7, 8], 10),       # diverge at 0: bonus only
    ([5, 6, 7], [5, 6, 7, 8], 2),        # capped by the request's window
    ([5, 6, 7], [5, 6, 7, 8], 1),        # one token left
    ([5], [5, 3], 4),
    ([], [4], 3),                        # k = 0 degenerate
])
def test_accept_greedy_agrees_with_jax(drafts, greedy, cap):
    got = spec.accept_greedy(np.asarray(drafts, np.int32),
                             np.asarray(greedy, np.int32), cap)
    want = jspec.accept_greedy(np.asarray(drafts, np.int32),
                               np.asarray(greedy, np.int32), cap)
    assert got == want
    assert 1 <= len(got[0]) <= cap


# -- one verify window, both packages ----------------------------------------

@pytest.mark.parametrize("switch", ["1", "0"])
def test_verify_window_matches_jax(params, monkeypatch, switch):
    """The same pools, window, positions, limits and table through JAX
    ``make_verify_window`` and the port's: equal greedy tokens, the same
    pool positions written (block 0, where colliding overhang writes
    land, aside) with equal values to f32 rounding.  Slot 0 overhangs its
    limit, slot 1 is live, slot 2 is dead (limit -1)."""
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", switch)
    k, S, NB, B, nblk = 3, 3, 6, 4, 20
    W = k + 1
    dh = DM // NH
    rng = np.random.default_rng(3)
    pk0 = [rng.standard_normal((nblk, B, NH, dh)).astype(np.float32)
           for _ in range(NL)]
    pv0 = [rng.standard_normal((nblk, B, NH, dh)).astype(np.float32)
           for _ in range(NL)]
    table = np.zeros((S, NB), np.int32)
    table[0, :3] = [3, 4, 5]
    table[1, :5] = [6, 7, 8, 9, 10]
    toks = rng.integers(1, VOCAB, (S, W)).astype(np.int32)
    pos = np.array([9, 14, 0], np.int32)
    limit = np.array([10, 20, -1], np.int32)

    jfn = jbd.make_verify_window(NL, NH, DM, k, donate=False)
    import jax.numpy as jnp
    jpk, jpv, jgreedy = jfn(
        {n: jnp.asarray(v) for n, v in params.items()},
        tuple(jnp.asarray(a) for a in pk0), tuple(jnp.asarray(a) for a in pv0),
        jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(limit),
        jnp.asarray(table))
    fn = batched_decode.make_verify_window(NL, NH, DM, k)
    assert fn.paged is (switch == "1")
    from paddle_tpu_torch.models.transformer import params_from_numpy
    tpk = [torch.tensor(a) for a in pk0]
    tpv = [torch.tensor(a) for a in pv0]
    greedy = fn(params_from_numpy(params, "cpu"), tpk, tpv,
                torch.tensor(toks), torch.tensor(pos), torch.tensor(limit),
                torch.tensor(table))
    assert greedy.dtype == torch.int32 and tuple(greedy.shape) == (S, W)
    # positions past a slot's limit are garbage the engine never commits
    live = (pos[:, None] + np.arange(W)[None, :]) <= limit[:, None]
    np.testing.assert_array_equal(greedy.numpy()[live],
                                  np.asarray(jgreedy)[live])
    for got, want, before in zip(tpk + tpv, list(jpk) + list(jpv),
                                 pk0 + pv0):
        got, want = got.numpy()[1:], np.asarray(want)[1:]
        written = (want != before[1:]).any(axis=(2, 3))
        np.testing.assert_array_equal((got != before[1:]).any(axis=(2, 3)),
                                      written)
        # slot 0 wrote positions 9, 10 (block 5), slot 1 14..17 (blocks
        # 9, 10); the dead slot and slot 0's overhang wrote only block 0
        assert written.sum() == 2 + 4
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
