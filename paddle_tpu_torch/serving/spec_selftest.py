"""``python -m paddle_tpu_torch --spec-selftest`` — speculative decoding's
gate, the counterpart of ``paddle_tpu/serving/spec_selftest.py``.  Runs
on the card unless ``--device=cpu`` is given.

The bar is the engine's bit-exactness contract applied to the
propose / verify / commit loop, on a toy GPT made by the port itself
(``transformer.build`` + ``extract_params``):

1. PARITY: a speculative engine (depth-pruned draft) emits exactly the
   tokens of single-stream greedy ``transformer.generate`` in f32, prefix
   reuse on and off; in bf16 exactly the plain engine's;
2. SELF-DRAFT: with the target as its own draft the acceptance rate is
   near 1 (the verify window is bit-consistent with the sequential step);
3. ADVERSARIAL: a draft from another random init still gives exact
   output, at a low acceptance rate, its rejected scratch blocks rolled
   back (``serving.spec_rollback_blocks``);
4. ZERO LEAK: after serving, ``blocks_in_use`` equals the plain
   engine's, and 0 with reuse off;
5. KILL SWITCH: ``PADDLE_TPU_SPEC=0`` with a draft passed is the plain
   engine — same tokens, no speculative state, no ``serving.spec_*``
   metrics.

``tests/test_torch_speculative.py`` and ``test_torch_kill_switch.py``
hold the same engine to the JAX package's; this gate needs no JAX.
"""

import os

import numpy as np

__all__ = ["run_selftest"]

_TOY = dict(vocab=50, n_layer=2, n_head=2, d_model=32, max_len=64)


def make_params(seed=7):
    """A toy GPT's parameters (numpy, f32), initialised by the port's
    startup program with ``seed``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer

    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = seed
    with pt.program_guard(main, startup):
        transformer.build(
            vocab_size=_TOY["vocab"], n_layer=_TOY["n_layer"],
            n_head=_TOY["n_head"], d_model=_TOY["d_model"],
            max_len=_TOY["max_len"], dropout_rate=0.0, dtype="float32")
    scope = pt.Scope()
    pt.Executor("cpu").run(startup, scope=scope)
    return transformer.extract_params(scope=scope, program=main)


def _bf16(params):
    """The block and head matmul weights in bf16 (held as torch tensors:
    numpy has no bf16), the rest f32 — the serving dtype the engine
    infers from them."""
    import torch

    return {k: (torch.as_tensor(v).to(torch.bfloat16)
                if (k.startswith("block") or k.startswith("lm_head"))
                and k.endswith(".w") else v)
            for k, v in params.items()}


def _engine(params, device, **kw):
    from .engine import ServingEngine

    kw.setdefault("max_len", _TOY["max_len"])
    kw.setdefault("max_slots", 4)
    kw.setdefault("decode_chunk", 4)
    kw.setdefault("min_bucket", 4)
    return ServingEngine(params, _TOY["n_layer"], _TOY["n_head"],
                         _TOY["d_model"], device=device, **kw)


def _ref_outputs(params, prompts, max_new, device):
    from ..models import transformer

    outs = []
    for p in prompts:
        toks, _ = transformer.generate(
            params, p[None], max_len=_TOY["max_len"],
            n_layer=_TOY["n_layer"], n_head=_TOY["n_head"],
            d_model=_TOY["d_model"], return_logits=False, device=device)
        outs.append(toks.cpu().numpy()[0][: len(p) + max_new])
    return outs


def _same(outs, refs):
    return all(np.array_equal(np.asarray(o), np.asarray(r))
               for o, r in zip(outs, refs))


def run_selftest(device=None):
    from ..core.place import resolve_device
    from ..observability import metrics as obs
    from .speculative import depth_draft

    device = resolve_device(device)
    old_spec = os.environ.pop("PADDLE_TPU_SPEC", None)
    failures = []

    def check(cond, what):
        (failures.append(what) if not cond else None)
        print(("  ok  " if cond else "  FAIL") + " " + what, flush=True)

    params = make_params(seed=7)
    draft = depth_draft(params, 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, _TOY["vocab"], (n,)).astype(np.int32)
               for n in (3, 5, 7, 4, 6, 2)]
    max_new = 14
    ref = _ref_outputs(params, prompts, max_new, device)

    # 1. parity: depth-pruned draft, f32, reuse on and off
    for reuse in (True, False):
        eng = _engine(params, device, prefix_reuse=reuse,
                      draft_params=draft, spec_k=3)
        outs = eng.generate_many(prompts, max_new)
        check(_same(outs, ref),
              f"f32 parity vs transformer.generate (reuse={reuse})")
        check(eng._spec.proposed > 0,
              f"speculative rounds actually ran (reuse={reuse})")

    # bf16: the speculative engine against the plain engine, same weights
    p16 = _bf16(params)
    eng16 = _engine(p16, device, prefix_reuse=True,
                    draft_params=depth_draft(p16, 1), spec_k=3)
    plain16 = _engine(p16, device, prefix_reuse=True)
    check(_same(eng16.generate_many(prompts, max_new),
                plain16.generate_many(prompts, max_new)),
          "bf16 parity: speculative == plain engine, bit for bit")

    # 2. self-draft: the target as its own draft accepts nearly all
    eng_self = _engine(params, device, prefix_reuse=False,
                       draft_params=params, spec_k=4)
    check(_same(eng_self.generate_many(prompts, max_new), ref),
          "self-draft parity")
    sp = eng_self._spec
    rate = sp.accepted / sp.proposed if sp.proposed else 0.0
    check(rate >= 0.8,
          f"self-draft acceptance ~1 (the verify window is bit-consistent "
          f"with the sequential step): {rate:.3f}")

    # 3. adversarial draft: another random init, still exact, its
    # rejected scratch blocks rolled back
    reg = obs.get_registry()
    rolled = reg.value("serving.spec_rollback_blocks")
    adv = depth_draft(make_params(seed=1234), 1)
    eng_adv = _engine(params, device, prefix_reuse=True, draft_params=adv,
                      spec_k=4, block_tokens=4)
    check(_same(eng_adv.generate_many(prompts, max_new), ref),
          "adversarial-draft parity (low acceptance, exact output)")
    sp = eng_adv._spec
    adv_rate = sp.accepted / sp.proposed if sp.proposed else 1.0
    check(adv_rate < 0.5,
          f"the adversarial draft really is adversarial: {adv_rate:.3f}")
    check(reg.value("serving.spec_rollback_blocks") > rolled,
          "adversarial rejections rolled scratch blocks back")

    # 4. zero leak: what the plain engine keeps after the same load
    plain = _engine(params, device, prefix_reuse=True, block_tokens=4)
    plain.generate_many(prompts, max_new)
    check(eng_adv.kv_pool.blocks_in_use == plain.kv_pool.blocks_in_use,
          f"zero scratch-block leak: spec in_use "
          f"{eng_adv.kv_pool.blocks_in_use} == plain "
          f"{plain.kv_pool.blocks_in_use}")
    eng_off = _engine(params, device, prefix_reuse=False,
                      draft_params=draft, spec_k=3)
    eng_off.generate_many(prompts, max_new)
    check(eng_off.kv_pool.blocks_in_use == 0,
          "zero blocks in use after serving (reuse off)")
    check(reg.value("serving.spec_compiles") > 0,
          "serving.spec_compiles counted the draft and verify callables")

    # 5. kill switch: PADDLE_TPU_SPEC=0 ignores the draft
    os.environ["PADDLE_TPU_SPEC"] = "0"
    try:
        kreg = obs.MetricsRegistry()
        eng_k = _engine(params, device, prefix_reuse=True,
                        draft_params=draft, spec_k=3, registry=kreg)
        outs_k = eng_k.generate_many(prompts, max_new)
        check(eng_k._spec is None,
              "kill switch: no speculative state constructed")
        check(_same(outs_k, ref),
              "kill switch: output bit for bit plain greedy")
        check(not any(k.startswith("serving.spec_") for k in eng_k.stats()),
              "kill switch: no serving.spec_* metrics emitted")
    finally:
        os.environ.pop("PADDLE_TPU_SPEC", None)
        if old_spec is not None:
            os.environ["PADDLE_TPU_SPEC"] = old_spec

    print("spec selftest " + ("FAILED" if failures else "PASSED"),
          flush=True)
    return 1 if failures else 0
