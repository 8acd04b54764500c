"""The analysis and attribution layer on the card (paddle_tpu_torch only:
no jax, so these run on a host without it).  Every test needs an NVIDIA
GPU and skips without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_analysis.py

* ``attribute_profile`` on a real bf16 step (flash attention, the fused
  CE head): >= 95% of its kernel time in a named class, the hand-written
  kernels under ``pallas`` and the projections under ``matmul``;
* the ``hlo.hbm-preflight`` check with the card's memory figure (one
  step's ``max_memory_allocated``) against ``total_memory`` (clean), then
  against a budget below the figure (fires; strict mode raises).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis.framework import CheckContext
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observability import attribution as attr

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profile and the memory figure "
                    "are the card's")


def _gpt(dtype, d_model=256, t=256, vocab=512):
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        outs = transformer.build(vocab_size=vocab, n_layer=2, n_head=2,
                                 d_model=d_model, max_len=t,
                                 dropout_rate=0.0, dtype=dtype,
                                 fused_head=True)
    return main, startup, outs["avg_cost"]


def test_attribute_profile_on_a_real_step():
    _need_card()
    main, startup, loss = _gpt("bfloat16")
    scope = tpt.Scope()
    exe = tpt.Executor("cuda")
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 256)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}

    def step(_i):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)

    step(0)
    assert exe.last_step_cost["kernel_families"] == {
        "flash_attention": "sm90", "fused_ce": "sm90"}
    assert exe.last_step_cost["kernel_backends"] == {
        "flash_attention": "cuda", "fused_ce": "cuda"}
    tab = attr.attribute_profile(step, device="cuda")
    assert tab["accounted_share"] >= 0.95, tab["unmatched"]
    assert tab["classes"]["pallas"]["calls"] >= 4
    assert "matmul" in tab["classes"]


def test_preflight_against_total_memory():
    _need_card()
    main, startup, loss = _gpt("float32", d_model=64, t=64, vocab=61)
    scope = tpt.Scope()
    tpt.Executor("cuda").run(startup, scope=scope)
    rep = analysis.lint(main, fetch_list=[loss], levels=("hlo",),
                        scope=scope, device="cuda")
    assert rep.ids() == []
    ctx = CheckContext(main, fetch_list=[loss], scope=scope, device="cuda")
    mem = ctx.memstats
    peak = mem["hbm_high_water_bytes"]
    assert mem["source"] == "max_memory_allocated" and peak > 0
    assert peak < torch.cuda.get_device_properties(0).total_memory
    assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
    with pytest.raises(analysis.AnalysisError, match="hbm-preflight"):
        analysis.lint(main, fetch_list=[loss], levels=("hlo",), scope=scope,
                      device="cuda", hbm_budget=peak - 1, strict=True)
