"""The kernel registry's ``triton`` backend on the card
(``paddle_tpu_torch/kernels/triton_attention.py``): each Triton kernel
against its plain PyTorch version at small shapes, and a strict
``backend="triton"`` on CUDA tensors launching it (paddle_tpu_torch only:
no jax).  Every test needs an NVIDIA GPU and ``triton`` and skips
without them; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_triton.py

(``--noconftest`` because tests/conftest.py imports the JAX package.)
Tolerances: ORACLE_TOL (flash f32 2e-4 forward, 1e-3 gradients; bf16
2e-2, 5e-2; paged f32 2e-4, bf16 2e-2), max |got - plain| / max |plain|.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import triton_attention as tr

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Triton kernels run there")
    ok, reason = kernels.registry.triton_availability()
    if not ok:
        pytest.skip(reason)
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t_q,t_k", [(160, 160), (96, 200)],
                         ids=["square", "ragged"])
def test_flash_kernels_match_the_plain_versions(dt, d, causal, t_q, t_k):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(d + t_q)
    b, h = 2, 3
    mk = lambda t: (torch.randn(b, t, h, d, generator=g,  # noqa: E731
                                device="cuda") * 0.5).to(dt)
    q, do = mk(t_q), mk(t_q)
    k, v = mk(t_k), mk(t_k)
    dlse = torch.randn(b * h, t_q, generator=g, device="cuda")
    o, lse = tr.flash_fwd_triton(q, k, v, causal, block_q=64, block_k=32)
    ro, rlse = fa.flash_attention_ref(q, k, v, causal)
    ftol, gtol = fa.oracle_tol(dt, "fwd"), fa.oracle_tol(dt, "grad")
    assert _rel(o, ro) <= ftol and _rel(lse, rlse) <= ftol
    dq = tr.flash_bwd_dq_triton(q, k, v, ro, rlse, do, dlse, causal)
    dk, dv = tr.flash_bwd_dkv_triton(q, k, v, ro, rlse, do, dlse, causal)
    want = fa.flash_attention_bwd_ref(q, k, v, ro, rlse, do, dlse, causal)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert _rel(got, w) <= gtol, name


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("W", [1, 3, 6])
def test_paged_kernel_matches_the_plain_version(dt, W):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(W)
    S, NB, B, h, dh = 5, 6, 16, 3, 64
    nblk = 1 + S * NB
    pk, pv = ((torch.randn(nblk, B, h, dh, generator=g, device="cuda")
               * 0.5).to(dt) for _ in range(2))
    pk[0], pv[0] = float("nan"), float("inf")   # never read: masked out
    table = torch.arange(1, nblk, dtype=torch.int32,
                         device="cuda").reshape(S, NB)
    last = torch.tensor([NB * B - 1, 40, 17, W - 1, 70], device="cuda")
    table[torch.arange(NB, device="cuda")[None, :]
          > (last // B)[:, None]] = 0
    pos = (last[:, None] - W + 1 + torch.arange(W, device="cuda")).to(
        torch.int32).contiguous()
    q = torch.randn(S, W, h, dh, generator=g, device="cuda").to(dt)
    got = pa.paged_attention_triton(q, pk, pv, table, pos)
    want = pa.paged_attention_split_ref(q, pk, pv, table, pos, 1)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= pa.oracle_tol(dt)
    assert torch.equal(got, pa.paged_attention_triton(q, pk, pv, table, pos))
    pos[0] = -1                                  # no live key: zeros
    assert (pa.paged_attention_triton(q, pk, pv, table, pos)[0] == 0).all()


def test_strict_triton_backend_launches_the_kernels(monkeypatch):
    """A ``backend="triton"`` attr on the flash ops (a strict request):
    each launches the Triton forward, and its gradient the dq and dk/dv
    kernels, never the cuda ones; the CE head stays on auto (cuda); the
    step records both in ``kernel_backends``."""
    _need_card()
    from paddle_tpu_torch.models import transformer

    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        outs = transformer.build(vocab_size=61, n_layer=2, n_head=2,
                                 d_model=64, max_len=64, dropout_rate=0.0,
                                 dtype="bfloat16", fused_head=True)
    for op in main.global_block().ops:
        if op.type.startswith("flash_attention"):
            op.attrs["backend"] = "triton"
    exe, scope = pt.Executor("cuda"), pt.Scope()
    exe.run(startup, scope=scope)
    toks = np.arange(2 * 64).reshape(2, 64) % 61
    kernels.reset_launches()
    loss, = exe.run(main, feed={"tokens": toks,
                                "labels": np.roll(toks, -1, 1)},
                    fetch_list=[outs["avg_cost"]], scope=scope)
    counts = kernels.launch_counts()
    assert np.isfinite(loss).all()
    assert counts["flash_attention_triton_fwd"] == 2
    assert counts["flash_attention_triton_dq"] == 2
    assert counts["flash_attention_triton_dkv"] == 2
    assert counts["flash_attention_fwd"] == counts["flash_attention_bwd"] == 0
    assert counts["fused_ce_fwd"] == 1
    assert exe.last_step_cost["kernel_backends"] == {
        "flash_attention": "triton", "fused_ce": "cuda"}


def test_triton_paged_engine_serves_generate_tokens(monkeypatch):
    """``PADDLE_TPU_KERNEL_BACKEND_PAGED_ATTENTION=triton``: an f32 engine
    resolves the Triton kernel once a step callable, launches it and
    serves ``generate``'s tokens."""
    _need_card()
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.serving import ServingEngine

    nl, nh, dm, vocab, t = 2, 2, 64, 61, 32
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 3
    with pt.program_guard(main, startup):
        transformer.build(vocab_size=vocab, n_layer=nl, n_head=nh,
                          d_model=dm, max_len=t, dropout_rate=0.0,
                          dtype="float32")
    scope = pt.Scope()
    pt.Executor("cuda").run(startup, scope=scope)
    params = transformer.extract_params(scope=scope, program=main)
    rng = np.random.default_rng(0)
    monkeypatch.setenv("PADDLE_TPU_KERNEL_BACKEND_PAGED_ATTENTION", "triton")
    kernels.reset_launches()
    eng = ServingEngine(params, nl, nh, dm, max_len=t, max_slots=2,
                        block_tokens=4, device="cuda",
                        compute_dtype="float32")
    prompts = [rng.integers(0, vocab, (n,)).astype(np.int32)
               for n in (5, 9)]
    outs = eng.generate_many(prompts, max_new_tokens=6)
    assert kernels.launch_counts()["paged_attention_triton"] > 0
    assert kernels.launch_counts()["paged_attention"] == 0
    assert all(sel == {"paged_attention": "triton"}
               for sel in eng.kernel_backends.values())
    p = transformer.params_from_numpy(params, "cuda", torch.float32)
    for prompt, out in zip(prompts, outs):
        toks, _ = transformer.generate(p, prompt[None], len(prompt) + 6, nl,
                                       nh, dm, device="cuda")
        np.testing.assert_array_equal(out, toks[0].cpu().numpy())
