"""The port's CUDA kernels on the card (paged attention, flash attention
forward and fused backward), against their plain PyTorch versions
(paddle_tpu_torch only: no jax, so these run on a host without it).  Every test needs an NVIDIA GPU and skips without one; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` because tests/conftest.py imports the JAX package.)
Tolerance: ORACLE_TOL, max |kernel - plain| / max |plain|."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as tpa

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _case(S, W, H, DH, B, NB, dtype, seed=0, trash=50.0):
    """Seeded inputs on the card: ragged positions, the first two chain
    entries of slot 1 shared with slot 0, entries past each position
    naming the trash block 0, filled with ``trash``-scaled garbage."""
    rng = np.random.default_rng(seed)
    num_blocks = S * NB + 1
    q = rng.standard_normal((S, W, H, DH)).astype(np.float32)
    pk = rng.standard_normal((num_blocks, B, H, DH)).astype(np.float32)
    pv = rng.standard_normal((num_blocks, B, H, DH)).astype(np.float32)
    pk[0] = trash * rng.standard_normal((B, H, DH))
    pv[0] = trash * rng.standard_normal((B, H, DH))
    base = rng.integers(0, NB * B - W + 1, (S, 1))
    pos = (base + np.arange(W)[None, :]).astype(np.int32)
    table = np.zeros((S, NB), np.int32)
    blocks = iter(rng.permutation(np.arange(1, num_blocks)))
    for s in range(S):
        for nb in range(int(pos[s].max()) // B + 1):
            table[s, nb] = (table[0, nb] if s == 1 and nb < 2
                            and table[0, nb] else next(blocks))
    dev = "cuda"
    return (torch.tensor(q, device=dev).to(dtype),
            torch.tensor(pk, device=dev).to(dtype),
            torch.tensor(pv, device=dev).to(dtype),
            torch.tensor(table, device=dev), torch.tensor(pos, device=dev))


def _rel(got, ref):
    d = (got.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [(4, 1, 2, 16, 4, 5), (3, 3, 2, 100, 7, 4),
                                  (32, 1, 6, 128, 32, 16),
                                  (2, 4, 1, 256, 1, 40)],
                         ids=["tiny", "odd_dh_B", "decode", "B1_wide"])
def test_kernel_matches_plain_version(dtype, geom):
    _need_card()
    args = _case(*geom, getattr(torch, dtype))
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert _rel(got, tpa.paged_attention_ref(*args)) <= tpa.oracle_tol(dtype)


def test_kernel_never_reads_past_pos():
    """Non-finite garbage in the trash block and past each position stays
    out of the output: the kernel skips those keys rather than weighting
    them by zero."""
    _need_card()
    q, pk, pv, table, pos = _case(4, 2, 2, 32, 4, 6, torch.float32, seed=3)
    clean = tpa.paged_attention(q, pk, pv, table, pos)
    live = torch.zeros(pk.shape[:2], dtype=torch.bool, device="cuda")
    for s in range(table.shape[0]):
        for j in range(int(pos[s].max()) + 1):
            live[table[s, j // 4], j % 4] = True
    pk[~live] = float("nan")
    pv[~live] = float("inf")
    got = tpa.paged_attention(q, pk, pv, table, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


def test_wrapper_checks_before_launching():
    _need_card()
    q, pk, pv, table, pos = _case(2, 1, 2, 16, 4, 3, torch.float32)
    before = tpa.paged_attention.launches
    with pytest.raises(TypeError):
        tpa.paged_attention(q.half(), pk.half(), pv.half(), table, pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pk, pv, table, pos.cpu())
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pk[:, :, :, ::2], pv[:, :, :, ::2], table,
                            pos)
    assert tpa.paged_attention.launches == before


def test_engine_on_the_card_matches_the_cpu():
    """A tiny f32 model served on the card gives the CPU's tokens, and
    every attention call went through the kernel."""
    _need_card()
    from paddle_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(0)
    V, L, H, D, T = 64, 2, 2, 64, 48
    p = {"tok_emb.w": rng.standard_normal((V, D)),
         "pos_emb.w.w": rng.standard_normal((T, D)),
         "ln_f.scale": 1 + 0.1 * rng.standard_normal(D),
         "ln_f.bias": 0.1 * rng.standard_normal(D),
         "lm_head.w": rng.standard_normal((D, V)) / D ** 0.5}
    for i in range(L):
        for nm, shape in (("att_q", (D, D)), ("att_k", (D, D)),
                          ("att_v", (D, D)), ("att_out", (D, D)),
                          ("ffn1", (D, 4 * D)), ("ffn2", (4 * D, D))):
            p[f"block{i}_{nm}.w"] = rng.standard_normal(shape) / shape[0] ** .5
            p[f"block{i}_{nm}.b"] = 0.1 * rng.standard_normal(shape[1])
        for ln in ("ln1", "ln2"):
            p[f"block{i}_{ln}.scale"] = 1 + 0.1 * rng.standard_normal(D)
            p[f"block{i}_{ln}.bias"] = 0.1 * rng.standard_normal(D)
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    stem = rng.integers(1, V, 10)
    prompts = [stem, np.concatenate([stem[:6], rng.integers(1, V, 5)]),
               rng.integers(1, V, 3)]
    geom = dict(max_len=T, max_slots=2, decode_chunk=4, min_bucket=4,
                block_tokens=4)
    cpu = ServingEngine(p, L, H, D, device="cpu", **geom)
    want = cpu.generate_many(prompts, max_new_tokens=12)
    eng = ServingEngine(p, L, H, D, **geom)
    before = tpa.paged_attention.launches
    got = eng.generate_many(prompts, max_new_tokens=12)
    assert tpa.paged_attention.launches > before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- flash attention: forward and fused backward ------------------------------

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402


def _flash_case(b, t_q, t_k, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), device="cuda").to(dtype)
    return (mk(b, t_q, h, d), mk(b, t_k, h, d), mk(b, t_k, h, d),
            mk(b, t_q, h, d),
            torch.tensor(rng.standard_normal((b * h, t_q)).astype(np.float32),
                         device="cuda"))


FLASH_GEOMS = {
    # b, t_q, t_k, h, d
    "tiny_d16": (2, 64, 64, 2, 16),
    "ragged_d64": (1, 200, 200, 2, 64),
    "d128": (1, 256, 256, 2, 128),
    "ragged_d100": (1, 77, 77, 3, 100),
    "tq_gt_tk": (1, 192, 128, 2, 64),
    "three_rows": (1, 3, 3, 1, 128),
}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(FLASH_GEOMS))
def test_flash_forward_matches_plain_version(dtype, geom, causal):
    _need_card()
    q, k, v, _, _ = _flash_case(*FLASH_GEOMS[geom], getattr(torch, dtype))
    before = tfa.flash_fwd.launches
    o, lse = tfa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal)
    tol = tfa.oracle_tol(dtype, "fwd")
    assert o.dtype == q.dtype and o.shape == q.shape
    assert _rel(o, o_ref) <= tol
    assert _rel(lse, lse_ref) <= tol


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(FLASH_GEOMS))
def test_flash_backward_matches_plain_version(dtype, geom, causal, with_dlse):
    _need_card()
    q, k, v, do, dlse = _flash_case(*FLASH_GEOMS[geom], getattr(torch, dtype))
    dlse = dlse if with_dlse else None
    o, lse = tfa.flash_attention_ref(q, k, v, causal)
    before = tfa.flash_bwd.launches
    got = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert tfa.flash_bwd.launches == before + 1
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal)
    tol = tfa.oracle_tol(dtype, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        assert _rel(g, w) <= tol, name


def test_flash_packed_autograd_goes_through_both_kernels():
    """The packed entry point on the card: same values and gradients as
    the plain versions, one forward and one backward launch."""
    _need_card()
    b, t, h, d = 2, 128, 2, 64
    q, k, v, do, _ = _flash_case(b, t, t, h, d, torch.float32, seed=2)
    flat = [x.reshape(b, t, h * d).clone().requires_grad_() for x in (q, k, v)]
    f0, b0 = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    out = tfa.flash_attention_packed(*flat, n_head=h, causal=True)
    out.backward(do.reshape(b, t, h * d))
    torch.cuda.synchronize()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == (f0 + 1, b0 + 1)
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, True)
    want = tfa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, None, True)
    assert _rel(out, o_ref.reshape(b, t, h * d)) <= 2e-4
    for x, w in zip(flat, want):
        assert _rel(x.grad, w.reshape(b, t, h * d)) <= 1e-3


def test_flash_wrapper_checks_before_launching():
    _need_card()
    q, k, v, do, _ = _flash_case(1, 32, 32, 2, 16, torch.float32)
    before = tfa.flash_fwd.launches
    with pytest.raises(TypeError):
        tfa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):
        tfa.flash_fwd(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError):
        wide = torch.zeros(1, 8, 1, 256, device="cuda")
        tfa.flash_fwd(wide, wide, wide)
    assert tfa.flash_fwd.launches == before


def test_executor_on_the_card_matches_the_cpu():
    """Three Adam steps of a tiny f32 GPT on the card, from the state the
    CPU run starts from: the same losses within 1e-4 relative, attention
    through both kernels (one forward and one backward launch per layer
    and step), parameters updated in place."""
    _need_card()
    import paddle_tpu_torch as pt

    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=61, n_layer=2, n_head=2, d_model=128, max_len=48,
            dropout_rate=0.0, dtype="float32", learning_rate=2e-3)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    state = {v.name: cpu_scope.numpy(v.name)
             for v in main.persistable_vars()}
    card_scope = pt.load_numpy_state(pt.Scope(), state)
    card = pt.Executor(pt.CUDAPlace(0))
    rng = np.random.default_rng(0)
    w = card_scope.get("lm_head.w")
    ptr, before = w.data_ptr(), w.clone()
    f0, b0 = tfa.flash_fwd.launches, tfa.flash_bwd.launches
    for _ in range(3):
        start = rng.integers(0, 61, (4, 1))
        toks = (start + np.arange(48)[None, :]) % 61
        labels = np.concatenate([toks[:, 1:], -np.ones((4, 1), int)], 1)
        feed = {"tokens": toks, "labels": labels}
        want, = cpu.run(main, feed=feed, fetch_list=[model["avg_cost"]],
                        scope=cpu_scope)
        got, = card.run(main, feed=feed, fetch_list=[model["avg_cost"]],
                        scope=card_scope)
        assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
    assert (tfa.flash_fwd.launches - f0, tfa.flash_bwd.launches - b0) == (6, 6)
    assert card_scope.get("lm_head.w").data_ptr() == ptr
    assert not torch.equal(card_scope.get("lm_head.w"), before)
    assert card_scope.get("@GRAD_NORM@").item() > 0
