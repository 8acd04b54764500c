"""The port's CUDA kernels on the card (paged attention, decode gather,
flash attention forward, fused backward and split backward (dq, dk/dv),
the fused cross-entropy head's forward, dx and dW, the fused ResNet
bottleneck), against their plain PyTorch versions
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


def _tiny_model(rng):
    """Seeded f32 weights of a 2-layer d64 model (vocab 64, 48 positions)
    with non-trivial biases and LayerNorm parameters."""
    V, L, D, T = 64, 2, 64, 48
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
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def test_engine_on_the_card_matches_the_cpu():
    """A tiny f32 model served on the card gives the CPU's tokens, and
    every attention call went through the kernel."""
    _need_card()
    from paddle_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(0)
    V, L, H, D, T = 64, 2, 2, 64, 48
    p = _tiny_model(rng)
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


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(FLASH_GEOMS))
def test_flash_split_backward_matches_plain_and_fused(dtype, geom, causal,
                                                     with_dlse, monkeypatch):
    """The split route (dq kernel + dk/dv kernel) within ORACLE_TOL of the
    plain version; its dk and dv the fused kernel's bits; its dq the same
    bits run to run."""
    _need_card()
    q, k, v, do, dlse = _flash_case(*FLASH_GEOMS[geom], getattr(torch, dtype),
                                    seed=5)
    dlse = dlse if with_dlse else None
    o, lse = tfa.flash_attention_ref(q, k, v, causal)
    fused = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    before = (tfa.flash_bwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    got = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    again = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (before[0], before[1] + 2,
                                            before[2] + 2)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal)
    tol = tfa.oracle_tol(dtype, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        assert _rel(g, w) <= tol, name
    assert torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel(got[0], fused[0]) <= tol


def test_flash_autograd_route_follows_block_k(monkeypatch):
    """Through ``flash_attention``: the block_k attr decides the route as
    in the reference.  The partials are nk * b*h*t*d * 2 bytes: 64 KiB at
    the default block_k (nk = 1), 256 KiB at block_k=64 (nk = 4); with a
    128 KiB budget the first takes the fused kernel, the second the two
    split kernels and no fused one."""
    _need_card()
    b, t, h, d = 1, 256, 2, 64
    q, k, v, do, _ = _flash_case(b, t, t, h, d, torch.bfloat16, seed=6)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 128 << 10)
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, True)
    want = tfa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, None, True)
    for blocks, launched in (({}, (1, 0, 0)),
                             ({"block_q": 64, "block_k": 64}, (0, 1, 1))):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        c0 = (tfa.flash_bwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
        out = tfa.flash_attention(*xs, causal=True, **blocks)
        out.backward(do)
        torch.cuda.synchronize()
        c1 = (tfa.flash_bwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
        assert tuple(a - b_ for a, b_ in zip(c1, c0)) == launched
        for x, w in zip(xs, want):
            assert _rel(x.grad, w) <= tfa.oracle_tol(torch.bfloat16, "grad")


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


# -- fused cross-entropy head: forward, dx, dW ---------------------------------

from paddle_tpu_torch.kernels import fused_ce as tce  # noqa: E402

CE_GEOMS = {
    # N, d, V: tile-aligned, ragged everywhere, odd widths (the scalar
    # copy path), the small-d template, and a wide head
    "aligned": (256, 256, 1024),
    "ragged": (1000, 200, 5000),
    "odd": (77, 61, 333),
    "d768": (130, 768, 2100),
}


def _ce_case(n, d, v, dtype, seed=0):
    """Seeded inputs on the card; labels -1 and V in some rows, and a
    cotangent with zeros (masked rows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (2 * rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    y[1::7] = -1
    y[3::11] = v
    g = rng.standard_normal(n).astype(np.float32)
    g[2::5] = 0.0
    dev = "cuda"
    return (torch.tensor(x, device=dev).to(dtype),
            torch.tensor(w, device=dev).to(dtype),
            torch.tensor(y, device=dev), torch.tensor(g, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(CE_GEOMS))
def test_ce_kernels_match_plain_versions(dtype, geom):
    _need_card()
    x, w, y, g = _ce_case(*CE_GEOMS[geom], getattr(torch, dtype))
    before = (tce.ce_fwd.launches, tce.ce_dx.launches, tce.ce_dw.launches)
    loss, lse = tce.ce_fwd(x, w, y)
    dx = tce.ce_dx(x, w, y, lse, g)
    dw = tce.ce_dw(x, w, y, lse, g)
    torch.cuda.synchronize()
    assert (tce.ce_fwd.launches, tce.ce_dx.launches, tce.ce_dw.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref_loss, ref_lse = tce.fused_ce_ref(x, w, y)
    tol = tce.oracle_tol(dtype, "fwd")
    assert loss.dtype == torch.float32 and loss.shape == y.shape
    assert _rel(loss, ref_loss) <= tol
    assert _rel(lse, ref_lse) <= tol
    out = (y < 0) | (y >= w.shape[1])
    assert torch.equal(loss[out], lse[out])
    # the backward from the plain lse, so only the backward is compared
    ref_dx, ref_dw = tce.fused_ce_bwd_ref(x, w, y, ref_lse, g)
    dx = tce.ce_dx(x, w, y, ref_lse.float(), g)
    dw = tce.ce_dw(x, w, y, ref_lse.float(), g)
    tol = tce.oracle_tol(dtype, "grad")
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert _rel(dx, ref_dx) <= tol
    assert _rel(dw, ref_dw) <= tol
    assert torch.equal(dx[g == 0], torch.zeros_like(dx[g == 0]))


def test_ce_autograd_goes_through_the_three_kernels():
    """The head's entry point on the card: leading dims, int64 labels cast
    once, the same loss and gradients as the plain versions, one launch of
    each kernel."""
    _need_card()
    x, w, y, g = _ce_case(300, 128, 700, torch.float32, seed=3)
    x3 = x.reshape(3, 100, 128).clone().requires_grad_()
    w = w.clone().requires_grad_()
    y3 = y.long().reshape(3, 100)
    before = (tce.ce_fwd.launches, tce.ce_dx.launches, tce.ce_dw.launches)
    loss = tce.fused_softmax_ce_head(x3, w, y3)
    loss.backward(g.reshape(3, 100))
    torch.cuda.synchronize()
    assert (tce.ce_fwd.launches, tce.ce_dx.launches, tce.ce_dw.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    ref_loss, ref_lse = tce.fused_ce_ref(x, w.detach(), y)
    ref_dx, ref_dw = tce.fused_ce_bwd_ref(x, w.detach(), y, ref_lse, g)
    assert loss.shape == (3, 100)
    assert _rel(loss.reshape(-1), ref_loss) <= 2e-4
    assert _rel(x3.grad.reshape(300, 128), ref_dx) <= 1e-3
    assert _rel(w.grad, ref_dw) <= 1e-3


def test_ce_wrapper_checks_before_launching():
    _need_card()
    x, w, y, g = _ce_case(64, 32, 100, torch.float32)
    before = tce.ce_fwd.launches
    with pytest.raises(TypeError):
        tce.ce_fwd(x.half(), w.half(), y)               # dtype
    with pytest.raises(TypeError):
        tce.ce_fwd(x, w, y.long())                      # int64 labels
    with pytest.raises(ValueError):
        tce.ce_fwd(x, w.cpu(), y)                       # device
    with pytest.raises(ValueError):
        tce.ce_fwd(x, w.T.contiguous().T, y)            # contiguity
    with pytest.raises(ValueError):
        wide = torch.zeros(4, 800, device="cuda")
        tce.ce_fwd(wide, torch.zeros(800, 8, device="cuda"), y[:4])
    assert tce.ce_fwd.launches == before


def test_fused_head_executor_on_the_card_matches_the_cpu():
    """Three Adam steps of a tiny f32 fused-head GPT on the card, from the
    state the CPU run starts from: the same losses within 1e-4 relative,
    each CE kernel launched once a step."""
    _need_card()
    import paddle_tpu_torch as pt

    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=61, n_layer=2, n_head=2, d_model=128, max_len=48,
            dropout_rate=0.0, dtype="float32", learning_rate=2e-3,
            fused_head=True)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    state = {v.name: cpu_scope.numpy(v.name)
             for v in main.persistable_vars()}
    card_scope = pt.load_numpy_state(pt.Scope(), state)
    card = pt.Executor(pt.CUDAPlace(0))
    rng = np.random.default_rng(0)
    before = (tce.ce_fwd.launches, tce.ce_dx.launches, tce.ce_dw.launches)
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
    assert (tce.ce_fwd.launches - before[0], tce.ce_dx.launches - before[1],
            tce.ce_dw.launches - before[2]) == (3, 3, 3)


# -- decode gather -------------------------------------------------------------

from paddle_tpu_torch.kernels import decode_gather as tdg  # noqa: E402


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [(32, 16, 32, 6, 128, 0), (1, 16, 32, 6, 128, 0),
                                  (7, 9, 5, 3, 21, 0), (7, 9, 5, 3, 21, 1),
                                  (3, 4, 1, 1, 3, 1)],
                         ids=["decode", "prefill", "ragged", "ragged_offset",
                              "odd_bytes"])
def test_decode_gather_bit_exact(dtype, geom):
    """Bit-exact against the plain version, with repeated and trash (0)
    table entries, block byte counts that are no multiple of 16 and a
    pool whose base address moves by one block."""
    _need_card()
    S, NB, B, H, DH, off = geom
    rng = np.random.default_rng(S * NB + B)
    nblk = 2 * S * NB + 1
    pool = torch.tensor(rng.standard_normal((nblk + off, B, H, DH)),
                        dtype=torch.float32, device="cuda").to(
        getattr(torch, dtype))[off:]
    table = rng.integers(0, nblk, (S, NB)).astype(np.int32)
    table[:, -1] = 0
    table[S // 2:, 0] = table[0, 0]
    table = torch.tensor(table, device="cuda")
    before = tdg.decode_gather.launches
    got = tdg.decode_gather(pool, table)
    torch.cuda.synchronize()
    assert tdg.decode_gather.launches == before + 1
    assert torch.equal(got, tdg.decode_gather_ref(pool, table))


def test_decode_gather_wrapper_checks_before_launching():
    _need_card()
    pool = torch.zeros((5, 4, 2, 8), device="cuda")
    table = torch.zeros((2, 3), dtype=torch.int32, device="cuda")
    before = tdg.decode_gather.launches
    with pytest.raises(TypeError):
        tdg.decode_gather(pool.half(), table)
    with pytest.raises(TypeError):
        tdg.decode_gather(pool, table.long())
    with pytest.raises(ValueError):
        tdg.decode_gather(pool, table.cpu())
    with pytest.raises(ValueError):
        tdg.decode_gather(pool[:, :, :, ::2], table)
    assert tdg.decode_gather.launches == before


@pytest.mark.parametrize("switch", ["1", "0"])
def test_spec_engine_on_the_card_matches_the_cpu(monkeypatch, switch):
    """A tiny speculative f32 engine on the card gives the CPU's tokens
    in both spellings, through the kernel of its spelling only."""
    _need_card()
    from paddle_tpu_torch.serving import ServingEngine, depth_draft

    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", switch)
    rng = np.random.default_rng(1)
    V, L, H, D, T = 64, 2, 2, 64, 48
    p = _tiny_model(rng)
    prompts = [rng.integers(1, V, n) for n in (5, 9, 3)]
    geom = dict(max_len=T, max_slots=2, decode_chunk=4, min_bucket=4,
                block_tokens=4, draft_params=depth_draft(p, 1), spec_k=3)
    want = ServingEngine(p, L, H, D, device="cpu", **geom).generate_many(
        prompts, max_new_tokens=12)
    eng = ServingEngine(p, L, H, D, **geom)
    pa0, dg0 = tpa.paged_attention.launches, tdg.decode_gather.launches
    got = eng.generate_many(prompts, max_new_tokens=12)
    used, unused = ((tpa.paged_attention.launches - pa0,
                     tdg.decode_gather.launches - dg0) if switch == "1" else
                    (tdg.decode_gather.launches - dg0,
                     tpa.paged_attention.launches - pa0))
    assert used > 0 and unused == 0
    assert eng._spec.proposed > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the fused bottleneck (kernels/bottleneck.py) -----------------------------

from paddle_tpu_torch.kernels import bottleneck as tbn  # noqa: E402

BOTTLENECK_GEOMS = {            # N, H, W, C, Cm
    "small": (2, 16, 16, 32, 8),
    "ragged_h_wide_cm": (3, 13, 11, 48, 72),
    "odd_channels": (2, 9, 7, 36, 12),
    "stage1": (4, 56, 56, 256, 64),
}


def _bottleneck_case(n, h, w, c, cm, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, scale, shift=0.0, dt=dtype):
        a = rng.normal(size=shape) * scale + shift
        return torch.tensor(a, dtype=torch.float32, device="cuda").to(dt)

    return (t((n, h, w, c), 0.5), t((c, cm), 0.05), t((3, 3, cm, cm), 0.05),
            t((cm, c), 0.05)) + tuple(
        t((k,), 0.1, 1.0, torch.float32) for k in (cm, cm, cm, cm, c, c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(BOTTLENECK_GEOMS))
def test_bottleneck_matches_plain_version(dtype, geom):
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    args = _bottleneck_case(*BOTTLENECK_GEOMS[geom], getattr(torch, dtype))
    before = tbn.bottleneck.launches
    got = tbn.bottleneck(*args)
    torch.cuda.synchronize()
    assert tbn.bottleneck.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert torch.isfinite(got.float()).all()
    assert tbn.uses_tensor_cores(*args[:4], got) == (
        dtype == "bfloat16" and geom != "odd_channels")
    assert _rel(got, tbn.bottleneck_ref(*args)) <= tbn.oracle_tol(
        getattr(torch, dtype))


def test_bottleneck_band_height_and_wrapper_checks():
    _need_card()
    assert tbn.band_rows(56, 56, 64, torch.bfloat16, True) == 8
    assert tbn.band_rows(3, 56, 64, torch.bfloat16, True) == 3
    assert 1 <= tbn.band_rows(56, 56, 64, torch.float32) <= 8
    assert tbn.band_rows(4, 4096, 512, torch.float32) == 0
    # a tensor one element off 16-byte alignment takes the FMA spelling
    args = _bottleneck_case(2, 8, 8, 16, 8, torch.bfloat16)
    x_off = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16,
                        device="cuda")[1:].view(args[0].shape)
    x_off.copy_(args[0])
    out = tbn.bottleneck(x_off, *args[1:])
    assert not tbn.uses_tensor_cores(x_off, *args[1:4], out)
    assert _rel(out, tbn.bottleneck(*args)) <= tbn.oracle_tol(torch.bfloat16)
    before = tbn.bottleneck.launches
    with pytest.raises(TypeError, match="not supported on the card"):
        tbn.bottleneck(*(a.half() if i < 4 else a
                         for i, a in enumerate(args)))
    with pytest.raises(ValueError, match="contiguous"):
        tbn.bottleneck(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="share a device"):
        tbn.bottleneck(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError, match="does not fit"):
        big = _bottleneck_case(1, 2, 4096, 16, 512, torch.float32)
        tbn.bottleneck(*big)
    assert tbn.bottleneck.launches == before


def test_resnet_executor_on_the_card_matches_the_cpu():
    """Two Momentum steps of the f32 CIFAR ResNet (depth 8) on the card
    (cuDNN, TF32 off) against the CPU from one state: losses within 1e-4
    relative, parameters within 1e-4 of their largest magnitude."""
    _need_card()
    import paddle_tpu_torch as tpt

    torch.backends.cudnn.allow_tf32 = False
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        out = tpt.models.resnet.build(depth=8, class_dim=10,
                                      image_shape=(3, 16, 16),
                                      dtype="float32", learning_rate=1e-3)
    base = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=base)
    rng = np.random.default_rng(0)
    feeds = [{"img": rng.normal(size=(8, 3, 16, 16)).astype(np.float32),
              "label": rng.integers(0, 10, (8, 1))} for _ in range(2)]
    runs = {}
    for dev in ("cpu", "cuda"):
        scope = tpt.Scope()
        for n in base.var_names():
            if n != "@RNG@":
                scope.set(n, base.get(n).clone().to(dev))
        exe = tpt.Executor(dev)
        losses = [exe.run(main, feed=f, fetch_list=[out["avg_cost"]],
                          scope=scope)[0][0] for f in feeds]
        runs[dev] = (losses, {p.name: scope.numpy(p.name)
                              for p in main.all_parameters()})
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        assert abs(a - b) <= 1e-4 * abs(b)
    for name, want in runs["cpu"][1].items():
        got = runs["cuda"][1][name]
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name


def test_selective_remat_runs_on_the_card(monkeypatch):
    """The selective checkpointing API of the card's torch: a 2-layer GPT
    step with dropout under ``memory_optimize("selective")`` gives the
    loss of the step without remat, and holds fewer bytes on the card when
    the backward starts."""
    _need_card()
    import paddle_tpu_torch as tpt

    held = []
    real_grad = torch.autograd.grad

    def grad(*a, **kw):
        held.append(torch.cuda.memory_allocated())
        return real_grad(*a, **kw)

    monkeypatch.setattr(torch.autograd, "grad", grad)

    def step(policy):
        tpt.core.unique_name.reset()
        main, startup = tpt.Program(), tpt.Program()
        main.random_seed = startup.random_seed = 1
        with tpt.program_guard(main, startup):
            out = tpt.models.transformer.build(
                vocab_size=64, n_layer=2, n_head=2, d_model=256, max_len=256,
                dropout_rate=0.1, dtype="float32", learning_rate=1e-3)
        if policy:
            tpt.memory_optimize(main, policy=policy)
        exe, scope = tpt.Executor("cuda"), tpt.Scope()
        exe.run(startup, scope=scope)
        toks = torch.arange(4 * 256, device="cuda").reshape(4, 256) % 64
        feed = {"tokens": toks, "labels": (toks + 1) % 64}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        loss = exe.run(main, feed=feed, fetch_list=[out["avg_cost"]],
                       scope=scope)[0][0]
        return loss, held[-1] - base

    plain, selective = step(None), step("selective")
    assert selective[0] == plain[0]
    assert 0 < selective[1] < plain[1]
