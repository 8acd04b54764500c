"""The port's CUDA kernels on the card (paged attention on both kernel
families, decode gather, flash attention forward, fused backward and split
backward (dq, dk/dv), each on the simple family and the sm90 one (the
backwards with its delta pre-pass; the simple family alone past d_head
128), the fused cross-entropy head's forward, dx and dW on both families
(the simple one alone past d = 768), the fused ResNet bottleneck on both),
against their plain PyTorch versions; and the recurrent path's ops
(``lstm``, ``gru``, the stacked-LSTM classifier's training), which run on
ATen, against the CPU (paddle_tpu_torch only: no jax, so these run on a
host without it).  Every test needs an NVIDIA GPU and skips
without one; on the card:

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


@pytest.mark.parametrize("dh,family", [(32, "split"), (100, "simple")])
def test_kernel_never_reads_past_pos(dh, family):
    """Non-finite garbage in the trash block and past each position stays
    out of the output: each kernel family skips those keys rather than
    weighting them by zero."""
    _need_card()
    q, pk, pv, table, pos = _case(4, 2, 2, dh, 4, 6, torch.float32, seed=3)
    before = dict(tpa.PAGED_FAMILY_CALLS)
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
    assert tpa.PAGED_FAMILY_CALLS[family] == before[family] + 2


# the serving paths' shapes, all on the split family: decode and prefill
# (phase 5), a 4-token window, the speculative verify window (phase 5c)
PAGED_SPLIT_GEOMS = {"decode": (32, 1, 6, 128, 32, 16),
                     "prefill": (1, 1, 6, 128, 32, 16),
                     "window": (32, 4, 6, 128, 32, 16),
                     "verify": (32, 6, 8, 32, 32, 16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(PAGED_SPLIT_GEOMS))
def test_split_kernel_matches_plain_versions(dtype, geom):
    """The split family against the plain block scan and the plain
    split-and-merge spelling, and the same bits from run to run."""
    _need_card()
    S, W, H, DH, B, NB = PAGED_SPLIT_GEOMS[geom]
    args = _case(S, W, H, DH, B, NB, getattr(torch, dtype), seed=7)
    before = dict(tpa.PAGED_FAMILY_CALLS)
    got = tpa.paged_attention(*args)
    again = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.PAGED_FAMILY_CALLS == {"split": before["split"] + 2,
                                      "simple": before["simple"]}
    assert torch.equal(got, again)
    tol = tpa.oracle_tol(dtype)
    assert _rel(got, tpa.paged_attention_ref(*args)) <= tol
    splits, _ = tpa.paged_splits(S, H, NB)
    assert _rel(got, tpa.paged_attention_split_ref(*args, splits)) <= tol


def test_split_kernel_rows_without_keys_are_zero():
    """``pos = -1`` attends nothing: a whole slot, and one row of a window
    whose other rows are live."""
    _need_card()
    q, pk, pv, table, pos = _case(4, 3, 2, 32, 4, 6, torch.float32, seed=5)
    pos[1] = -1
    pos[2, 0] = -1
    got = tpa.paged_attention(q, pk, pv, table, pos)
    torch.cuda.synchronize()
    assert not got[1].any() and not got[2, 0].any()
    splits, _ = tpa.paged_splits(4, 2, 6)
    want = tpa.paged_attention_split_ref(q, pk, pv, table, pos, splits)
    assert _rel(got, want) <= tpa.oracle_tol("float32")


def test_split_launch_refuses_what_it_does_not_take(monkeypatch):
    """A call the split kernels cannot take, forced onto them, raises: the
    wrapper never falls back to another kernel or the plain version."""
    _need_card()
    args = _case(2, 1, 2, 100, 4, 3, torch.float32)
    monkeypatch.setattr(tpa, "paged_family", lambda *a: "split")
    before = tpa.paged_attention.launches
    with pytest.raises(RuntimeError):
        tpa.paged_attention(*args)
    assert tpa.paged_attention.launches == before


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


def _rule_family(dtype, geom):
    """The family the static rule gives FLASH_GEOMS' inputs: sm90 for bf16
    that TMA can address; ragged_d100's 300-element time stride and f32
    take the simple kernels."""
    return ("sm90" if dtype in ("bfloat16", torch.bfloat16)
            and geom != "ragged_d100" else "simple")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(FLASH_GEOMS))
def test_flash_forward_matches_plain_version(dtype, geom, causal):
    _need_card()
    q, k, v, _, _ = _flash_case(*FLASH_GEOMS[geom], getattr(torch, dtype))
    before = tfa.flash_fwd.launches
    family = _rule_family(dtype, geom)
    c0 = dict(tfa.FWD_FAMILY_CALLS)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.flash_fwd.launches == before + 1
    assert tfa.FWD_FAMILY_CALLS[family] == c0[family] + 1
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
    family = _rule_family(dtype, geom)
    c0 = (dict(tfa.FUSED_FAMILY_CALLS), tfa.flash_bwd_delta.launches)
    got = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert tfa.flash_bwd.launches == before + 1
    assert tfa.FUSED_FAMILY_CALLS[family] == c0[0][family] + 1
    assert tfa.flash_bwd_delta.launches == c0[1] + (family == "sm90")
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
    plain version, on the family the rule picks (sm90 for bf16 that TMA
    can address; ragged_d100's 300-element time stride and f32 take the
    simple kernels); the same bits run to run; dk and dv the fused
    kernel's bits (the fused route takes the same family, and each family's
    fused and dk/dv kernels share one k-major body)."""
    _need_card()
    q, k, v, do, dlse = _flash_case(*FLASH_GEOMS[geom], getattr(torch, dtype),
                                    seed=5)
    dlse = dlse if with_dlse else None
    o, lse = tfa.flash_attention_ref(q, k, v, causal)
    fused = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    family = _rule_family(dtype, geom)
    before = (tfa.flash_bwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches, tfa.flash_bwd_delta.launches,
              dict(tfa.BWD_FAMILY_CALLS))
    got = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    again = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    pre = 2 if family == "sm90" else 0
    assert (tfa.flash_bwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches, tfa.flash_bwd_delta.launches) == (
        before[0], before[1] + 2, before[2] + 2, before[3] + pre)
    assert tfa.BWD_FAMILY_CALLS[family] == before[4][family] + 4
    assert sum(tfa.BWD_FAMILY_CALLS.values()) == sum(before[4].values()) + 4
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal)
    tol = tfa.oracle_tol(dtype, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        assert _rel(g, w) <= tol, name
    assert torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel(got[0], fused[0]) <= tol


# the sm90 split family's geometries: FLASH_GEOMS' bf16 cases that TMA can
# address, and ragged t that is no multiple of 64 or 128 at d=128
SM90_GEOMS = {nm: g for nm, g in FLASH_GEOMS.items() if nm != "ragged_d100"}
SM90_GEOMS.update({"ragged_t1000": (1, 1000, 1000, 2, 128),
                   "ragged_t77": (1, 77, 77, 2, 128),
                   "tk_gt_tq": (1, 128, 320, 2, 64)})


@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", list(SM90_GEOMS))
def test_flash_sm90_split_matches_plain_version(geom, causal, with_dlse,
                                                monkeypatch):
    """The sm90 pre-pass, dq and dk/dv kernels (csrc/flash_bwd_sm90.cu)
    within ORACLE_TOL of the plain version, bit-identical run to run; the
    wrappers called without delta launch the pre-pass themselves and give
    the same bits; the pre-pass within 1e-5 of its plain version."""
    _need_card()
    q, k, v, do, dlse = _flash_case(*SM90_GEOMS[geom], torch.bfloat16, seed=7)
    dlse = dlse if with_dlse else None
    o, lse = tfa.flash_attention_ref(q, k, v, causal)
    assert tfa._family(q, k, v, o, do) == "sm90"
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    c0 = (tfa.flash_bwd_delta.launches, tfa.BWD_FAMILY_CALLS["sm90"])
    got = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    again = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_bwd_delta.launches, tfa.BWD_FAMILY_CALLS["sm90"]) == (
        c0[0] + 2, c0[1] + 4)
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal)
    tol = tfa.oracle_tol(torch.bfloat16, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all()) and _rel(g, w) <= tol, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    d0 = tfa.flash_bwd_delta.launches
    dq = tfa.flash_bwd_dq(q, k, v, o, lse, do, dlse, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert tfa.flash_bwd_delta.launches == d0 + 2
    assert torch.equal(dq, got[0]) and torch.equal(dk, got[1])
    assert torch.equal(dv, got[2])
    delta = tfa.flash_bwd_delta(o, do, dlse)
    assert _rel(delta, tfa.flash_bwd_delta_ref(o, do, dlse)) <= 1e-5


@pytest.mark.parametrize("geom", [(2, 130, 3, 128), (1, 77, 2, 64)],
                         ids=["d128", "ragged_d64"])
def test_flash_bwd_delta_kernel_matches_plain_version(geom):
    """The pre-pass within 1e-5 of its plain version, with and without
    dlse; inputs the sm90 family does not take (f32, bf16 d=100: rows no
    multiple of 16 bytes) raise before any launch."""
    _need_card()
    b, t, h, d = geom
    _, _, _, do, dlse = _flash_case(b, t, t, h, d, torch.bfloat16, seed=9)
    o = _flash_case(b, t, t, h, d, torch.bfloat16, seed=10)[0]
    for dl in (None, dlse):
        before = tfa.flash_bwd_delta.launches
        got = tfa.flash_bwd_delta(o, do, dl)
        torch.cuda.synchronize()
        assert tfa.flash_bwd_delta.launches == before + 1
        assert got.shape == (b * h, t) and got.dtype == torch.float32
        assert _rel(got, tfa.flash_bwd_delta_ref(o, do, dl)) <= 1e-5
    before = tfa.flash_bwd_delta.launches
    for dtype, d_ in ((torch.float32, d), (torch.bfloat16, 100)):
        x = _flash_case(1, 8, 8, 3, d_, dtype)[0]
        with pytest.raises(ValueError):
            tfa.flash_bwd_delta(x, x)
    assert tfa.flash_bwd_delta.launches == before


@pytest.mark.parametrize("h,d", [(1, 128), (2, 64)],
                         ids=["packed_d128", "packed_d64_paired"])
def test_flash_sm90_packed_autograd(h, d, monkeypatch):
    """The packed [b, t, h*d] entry point on the split route: one head a
    128-lane slice (d=128) and two (d=64), read in place by the tensor
    maps; gradients within the bf16 grad tolerance, every split kernel on
    the sm90 family."""
    _need_card()
    b, t = 2, 320
    q, k, v, do, _ = _flash_case(b, t, t, h, d, torch.bfloat16, seed=8)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    flat = [x.reshape(b, t, h * d).clone().requires_grad_() for x in (q, k, v)]
    c0 = dict(tfa.BWD_FAMILY_CALLS)
    out = tfa.flash_attention_packed(*flat, n_head=h, causal=True)
    out.backward(do.reshape(b, t, h * d))
    torch.cuda.synchronize()
    assert tfa.BWD_FAMILY_CALLS == {"sm90": c0["sm90"] + 2,
                                    "simple": c0["simple"]}
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, True)
    want = tfa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, None, True)
    for x, w in zip(flat, want):
        assert _rel(x.grad, w.reshape(b, t, h * d)) <= tfa.oracle_tol(
            torch.bfloat16, "grad")


# the sm90 forward and fused backward's geometries: FLASH_GEOMS' bf16 cases
# that TMA can address (t_q > t_k, three rows in one partial tile, d=16
# padded to 64 by the box's zero fill)
SM90_FLASH_GEOMS = [nm for nm in FLASH_GEOMS if nm != "ragged_d100"]


def _forced_simple(monkeypatch):
    """The simple family forced for inputs the rule sends to sm90."""
    monkeypatch.setattr(tfa, "bwd_family", lambda *a, **kw: "simple")


@pytest.mark.parametrize("family", ["sm90", "simple"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", SM90_FLASH_GEOMS)
def test_flash_forward_families_match_plain_version(geom, causal, family,
                                                    monkeypatch):
    """The forward of either family on bf16 inputs the rule sends to sm90
    (the simple one forced): o and lse within ORACLE_TOL of the plain
    version (lse holds the natural log: the exp2-domain state converted),
    one launch on the named family, finite everywhere."""
    _need_card()
    q, k, v, _, _ = _flash_case(*FLASH_GEOMS[geom], torch.bfloat16, seed=11)
    if family == "simple":
        _forced_simple(monkeypatch)
    c0 = dict(tfa.FWD_FAMILY_CALLS)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.FWD_FAMILY_CALLS == {**c0, family: c0[family] + 1}
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal)
    tol = tfa.oracle_tol(torch.bfloat16, "fwd")
    assert bool(torch.isfinite(o.float()).all())
    assert _rel(o, o_ref) <= tol and _rel(lse, lse_ref) <= tol


@pytest.mark.parametrize("family", ["sm90", "simple"])
@pytest.mark.parametrize("with_dlse", [False, True], ids=["do", "do_dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", SM90_FLASH_GEOMS)
def test_flash_fused_families_match_plain_version(geom, causal, with_dlse,
                                                  family, monkeypatch):
    """The fused route of either family (sm90 by the rule, simple forced)
    within ORACLE_TOL of the plain version, with and without dlse; the
    sm90 one launches the pre-pass once and its dk, dv are the same bits
    run to run (dq only to f32 rounding: atomics)."""
    _need_card()
    q, k, v, do, dlse = _flash_case(*FLASH_GEOMS[geom], torch.bfloat16,
                                    seed=12)
    dlse = dlse if with_dlse else None
    o, lse = tfa.flash_attention_ref(q, k, v, causal)
    if family == "simple":
        _forced_simple(monkeypatch)
    c0 = (dict(tfa.FUSED_FAMILY_CALLS), tfa.flash_bwd_delta.launches)
    got = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    again = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert tfa.FUSED_FAMILY_CALLS == {**c0[0], family: c0[0][family] + 2}
    assert tfa.flash_bwd_delta.launches == c0[1] + 2 * (family == "sm90")
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal)
    tol = tfa.oracle_tol(torch.bfloat16, "grad")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g.float()).all()) and _rel(g, w) <= tol, name
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    assert _rel(got[0], again[0]) <= 2.0 ** -8


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", SM90_FLASH_GEOMS)
def test_flash_fused_sm90_dk_dv_are_the_split_bits(geom, causal,
                                                   monkeypatch):
    """The fused sm90 kernel and the split sm90 dk/dv kernel are one k-major
    body: the same dk and dv bits; dq within bf16 rounding of the split
    dq kernel's."""
    _need_card()
    q, k, v, do, dlse = _flash_case(*FLASH_GEOMS[geom], torch.bfloat16,
                                    seed=13)
    o, lse = tfa.flash_attention_ref(q, k, v, causal)
    c0 = dict(tfa.FUSED_FAMILY_CALLS)
    fused = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    assert tfa.FUSED_FAMILY_CALLS["sm90"] == c0["sm90"] + 1
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    b0 = tfa.BWD_FAMILY_CALLS["sm90"]
    split = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert tfa.BWD_FAMILY_CALLS["sm90"] == b0 + 2
    assert torch.equal(fused[1], split[1]) and torch.equal(fused[2], split[2])
    assert _rel(fused[0], split[0]) <= 2.0 ** -7


@pytest.mark.parametrize("h,d", [(1, 128), (2, 64)],
                         ids=["packed_d128", "packed_d64_paired"])
def test_flash_sm90_forward_and_fused_packed_autograd(h, d):
    """The packed [b, t, h*d] entry point on the default (fused) route: the
    sm90 forward and the fused sm90 backward read the projections in place;
    one launch of each on the sm90 family, one pre-pass; values within the
    bf16 tolerances of the plain versions."""
    _need_card()
    b, t = 2, 320
    q, k, v, do, _ = _flash_case(b, t, t, h, d, torch.bfloat16, seed=14)
    flat = [x.reshape(b, t, h * d).clone().requires_grad_() for x in (q, k, v)]
    c0 = (dict(tfa.FWD_FAMILY_CALLS), dict(tfa.FUSED_FAMILY_CALLS),
          tfa.flash_bwd_delta.launches)
    out = tfa.flash_attention_packed(*flat, n_head=h, causal=True)
    out.backward(do.reshape(b, t, h * d))
    torch.cuda.synchronize()
    assert tfa.FWD_FAMILY_CALLS == {"sm90": c0[0]["sm90"] + 1,
                                    "simple": c0[0]["simple"]}
    assert tfa.FUSED_FAMILY_CALLS == {"sm90": c0[1]["sm90"] + 1,
                                      "simple": c0[1]["simple"]}
    assert tfa.flash_bwd_delta.launches == c0[2] + 1
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, True)
    want = tfa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, None, True)
    assert _rel(out, o_ref.reshape(b, t, h * d)) <= tfa.oracle_tol(
        torch.bfloat16, "fwd")
    for x, w in zip(flat, want):
        assert _rel(x.grad, w.reshape(b, t, h * d)) <= tfa.oracle_tol(
            torch.bfloat16, "grad")


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
        wide = torch.zeros(1, 8, 1, 257, device="cuda")
        tfa.flash_fwd(wide, wide, wide)
    assert tfa.flash_fwd.launches == before


# head widths past the sm90 family's 128: the simple family takes them to
# 256 (the forward on 32 query rows in f32, the backwards on 32-key tiles)
WIDE_FLASH_GEOMS = {"d192": (1, 130, 130, 2, 192),    # b, t_q, t_k, h, d
                    "d256": (2, 200, 200, 2, 256)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(WIDE_FLASH_GEOMS))
def test_flash_wide_heads_match_plain_version(dtype, geom, causal,
                                              monkeypatch):
    """The forward, the fused backward and the split pair at d_head 192
    and 256 on the simple family (by the rule and the counters) against
    the plain version, with an lse cotangent."""
    _need_card()
    dt = getattr(torch, dtype)
    q, k, v, do, dlse = _flash_case(*WIDE_FLASH_GEOMS[geom], dt)
    c0 = (dict(tfa.FWD_FAMILY_CALLS), dict(tfa.FUSED_FAMILY_CALLS),
          dict(tfa.BWD_FAMILY_CALLS))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    fused = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    split = tfa.flash_bwd(q, k, v, o, lse, do, dlse, causal)
    torch.cuda.synchronize()
    assert tfa.FWD_FAMILY_CALLS == {"sm90": c0[0]["sm90"],
                                    "simple": c0[0]["simple"] + 1}
    assert tfa.FUSED_FAMILY_CALLS == {"sm90": c0[1]["sm90"],
                                      "simple": c0[1]["simple"] + 1}
    assert tfa.BWD_FAMILY_CALLS == {"sm90": c0[2]["sm90"],
                                    "simple": c0[2]["simple"] + 2}
    o_ref, lse_ref = tfa.flash_attention_ref(q, k, v, causal)
    assert _rel(o, o_ref) <= tfa.oracle_tol(dtype, "fwd")
    assert _rel(lse, lse_ref) <= tfa.oracle_tol(dtype, "fwd")
    want = tfa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal)
    for route, got in (("fused", fused), ("split", split)):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel(g, w) <= tfa.oracle_tol(dtype, "grad"), (route, name)
    # the split route's dk and dv are the fused kernel's bits (one body)
    assert torch.equal(split[1], fused[1]) and torch.equal(split[2], fused[2])


@pytest.mark.parametrize("kernel", ["forward", "fused", "split"])
def test_flash_sm90_refuses_wide_heads(kernel, monkeypatch):
    """bf16 at d_head 256 forced onto the sm90 family raises and counts
    nothing: that family takes d_head <= 128."""
    _need_card()
    q, k, v, do, _ = _flash_case(1, 64, 64, 2, 256, torch.bfloat16)
    o, lse = tfa.flash_attention_ref(q, k, v, True)
    monkeypatch.setattr(tfa, "bwd_family", lambda *a, **kw: "sm90")
    if kernel == "split":
        monkeypatch.setattr(tfa, "FUSED_BWD_PARTIAL_BYTES", 0)
    tables = (tfa.FWD_FAMILY_CALLS, tfa.FUSED_FAMILY_CALLS,
              tfa.BWD_FAMILY_CALLS)
    before = [dict(t) for t in tables] + [tfa.flash_fwd.launches,
                                          tfa.flash_bwd.launches]
    with pytest.raises((RuntimeError, ValueError)):
        if kernel == "forward":
            tfa.flash_fwd(q, k, v, True)
        else:
            tfa.flash_bwd(q, k, v, o, lse.float(), do, None, True)
    assert [dict(t) for t in tables] + [
        tfa.flash_fwd.launches, tfa.flash_bwd.launches] == before


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
    family = tce.ce_family(x.dtype, x.shape[1], w.shape[1],
                           [t.data_ptr() for t in (x, w, y, ref_lse, g)])
    fam = dict(tce.CE_DW_FAMILY_CALLS)
    dx = tce.ce_dx(x, w, y, ref_lse.float(), g)
    dw = tce.ce_dw(x, w, y, ref_lse.float(), g)
    assert tce.CE_DW_FAMILY_CALLS[family] == fam[family] + 1
    tol = tce.oracle_tol(dtype, "grad")
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert _rel(dx, ref_dx) <= tol
    assert _rel(dw, ref_dw) <= tol
    assert torch.equal(dx[g == 0], torch.zeros_like(dx[g == 0]))


# the training path's shape (phase 7: b=8, t=4096) and the ragged one
CE_DW_SM90_GEOMS = {"path": (32768, 768, 32768), "ragged": (1000, 200, 5000)}


@pytest.mark.parametrize("geom", list(CE_DW_SM90_GEOMS))
def test_ce_dw_sm90_matches_plain_and_repeats_its_bits(geom):
    """The sm90 dW kernel (a cluster of d slices at the path shape, one
    block at the ragged one) against the plain version, and bit-identical
    over two launches (no atomics)."""
    _need_card()
    n, d, v = CE_DW_SM90_GEOMS[geom]
    x, w, y, g = _ce_case(n, d, v, torch.bfloat16, seed=11)
    _, lse = tce.fused_ce_ref(x, w, y)
    lse = lse.float()
    fam = dict(tce.CE_DW_FAMILY_CALLS)
    got = tce.ce_dw(x, w, y, lse, g)
    again = tce.ce_dw(x, w, y, lse, g)
    torch.cuda.synchronize()
    assert tce.CE_DW_FAMILY_CALLS == {"sm90": fam["sm90"] + 2,
                                      "simple": fam["simple"]}
    assert torch.equal(got, again)
    ref = tce.fused_ce_dw_ref(x, w, y, lse, g)
    assert _rel(got, ref) <= tce.oracle_tol("bfloat16", "grad")


def test_ce_dw_sm90_refuses_what_it_does_not_take(monkeypatch):
    """An input the sm90 kernel cannot take (d = 61 is no multiple of 8),
    forced onto it, raises: no fallback to the simple kernel."""
    _need_card()
    x, w, y, g = _ce_case(77, 61, 333, torch.bfloat16)
    _, lse = tce.fused_ce_ref(x, w, y)
    monkeypatch.setattr(tce, "ce_family", lambda *a: "sm90")
    before = tce.ce_dw.launches
    with pytest.raises(RuntimeError):
        tce.ce_dw(x, w, y, lse.float(), g)
    assert tce.ce_dw.launches == before


# the sm90 forward and dx: the training path's shape, the ragged one, a
# wide head with few rows and V no tile divides, and the 192-column half
CE_FWD_DX_SM90_GEOMS = {"path": (32768, 768, 32768),
                        "ragged": (1000, 200, 5000),
                        "d768": (130, 768, 2096),
                        "d384": (300, 384, 1000)}


@pytest.mark.parametrize("geom", list(CE_FWD_DX_SM90_GEOMS))
def test_ce_fwd_dx_sm90_match_plain_and_repeat_their_bits(geom):
    """The sm90 forward and dx kernels against the plain versions (the
    forward's loss and lse, dx from the plain lse), on the sm90 family by
    its counters, and bit-identical over two launches (no atomics)."""
    _need_card()
    n, d, v = CE_FWD_DX_SM90_GEOMS[geom]
    x, w, y, g = _ce_case(n, d, v, torch.bfloat16, seed=13)
    fams = (dict(tce.CE_FWD_FAMILY_CALLS), dict(tce.CE_DX_FAMILY_CALLS))
    loss, lse = tce.ce_fwd(x, w, y)
    loss2, lse2 = tce.ce_fwd(x, w, y)
    chunk = 4096
    refs = [tce.fused_ce_ref(x[i:i + chunk], w, y[i:i + chunk])
            for i in range(0, n, chunk)]
    ref_loss = torch.cat([r[0] for r in refs])
    ref_lse = torch.cat([r[1] for r in refs])
    del refs
    dx = tce.ce_dx(x, w, y, ref_lse, g)
    dx2 = tce.ce_dx(x, w, y, ref_lse, g)
    torch.cuda.synchronize()
    assert tce.CE_FWD_FAMILY_CALLS == {"sm90": fams[0]["sm90"] + 2,
                                       "simple": fams[0]["simple"]}
    assert tce.CE_DX_FAMILY_CALLS == {"sm90": fams[1]["sm90"] + 2,
                                      "simple": fams[1]["simple"]}
    assert torch.equal(loss, loss2) and torch.equal(lse, lse2)
    assert torch.equal(dx, dx2)
    tol = tce.oracle_tol("bfloat16", "fwd")
    assert _rel(loss, ref_loss) <= tol and _rel(lse, ref_lse) <= tol
    out = (y < 0) | (y >= v)
    assert torch.equal(loss[out], lse[out])
    ref_dx = torch.cat([tce.fused_ce_dx_ref(
        x[i:i + chunk], w, y[i:i + chunk], ref_lse[i:i + chunk],
        g[i:i + chunk]) for i in range(0, n, chunk)])
    assert _rel(dx, ref_dx) <= tce.oracle_tol("bfloat16", "grad")
    assert torch.equal(dx[g == 0], torch.zeros_like(dx[g == 0]))


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("kernel", ["forward", "dx", "dW"])
@pytest.mark.parametrize("what", ["odd_d", "f32", "misaligned"])
def test_ce_sm90_refuses_what_it_does_not_take(monkeypatch, kernel, what):
    """An input the sm90 kernels cannot take (d = 61 is no multiple of 8,
    f32, an x that starts off a 16-byte boundary), forced onto them,
    raises: no fallback to the simple family, no launch counted."""
    _need_card()
    d = 61 if what == "odd_d" else 64
    dtype = torch.float32 if what == "f32" else torch.bfloat16
    x, w, y, g = _ce_case(77, d, 336, dtype)
    if what == "misaligned":
        x = _misaligned(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    _, lse = tce.fused_ce_ref(x, w, y)
    lse = lse.float()
    monkeypatch.setattr(tce, "ce_family", lambda *a: "sm90")
    wrapper, table, args = {
        "forward": (tce.ce_fwd, tce.CE_FWD_FAMILY_CALLS, (x, w, y)),
        "dx": (tce.ce_dx, tce.CE_DX_FAMILY_CALLS, (x, w, y, lse, g)),
        "dW": (tce.ce_dw, tce.CE_DW_FAMILY_CALLS, (x, w, y, lse, g))}[kernel]
    before = (wrapper.launches, dict(table))
    with pytest.raises(RuntimeError):
        wrapper(*args)
    assert (wrapper.launches, dict(table)) == before


def test_ce_autograd_launches_the_sm90_family():
    """Autograd through ``FusedCEFunction`` on bf16 inputs: one launch of
    each sm90 kernel (forward, dx, dW), the loss and gradients of the plain
    versions within the bf16 tolerances."""
    _need_card()
    x, w, y, g = _ce_case(1000, 200, 5000, torch.bfloat16, seed=5)
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    tables = (tce.CE_FWD_FAMILY_CALLS, tce.CE_DX_FAMILY_CALLS,
              tce.CE_DW_FAMILY_CALLS)
    before = [dict(t) for t in tables]
    loss = tce.FusedCEFunction.apply(xr, wr, y)
    loss.backward(g)
    torch.cuda.synchronize()
    for t, b in zip(tables, before):
        assert t == {"sm90": b["sm90"] + 1, "simple": b["simple"]}
    ref_loss, ref_lse = tce.fused_ce_ref(x, w, y)
    ref_dx, ref_dw = tce.fused_ce_bwd_ref(x, w, y, ref_lse, g)
    assert _rel(loss, ref_loss) <= tce.oracle_tol("bfloat16", "fwd")
    assert _rel(xr.grad, ref_dx) <= tce.oracle_tol("bfloat16", "grad")
    assert _rel(wr.grad, ref_dw) <= tce.oracle_tol("bfloat16", "grad")


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
        tce.ce_fwd(x, w, y[:-1])                        # label count
    assert tce.ce_fwd.launches == before


# past the sm90 family's d <= 768: the simple kernels loop over d-chunks
# of 768; d = 2048, V = 50,000 is the reference's own test shape
# (tests/test_fused_ce.py)
CE_WIDE_GEOMS = {"d1024": (4096, 1024, 32768), "d2048": (2048, 2048, 50000),
                 "d800_ragged": (333, 800, 1001)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", list(CE_WIDE_GEOMS))
def test_ce_wide_heads_match_plain_versions(dtype, geom):
    """The forward, dx and dW past d = 768 on the simple family (by the
    rule and the counters) against the plain versions, the same bits
    twice."""
    _need_card()
    n, d, v = CE_WIDE_GEOMS[geom]
    if dtype == "float32" and geom != "d800_ragged":
        n = 512                   # the f32 FMA tiles are slow; fewer rows
    x, w, y, g = _ce_case(n, d, v, getattr(torch, dtype), seed=17)
    tables = (tce.CE_FWD_FAMILY_CALLS, tce.CE_DX_FAMILY_CALLS,
              tce.CE_DW_FAMILY_CALLS)
    before = [dict(t) for t in tables]
    loss, lse = tce.ce_fwd(x, w, y)
    ref_loss, ref_lse = tce.fused_ce_ref(x, w, y)
    ref_lse = ref_lse.float()
    dx = tce.ce_dx(x, w, y, ref_lse, g)
    dw = tce.ce_dw(x, w, y, ref_lse, g)
    dw2 = tce.ce_dw(x, w, y, ref_lse, g)
    torch.cuda.synchronize()
    for t, b, k in zip(tables, before, (1, 1, 2)):
        assert t == {"sm90": b["sm90"], "simple": b["simple"] + k}
    assert torch.equal(dw, dw2)
    tol = tce.oracle_tol(dtype, "fwd")
    assert _rel(loss, ref_loss) <= tol and _rel(lse, ref_lse) <= tol
    out = (y < 0) | (y >= v)
    assert torch.equal(loss[out], lse[out])
    ref_dx, ref_dw = tce.fused_ce_bwd_ref(x, w, y, ref_lse, g)
    tol = tce.oracle_tol(dtype, "grad")
    assert _rel(dx, ref_dx) <= tol and _rel(dw, ref_dw) <= tol
    assert torch.equal(dx[g == 0], torch.zeros_like(dx[g == 0]))


@pytest.mark.parametrize("kernel", ["forward", "dx", "dW"])
def test_ce_sm90_refuses_past_768(monkeypatch, kernel):
    """bf16 at d = 1024 forced onto the sm90 family raises and counts
    nothing: that family takes d <= 768."""
    _need_card()
    x, w, y, g = _ce_case(77, 1024, 336, torch.bfloat16)
    _, lse = tce.fused_ce_ref(x, w, y)
    lse = lse.float()
    monkeypatch.setattr(tce, "ce_family", lambda *a: "sm90")
    wrapper, table, args = {
        "forward": (tce.ce_fwd, tce.CE_FWD_FAMILY_CALLS, (x, w, y)),
        "dx": (tce.ce_dx, tce.CE_DX_FAMILY_CALLS, (x, w, y, lse, g)),
        "dW": (tce.ce_dw, tce.CE_DW_FAMILY_CALLS, (x, w, y, lse, g))}[kernel]
    before = (wrapper.launches, dict(table))
    with pytest.raises(RuntimeError):
        wrapper(*args)
    assert (wrapper.launches, dict(table)) == before


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


def test_fused_head_d1024_step_on_the_card_matches_the_cpu():
    """One Adam step of a one-layer f32 fused-head GPT at
    d_model 1024 on the card, from the state the CPU run starts from: the
    loss within 1e-4 relative, every parameter's gradient within 1e-3 of
    its largest entry, each CE kernel launched once on the simple family
    (d > 768)."""
    _need_card()
    import paddle_tpu_torch as pt

    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=61, n_layer=1, n_head=8, d_model=1024, max_len=32,
            dropout_rate=0.0, dtype="float32", learning_rate=2e-3,
            fused_head=True)
    cpu_scope = pt.Scope()
    cpu = pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    state = {v.name: cpu_scope.numpy(v.name)
             for v in main.persistable_vars()}
    card_scope = pt.load_numpy_state(pt.Scope(), state)
    card = pt.Executor(pt.CUDAPlace(0))
    rng = np.random.default_rng(1)
    start = rng.integers(0, 61, (4, 1))
    toks = (start + np.arange(32)[None, :]) % 61
    labels = np.concatenate([toks[:, 1:], -np.ones((4, 1), int)], 1)
    feed = {"tokens": toks, "labels": labels}
    params = [p.name for p in main.all_parameters()]
    fetch = [model["avg_cost"]] + [p + "@GRAD" for p in params]
    tables = (tce.CE_FWD_FAMILY_CALLS, tce.CE_DX_FAMILY_CALLS,
              tce.CE_DW_FAMILY_CALLS)
    before = [dict(t) for t in tables]
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    got = card.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    for t, b in zip(tables, before):
        assert t == {"sm90": b["sm90"], "simple": b["simple"] + 1}
    assert abs(got[0][0] - want[0][0]) <= 1e-4 * abs(want[0][0])
    top = max(float(np.abs(w).max()) for w in want[1:])
    for name, g, w in zip(params, got[1:], want[1:]):
        scale = top if "_att_k.b" in name else float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-3 * max(scale, 1e-30), name


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


# the sm90 family (csrc/bottleneck_sm90.cu): the script's shape (a whole
# image a strip), a small batch (strips of one and two rows, an odd last
# strip), W = 13 and 64, H = 1 and W = 1, each Cin it takes
BOTTLENECK_SM90_GEOMS = {"script": (128, 56, 56, 256), "ragged_strips":
                         (6, 13, 13, 128), "w64_c192": (3, 9, 64, 192),
                         "h1_w1_c64": (5, 1, 1, 64), "n4_stage1":
                         (4, 56, 56, 256)}


@pytest.mark.parametrize("geom", list(BOTTLENECK_SM90_GEOMS))
def test_bottleneck_sm90_matches_plain_and_repeats_its_bits(geom):
    _need_card()
    n, h, w, c = BOTTLENECK_SM90_GEOMS[geom]
    args = _bottleneck_case(n, h, w, c, 64, torch.bfloat16, seed=7)
    assert tbn.bottleneck_family(torch.bfloat16, h, w, c, 64, [
        a.data_ptr() for a in args[:4]]) == "sm90"
    before = dict(tbn.BOTTLENECK_FAMILY_CALLS)
    got = tbn.bottleneck(*args)
    again = tbn.bottleneck(*args)
    torch.cuda.synchronize()
    assert tbn.BOTTLENECK_FAMILY_CALLS == {"sm90": before["sm90"] + 2,
                                           "simple": before["simple"]}
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    assert _rel(got, tbn.bottleneck_ref(*args)) <= tbn.oracle_tol(
        torch.bfloat16)
    assert _rel(got, tbn.bottleneck(*args, family="simple")) <= (
        tbn.oracle_tol(torch.bfloat16))


@pytest.mark.parametrize("what", ["f32", "cm72", "cin512", "misaligned",
                                  "w65"])
def test_bottleneck_sm90_refuses_what_it_does_not_take(what):
    """Inputs the sm90 family does not take, forced onto it, raise and
    count nothing: no fallback to the simple kernel."""
    _need_card()
    n, h, w, c, cm, dt = {"f32": (2, 8, 8, 64, 64, torch.float32),
                          "cm72": (2, 8, 8, 64, 72, torch.bfloat16),
                          "cin512": (1, 4, 4, 512, 64, torch.bfloat16),
                          "misaligned": (2, 8, 8, 64, 64, torch.bfloat16),
                          "w65": (1, 3, 65, 64, 64, torch.bfloat16)}[what]
    args = _bottleneck_case(n, h, w, c, cm, dt)
    if what == "misaligned":
        x = torch.empty(args[0].numel() + 1, dtype=dt,
                        device="cuda")[1:].view(args[0].shape)
        x.copy_(args[0])
        args = (x,) + args[1:]
    before = (tbn.bottleneck.launches, dict(tbn.BOTTLENECK_FAMILY_CALLS))
    with pytest.raises(RuntimeError):
        tbn.bottleneck(*args, family="sm90")
    assert (tbn.bottleneck.launches,
            dict(tbn.BOTTLENECK_FAMILY_CALLS)) == before


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


# -- the training loop and the checkpoint format on the card -----------------

def _tiny_gpt(tpt, dtype="bfloat16"):
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    main.random_seed = startup.random_seed = 3
    with tpt.program_guard(main, startup):
        out = tpt.models.transformer.build(
            vocab_size=256, n_layer=2, n_head=2, d_model=128, max_len=128,
            dropout_rate=0.1, dtype=dtype, fused_head=True,
            learning_rate=1e-3)
    return main, startup, out


def _tiny_samples(n):
    def reader():
        rng = np.random.default_rng(0)
        for _ in range(n):
            toks = (rng.integers(0, 256) + np.arange(128)) % 256
            yield toks, (toks + 1) % 256
    return reader


def test_trainer_resume_is_bitwise_on_the_card(tmp_path):
    """bf16 with dropout on the card, prefetch and async step checkpoints:
    under deterministic algorithms (the flash backward on its split
    route) a resume from step 4 repeats the uninterrupted run's steps 5-6
    and every parameter bit for bit."""
    _need_card()
    import os

    import paddle_tpu_torch as tpt

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for ck, resume in ((tmp_path / "a", False), (tmp_path / "b", True)):
            if resume:
                ck.mkdir()
                os.rename(tmp_path / "a" / "step_4", ck / "step_4")
            main, startup, out = _tiny_gpt(tpt)
            scope, losses = tpt.Scope(), []
            with tpt.scope_guard(scope):
                tr = tpt.Trainer(out["avg_cost"], out["feed"],
                                 main_program=main, startup_program=startup)
                tr.train(tpt.reader.resumable(tpt.reader.batch(
                    _tiny_samples(12), 2)),
                    event_handler=lambda e: losses.append(e.cost) if
                    isinstance(e, tpt.EndIteration) else None,
                    checkpoint_dir=str(ck), checkpoint_every_n_steps=2,
                    keep_checkpoints=2, async_checkpoint=True, prefetch=2,
                    resume=resume)
            runs.append((losses, {p.name: scope.get(p.name).cpu()
                                  for p in main.all_parameters()}))
    finally:
        torch.use_deterministic_algorithms(prev)
    (full, pa), (tail, pb) = runs
    assert len(full) == 6 and tail == full[4:]
    assert all(torch.equal(pa[n], pb[n]) for n in pa)


def test_prefetch_waits_for_the_side_stream_copy():
    """Batches large enough that a read racing the copy would see a
    half-written tensor: every prefetched batch sums as its host copy."""
    _need_card()
    import paddle_tpu_torch as tpt

    def reader():
        rng = np.random.default_rng(0)
        for _ in range(6):
            yield {"x": rng.standard_normal((4096, 4096)).astype(np.float32)}

    got = [b["x"].sum().item()
           for b in tpt.reader.prefetch_to_device(reader, 2)()]
    want = [torch.from_numpy(h["x"]).cuda().sum().item() for h in reader()]
    assert got == want


def test_async_checkpoint_snapshot_under_in_place_updates(tmp_path):
    """bf16 on the card: the pinned side-stream copy is complete when
    save() returns, before the next in-place Adam step overwrites the
    tensors; the files hold the state of the moment of save()."""
    _need_card()
    import paddle_tpu_torch as tpt

    main, startup, out = _tiny_gpt(tpt)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    toks = torch.arange(2 * 128, device="cuda").reshape(2, 128) % 256
    feed = {"tokens": toks, "labels": (toks + 1) % 256}
    ck = tpt.io.AsyncCheckpointer()
    with tpt.scope_guard(scope):
        exe.run(main, feed=feed, fetch_list=[out["avg_cost"]])
        want = {v.name: scope.get(v.name).cpu().clone()
                for v in main.persistable_vars()}
        ck.save(str(tmp_path), main)
        exe.run(main, feed=feed, fetch_list=[out["avg_cost"]])
        ck.close()
    loaded = tpt.Scope()
    with tpt.scope_guard(loaded):
        tpt.io.load_persistables(tpt.Executor(tpt.CPUPlace()), str(tmp_path),
                                 main)
    assert not torch.equal(scope.get("lm_head.w").cpu(), want["lm_head.w"])
    for n, w in want.items():
        assert torch.equal(loaded.get(n), w), n


def _recipe_gpt(tpt, make, t=256, n_layer=4, policy=None):
    """A bf16 GPT (fused head, dropout 0) built with ``make(tpt)`` as its
    optimizer in place of ``build``'s Adam, and ``policy`` remat."""
    import types

    mod = tpt.models.transformer
    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    main.random_seed = startup.random_seed = 5
    orig = mod.opt
    mod.opt = types.SimpleNamespace(Adam=lambda learning_rate: make(tpt))
    try:
        with tpt.program_guard(main, startup):
            out = mod.build(vocab_size=512, n_layer=n_layer, n_head=2,
                            d_model=256, max_len=t, dropout_rate=0.0,
                            dtype="bfloat16", fused_head=True)
    finally:
        mod.opt = orig
    if policy:
        tpt.memory_optimize(main, policy=policy)
    return main, startup, out


def _recipe_feed(t, b=4, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, 512, (b, t)), device="cuda")
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def test_offload_streams_on_the_card_and_keeps_selective_bits():
    """Mode ``"host"``: the block inputs go to pinned host memory and come
    back for the recompute; under deterministic algorithms the losses and
    every parameter after 2 Adam steps are ``selective``'s bits, and the
    peak is below ``selective``'s."""
    _need_card()
    import paddle_tpu_torch as tpt

    adam = lambda pkg: pkg.optimizer.Adam(learning_rate=1e-3)  # noqa: E731
    runs = {}
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for policy in ("selective", "offload"):
            main, startup, out = _recipe_gpt(tpt, adam, t=2048,
                                             policy=policy)
            exe, scope = tpt.Executor(), tpt.Scope()
            exe.run(startup, scope=scope)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses = [exe.run(main, feed=_recipe_feed(2048, seed=i),
                              fetch_list=[out["avg_cost"]], scope=scope,
                              return_numpy=False)[0] for i in range(2)]
            torch.cuda.synchronize()
            runs[policy] = (losses, torch.cuda.max_memory_allocated(),
                            exe.last_remat_plan,
                            {p.name: scope.get(p.name).cpu()
                             for p in main.all_parameters()})
            del exe, scope
    finally:
        torch.use_deterministic_algorithms(prev)
    (sl, speak, splan, sp), (ol, opeak, oplan, op) = (runs["selective"],
                                                      runs["offload"])
    assert splan["offload"] == "off" and oplan["offload"] == "host"
    assert oplan["offloaded"] == 2 * 4 and oplan["offloaded_bytes"] > 0
    assert all(torch.equal(a, b) for a, b in zip(sl, ol))
    assert all(torch.equal(sp[n], op[n]) for n in sp)
    assert opeak < speak


def test_recipe_ops_on_the_card_match_the_cpu():
    """Every update op the recipes add, on bf16 parameters and gradients
    with f32 state: the card's result within ORACLE_TOL bf16 (2e-2) of
    the CPU's, written in place."""
    _need_card()
    import paddle_tpu_torch  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.registry import get_op_impl

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (768, 3072)

    def rnd(pos=False, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x.abs() + 0.1 if pos else x).to(dtype)

    cases = {
        "sgd": {},
        "adagrad": {"Moment": rnd(True)},
        "adamax": {"Moment": rnd(), "InfNorm": rnd(True),
                   "Beta1Pow": torch.tensor([0.729], device="cuda")},
        "adadelta": {"AvgSquaredGrad": rnd(True),
                     "AvgSquaredUpdate": rnd(True)},
        "decayed_adagrad": {"Moment": rnd(True)},
        "rmsprop": {"MeanSquare": rnd(True), "Moment": rnd()},
        "ftrl": {"SquaredAccumulator": rnd(True), "LinearAccumulator": rnd()},
        "proximal_gd": {},
        "proximal_adagrad": {"Moment": rnd(True)},
    }
    attrs = {"ftrl": {"l1": 1e-3, "l2": 1e-3}, "rmsprop": {"momentum": 0.9},
             "proximal_gd": {"l1": 1e-3, "l2": 1e-3},
             "proximal_adagrad": {"l1": 1e-3, "l2": 1e-3}}
    for name, state in cases.items():
        ins = dict(state, Param=rnd(dtype=torch.bfloat16),
                   Grad=rnd(dtype=torch.bfloat16))
        if name != "adadelta":
            ins["LearningRate"] = torch.tensor([0.01], device="cuda")
        cpu = {k: v.cpu().clone() for k, v in ins.items()}
        ptr = ins["Param"].data_ptr()
        got = get_op_impl(name).fn(**ins, **attrs.get(name, {}))
        want = get_op_impl(name).fn(**cpu, **attrs.get(name, {}))
        assert got["ParamOut"].data_ptr() == ptr
        for slot, t in got.items():
            w = want[slot].float()
            err = (t.cpu().float() - w).abs().max() / w.abs().max()
            assert float(err) <= 2e-2, (name, slot)


# -- the recurrent path (no hand-written kernel: ATen on the card) ----------

def _rnn_op_on_both(op, inputs, lengths, attrs, outs):
    """``op`` on the card and on the CPU from the same seeded f32 inputs
    with TF32 off: every output within ORACLE_TOL f32's forward bound,
    every input's gradient under one cotangent within its gradient
    bound."""
    import paddle_tpu_torch  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.registry import get_op_impl

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for dev in ("cuda", "cpu"):
            ts = {k: torch.tensor(v, device=dev, requires_grad=True)
                  for k, v in inputs.items()}
            got = get_op_impl(op).fn(
                **ts, Length=torch.tensor(lengths, device=dev), **attrs)
            vals = [got[o] for o in outs]
            gen = torch.Generator().manual_seed(1)
            cots = [torch.randn(v.shape, generator=gen).to(dev)
                    for v in vals]
            grads = torch.autograd.grad(
                sum((v * c).sum() for v, c in zip(vals, cots)),
                list(ts.values()))
            res[dev] = ([v.detach().cpu() for v in vals],
                        [g.cpu() for g in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for g, w in zip(res["cuda"][0], res["cpu"][0]):
        assert _rel(g, w) <= 2e-4
    for g, w in zip(res["cuda"][1], res["cpu"][1]):
        assert _rel(g, w) <= 1e-3


def test_lstm_op_on_the_card_matches_the_cpu():
    """``lstm`` with peepholes, reversed, on a ragged batch, at the
    text classifier's hidden width."""
    _need_card()
    rng = np.random.default_rng(0)
    b, t, d = 8, 20, 512
    _rnn_op_on_both(
        "lstm",
        {"Input": rng.standard_normal((b, t, 4 * d)).astype(np.float32),
         "Weight": (rng.standard_normal((d, 4 * d)) / d ** 0.5
                    ).astype(np.float32),
         "Bias": (0.1 * rng.standard_normal((1, 7 * d))).astype(np.float32)},
        rng.integers(4, t + 1, b).astype(np.int32),
        {"use_peepholes": True, "is_reverse": True}, ("Hidden", "Cell"))


def test_gru_op_on_the_card_matches_the_cpu():
    """``gru`` from ``H0`` on a ragged batch, at seq2seq's hidden width."""
    _need_card()
    rng = np.random.default_rng(1)
    b, t, d = 8, 16, 512
    _rnn_op_on_both(
        "gru",
        {"Input": rng.standard_normal((b, t, 3 * d)).astype(np.float32),
         "Weight": (rng.standard_normal((d, 3 * d)) / d ** 0.5
                    ).astype(np.float32),
         "Bias": (0.1 * rng.standard_normal((1, 3 * d))).astype(np.float32),
         "H0": rng.standard_normal((b, d)).astype(np.float32)},
        rng.integers(4, t + 1, b).astype(np.int32), {}, ("Hidden",))


def test_text_classification_trains_on_the_card_without_a_cpu_tensor():
    """Every tensor an op of the stacked-LSTM classifier reads or writes
    lies on the card, for three Adam steps of one ragged batch fed
    through ``DataFeeder``; the loss falls."""
    _need_card()
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.core import registry

    tpt.core.unique_name.reset()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        out = tpt.models.text_classification.build(
            dict_dim=1000, emb_dim=32, hid_dim=64, max_len=24)
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(2)
    rows = [(rng.integers(0, 1000, int(rng.integers(5, 25))).tolist(),
             [int(rng.integers(0, 2))]) for _ in range(16)]
    feed = tpt.DataFeeder(out["feed"]).feed(rows)
    seen = []
    real_call = registry.OpImpl.call

    def checked_call(self, ins, attrs, ctx, live=None):
        res = real_call(self, ins, attrs, ctx, live)
        for v in list(ins.values()) + list((res or {}).values()):
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(x, torch.Tensor) and x.device.type != "cuda":
                    seen.append((self.type, x.device))
        return res

    registry.OpImpl.call = checked_call
    try:
        losses = [float(exe.run(main, feed=feed, scope=scope,
                                fetch_list=[out["avg_cost"]])[0][0])
                  for _ in range(3)]
    finally:
        registry.OpImpl.call = real_call
    assert not seen, seen[:5]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
