"""The port's CUDA kernels on the card, against their plain PyTorch
versions (paddle_tpu_torch only: no jax, so these run on a host without
it).  Every test needs an NVIDIA GPU and skips without one; on the card:

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
