"""The paged-attention split family's decomposition
(``paddle_tpu_torch.kernels.paged_attention``: ``paged_attention_split_ref``,
the static rule ``paged_family`` and the split count ``paged_splits``)
against the JAX package, on seeded numpy inputs fed to both.

The plain split-and-merge spelling — each slot's chain cut into runs of
entries, each run's online softmax, the runs merged in order — is held to
the JAX block-scan oracle (``paged_attention_ref``) and to the Pallas TPU
kernel run in interpret mode, for every split count from one to beyond the
live entries (so some runs are empty), windows W in {1, 3, 6}, ``pos = -1``
rows, and non-finite garbage in the trash block past each position.  The
CUDA kernels themselves are held against these spellings on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).

Tolerance: f32 ``ORACLE_TOL`` 2e-4, max |port - jax| / max |jax|.  Where a
row has no live key (``pos = -1``) the kernels return zeros; the JAX
oracle there averages every value of the chain (its finite ``NEG_INF``
weighs all masked keys alike), so those rows are compared with zeros and
the others with the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as tpa

S, H, DH, B, NB, NUM_BLOCKS = 4, 2, 16, 4, 5, 16
TOL = tpa.oracle_tol("float32")


def _inputs(w, seed):
    """Seeded numpy inputs: ragged chains (slot 2 lives in one entry, slot
    3 fills all NB), slot 1 sharing slot 0's first two blocks, entries past
    each chain naming the trash block 0, which holds finite garbage."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, w, H, DH)).astype(np.float32)
    pk = rng.standard_normal((NUM_BLOCKS, B, H, DH)).astype(np.float32)
    pv = rng.standard_normal((NUM_BLOCKS, B, H, DH)).astype(np.float32)
    pk[0] = 50.0 * rng.standard_normal((B, H, DH))
    pv[0] = 50.0 * rng.standard_normal((B, H, DH))
    base = np.array([11, 6, 0, NB * B - w])[:, None]
    pos = (base + np.arange(w)[None, :]).astype(np.int32)
    blocks = iter(rng.permutation(np.arange(1, NUM_BLOCKS)))
    table = np.zeros((S, NB), np.int32)
    for s in range(S):
        for nb in range(int(pos[s].max()) // B + 1):
            table[s, nb] = table[0, nb] if s == 1 and nb < 2 else next(blocks)
    return q, pk, pv, table, pos


def _torch(arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", params=[1, 3, 6], ids=lambda w: f"W{w}")
def window(request):
    """(inputs, the JAX oracle's output) for one window width."""
    arrs = _inputs(request.param, seed=request.param)
    ref = jpa.paged_attention_ref(*(jnp.asarray(a) for a in arrs))
    return arrs, np.asarray(ref)


@pytest.mark.parametrize("splits", range(1, NB + 3))
def test_split_spelling_matches_jax_oracle(window, splits):
    """Every split count, up to two past the chain's NB entries: runs past
    a slot's live entries are empty and merge to nothing."""
    arrs, ref = window
    got = tpa.paged_attention_split_ref(*_torch(arrs), splits)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= TOL


@pytest.fixture
def pallas_interpretable(monkeypatch):
    """The TPU kernel passes Mosaic ``compiler_params`` in the dict form,
    which the installed jax rejects before interpreting; interpret mode
    ignores them, so drop them for the call (as
    ``test_torch_paged_attention.py`` does).  The kernel body runs
    unchanged."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def pallas_call(*args, **kw):
        kw.pop("compiler_params", None)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)


@pytest.mark.parametrize("w", [1, 6])
def test_split_spelling_matches_pallas_kernel_interpret(w,
                                                       pallas_interpretable):
    arrs = _inputs(w, seed=10 + w)
    ref = jpa.paged_attention_pallas(*(jnp.asarray(a) for a in arrs),
                                     interpret=True)
    splits, _ = tpa.paged_splits(S, H, NB)
    got = tpa.paged_attention_split_ref(*_torch(arrs), splits)
    assert _rel(got.numpy(), np.asarray(ref)) <= TOL


@pytest.mark.parametrize("splits", [1, 2, NB + 1])
def test_rows_without_keys_are_zero(splits):
    """``pos = -1``: a whole slot, and the first row of a window whose
    other rows are live.  Those rows are zeros; every other row matches
    the oracle."""
    q, pk, pv, table, pos = _inputs(3, seed=4)
    pos[1] = -1
    pos[3, 0] = -1
    ref = np.asarray(jpa.paged_attention_ref(
        *(jnp.asarray(a) for a in (q, pk, pv, table, pos))))
    got = tpa.paged_attention_split_ref(*_torch((q, pk, pv, table, pos)),
                                        splits).numpy()
    dead = np.zeros(pos.shape, bool)
    dead[1], dead[3, 0] = True, True
    assert not got[dead].any()
    assert _rel(got[~dead], ref[~dead]) <= TOL


@pytest.mark.parametrize("splits", [1, 3])
def test_non_finite_garbage_past_pos_never_reaches_the_output(splits):
    """NaN and inf in every key and value past each slot's last position
    (the trash block included) leave the split spelling's bits unchanged,
    and equal to the oracle on the finite inputs."""
    q, pk, pv, table, pos = _inputs(3, seed=5)
    clean = tpa.paged_attention_split_ref(*_torch((q, pk, pv, table, pos)),
                                          splits)
    live = {(int(table[s, j // B]), j % B)
            for s in range(S) for j in range(int(pos[s].max()) + 1)}
    pk2, pv2 = pk.copy(), pv.copy()
    for blk in range(NUM_BLOCKS):
        for b in range(B):
            if (blk, b) not in live:
                pk2[blk, b] = np.nan
                pv2[blk, b] = np.inf
    got = tpa.paged_attention_split_ref(*_torch((q, pk2, pv2, table, pos)),
                                        splits)
    assert torch.equal(got, clean)
    ref = jpa.paged_attention_ref(*(jnp.asarray(a)
                                    for a in (q, pk, pv, table, pos)))
    assert _rel(got.numpy(), np.asarray(ref)) <= TOL


def test_family_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    ok = (0, 256, 4096)
    # the serving paths: decode / prefill / windows (bf16 and f32, dh 128)
    # and the speculative verify window (f32, dh 32)
    assert tpa.paged_family(bf16, 32, 1, 6, 128, 32, ok) == "split"
    assert tpa.paged_family(f32, 32, 6, 8, 32, 32, ok) == "split"
    assert tpa.paged_family(f32, 1, 1, 6, 128, 32, ok) == "split"
    assert tpa.paged_family(bf16, 2, 4, 1, 256, 1, ok) == "split"
    # rows that are no power-of-two count of 16-byte chunks, or too wide
    assert tpa.paged_family(f32, 3, 3, 2, 100, 7, ok) == "simple"
    assert tpa.paged_family(bf16, 3, 1, 2, 4, 7, ok) == "simple"
    assert tpa.paged_family(f32, 2, 4, 1, 256, 1, ok) == "simple"
    # windows past 8, blocks past 64 tokens, grid limits, misaligned bases
    assert tpa.paged_family(f32, 32, 9, 8, 32, 32, ok) == "simple"
    assert tpa.paged_family(f32, 32, 1, 8, 32, 65, ok) == "simple"
    assert tpa.paged_family(f32, 65536, 1, 8, 32, 32, ok) == "simple"
    assert tpa.paged_family(f32, 32, 1, 8, 32, 32, (0, 8, 0)) == "simple"
    assert tpa.paged_family(torch.float16, 32, 1, 8, 32, 32, ok) == "simple"


def test_split_count_is_a_function_of_the_shapes():
    # decode (S=32, h=6, NB=16) and the verify window (h=8): 8 runs of 2
    # entries; one prefill slot: one entry a run; a wide batch: one run
    assert tpa.paged_splits(32, 6, 16) == (8, 2)
    assert tpa.paged_splits(32, 8, 16) == (8, 2)
    assert tpa.paged_splits(1, 6, 16) == (16, 1)
    assert tpa.paged_splits(4096, 6, 16) == (1, 16)
    for S_, h, nb in ((32, 6, 16), (3, 5, 7), (1, 1, 1), (200, 3, 33)):
        splits, per = tpa.paged_splits(S_, h, nb)
        assert (splits - 1) * per < nb <= splits * per
        assert tpa.paged_splits(S_, h, nb) == (splits, per)


def test_cpu_calls_count_no_family():
    """The wrapper counts a family where it launches a kernel, and CPU
    tensors launch none."""
    before = (dict(tpa.PAGED_FAMILY_CALLS), tpa.paged_attention.launches)
    args = _torch(_inputs(3, seed=6))
    got = tpa.paged_attention(*args)
    assert torch.equal(got, tpa.paged_attention_ref(*args))
    assert (dict(tpa.PAGED_FAMILY_CALLS), tpa.paged_attention.launches) == before
