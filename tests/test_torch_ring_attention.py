"""The port's ring attention on gloo CPU ranks, held to the JAX package's
``ring_attention`` on the conftest's 8-device CPU mesh (an sp=4
sub-mesh).

Each of 4 ranks holds its block of the sequence (b=2, t=64: 16 rows a
rank, 2 heads of 8, f32) and runs ``ring_attention`` with
``impl="dense"`` and ``impl="flash"`` (the flash kernels' wrappers run
their plain versions on CPU tensors), causal and not: its output block
and dq, dk, dv against the reference's (its flash impl interpreted,
block 16), within 2e-4 of the largest entry.  The flash ring launches
its kernel once a step it does not skip — r + 1 times on rank r when
causal, with the diagonal step causal — and every rank issues the same
sp - 1 shifts forward and backward.  One spawn of 4 ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel.mesh import make_mesh
from paddle_tpu.parallel.ring_attention import ring_attention

import torch_mesh_workers as W
import torch_parallel_workers as PW

SP = 4
B, T, H, D = 2, 64, 2, 8
CASES = [(impl, causal) for impl in ("dense", "flash")
         for causal in (False, True)]


def _inputs():
    rng = np.random.default_rng(7)
    return [(0.5 * rng.standard_normal((B, T, H, D))).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def runs():
    q, k, v, g = _inputs()
    cases = [((impl, causal), q, k, v, g, causal, impl)
             for impl, causal in CASES]
    ranks = W.spawn(SP, PW.ring_cases, cases)
    mesh = make_mesh({"sp": SP}, devices=jax.devices()[:SP])
    refs = {}
    for impl, causal in CASES:
        def f(q, k, v, impl=impl, causal=causal):
            return ring_attention(q, k, v, mesh, causal=causal, impl=impl,
                                  block_q=16, block_k=16)

        @jax.jit
        def fwd_bwd(q, k, v, g):
            o, vjp = jax.vjp(f, q, k, v)
            return o, vjp(g)

        o, grads = fwd_bwd(*(jnp.asarray(a) for a in (q, k, v, g)))
        refs[(impl, causal)] = (np.asarray(o), [np.asarray(x) for x in grads])
    return ranks, refs


def _block(a, r):
    n = a.shape[1] // SP
    return a[:, r * n:(r + 1) * n]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("impl,causal", CASES)
def test_ring_attention_matches_the_reference(runs, impl, causal):
    ranks, refs = runs
    o, grads = refs[(impl, causal)]
    for r, res in enumerate(ranks):
        got = res[(impl, causal)]
        assert _rel(got["o"], _block(o, r)) < 2e-4, (r, "o")
        for name, a, want in zip("qkv", got["grads"], grads):
            assert _rel(a, _block(want, r)) < 2e-4, (r, "d" + name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_launches_once_a_step_it_does_not_skip(runs, causal):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        calls = res[("flash", causal)]["calls"]
        if causal:
            # the diagonal step (step 0) causal, the past steps full, the
            # future steps skipped
            assert calls == [True] + [False] * r, (r, calls)
        else:
            assert calls == [False] * SP, (r, calls)
        assert res[("dense", causal)]["calls"] == []


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_every_rank_shifts_alike_forward_and_backward(runs, impl):
    ranks, _ = runs
    for res in ranks:
        for causal in (False, True):
            got = res[(impl, causal)]
            assert got["shifts"] == 2 * (SP - 1)
            assert got["log"] == [("collective-permute", "backward"),
                                  ("collective-permute", "forward")]


def test_unknown_impl_raises_the_references_message(runs):
    ranks, _ = runs
    q, k, v, _g = _inputs()
    mesh = make_mesh({"sp": SP}, devices=jax.devices()[:SP])
    with pytest.raises(ValueError) as e:
        ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                       impl="falsh")
    for res in ranks:
        assert res["errors"]["impl"] == str(e.value)
