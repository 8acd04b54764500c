"""The port's pipeline and expert parallelism on gloo CPU ranks, held to
the JAX package's ``pipeline``, ``pipeline_lm`` and ``moe_ffn`` on the
conftest's 8-device CPU mesh.

One spawn of 4 ranks runs:

* ``pipeline`` on pp=4 — GPipe (4 stages, 4 microbatches) and the
  interleaved schedule (``virtual_stages=2``: 8 stages, 4 and 8
  microbatches) — with the reference's residual tanh stage: the output
  and every stage parameter's gradient of ``mean(out ** 2)``;
* ``pipeline_lm`` on pp=4, GPipe and interleaved: the loss and the
  embedding's, every stage's and the head's gradients;
* pp x sp: attention stages pipelined over pp=2 while each stage rings
  its sequence over sp=2 (``wire_spec=("sp", None)``,
  ``ring_attention_local`` inside the stage): the loss, each rank's
  output block and the stage gradients;
* ``moe_ffn`` on ep=4 (8 experts, d 8, hidden 16, 32 tokens) at
  ``capacity_factor`` 2.0 (tokens dropped, the same ones) and 16.0 (none
  dropped): each rank's rows of ``y``, ``aux``, and the gradients of
  ``sum(y ** 2) + 0.01 * aux`` for the gate, the rank's experts and its
  tokens;
* the reference's error messages.

Stage parameters and the MoE dict are the reference's (numpy), carried
across by ``stage_params_from_numpy`` / ``moe_params_from_numpy`` to
each rank's block.  f32, within 2e-4 of the largest entry (the loss
2e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel.mesh import make_mesh
from paddle_tpu.parallel.moe import init_moe_params, moe_ffn
from paddle_tpu.parallel.pipeline import (pipeline, pipeline_lm,
                                          stack_stage_params)
from paddle_tpu.parallel.ring_attention import ring_attention_local

import torch_mesh_workers as W
import torch_parallel_workers as PW

WORLD, D = 4, 8
PIPE = [("gpipe", 1, 4), ("interleaved_m4", 2, 4), ("interleaved_m8", 2, 8)]
LM = [("gpipe", 1, 4), ("interleaved", 2, 4)]
VOCAB, TLEN = 12, 5
MOE = [("cf2", 2.0), ("cf16", 16.0)]


def _mlp_stage(params, h):
    return h + jnp.tanh(h @ params["w"] + params["b"])


def _stages(n, d, key):
    ks = jax.random.split(jax.random.PRNGKey(key), n)
    return [{"w": jax.random.normal(k, (d, d)) * 0.3,
             "b": jnp.full((d,), 0.01)} for k in ks]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _embed(p, tok):
    return p["table"][tok]


def _head_loss(p, h, tgt):
    logp = jax.nn.log_softmax(h @ p["w"])
    return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], axis=-1))


def _pipe_refs():
    mesh = make_mesh({"pp": WORLD}, devices=jax.devices()[:WORLD])
    cases, refs = [], {}
    for key, v, m in PIPE:
        sp = stack_stage_params(_stages(v * WORLD, D, key=len(key)))
        x = jax.random.normal(jax.random.PRNGKey(9), (2 * m, D))

        def loss(sp, x, v=v, m=m):
            out = pipeline(_mlp_stage, sp, x, mesh, num_microbatches=m,
                           virtual_stages=v)
            return jnp.mean(out ** 2), out

        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(sp, x)
        refs[key] = (np.asarray(out), _np(g))
        cases.append((key, _np(sp), np.asarray(x), m, v))
    return cases, refs


def _lm_refs():
    mesh = make_mesh({"pp": WORLD}, devices=jax.devices()[:WORLD])
    cases, refs = [], {}
    for key, v, m in LM:
        b = 2 * m
        sp = stack_stage_params(_stages(v * WORLD, D, key=3 + v))
        emb = {"table": jax.random.normal(jax.random.PRNGKey(4),
                                          (VOCAB, D)) * 0.2}
        head = {"w": jax.random.normal(jax.random.PRNGKey(5),
                                       (D, VOCAB)) * 0.2}
        tok = jax.random.randint(jax.random.PRNGKey(6), (b, TLEN), 0, VOCAB)
        tgt = jax.random.randint(jax.random.PRNGKey(7), (b, TLEN), 0, VOCAB)

        def loss(emb, sp, head, v=v, m=m, tok=tok, tgt=tgt):
            return pipeline_lm(_embed, _mlp_stage, _head_loss, emb, sp, head,
                               tok, tgt, mesh, num_microbatches=m,
                               virtual_stages=v)

        lv, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
            emb, sp, head)
        refs[key] = (float(lv), _np(g))
        cases.append((key, _np(sp), _np(emb), _np(head),
                      np.asarray(tok, np.int64), np.asarray(tgt, np.int64),
                      m, v))
    return cases, refs


HEADS, PPSP_T = 2, 16


def _ppsp_ref():
    mesh = make_mesh({"pp": 2, "sp": WORLD // 2},
                     devices=jax.devices()[:WORLD])
    b, dh = 2, D // HEADS

    def stage_fn(params, h):
        mb, tl, _ = h.shape
        q, k, v = jnp.split(h @ params["w_qkv"], 3, axis=-1)
        shp = (mb, tl, HEADS, dh)
        o = ring_attention_local(q.reshape(shp), k.reshape(shp),
                                 v.reshape(shp), WORLD // 2, axis_name="sp",
                                 causal=True)
        return h + o.reshape(mb, tl, D) @ params["w_o"]

    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    stages = [{"w_qkv": jax.random.normal(k, (D, 3 * D)) * 0.1,
               "w_o": jax.random.normal(k, (D, D)) * 0.1} for k in keys]
    sp = stack_stage_params(stages)
    x = jax.random.normal(jax.random.PRNGKey(1), (b, PPSP_T, D))
    y = jax.random.normal(jax.random.PRNGKey(2), (b, PPSP_T, D))

    def loss(params):
        out = pipeline(stage_fn, params, x, mesh, num_microbatches=2,
                       wire_spec=("sp", None))
        return jnp.mean((out - y) ** 2), out

    (lv, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(sp)
    case = (_np(sp), np.asarray(x), np.asarray(y), HEADS)
    return case, (float(lv), np.asarray(out), _np(g))


def _moe_refs():
    mesh = make_mesh({"ep": WORLD}, devices=jax.devices()[:WORLD])
    params = init_moe_params(jax.random.PRNGKey(4), 8, D, 16)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((32, D)),
                    jnp.float32)
    cases, refs = [], {}
    for key, cf in MOE:
        def loss(params, x, cf=cf):
            y, aux = moe_ffn(params, x, mesh, capacity_factor=cf)
            return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, x)
        refs[key] = (np.asarray(y), float(aux), _np(gp), np.asarray(gx))
        cases.append((key, _np(params), np.asarray(x), cf))
    return cases, refs


@pytest.fixture(scope="module")
def runs():
    pipe_cases, pipe_refs = _pipe_refs()
    lm_cases, lm_refs = _lm_refs()
    ppsp_case, ppsp_ref = _ppsp_ref()
    moe_cases, moe_refs = _moe_refs()
    ranks = W.spawn(WORLD, PW.pp_ep_cases, pipe_cases, lm_cases, ppsp_case,
                    moe_cases)
    return ranks, {"pipe": pipe_refs, "lm": lm_refs, "ppsp": ppsp_ref,
                   "moe": moe_refs}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _laps(stacked, r, v, pp=WORLD):
    """Rank r's laps of a whole stack [v*pp, ...] -> [v, ...]."""
    return stacked.reshape(v, pp, *stacked.shape[1:])[:, r]


@pytest.mark.parametrize("key,v,m", PIPE)
def test_pipeline_matches_the_reference(runs, key, v, m):
    ranks, refs = runs
    out, grads = refs["pipe"][key]
    for r, res in enumerate(ranks):
        got = res["pipe"][key]
        assert _rel(got["y"], out) < 2e-4, (key, r)
        for name, g in grads.items():
            assert _rel(got["grads"][name], _laps(g, r, v)) < 2e-4, (
                key, r, name)


@pytest.mark.parametrize("key,v,m", LM)
def test_pipeline_lm_matches_the_reference(runs, key, v, m):
    ranks, refs = runs
    loss, (g_emb, g_stages, g_head) = refs["lm"][key]
    for r, res in enumerate(ranks):
        got = res["lm"][key]
        assert abs(got["loss"] - loss) <= 2e-5 * abs(loss), (key, r)
        assert _rel(got["embed"], g_emb["table"]) < 2e-4, (key, r)
        assert _rel(got["head"], g_head["w"]) < 2e-4, (key, r)
        for name, g in g_stages.items():
            assert _rel(got["grads"][name], _laps(g, r, v)) < 2e-4, (
                key, r, name)
        # every rank runs every tick's shift, bubble ticks included, and
        # the reverse shift of each in the backward
        assert got["shifts"] == 2 * (v * m + WORLD - 1)


def test_pipeline_composes_with_ring_attention_pp_sp(runs):
    ranks, refs = runs
    loss, out, grads = refs["ppsp"]
    n = PPSP_T // (WORLD // 2)
    for rank, res in enumerate(ranks):
        got = res["ppsp"]
        s = rank % (WORLD // 2)                 # mesh {"pp": 2, "sp": 2}
        assert abs(got["loss"] - loss) <= 2e-5 * abs(loss), rank
        assert _rel(got["out"], out[:, s * n:(s + 1) * n]) < 2e-4, rank
        p = rank // (WORLD // 2)
        for name, g in grads.items():
            assert _rel(got["grads"][name][0], g[p]) < 2e-4, (rank, name)


@pytest.mark.parametrize("key,cf", MOE)
def test_moe_ffn_matches_the_reference(runs, key, cf):
    ranks, refs = runs
    y, aux, gp, gx = refs["moe"][key]
    n = y.shape[0] // WORLD
    e_local = gp["w1"].shape[0] // WORLD
    for r, res in enumerate(ranks):
        got = res["moe"][key]
        rows = slice(r * n, (r + 1) * n)
        assert _rel(got["y"], y[rows]) < 2e-4, (key, r)
        # the same tokens dropped: the rows that came out zero
        assert np.array_equal(np.all(got["y"] == 0, axis=1),
                              np.all(y[rows] == 0, axis=1)), (key, r)
        assert abs(got["aux"] - aux) <= 2e-5 * abs(aux), (key, r)
        assert _rel(got["grads"]["gate"], gp["gate"]) < 2e-4, (key, r)
        for name in ("w1", "b1", "w2", "b2"):
            want = gp[name][r * e_local:(r + 1) * e_local]
            assert _rel(got["grads"][name], want) < 2e-4, (key, r, name)
        assert _rel(got["dx"], gx[rows]) < 2e-4, (key, r)


def test_moe_drops_tokens_at_capacity_2_and_none_at_16(runs):
    ranks, refs = runs
    assert np.any(np.all(refs["moe"]["cf2"][0] == 0, axis=1))
    assert not np.any(np.all(refs["moe"]["cf16"][0] == 0, axis=1))


def test_the_references_error_messages(runs):
    ranks, _ = runs
    mesh = make_mesh({"pp": WORLD}, devices=jax.devices()[:WORLD])
    want = {}
    with pytest.raises(ValueError) as e:
        pipeline(_mlp_stage, {"w": jnp.zeros((8, 4, 4))}, jnp.zeros((4, 4)),
                 mesh, num_microbatches=2, virtual_stages=2)
    want["microbatches"] = str(e.value)
    with pytest.raises(ValueError) as e:
        pipeline(_mlp_stage, {"w": jnp.zeros((4, 4, 4))}, jnp.zeros((6, 4)),
                 mesh, num_microbatches=4)
    want["divisible"] = str(e.value)
    emesh = make_mesh({"ep": WORLD}, devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError) as e:
        moe_ffn(init_moe_params(jax.random.PRNGKey(0), 6, 4, 8),
                jnp.zeros((8, 4)), emesh)
    want["experts"] = str(e.value)
    for res in ranks:
        for k, msg in want.items():
            assert res["errors"][k] == msg, k
        # a rank's block of the stack: the reference's wording, counted
        # on the rank
        assert res["errors"]["stages"].startswith(
            "stacked stage params have leading dim(s) [3]")
