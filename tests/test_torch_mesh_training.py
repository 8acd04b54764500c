"""Sharded training through the port's ``Executor(mesh=...)`` on gloo
CPU process groups, held to the JAX package's unsharded single-device
run of the same program and weights.

One spawn of 8 ranks (a FileStore in a temporary directory) trains the
2-layer GPT (d64, 2 heads, vocab 256, f32, the fused CE head) three
steps on every mesh: dp8 with ZeRO-1 on and off, dp4 x tp2, dp2 x fsdp4
with ZeRO-3's reduce-scatter (and with it off), dp2 x fsdp2 x tp2,
and dp-local gradient accumulation on dp8 (Momentum on a mesh is in
``test_torch_mesh_checkpoint.py``).  The initial state is the JAX
package's startup state, imported with ``load_numpy_state``; the
reference trains it unsharded on one device, its attention and fused
head through its kernel registry's ``xla_ref`` backend (the plain XLA
versions, as the port's CPU path runs its plain versions).

Tolerances: losses within 2e-4 relative; parameters within 1e-3 of the
tensor's largest entry, at ``test_torch_training.py``'s learning rate
2e-3 (Adam moves an entry whose gradient is near its epsilon by a step
that rounding in the gradient's sum changes, and a mesh sums in another
order; the step scales with the rate).  The key-projection biases (``*_att_k.b``) have
a zero gradient analytically and roundoff in practice, which Adam turns
into steps of either sign: across the two packages they are not
compared (as in ``test_torch_training.py``); against the port's own
unsharded run they are held to the model's largest entry.  Every row of
the feed counts the same number of labels, so each rank's loss has the
same denominator and the mesh step's DDP semantics (each rank's loss
over its rows, gradients averaged over dp) equal the global batch's.

The same spawn runs the flash and fused-CE ops' tp branches on a dp4 x
tp2 mesh, held to the reference's ``shard_map`` branches on the
conftest's 8-device CPU mesh.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr

import torch_mesh_workers as W
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

STEPS = 3

CONFIGS = [
    ("dp8", dict(axes={"dp": 8})),
    ("dp8_zero_off", dict(axes={"dp": 8}, env={"PADDLE_TPU_ZERO": "0"})),
    ("dp4xtp2", dict(axes={"dp": 4, "tp": 2})),
    ("dp2xfsdp4", dict(axes={"dp": 2, "fsdp": 4}, fsdp=True, memopt=True)),
    ("dp2xfsdp4_rs_off", dict(axes={"dp": 2, "fsdp": 4}, fsdp=True,
                              memopt=True,
                              env={"PADDLE_TPU_ZERO3_RS": "0"})),
    ("dp2xfsdp2xtp2", dict(axes={"dp": 2, "fsdp": 2, "tp": 2}, fsdp=True,
                           memopt=True)),
    ("dp8_accum", dict(axes={"dp": 8}, accum=2)),
]


def _reference(opt, feeds=None):
    """The JAX package's startup state and its unsharded three steps."""
    main, startup, outs = W.build_gpt(pt, jtr, opt)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    state = {v.name: np.asarray(scope.get(v.name))
             for v in main.persistable_vars()}
    losses = []
    for f in feeds or _feeds():
        r = exe.run(main, feed=f, fetch_list=[outs["avg_cost"]],
                    scope=scope)
        losses.append(float(np.asarray(r[0]).reshape(-1)[0]))
    params = {p.name: np.asarray(scope.get(p.name))
              for p in main.all_parameters()}
    return state, losses, params


def _port_unsharded(state, opt, feeds=None):
    main, _startup, outs = W.build_gpt(tpt, ttr, opt)
    scope = tpt.Scope()
    tpt.load_numpy_state(scope, state, device="cpu")
    exe = tpt.Executor(tpt.CPUPlace())
    losses = []
    for f in feeds or _feeds():
        r = exe.run(main, feed=f, fetch_list=[outs["avg_cost"]],
                    scope=scope)
        losses.append(float(np.asarray(r[0]).reshape(-1)[0]))
    return losses, {p.name: scope.get(p.name).numpy().copy()
                    for p in main.all_parameters()}


def _feeds():
    return [W.gpt_feed(seed=5 + i) for i in range(STEPS)]


def _tp_inputs():
    rng = np.random.default_rng(11)
    b, t, h, d = 4, 16, 4, 16
    flash = {n: rng.standard_normal((b, t, h * d)).astype(np.float32)
             for n in ("q", "k", "v", "g")}
    flash["n_head"] = h
    n, dm, v = 16, 32, 64
    y = rng.integers(0, v, (n,)).astype(np.int64)
    y[3] = -1
    ce = {"x": rng.standard_normal((n, dm)).astype(np.float32),
          "w": (0.3 * rng.standard_normal((dm, v))).astype(np.float32),
          "y": y, "g": rng.standard_normal((n,)).astype(np.float32)}
    return flash, ce


@pytest.fixture(scope="module")
def runs():
    # the JAX package's runs on its xla_ref kernels; the port's (which
    # reads the same variable, naming its own backends) on auto
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_KERNEL_BACKEND", "xla_ref")
        refs = {o: _reference(o) for o in ("adam",)}
    return _runs(refs)


def _runs(refs):
    state = {o: r[0] for o, r in refs.items()}
    flash, ce = _tp_inputs()
    ranks = W.spawn(8, _both, CONFIGS, state, _feeds(), flash, ce)
    port = {o: _port_unsharded(state[o], o) for o in refs}
    return {"refs": refs, "port": port, "ranks": ranks,
            "tp_inputs": (flash, ce)}


def _both(rank, world, configs, state, feeds, flash, ce):
    return {"train": W.train_configs(rank, world, configs, state, feeds),
            "tp": W.tp_branches(rank, world, flash, ce)}


def _rel(a, b, scale=None):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (scale or max(np.abs(np.asarray(b)).max(), 1e-30)))


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_mesh_training_matches_unsharded(runs, name):
    opt = dict(CONFIGS)[name].get("opt", "adam")
    _state, ref_losses, ref_params = runs["refs"][opt]
    port_losses, port_params = runs["port"][opt]
    got = runs["ranks"][0]["train"][name]
    for r in runs["ranks"]:            # every rank reports the same loss
        assert r["train"][name]["losses"] == got["losses"]
    for a, b in zip(got["losses"], ref_losses):
        assert abs(a - b) / abs(b) < 2e-4, (name, got["losses"], ref_losses)
    for a, b in zip(got["losses"], port_losses):
        assert abs(a - b) / abs(b) < 2e-4
    biggest = max(np.abs(v).max() for v in port_params.values())
    for k, want in ref_params.items():
        if "_att_k.b" in k:
            continue
        assert _rel(got["params"][k], want) < 1e-3, (name, k)
    for k, want in port_params.items():
        scale = biggest if "_att_k.b" in k else None
        assert _rel(got["params"][k], want, scale) < 1e-3, (name, k)


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_every_rank_log_satisfies_the_training_step_contract(runs, name):
    for rank, r in enumerate(runs["ranks"]):
        assert r["train"][name]["viol"] == [], (name, rank)
    plan = runs["ranks"][0]["train"][name]["plan"]        # what ran
    ref_plan = runs["ranks"][0]["train"][name]["ref_plan"]
    kinds = {(row["kind"], row["axes"], row["phase"]) for row in plan}
    assert ("all-reduce", "dp", "boundary") in kinds
    assert not any(row["kind"] == "reduce-scatter" for row in plan)
    cfg = dict(CONFIGS)[name]
    if cfg.get("fsdp"):
        assert any(row["kind"] == "all-gather" and row["axes"] == "fsdp"
                   and row["in_loop"] for row in plan)
        rs = cfg.get("env", {}).get("PADDLE_TPU_ZERO3_RS", "1") != "0"
        # a FSDP block's all-reduce over dp is the reference's
        # reduce-scatter over dp and fsdp, at the block's volume
        scatters = [row for row in ref_plan
                    if row["kind"] == "reduce-scatter"]
        assert bool(scatters) == rs
        assert all(row["phase"] == "boundary" and "dp" in row["axes"]
                   and "fsdp" in row["axes"] for row in scatters)
        ran = sum(row["bytes"] for row in plan if row["kind"] == "all-reduce"
                  and row["phase"] == "boundary")
        named = sum(row["bytes"] for row in ref_plan
                    if row["kind"] in ("all-reduce", "reduce-scatter")
                    and row["phase"] == "boundary")
        assert ran == named
    if cfg["axes"].get("tp", 1) > 1:
        assert any(row["axes"] == "tp" and row["phase"] == "forward"
                   and row["kind"] == "all-reduce" for row in plan)
    zero = cfg.get("env", {}).get("PADDLE_TPU_ZERO", "1") != "0"
    if set(cfg["axes"]) == {"dp"}:
        gathers = [row for row in plan if row["kind"] == "all-gather"
                   and row["phase"] == "boundary" and row["count"] > 1]
        assert bool(gathers) == zero     # ZeRO-1's parameter gathers


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_ranks_holding_one_block_hold_it_alike(runs, name):
    """Replicas over dp, tp and fsdp stay bit for bit alike: a replicated
    parameter's gradient is averaged over every axis that holds it."""
    held = {}
    for r in runs["ranks"]:
        for key, digest in r["train"][name]["blocks"].items():
            held.setdefault(key, []).append(digest)
    assert all(len(set(d)) == 1 for d in held.values())
    assert all(len(d) > 1 for d in held.values())     # dp replicates all
    axes = dict(CONFIGS)[name]["axes"]
    if axes.get("tp", 1) > 1 or axes.get("fsdp", 1) > 1:
        plan = runs["ranks"][0]["train"][name]["plan"]
        assert any(row["kind"] == "all-reduce" and row["phase"] == "boundary"
                   and row["axes"].startswith("dpx") for row in plan)


def _reference_tp(flash, ce):
    """The reference's tp branches (shard_map over a dp4 x tp2 mesh of
    the conftest's 8 CPU devices) and their gradients."""
    from paddle_tpu.ops.pallas_attention import flash_attention_packed_op
    from paddle_tpu.ops.pallas_ce import fused_softmax_ce_head_op

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("dp", "tp"))
    ctx = types.SimpleNamespace(executor=types.SimpleNamespace(mesh=mesh))

    def attn(q, k, v):
        return flash_attention_packed_op(
            q, k, v, n_head=flash["n_head"], causal=True, _ctx=ctx)["Out"]

    q, k, v, g = (jnp.asarray(flash[n]) for n in ("q", "k", "v", "g"))

    @jax.jit
    def attn_vjp(q, k, v, g):
        out, vjp = jax.vjp(attn, q, k, v)
        return out, vjp(g)

    out, grads = attn_vjp(q, k, v, g)

    def head(x, w):
        return fused_softmax_ce_head_op(
            x, w, jnp.asarray(ce["y"]), _ctx=ctx)["Loss"][..., 0]

    x, w = jnp.asarray(ce["x"]), jnp.asarray(ce["w"])

    @jax.jit
    def head_vjp(x, w, g):
        loss, vjp = jax.vjp(head, x, w)
        return loss, vjp(g)

    loss, (dx, dw) = head_vjp(x, w, jnp.asarray(ce["g"]))
    return out, grads, loss, dx, dw


def test_tp_branches_match_the_reference_shard_map(runs):
    flash, ce = runs["tp_inputs"]
    out, grads, loss, dx, dw = _reference_tp(flash, ce)
    for r in runs["ranks"]:
        got = r["tp"]
        assert got["flash"]["placement"] == 2
        assert _rel(got["flash"]["out"], out) < 1e-5
        for a, b in zip(got["flash"]["grads"], grads):
            assert _rel(a, b) < 1e-4
        assert _rel(got["ce"]["loss"], loss) < 1e-5
        assert _rel(got["ce"]["dx"], dx) < 1e-4
        assert _rel(got["ce"]["dw"], dw) < 1e-4
        kinds = {k for k, _ in got["log"]}
        assert "all-reduce" in kinds      # the lse merge and dX's sum
