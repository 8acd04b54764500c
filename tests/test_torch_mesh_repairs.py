"""Two reductions over a whole value on the port's mesh path, held to the
JAX package's unsharded run, and the boundary's overlap knob.

* Clipping on tp and FSDP meshes: the 2-layer GPT (d64, 2 heads, vocab
  256, f32, the fused CE head) with Momentum (lr 0.5, momentum 0.9)
  clipped by ``GradientClipByGlobalNorm(0.05)``, and with every
  parameter's ``GradientClipByNorm(0.02)`` — small enough that every
  step clips — three steps on dp2 x tp2 and dp2 x fsdp2.  A tp or FSDP
  rank holds a block of a gradient; the clip's norm is the whole
  gradient's (the reference's jitted step sees whole values).
* BatchNorm on dp4: ``resnet_cifar10`` depth 8 at 16x16, f32, Momentum,
  three steps on a global batch of 8 (two rows a rank).  The reference's
  statistics are the whole batch's; so are the port's on a mesh.
* The overlap knob (``PADDLE_TPU_COMM_OVERLAP``, default on): the
  global-clip GPT on dp4 and dp2 x tp2 with the knob on and off, bit for
  bit equal, and the reductions started during the backward counted.

One spawn of 4 gloo ranks runs every configuration.  Tolerances: losses
within 2e-4 relative; every persistable (parameters, velocities, BN
running statistics) within 1e-3 of the tensor's largest entry, as
``test_torch_mesh_training.py`` holds them.  The reference runs its
attention and fused head through its kernel registry's ``xla_ref``
backend.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models import resnet as jrn
from paddle_tpu.models import transformer as jtr

import torch_mesh_workers as W
import torch_parallel_workers as PW
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

STEPS = 3

CONFIGS = [
    ("global_dp2xtp2", dict(axes={"dp": 2, "tp": 2}, model="global")),
    ("global_dp2xfsdp2", dict(axes={"dp": 2, "fsdp": 2}, model="global",
                              fsdp=True)),
    ("norm_dp2xtp2", dict(axes={"dp": 2, "tp": 2}, model="norm")),
    ("norm_dp2xfsdp2", dict(axes={"dp": 2, "fsdp": 2}, model="norm",
                            fsdp=True)),
    ("bn_dp4", dict(axes={"dp": 4}, model="resnet")),
    ("global_dp4", dict(axes={"dp": 4}, model="global")),
    ("global_dp4_overlap_off", dict(axes={"dp": 4}, model="global",
                                    env={"PADDLE_TPU_COMM_OVERLAP": "0"})),
    ("global_dp2xtp2_overlap_off", dict(
        axes={"dp": 2, "tp": 2}, model="global",
        env={"PADDLE_TPU_COMM_OVERLAP": "0"})),
]
HELD = [c[0] for c in CONFIGS if not c[0].endswith("overlap_off")]


def _gpt_feeds():
    return [W.gpt_feed(batch=8, seed=5 + i) for i in range(STEPS)]


def _resnet_feeds():
    rng = np.random.default_rng(21)
    return [{"img": rng.standard_normal((8, 3, 16, 16)).astype(np.float32),
             "label": rng.integers(0, 10, (8, 1)).astype(np.int64)}
            for _ in range(STEPS)]


def _reference(main, startup, outs, feeds):
    """The JAX package's startup state, and its unsharded steps: losses
    and every persistable after them."""
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    state = {v.name: np.asarray(scope.get(v.name))
             for v in main.persistable_vars()}
    losses = []
    for f in feeds:
        r = exe.run(main, feed=f, fetch_list=[outs["avg_cost"]], scope=scope)
        losses.append(float(np.asarray(r[0]).reshape(-1)[0]))
    after = {n: np.asarray(scope.get(n)) for n in state}
    return state, losses, after


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_KERNEL_BACKEND", "xla_ref")
        refs = {}
        for kind in ("global", "norm"):
            refs[kind] = _reference(*PW.build_clipped_gpt(pt, jtr, kind),
                                    _gpt_feeds())
        refs["resnet"] = _reference(*PW.build_resnet(pt, jrn),
                                    _resnet_feeds())
    states = {k: r[0] for k, r in refs.items()}
    ranks = W.spawn(4, PW.repair_configs, CONFIGS, states, _gpt_feeds(),
                    _resnet_feeds())
    return refs, ranks


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", HELD)
def test_mesh_run_matches_the_unsharded_reference(runs, name):
    refs, ranks = runs
    model = dict(CONFIGS)[name]["model"]
    _state, ref_losses, ref_after = refs[model]
    got = ranks[0][name]
    for r in ranks:                     # every rank reports the same loss
        assert r[name]["losses"] == got["losses"]
    for a, b in zip(got["losses"], ref_losses):
        assert abs(a - b) / abs(b) < 2e-4, (name, got["losses"], ref_losses)
    assert got["losses"][0] != got["losses"][-1]
    for k, want in ref_after.items():
        if "_att_k.b" in k or k not in got["state"]:
            continue
        assert _rel(got["state"][k], want) < 1e-3, (name, k)
    if model == "resnet":
        stats = [k for k in ref_after if k.endswith((".mean", ".variance"))]
        assert stats and all(k in got["state"] for k in stats)


@pytest.mark.parametrize("name", HELD)
def test_replicas_stay_alike_and_contracts_hold(runs, name):
    _refs, ranks = runs
    held = {}
    for r in ranks:
        assert r[name]["viol"] == [], name
        for key, digest in r[name]["blocks"].items():
            held.setdefault(key, []).append(digest)
    assert all(len(set(d)) == 1 for d in held.values()), name


@pytest.mark.parametrize("name", ["global_dp2xtp2", "global_dp2xfsdp2",
                                  "norm_dp2xtp2", "norm_dp2xfsdp2"])
def test_clip_norm_reduces_over_the_blocks_axes(runs, name):
    """The clip's squares of a cut gradient are all-reduced over the
    axes it is cut over, at the boundary."""
    _refs, ranks = runs
    axis = "tp" if "tp" in name else "fsdp"
    plan = ranks[0][name]["plan"]
    assert any(row["kind"] == "all-reduce" and row["phase"] == "boundary"
               and row["axes"] == axis for row in plan), plan


def test_batch_norm_statistics_are_reduced_over_dp(runs):
    _refs, ranks = runs
    plan = ranks[0]["bn_dp4"]["plan"]
    phases = {row["phase"] for row in plan if row["kind"] == "all-reduce"
              and row["axes"] == "dp"}
    assert {"forward", "backward", "boundary"} <= phases, plan


@pytest.mark.parametrize("mesh", ["dp4", "dp2xtp2"])
def test_overlap_on_and_off_are_bit_equal(runs, mesh):
    _refs, ranks = runs
    on, off = f"global_{mesh}", f"global_{mesh}_overlap_off"
    assert ranks[0][on]["losses"] == ranks[0][off]["losses"]
    for k, v in ranks[0][off]["state"].items():
        assert np.array_equal(ranks[0][on]["state"][k], v), (mesh, k)
    for r in ranks:
        assert r[on]["overlapped"] > 0
        assert r[off]["overlapped"] == 0
        assert r[on]["blocks"] == r[off]["blocks"]
