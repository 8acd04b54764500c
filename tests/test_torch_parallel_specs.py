"""The port's spec rules (``paddle_tpu_torch/parallel/api.py``) equal the
JAX package's, spec for spec, in one process (no process group: a port
mesh is ranks on named axes, the reference's the conftest's 8 CPU
devices).

For the 2-layer GPT (memory-optimized, so ``shard_fsdp`` reads its layer
groups) and a small ResNet, under dp8, dp4 x tp2, dp2 x fsdp4 and
dp2 x fsdp2 x tp2, after the same annotations in both packages (the tp
rules, ``data_parallel``, ``shard_fsdp``): every variable's
``zero_spec_for``, ``fsdp_spec_for``, ``grad_rs_spec_for`` and resolved
spec, the recorded fallback reasons, ``sharding_report`` and
``optimizer_state_report`` byte for byte, with the kill switches on and
off.
"""

import jax
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import resnet as jres
from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel import api as japi
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.parallel import api as tapi
from paddle_tpu_torch.parallel.mesh import make_mesh as tmake_mesh

MESHES = {"dp8": {"dp": 8}, "dp4xtp2": {"dp": 4, "tp": 2},
          "dp2xfsdp4": {"dp": 2, "fsdp": 4},
          "dp2xfsdp2xtp2": {"dp": 2, "fsdp": 2, "tp": 2}}


def _gpt(pkg, tr):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        tr.build(vocab_size=250, n_layer=2, n_head=2, d_model=64,
                 max_len=16, dropout_rate=0.0, dtype="float32",
                 fused_head=True)
    pkg.memory_optimize(main, policy="selective")
    return main, startup


def _resnet(pkg, res):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        res.build(depth=8, class_dim=10, image_shape=(3, 32, 32))
    return main, startup


def _annotated(model, axes):
    out = []
    for pkg, api, mods in ((pt, japi, (jtr, jres)), (tpt, tapi, (ttr, tres))):
        tr, res = mods
        main, startup = _gpt(pkg, tr) if model == "gpt" else \
            _resnet(pkg, res)
        if model == "gpt" and axes.get("tp", 1) > 1:
            for prog in (main, startup):
                api.shard_parameters_by_rule(prog, tr.tp_rules())
        api.data_parallel(main, "dp", programs=(startup,))
        tagged = api.shard_fsdp(main, programs=(startup,)) \
            if "fsdp" in axes else []
        out.append((main, tagged))
    return out


def _spec(s):
    return None if s is None else tuple(s)


@pytest.mark.parametrize("model", ["gpt", "resnet"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("switch", [None, "PADDLE_TPU_ZERO",
                                    "PADDLE_TPU_FSDP",
                                    "PADDLE_TPU_ZERO3_RS"])
def test_spec_rules_equal_the_reference(model, mesh, switch, monkeypatch):
    if switch:
        monkeypatch.setenv(switch, "0")
    axes = MESHES[mesh]
    (jmain, jtag), (tmain, ttag) = _annotated(model, axes)
    assert jtag == ttag
    jm = jmake_mesh(axes, devices=jax.devices()[:8])
    tm = tmake_mesh(axes)
    jb, tb = jmain.global_block(), tmain.global_block()
    assert sorted(jb.vars) == sorted(tb.vars)
    for name in sorted(jb.vars):
        jv, tv = jb.vars[name], tb.vars[name]
        for fn in ("zero_spec_for", "fsdp_spec_for", "grad_rs_spec_for",
                   "_spec_for"):
            want = _spec(getattr(japi, fn)(jv, jm, jb))
            got = _spec(getattr(tapi, fn)(tv, tm, tb))
            assert got == want, (fn, name, got, want)
    assert getattr(tb, "_shard_fallbacks", {}) == \
        getattr(jb, "_shard_fallbacks", {})
    jrep, trep = japi.sharding_report(jmain, jm), \
        tapi.sharding_report(tmain, tm)
    for sec in ("params", "opt_state", "grads"):
        for k in ("total_bytes", "per_device_bytes", "sharded_vars",
                  "replicated_vars"):
            assert trep[sec][k] == jrep[sec][k], (sec, k)
        assert {n: (v["bytes"], v["per_device_bytes"])
                for n, v in trep[sec]["vars"].items()} == \
            {n: (v["bytes"], v["per_device_bytes"])
             for n, v in jrep[sec]["vars"].items()}
    assert tapi.optimizer_state_report(tmain, tm)["per_device_bytes"] == \
        japi.optimizer_state_report(jmain, jm)["per_device_bytes"]


def test_fallback_reasons_on_indivisible_shapes():
    """An odd vocabulary: the embedding's and the head's fsdp and dp
    shards fall back with the reference's reasons."""
    out = []
    for pkg, api, tr, mk in ((pt, japi, jtr, lambda a: jmake_mesh(
            a, devices=jax.devices()[:8])), (tpt, tapi, ttr, tmake_mesh)):
        pkg.core.unique_name.reset()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            tr.build(vocab_size=61, n_layer=2, n_head=2, d_model=36,
                     max_len=15, dropout_rate=0.0, dtype="float32")
        pkg.memory_optimize(main, policy="selective")
        api.shard_fsdp(main, programs=(startup,))
        mesh = mk({"dp": 2, "fsdp": 4})
        block = main.global_block()
        specs = {n: _spec(api._spec_for(v, mesh, block))
                 for n, v in block.vars.items()}
        out.append((specs, dict(block._shard_fallbacks)))
    assert out[0] == out[1]
    assert any("not divisible" in r for r in out[1][1].values())


def test_scalar_and_untagged_vars_replicate():
    mesh = tmake_mesh({"dp": 8})
    prog = tpt.Program()
    v = prog.global_block().create_var(name="s", shape=(), dtype="float32")
    assert tapi.zero_spec_for(v, mesh, prog.global_block()) is None
    assert tuple(tapi._spec_for(v, mesh, prog.global_block())) == ()
    assert tapi.compile_shardings(mesh, prog, ["s", "@RNG@"]) == {
        "s": tapi.P(), "@RNG@": tapi.P()}
    assert tapi.axis_size(mesh, "tp") == 0 and tapi.axis_size(None, "dp") == 0


def test_sparse_rows_match_the_reference():
    """``parallel.sparse``: the row-shard annotation, the SelectedRows
    compression and its SGD apply, against the JAX package's."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.parallel import sparse as jsp
    from paddle_tpu_torch.parallel import sparse as tsp

    rng = np.random.default_rng(3)
    ids = rng.integers(0, 10, (4, 3))
    grad = rng.standard_normal((4, 3, 5)).astype(np.float32)
    table = rng.standard_normal((10, 5)).astype(np.float32)
    jr, jv = jsp.sparse_rows_from_grad(jnp.asarray(grad), jnp.asarray(ids),
                                       10)
    tr, tv = tsp.sparse_rows_from_grad(torch.from_numpy(grad),
                                       torch.from_numpy(ids), 10)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tsp.apply_sparse_rows(torch.from_numpy(table), tr, tv, 0.1).numpy(),
        np.asarray(jsp.apply_sparse_rows(jnp.asarray(table), jr, jv, 0.1)),
        rtol=1e-6, atol=1e-6)
    prog = tpt.Program()
    w = prog.global_block().create_var(name="emb", shape=(10, 5),
                                       dtype="float32")
    assert tuple(tsp.row_shard_embedding(w).partition_spec) == ("tp", None)
