"""The port's ``analysis.comm`` (CommOp, CommPlan, CommContract,
comm_diff) against the JAX package's on the same hand-built op lists,
and the port's canned contracts (``parallel/contracts.py``) against the
reference's on the meshes where they are the same rules (no tp axis)."""

import jax
import pytest

from paddle_tpu.analysis import comm as jcomm
from paddle_tpu.parallel import contracts as jcon
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu_torch.analysis import comm as tcomm
from paddle_tpu_torch.parallel import contracts as tcon
from paddle_tpu_torch.parallel.mesh import make_mesh as tmake_mesh

# (kind, bytes, axes, in_loop, phase, provenance)
OPS_A = [
    ("all-reduce", 4096, ("dp",), False, "boundary", {"var": "w,b"}),
    ("all-gather", 2048, ("fsdp",), True, "fwd-scan", {"var": "w"}),
    ("all-gather", 2048, ("fsdp",), True, "bwd-scan", None),
    ("reduce-scatter", 1024, ("dp", "fsdp"), False, "boundary",
     {"site": "grad_rs_boundary:w"}),
    ("all-reduce", 512, ("tp",), True, "fwd-scan", {"var": "h_3"}),
    ("collective-permute", 256, None, False, "boundary", None),
]
OPS_B = OPS_A[:3] + [
    ("all-reduce", 8192, ("dp",), True, "bwd-scan", {"var": "w"}),
    ("all-gather", 64, ("dp",), False, "boundary", {"var": "p"}),
]


def _plans(ops):
    def mk(mod):
        return mod.CommPlan(
            [mod.CommOp(k, b, a, l, ph, provenance=pv)
             for k, b, a, l, ph, pv in ops],
            {"dp": 2, "fsdp": 2, "tp": 2}, "step")
    return mk(jcomm), mk(tcomm)


def _contracts(mod):
    c1 = mod.CommContract("boundary")
    c1.forbid(kind="reduce", in_loop=True)
    c1.expect(kind="reduce", axis="dp", min_count=1, in_loop=False)
    c2 = mod.CommContract("gathers")
    c2.expect(kind="all-gather", axis="fsdp", count=2)
    c2.expect(kind="gather", max_count=2, phase="boundary")
    c2.forbid_reshard(r"^h_")
    c3 = mod.CommContract("rs")
    c3.expect(kind="reduce-scatter", axis="fsdp", in_loop=False,
              phase="boundary", count=1)
    c3.forbid(kind="any", axis="tp")
    return [c1, c2, c3]


@pytest.mark.parametrize("ops", [OPS_A, OPS_B], ids=["a", "b"])
def test_plan_and_contracts_match_the_reference(ops):
    jp, tp = _plans(ops)
    assert [o.describe() for o in tp] == [o.describe() for o in jp]
    assert [o.to_dict() for o in tp] == [o.to_dict() for o in jp]
    assert tp.summary() == jp.summary()
    assert tp.comm_report() == jp.comm_report()
    assert tp.buckets() == jp.buckets()
    assert [o.describe() for o in tp.unattributed()] == \
        [o.describe() for o in jp.unattributed()]
    for sel in ({"kind": "reduce"}, {"kind": "gather", "in_loop": True},
                {"axis": "fsdp"}, {"phase": "boundary"},
                {"provenance": r"^w$"}, {"kind": "any", "axis": "dp"}):
        assert [o.describe() for o in tp.select(**sel)] == \
            [o.describe() for o in jp.select(**sel)], sel
    for jc, tc in zip(_contracts(jcomm), _contracts(tcomm)):
        assert tc.to_dict() == jc.to_dict()
        assert tc.check(tp) == jc.check(jp)
        assert [o.describe() for o in tc.covered(tp)] == \
            [o.describe() for o in jc.covered(jp)]
        assert tc.loop_insensitive().to_dict() == \
            jc.loop_insensitive().to_dict()


def test_comm_diff_matches_the_reference():
    ja, ta = _plans(OPS_A)
    jb, tb = _plans(OPS_B)
    assert tcomm.comm_diff(ta, tb, "x", "y") == \
        jcomm.comm_diff(ja, jb, "x", "y")
    assert tcomm.comm_diff(ta, ta)["same"]


def test_plan_from_log_and_attached_contracts():
    log = [{"kind": k, "bytes": b, "axes": a, "in_loop": l, "phase": ph,
            **(pv or {})} for k, b, a, l, ph, pv in OPS_A]
    plan = tcomm.plan_from_log(log, {"dp": 2}, "step")
    _jp, tp = _plans(OPS_A)
    assert [o.describe() for o in plan] == [o.describe() for o in tp]
    prog = object.__new__(type("Prog", (), {}))
    c = tcomm.attach_comm_contract(prog, tcomm.CommContract("x"))
    assert tcomm.comm_contracts(prog) == [c]
    with pytest.raises(ValueError, match="unknown collective kind"):
        tcomm.CommContract("bad").expect(kind="all-to-none")


def test_a_fsdp_block_all_reduce_is_the_reference_reduce_scatter():
    """The port's log holds what ran — a FSDP block's boundary all-reduce
    over dp — and ``reference=True`` names it as the reference's compiled
    step does, so the reference's ZeRO-3 contract reads it."""
    log = [{"kind": "all-reduce", "bytes": 512, "axes": ("dp",),
            "in_loop": False, "phase": "boundary", "var": "w",
            "block": ("fsdp",)},
           {"kind": "all-reduce", "bytes": 64, "axes": ("dp", "fsdp"),
            "in_loop": False, "phase": "boundary", "var": "ln.w"},
           {"kind": "all-gather", "bytes": 1024, "axes": ("fsdp",),
            "in_loop": True, "phase": "fwd-scan", "var": "w"}]
    ran = tcomm.plan_from_log(log, {"dp": 2, "fsdp": 4})
    named = tcomm.plan_from_log(log, {"dp": 2, "fsdp": 4}, reference=True)
    assert [o.describe() for o in ran] == [
        "all-reduce@dp boundary 512B [var=w]",
        "all-reduce@dpxfsdp boundary 64B [var=ln.w]",
        "all-gather@fsdp fwd-scan in-loop 1024B [var=w]"]
    assert [o.describe() for o in named][0] == \
        "reduce-scatter@dpxfsdp boundary 512B [var=w]"
    assert [o.describe() for o in named][1:] == [
        o.describe() for o in ran][1:]
    mesh = tmake_mesh({"dp": 2, "fsdp": 4})
    assert tcon.zero3_grad_contract(mesh).check(named) == []
    assert tcon.zero3_grad_contract(mesh).check(ran) != []


@pytest.mark.parametrize("axes", [{"dp": 8}, {"dp": 2, "fsdp": 4},
                                  {"fsdp": 8}])
@pytest.mark.parametrize("flags", [(False, False, False),
                                   (True, False, False),
                                   (False, True, True), (True, True, False)])
def test_canned_contracts_match_the_reference(axes, flags):
    jm = jmake_mesh(axes, devices=jax.devices()[:8])
    tm = tmake_mesh(axes)
    accum, fsdp, rs = flags
    js = jcon.training_step_contract(jm, accum=accum, fsdp=fsdp,
                                     grad_rs=rs)
    ts = tcon.training_step_contract(tm, accum=accum, fsdp=fsdp,
                                     grad_rs=rs)
    assert [c.to_dict() for c in ts] == [c.to_dict() for c in js]
    jp, tp = _plans(OPS_A)
    assert [c.check(tp) for c in ts] == [c.check(jp) for c in js]
    assert tcon.zero3_grad_contract(tm, n_grads=3).to_dict() == \
        jcon.zero3_grad_contract(jm, n_grads=3).to_dict()


def test_tp_meshes_narrow_the_in_loop_forbid_to_dp():
    """On a tp mesh the port's one-boundary and FSDP contracts forbid
    in-loop reduces over dp only (tp's per-layer sums are forward math),
    as the reference's zero3_grad_contract does."""
    tm = tmake_mesh({"dp": 2, "fsdp": 2, "tp": 2})
    ops = [tcomm.CommOp("all-reduce", 8, ("tp",), True, "fwd-scan"),
           tcomm.CommOp("all-gather", 8, ("fsdp",), True, "fwd-scan"),
           tcomm.CommOp("all-reduce", 8, ("dp",), False, "boundary"),
           tcomm.CommOp("reduce-scatter", 8, ("dp", "fsdp"), False,
                        "boundary")]
    plan = tcomm.CommPlan(ops, tm.shape)
    cs = tcon.training_step_contract(tm, fsdp=True, grad_rs=True)
    assert [v for c in cs for v in c.check(plan)] == []
    bad = tcomm.CommPlan(ops + [tcomm.CommOp(
        "all-reduce", 8, ("dp",), True, "bwd-scan")], tm.shape)
    assert any(c.check(bad) for c in cs)
