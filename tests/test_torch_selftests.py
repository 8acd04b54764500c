"""The port's selftest flags and the two subcommands added beside them, on
the CPU, through ``paddle_tpu_torch.__main__.main``.

* ``--metrics-selftest``, ``--memory-selftest``, ``--lint-selftest``,
  ``--trace-selftest``, ``--resilience-selftest``, ``--tune-selftest``,
  ``--costmodel-selftest``, ``--attribution-selftest`` and
  ``--spec-selftest`` with ``--device=cpu`` each exit 0 (each prints its
  own checks);
* ``--bench-history`` exits 0 on clean artifacts and 1 on an
  unacknowledged failure, one JSON summary line on stdout; ``--lint``
  returns the reference's codes: 0 clean, 1 on error findings, 2 under
  ``--strict``;
* a JAX-package flag that is not ported exits 2 naming its ROADMAP.md
  item, and is not ignored;
* ``dump_config`` prints what the JAX package's prints for the same
  config, and ``merge_model`` writes the same tar members.
"""

import os
import tarfile

import pytest

from paddle_tpu_torch import tune
from paddle_tpu_torch.__main__ import (SELFTESTS, _UNPORTED, _take_device,
                                       main)

PORTED = ("--metrics-selftest", "--memory-selftest", "--lint-selftest",
          "--trace-selftest", "--resilience-selftest", "--tune-selftest",
          "--costmodel-selftest", "--attribution-selftest",
          "--spec-selftest")
# the flags that take their own arguments
ARGV_FLAGS = ("--bench-history", "--lint")


@pytest.fixture(autouse=True)
def _tmp_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "t.json"))
    tune.reset_cache()
    yield
    tune.reset_cache()


@pytest.mark.parametrize("flag", PORTED)
def test_selftest_flag_exits_zero_on_the_cpu(flag, capsys):
    assert main([flag, "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASSED" in out and "FAIL " not in out and "  FAIL" not in out


def test_dispatch_order_is_the_references():
    """The port walks the JAX package's flags in its order; every flag it
    does not run names the ROADMAP item that ports it."""
    flags = [f for f, _ in SELFTESTS]
    assert flags[:3] == ["--metrics-selftest", "--memory-selftest",
                         "--multichip-selftest"]
    assert flags.index("--resilience-selftest") < flags.index(
        "--tune-selftest") < flags.index("--spec-selftest")
    assert {f for f, fn in SELFTESTS if fn is None} == set(_UNPORTED) == {
        "--multichip-selftest", "--sharding-selftest", "--kernels-selftest"}
    assert set(PORTED) | set(ARGV_FLAGS) == {
        f for f, fn in SELFTESTS if fn is not None}
    assert _take_device(["--tune-selftest"]) is None          # the card
    assert _take_device(["--device=cpu", "--spec-selftest"]) == "cpu"
    assert _take_device(["--spec-selftest", "--device", "cuda:0"]) == "cuda:0"


@pytest.mark.parametrize("flag", sorted(_UNPORTED))
def test_unported_flag_exits_nonzero_naming_its_item(flag, capsys):
    assert main([flag, "--device=cpu"]) == 2
    assert "ROADMAP.md A" in capsys.readouterr().err


def test_bench_history_flag(tmp_path, capsys):
    """Clean artifacts: rc 0; an unacknowledged failed one: rc 1; one
    parseable JSON summary line on stdout either way."""
    import json

    for n, value in ((1, 100.0), (2, 101.0)):
        (tmp_path / f"BENCH_r0{n}.json").write_text(json.dumps(
            {"n": n, "rc": 0, "parsed": {"metric": "m", "value": value}}))
    assert main(["--bench-history", "--dir", str(tmp_path),
                 "--device=cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])["ok"] is True
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(
        {"n": 3, "rc": 1, "parsed": None}))
    assert main(["--bench-history", "--dir", str(tmp_path)]) == 1
    summary = json.loads(capsys.readouterr().out)
    assert summary["failed"] == ["BENCH_r03.json"] and not summary["ok"]


_PLANTED_CONFIG = '''
import paddle_tpu_torch as pt


def build():
    x = pt.layers.data("x", shape=[4], dtype="float32")
    y = pt.layers.fc(x, size=2)
    blk = pt.default_main_program().global_block()
    a = blk.create_var(name="a", shape=(-1, 4), dtype="float32")
    blk.append_op("relu", {"X": [a.name]}, {"Out": [y.name]})
    return {"feed": [x], "avg_cost": pt.layers.mean(y)}
'''


def test_lint_flag_return_codes(tmp_path, capsys):
    """A config whose op reads an undefined var: rc 1 (the finding
    printed), rc 2 under --strict; --json gives the reference's schema;
    a clean config: rc 0."""
    import json

    from paddle_tpu_torch import analysis

    bad = tmp_path / "bad.py"
    bad.write_text(_PLANTED_CONFIG)
    assert main(["--lint", str(bad), "--levels", "program"]) == 1
    assert "program.read-before-write" in capsys.readouterr().out
    assert main(["--lint", str(bad), "--strict", "--levels",
                 "program"]) == 2
    assert "lint found" in capsys.readouterr().out
    assert main(["--lint", str(bad), "--json", "--levels", "program"]) == 1
    obj = json.loads(capsys.readouterr().out)
    assert obj["schema_version"] == 1 and not obj["ok"]
    assert "program.read-before-write" in analysis.report_from_json(
        obj).ids()
    good = tmp_path / "good.py"
    good.write_text(_CONFIG.format(pkg="paddle_tpu_torch"))
    assert main(["--lint", str(good), "--device=cpu"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


_CONFIG = '''
import {pkg} as pt


def build():
    x = pt.layers.data("x", shape=[4], dtype="float32")
    y = pt.layers.data("y", shape=[1], dtype="float32")
    h = pt.layers.fc(x, size=3, act="relu")
    cost = pt.layers.mean(pt.layers.square_error_cost(
        pt.layers.fc(h, size=1), y))
    pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(cost)
    return {{"feed": [x, y], "avg_cost": cost}}


def train_reader():
    yield [0.0, 1.0, 2.0, 3.0], [1.0]
'''


def test_dump_config_prints_what_the_reference_prints(tmp_path, capsys):
    from paddle_tpu.__main__ import main as jmain
    from paddle_tpu_torch.core import unique_name

    outs = {}
    for pkg, entry in (("paddle_tpu", jmain), ("paddle_tpu_torch", main)):
        cfg = tmp_path / f"{pkg}_cfg.py"
        cfg.write_text(_CONFIG.format(pkg=pkg))
        unique_name.reset()
        __import__("paddle_tpu").core.unique_name.reset()
        assert entry(["dump_config", str(cfg), "--startup"]) == 0
        outs[pkg] = capsys.readouterr().out
    assert outs["paddle_tpu_torch"] == outs["paddle_tpu"]
    assert "momentum" in outs["paddle_tpu"] and "startup program" in \
        outs["paddle_tpu"]
    with pytest.raises(SystemExit, match="A9"):
        main(["dump_config", str(tmp_path / "paddle_tpu_torch_cfg.py"),
              "--dot"])


def test_merge_model_writes_the_references_tar(tmp_path, capsys):
    from paddle_tpu.__main__ import main as jmain

    model = tmp_path / "model"
    model.mkdir()
    for name, data in (("__model__", b"program"), ("fc_0.w", b"\x00\x01"),
                       ("fc_0.b", b"\x02")):
        (model / name).write_bytes(data)
    members = {}
    for pkg, entry in (("jax", jmain), ("torch", main)):
        out = tmp_path / f"{pkg}.tar"
        assert entry(["merge_model", str(model), str(out)]) == 0
        with tarfile.open(out) as tar:
            members[pkg] = [(m.name, tar.extractfile(m).read())
                            for m in tar.getmembers()]
    assert members["torch"] == members["jax"] and len(members["jax"]) == 3
    with pytest.raises(SystemExit):
        main(["merge_model", os.path.join(str(tmp_path), "absent"),
              str(tmp_path / "x.tar")])
