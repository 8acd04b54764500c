"""The port's selftest flags and the two subcommands added beside them, on
the CPU, through ``paddle_tpu_torch.__main__.main``.

* ``--metrics-selftest``, ``--trace-selftest``, ``--resilience-selftest``,
  ``--tune-selftest`` and ``--spec-selftest`` with ``--device=cpu`` each
  exit 0 (each prints its own checks);
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

PORTED = ("--metrics-selftest", "--trace-selftest", "--resilience-selftest",
          "--tune-selftest", "--spec-selftest")


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
    assert {f for f, fn in SELFTESTS if fn is None} == set(_UNPORTED)
    assert set(PORTED) == {f for f, fn in SELFTESTS if fn is not None}
    assert _take_device(["--tune-selftest"]) is None          # the card
    assert _take_device(["--device=cpu", "--spec-selftest"]) == "cpu"
    assert _take_device(["--spec-selftest", "--device", "cuda:0"]) == "cuda:0"


@pytest.mark.parametrize("flag", sorted(_UNPORTED))
def test_unported_flag_exits_nonzero_naming_its_item(flag, capsys):
    assert main([flag, "--device=cpu"]) == 2
    assert "ROADMAP.md A" in capsys.readouterr().err


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
