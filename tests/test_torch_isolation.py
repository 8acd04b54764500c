"""The port stands on its own: nothing under paddle_tpu_torch/, and
nothing in chip_smoke.py, imports jax or the JAX package; importing the
port's serving stack leaves jax out of ``sys.modules``; and chip_smoke.py
refuses to run (non-zero exit, no result line) without a card or
without the rest of the repository."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def _run(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable] + list(code_or_args))
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_serving_import_leaves_jax_out():
    r = _run("import sys, paddle_tpu_torch.serving, "
             "paddle_tpu_torch.models.transformer\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')]\n"
             "assert not bad, bad\nprint('clean')", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_kernel_sources_and_build_flags():
    from paddle_tpu_torch.kernels import _build

    assert "paged_attention" in _build.sources()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert _build.lib_path("paged_attention").startswith(_build.BUILD_DIR)


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["chip_smoke.py"], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
