"""The port stands on its own: nothing under paddle_tpu_torch/ (its
``parallel/``, ``analysis/`` and ``distributed/launch.py`` included), and
nothing in chip_smoke.py, imports jax or the JAX package; importing the
port's serving, training and mesh stacks leaves jax out of
``sys.modules``;
every entry point raises without a card unless the CPU is asked for; and
chip_smoke.py refuses to run (non-zero exit, no result line) without a
card or without the rest of the repository."""

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


SERVING_MODULES = [
    "paddle_tpu_torch.serving", "paddle_tpu_torch.serving.engine",
    "paddle_tpu_torch.serving.batched_decode",
    "paddle_tpu_torch.serving.kvcache", "paddle_tpu_torch.serving.scheduler",
    "paddle_tpu_torch.serving.speculative",
    "paddle_tpu_torch.kernels.paged_attention",
    "paddle_tpu_torch.kernels.decode_gather",
    "paddle_tpu_torch.observability.metrics",
    "paddle_tpu_torch.observability.trace",
    "paddle_tpu_torch.observability.flight",
    "paddle_tpu_torch.resilience", "paddle_tpu_torch.resilience.faults",
    "paddle_tpu_torch.models.transformer",
]


def test_every_serving_module_is_a_file_the_import_scan_covers():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in SERVING_MODULES:
        rel = mod.replace(".", "/")
        assert (rel + ".py" in scanned
                or rel + "/__init__.py" in scanned), mod


def test_serving_import_leaves_jax_out():
    r = _run("import sys\n"
             + "".join(f"import {m}\n" for m in SERVING_MODULES)
             + "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu')]\n"
             "assert not bad, bad\nprint('clean')", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


TRAINING_MODULES = [
    "paddle_tpu_torch", "paddle_tpu_torch.core.dtypes",
    "paddle_tpu_torch.core.unique_name", "paddle_tpu_torch.core.registry",
    "paddle_tpu_torch.core.scope", "paddle_tpu_torch.core.program",
    "paddle_tpu_torch.core.executor", "paddle_tpu_torch.core.place",
    "paddle_tpu_torch.param_attr", "paddle_tpu_torch.initializer",
    "paddle_tpu_torch.backward", "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.layers", "paddle_tpu_torch.layers.layer_helper",
    "paddle_tpu_torch.layers.io", "paddle_tpu_torch.layers.tensor",
    "paddle_tpu_torch.layers.ops", "paddle_tpu_torch.layers.nn",
    "paddle_tpu_torch.ops", "paddle_tpu_torch.ops.math_ops",
    "paddle_tpu_torch.ops.tensor_ops", "paddle_tpu_torch.ops.nn_ops",
    "paddle_tpu_torch.ops.activation_ops", "paddle_tpu_torch.ops.loss_ops",
    "paddle_tpu_torch.ops.random_ops", "paddle_tpu_torch.ops.optimizer_ops",
    "paddle_tpu_torch.ops.control_flow_ops",
    "paddle_tpu_torch.ops.attention_ops",
    "paddle_tpu_torch.kernels.flash_attention",
    "paddle_tpu_torch.kernels.fused_ce",
    "paddle_tpu_torch.models.transformer",
    "paddle_tpu_torch.ops.metric_ops",
    "paddle_tpu_torch.kernels.bottleneck",
    "paddle_tpu_torch.models.resnet",
    "paddle_tpu_torch.benchmarks",
    "paddle_tpu_torch.benchmarks.bottleneck",
    # the training loop, the checkpoint format and the input pipeline
    "paddle_tpu_torch.trainer", "paddle_tpu_torch.io",
    "paddle_tpu_torch.data_feeder", "paddle_tpu_torch.profiler",
    "paddle_tpu_torch.reader", "paddle_tpu_torch.reader.creator",
    "paddle_tpu_torch.reader.decorator", "paddle_tpu_torch.reader.provider",
    "paddle_tpu_torch.observability", "paddle_tpu_torch.observability.hardware",
    "paddle_tpu_torch.observability.runlog",
    "paddle_tpu_torch.observability.reporter",
    "paddle_tpu_torch.resilience.checkpoint",
    "paddle_tpu_torch.resilience.retry",
    "paddle_tpu_torch.resilience.watchdog",
    # the training recipes: clipping, regularizers, schedules
    "paddle_tpu_torch.clip", "paddle_tpu_torch.regularizer",
    "paddle_tpu_torch.learning_rate_decay",
    # the recurrent path: control flow, sequence and LSTM/GRU ops, nets,
    # the two recurrent models
    "paddle_tpu_torch.ops.sequence_ops", "paddle_tpu_torch.ops.rnn_ops",
    "paddle_tpu_torch.layers.control_flow", "paddle_tpu_torch.nets",
    "paddle_tpu_torch.models.text_classification",
    "paddle_tpu_torch.models.seq2seq",
    # CTC, the CRF and the image zoo: their ops and the seven models
    "paddle_tpu_torch.ops.ctc_ops", "paddle_tpu_torch.ops.crf_ops",
    "paddle_tpu_torch.models.deep_speech2",
    "paddle_tpu_torch.models.label_semantic_roles",
    "paddle_tpu_torch.models.lenet", "paddle_tpu_torch.models.smallnet",
    "paddle_tpu_torch.models.alexnet", "paddle_tpu_torch.models.googlenet",
    "paddle_tpu_torch.models.vgg",
    # the beam decode and the book's small models: the beam ops, the
    # dataset readers, the four models
    "paddle_tpu_torch.ops.beam_search_ops", "paddle_tpu_torch.dataset",
    "paddle_tpu_torch.dataset.common", "paddle_tpu_torch.dataset.movielens",
    "paddle_tpu_torch.dataset.uci_housing",
    "paddle_tpu_torch.dataset.imikolov", "paddle_tpu_torch.dataset.wmt14",
    "paddle_tpu_torch.models.fit_a_line", "paddle_tpu_torch.models.word2vec",
    "paddle_tpu_torch.models.recommender", "paddle_tpu_torch.models.ctr_dnn",
    # the SSD detector: the detection ops and layers, the model
    "paddle_tpu_torch.ops.detection_ops", "paddle_tpu_torch.layers.detection",
    "paddle_tpu_torch.models.ssd",
    # the analysis and attribution layer the Executor folds in: the lints,
    # the attribution table, the corpus, the bench history, the cost
    # model's selftest
    "paddle_tpu_torch.analysis", "paddle_tpu_torch.analysis.framework",
    "paddle_tpu_torch.analysis.program_checks",
    "paddle_tpu_torch.analysis.jaxpr_tools",
    "paddle_tpu_torch.analysis.jaxpr_checks",
    "paddle_tpu_torch.analysis.hlo_tools",
    "paddle_tpu_torch.analysis.hlo_checks",
    "paddle_tpu_torch.analysis.comm.checks",
    "paddle_tpu_torch.observability.attribution",
    "paddle_tpu_torch.observability.corpus",
    "paddle_tpu_torch.observability.bench_history",
    "paddle_tpu_torch.tune.costmodel_selftest",
    "paddle_tpu_torch.benchmarks.fold_in_cost",
]


def test_every_training_module_is_a_file_the_import_scan_covers():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in TRAINING_MODULES:
        rel = mod.replace(".", "/")
        assert (rel + ".py" in scanned
                or rel + "/__init__.py" in scanned), mod


def test_training_import_leaves_jax_out():
    r = _run("import sys\n"
             + "".join(f"import {m}\n" for m in TRAINING_MODULES)
             + "import paddle_tpu_torch as pt\n"
             "main, startup = pt.Program(), pt.Program()\n"
             "with pt.program_guard(main, startup):\n"
             "    pt.models.transformer.build(vocab_size=11, n_layer=1, "
             "n_head=1, d_model=8, max_len=4, dropout_rate=0.0, "
             "dtype='float32')\n"
             "exe = pt.Executor(pt.CPUPlace())\n"
             "exe.run(startup, scope=pt.Scope())\n"
             "rmain, rstart = pt.Program(), pt.Program()\n"
             "with pt.program_guard(rmain, rstart):\n"
             "    pt.models.resnet.build(depth=8, class_dim=3, "
             "image_shape=(3, 8, 8), dtype='float32')\n"
             "exe.run(rstart, scope=pt.Scope())\n"
             "smain, sstart = pt.Program(), pt.Program()\n"
             "with pt.program_guard(smain, sstart):\n"
             "    pt.models.seq2seq.build(src_dict_size=11, trg_dict_size=11, "
             "word_dim=4, hidden_dim=4, max_len=3)\n"
             "exe.run(sstart, scope=pt.Scope())\n"
             "lmain, lstart = pt.Program(), pt.Program()\n"
             "with pt.program_guard(lmain, lstart):\n"
             "    pt.models.text_classification.build(dict_dim=11, "
             "emb_dim=4, hid_dim=4, max_len=3)\n"
             "exe.run(lstart, scope=pt.Scope())\n"
             "dmain, dstart = pt.Program(), pt.Program()\n"
             "with pt.program_guard(dmain, dstart):\n"
             "    pt.models.deep_speech2.build(feat_dim=4, max_audio_len=3, "
             "max_label_len=2, rnn_size=4, num_rnn_layers=1, vocab_size=3)\n"
             "exe.run(dstart, scope=pt.Scope())\n"
             "cmain, cstart = pt.Program(), pt.Program()\n"
             "with pt.program_guard(cmain, cstart):\n"
             "    pt.models.label_semantic_roles.build(word_dict_len=11, "
             "label_dict_len=3, pred_dict_len=5, max_len=3, word_dim=4, "
             "hidden_dim=4, depth=2)\n"
             "exe.run(cstart, scope=pt.Scope())\n"
             "amain, astart = pt.Program(), pt.Program()\n"
             "with pt.program_guard(amain, astart):\n"
             "    pt.models.alexnet.build(class_dim=3, image_shape=(3, 67, 67), "
             "dtype='float32')\n"
             "exe.run(astart, scope=pt.Scope())\n"
             "for build, kw in ((pt.models.seq2seq.build_decode, dict("
             "src_dict_size=11, trg_dict_size=11, word_dim=4, hidden_dim=4, "
             "max_len=3, beam_size=2, max_out_len=3)), "
             "(pt.models.recommender.build, dict(max_title_len=3, "
             "max_cat_len=2)), (pt.models.ctr_dnn.build_sparse_slots, dict("
             "sparse_feature_dim=50, num_slots=2)), (pt.models.ssd.build, "
             "dict(num_classes=3, image_shape=(3, 16, 16), max_gt=2))):\n"
             "    m, s = pt.Program(), pt.Program()\n"
             "    with pt.program_guard(m, s):\n"
             "        build(**kw)\n"
             "    exe.run(s, scope=pt.Scope())\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')]\n"
             "assert not bad, bad\nprint('clean')", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


DISTRIBUTED_MODULES = [
    "paddle_tpu_torch.distributed", "paddle_tpu_torch.distributed.rpc",
    "paddle_tpu_torch.distributed.store",
    "paddle_tpu_torch.distributed.pserver",
    "paddle_tpu_torch.distributed.master",
    "paddle_tpu_torch.distributed.transpiler",
    "paddle_tpu_torch.native", "paddle_tpu_torch.native.build",
    "paddle_tpu_torch.native.recordio", "paddle_tpu_torch.flags",
    "paddle_tpu_torch.checkgrad", "paddle_tpu_torch.__main__",
]


def test_every_distributed_module_is_a_file_the_import_scan_covers():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in DISTRIBUTED_MODULES:
        rel = mod.replace(".", "/")
        assert (rel + ".py" in scanned
                or rel + "/__init__.py" in scanned), mod


def test_distributed_trainer_and_cli_import_leave_jax_out(tmp_path):
    """The parameter-server path end to end without jax: the CLI module,
    a DistributedTrainer over an in-process server taking one step, a
    recordio file through the native codec."""
    r = _run("import sys\n"
             + "".join(f"import {m}\n" for m in DISTRIBUTED_MODULES)
             + "import numpy as np\n"
             "import paddle_tpu_torch as pt\n"
             "from paddle_tpu_torch.distributed import (ParameterServer, "
             "DistributeTranspiler, DistributedTrainer)\n"
             "main, startup = pt.Program(), pt.Program()\n"
             "with pt.program_guard(main, startup):\n"
             "    out = pt.models.ctr_dnn.build(sparse_feature_dim=20, "
             "num_slots=1, embedding_size=2, dense_dim=2, hidden=(4,))\n"
             "exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()\n"
             "exe.run(startup, scope=scope)\n"
             "with pt.scope_guard(scope):\n"
             "    t = DistributeTranspiler().transpile(main, pservers=1)\n"
             "    dt = DistributedTrainer(t, exe, [ParameterServer()], "
             "sparse_params={'embedding_0.w': 'slot_0'})\n"
             "    dt.init_params_on_pservers()\n"
             "    dt.train_step({'dense_feature': np.ones((3, 2), "
             "np.float32), 'slot_0': np.array([[1], [4], [1]]), "
             "'click': np.array([[0], [1], [1]])})\n"
             "    dt.close()\n"
             f"p = {str(tmp_path / 'x.rio')!r}\n"
             "with pt.native.recordio.Writer(p, use_native=True) as w:\n"
             "    w.write(b'abc')\n"
             "assert list(pt.native.recordio.reader(p)) == [b'abc']\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')]\n"
             "assert not bad, bad\nprint('clean')", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


PARALLEL_MODULES = [
    "paddle_tpu_torch.parallel", "paddle_tpu_torch.parallel.mesh",
    "paddle_tpu_torch.parallel.api", "paddle_tpu_torch.parallel.contracts",
    "paddle_tpu_torch.parallel.sparse",
    "paddle_tpu_torch.parallel.collectives",
    "paddle_tpu_torch.parallel.spmd",
    "paddle_tpu_torch.parallel.ring_attention",
    "paddle_tpu_torch.parallel.pipeline", "paddle_tpu_torch.parallel.moe",
    "paddle_tpu_torch.analysis",
    "paddle_tpu_torch.analysis.comm", "paddle_tpu_torch.analysis.comm.plan",
    "paddle_tpu_torch.analysis.comm.contract",
    "paddle_tpu_torch.distributed.launch",
    "paddle_tpu_torch.layers.device",
]


def test_every_parallel_module_is_a_file_the_import_scan_covers():
    scanned = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in PARALLEL_MODULES:
        rel = mod.replace(".", "/")
        assert (rel + ".py" in scanned
                or rel + "/__init__.py" in scanned), mod


def test_mesh_stack_import_leaves_jax_out():
    """The spec rules, a mesh step's plan and its contracts without jax:
    a mesh with no process group, the specs of an annotated GPT, a
    one-rank mesh step on the CPU and its (empty) collective log."""
    r = _run("import sys\n"
             + "".join(f"import {m}\n" for m in PARALLEL_MODULES)
             + "import numpy as np\n"
             "import paddle_tpu_torch as pt\n"
             "from paddle_tpu_torch import parallel\n"
             "main, startup = pt.Program(), pt.Program()\n"
             "with pt.program_guard(main, startup):\n"
             "    out = pt.models.transformer.build(vocab_size=32, "
             "n_layer=1, n_head=2, d_model=16, max_len=8, "
             "dropout_rate=0.0, dtype='float32', fused_head=True)\n"
             "parallel.data_parallel(main, 'dp', programs=(startup,))\n"
             "rep = parallel.sharding_report(main, parallel.make_mesh("
             "{'dp': 4, 'tp': 2}))\n"
             "assert rep['opt_state']['sharded_vars'] > 0\n"
             "exe = pt.Executor(pt.CPUPlace(), "
             "mesh=parallel.make_mesh({'dp': 1}))\n"
             "scope = pt.Scope()\n"
             "exe.run(startup, scope=scope)\n"
             "feed = {'tokens': np.zeros((2, 8), np.int64), "
             "'labels': np.zeros((2, 8), np.int64)}\n"
             "exe.run(main, feed=feed, fetch_list=[out['avg_cost']], "
             "scope=scope)\n"
             "assert len(exe.last_comm_plan) == 0\n"
             "assert exe.last_step_cost['collective_count'] == 0\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')]\n"
             "assert not bad, bad\nprint('clean')", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_sequence_pipeline_and_expert_parallelism_leave_jax_out():
    """A one-rank ``ring_attention`` (both impls), ``moe_ffn`` and
    ``pipeline`` on the CPU without jax, and the overlap's names."""
    r = _run("import sys, importlib, torch\n"
             "from paddle_tpu_torch import parallel\n"
             "g = torch.Generator().manual_seed(0)\n"
             "q, k, v = (torch.randn(2, 8, 2, 4, generator=g) "
             "for _ in range(3))\n"
             "mesh = parallel.make_mesh({'sp': 1})\n"
             "o1 = parallel.ring_attention(q, k, v, mesh, causal=True)\n"
             "o2 = parallel.ring_attention(q, k, v, mesh, causal=True, "
             "impl='flash')\n"
             "assert torch.allclose(o1, o2, atol=1e-5)\n"
             "p = parallel.init_moe_params(g, 4, 8, 16, device='cpu')\n"
             "y, aux = parallel.moe_ffn(p, torch.randn(16, 8, generator=g), "
             "parallel.make_mesh({'ep': 1}))\n"
             "assert y.shape == (16, 8) and bool(torch.isfinite(aux))\n"
             "st = parallel.stack_stage_params([{'w': torch.eye(8)}])\n"
             "out = parallel.pipeline(lambda p, h: h @ p['w'], st, "
             "torch.ones(4, 8), parallel.make_mesh({'pp': 1}))\n"
             "assert torch.equal(out, torch.ones(4, 8))\n"
             "assert parallel.enable_comm_overlap('cpu') == "
             "parallel.comm_overlap_flags('gpu')\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')]\n"
             "assert not bad, bad\nprint('clean')", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_native_sources_include_nothing_of_the_jax_package():
    import re

    sources = sorted((PORT / "native" / "src").glob("*.cc"))
    assert [p.name for p in sources] == ["loader.cc", "recordio.cc"]
    for src in sources:
        for inc in re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]',
                              src.read_text(), flags=re.M):
            assert "paddle_tpu" not in inc and ".." not in inc, (src, inc)
            assert not inc.endswith(".h") or inc == "zlib.h", (src, inc)


def test_training_entry_points_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import paddle_tpu_torch as pt

    for call in (lambda: pt.Executor(), lambda: pt.Executor(pt.CUDAPlace()),
                 lambda: pt.load_numpy_state(pt.Scope(), {}),
                 lambda: pt.resolve_device(None),
                 lambda: pt.Trainer(None, []), lambda: pt.DataFeeder([]),
                 lambda: pt.reader.prefetch_to_device(lambda: iter(()))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert pt.Executor(pt.CPUPlace()).device.type == "cpu"
    assert pt.resolve_device(pt.CPUPlace()).type == "cpu"


def test_kernel_wrappers_and_counters_are_registered():
    from paddle_tpu_torch import kernels

    assert set(kernels.WRAPPERS) == {
        "paged_attention", "decode_gather",
        "flash_attention_fwd", "flash_attention_bwd",
        "flash_attention_bwd_delta", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv",
        "fused_ce_fwd", "fused_ce_dx", "fused_ce_dw", "bottleneck",
        "paged_attention_triton", "flash_attention_triton_fwd",
        "flash_attention_triton_dq", "flash_attention_triton_dkv"}
    assert kernels.launch_counts() == {nm: fn.launches
                                       for nm, fn in kernels.WRAPPERS.items()}
    for fn in kernels.WRAPPERS.values():
        fn.launches += 3
    kernels.reset_launches()
    assert all(fn.launches == 0 for fn in kernels.WRAPPERS.values())


def test_kernel_names_are_the_global_functions_of_the_sources():
    import re

    from paddle_tpu_torch import kernels

    found = set()
    for src in (PORT / "csrc").glob("*.cu"):
        text = re.sub(r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)", "",
                      src.read_text())
        found |= set(re.findall(r"__global__\s+void\s+(\w+)", text))
    triton_src = (PORT / "kernels" / "triton_attention.py").read_text()
    found |= set(re.findall(r"@triton\.jit\s+def\s+(\w+)", triton_src))
    assert found == set(kernels.KERNEL_NAMES)
    assert kernels.hand_written(
        "void flash_bwd_sm90_fused_kernel<true>(CUtensorMap)") == \
        "flash_bwd_sm90_fused_kernel"
    assert kernels.hand_written("flash_bwd_kernel(float const*)") == \
        "flash_bwd_kernel"
    assert kernels.hand_written("sm90_xmma_gemm_bf16bf16_bf16f32") is None


def test_kernel_sources_and_build_flags():
    from paddle_tpu_torch.kernels import _build

    assert "paged_attention" in _build.sources()
    assert "decode_gather" in _build.sources()
    assert "flash_attention" in _build.sources()
    assert "flash_bwd_sm90" in _build.sources()
    assert "flash_fwd_sm90" in _build.sources()
    assert "fused_ce" in _build.sources()
    assert "fused_ce_sm90" in _build.sources()
    assert "bottleneck" in _build.sources()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert _build.lib_path("paged_attention").startswith(_build.BUILD_DIR)


def test_build_digest_keys_on_shared_header(tmp_path, monkeypatch):
    """Both sm90 sources include ``sm90.cuh``: a changed header must give
    each of them a new library name (a rebuild), a changed source only
    its own."""
    from paddle_tpu_torch.kernels import _build

    for name in ("a", "b"):
        (tmp_path / f"{name}.cu").write_text(f'#include "h.cuh"\n// {name}\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    before = {n: _build.lib_path(n) for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("// two\n")
    after = {n: _build.lib_path(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// a, changed\n')
    assert _build.lib_path("a") != after["a"]
    assert _build.lib_path("b") == after["b"]


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
