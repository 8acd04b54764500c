"""The port's attribution table, measurement corpus and bench history
(``paddle_tpu_torch/observability/{attribution,corpus,bench_history}``)
against the JAX package's, on the CPU.

Held against the reference (the same inputs in both packages):
``program_workload_key`` / ``normalize_workload_key`` give equal strings
for the same program; ``summarize``, ``share_table`` and ``reconcile``
give equal output on the same table dict; ``Corpus`` ingests a trainer
JSONL the reference's ``MetricsReporter`` wrote into equal rows, and a
saved corpus loads back equal; ``classify_artifact`` / ``history`` give
equal verdicts on planted ``BENCH_*`` / ``MULTICHIP_*`` fixtures under
``tmp_path`` (never the repo's own artifacts).

The port's own: the table's product flops equal ``step_flops`` (the
coverage is exactly 1.0) on the GPT under every policy and on the
recurrent and convolution models; recompute shows under the remat
policies; the reporter's JSONL carries the attribution and lint keys;
a tune-cache entry and a corpus row from one checkout join on one
``git_sha`` stamp; the kernel-name classifier; ``attribute_profile``
refuses the CPU.  The card's cases (``cuda``) are in
``tests/test_torch_cuda_analysis.py``.
"""

import json
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.models import transformer as jtr
from paddle_tpu.observability import attribution as jattr
from paddle_tpu.observability import bench_history as jbh
from paddle_tpu.observability.corpus import Corpus as JCorpus
from paddle_tpu_torch import tune
from paddle_tpu_torch.core.executor import step_flops
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.observability import attribution as attr
from paddle_tpu_torch.observability import bench_history as bh
from paddle_tpu_torch.observability.corpus import Corpus
from torch_ref_gauges import restore_reference_gauges  # noqa: F401


def _gpt(pkg, tr, policy=None, fused_head=True, t=32):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 7
    with pkg.program_guard(main, startup):
        outs = tr.build(vocab_size=61, n_layer=3, n_head=2, d_model=64,
                        max_len=t, dropout_rate=0.0, dtype="float32",
                        fused_head=fused_head)
    if policy:
        pkg.memory_optimize(main, policy=policy)
    return main, startup, outs


@pytest.mark.parametrize("policy",
                         [None, "selective", "compact", "full", "offload"])
@pytest.mark.parametrize("fused_head", [True, False])
def test_product_flops_equal_step_flops(policy, fused_head):
    main, _s, _o = _gpt(tpt, ttr, policy, fused_head)
    flops = step_flops(main, 4)
    att = attr.attribute_step(main, 4, flops=flops, device="cpu")
    assert att["coverage"] == 1.0 and att["product_flops"] == flops
    classes = att["classes"]
    assert {"pallas", "matmul", "elementwise", "reduce"} <= set(classes)
    assert abs(sum(r["share"] for r in classes.values()) - 1) < 2e-3
    assert all(r["bound"] in ("compute", "memory") for r in classes.values())
    recompute = sum(r["recompute_flops"] for r in classes.values())
    assert (recompute > 0) == (policy is not None)
    # compact and full recompute the products, selective only the rest
    assert (classes["matmul"]["recompute_flops"] > 0) == (
        policy in ("compact", "full"))
    assert att["hlo_flops_total"] == sum(r["flops"]
                                         for r in classes.values())


def test_product_flops_of_the_recurrent_and_conv_models():
    """``step_flops`` has a hook for every product of the LSTM classifier
    (coverage 1.0); it counts no convolution, so LeNet reads above 1."""
    for build, kw, want in (
            (tpt.models.text_classification.build,
             dict(dict_dim=50, emb_dim=8, hid_dim=8, max_len=6), "eq"),
            (tpt.models.lenet.build, {}, "gt")):
        tpt.core.unique_name.reset()
        main, startup = tpt.Program(), tpt.Program()
        with tpt.program_guard(main, startup):
            build(**kw)
        flops = step_flops(main, 4)
        att = attr.attribute_step(main, 4, flops=flops, device="cpu")
        assert (att["coverage"] == 1.0) if want == "eq" else \
            (att["coverage"] > 1.0), att["coverage"]


def test_program_workload_key_is_the_references():
    from paddle_tpu.kernels import registry as jreg

    for policy in (None, "selective"):
        tmain, _s, _o = _gpt(tpt, ttr, policy)
        jmain, _s, _o = _gpt(pt, jtr, policy)
        jreg.reset_selected()          # no kernel resolved: no |kb= token
        want = jattr.program_workload_key(jmain)
        got = attr.program_workload_key(tmain, device="cpu")
        assert got == want and got.startswith("op=step|t=32|dh=32|h=2")
        assert attr.normalize_workload_key(got) == \
            jattr.normalize_workload_key(want) == got + "|kb=unknown"
    for key in (None, "", "not-a-key", "op=step|t=1|kb=cuda"):
        assert attr.normalize_workload_key(key) == \
            jattr.normalize_workload_key(key)


def test_summarize_share_table_reconcile_are_the_references():
    main, _s, _o = _gpt(tpt, ttr, "selective")
    att = json.loads(json.dumps(attr.attribute_step(
        main, 4, flops=step_flops(main, 4), device="cpu")))
    for top_n in (1, 3, 9):
        assert attr.summarize(att, top_n) == jattr.summarize(att, top_n)
    assert attr.share_table(att) == jattr.share_table(att)
    for wall in (1e-3, 0.25, 0, None):
        assert attr.reconcile(att, wall) == jattr.reconcile(att, wall)
    for bad in (None, {}, []):
        assert attr.summarize(bad) == jattr.summarize(bad)
    for bad in (None, {}, {"classes": None}, [], {"classes": {"x": 1}}):
        assert attr.share_table(bad) == jattr.share_table(bad)
    assert attr.SCHEMA_VERSION == jattr.SCHEMA_VERSION == 1


class EndIteration:
    """A duck-typed trainer event (both reporters dispatch on the class
    name)."""

    def __init__(self, batch_id, wall, step_cost):
        self.pass_id, self.batch_id, self.cost = 0, batch_id, 1.0 + batch_id
        self.wall_time, self.samples = wall, 4
        self.throughput, self.mfu = (4 / wall if wall else None), None
        self.reader_wait, self.grad_norm = None, None
        self.step_cost, self.metrics = step_cost, []


def test_corpus_ingests_the_references_trainer_jsonl_equally(tmp_path):
    from paddle_tpu.observability import MetricsReporter as JReporter

    main, _s, _o = _gpt(tpt, ttr, "selective")
    att = attr.attribute_step(main, 4, flops=step_flops(main, 4),
                              device="cpu")
    cost = {"cache_hit": True, "flops": step_flops(main, 4),
            "bytes_accessed": att["bytes_total"],
            "attribution": attr.summarize(att)}
    path = str(tmp_path / "ref.jsonl")
    rep = JReporter(log_every_n=0, jsonl_path=path,
                    run_meta={"run_id": "ref-run"})
    for i, wall in enumerate((0.02, 0.021, 0.019)):
        rep(EndIteration(i, wall, cost))
    rep(EndIteration(3, 0.0, cost))             # no measured wall: skipped
    rep.close()
    with open(path, "a") as fh:
        fh.write('{"event": "step", "truncat\n')  # a torn line: skipped
    got, want = Corpus(), JCorpus()
    assert got.ingest_trainer_jsonl(path) == want.ingest_trainer_jsonl(
        path) == 3
    assert got.rows == want.rows and got.skipped == want.skipped
    assert got.ingest_trainer_jsonl(path) == 0          # idempotent
    # again the wall-less and the torn records, and the 3 duplicates
    assert len(got.skipped) == 2 * len(want.skipped) + 3 == 7
    saved = str(tmp_path / "corpus.jsonl")
    got.save_jsonl(saved)
    back, jback = Corpus(), JCorpus()
    assert back.load_jsonl(saved) == jback.load_jsonl(saved) == 3
    assert back.rows == jback.rows == got.rows
    assert got.ingest_attribution(att, 0.02, run_id="r", step=1)
    assert got.rows[-1]["err_pct"] == attr.reconcile(att, 0.02)["err_pct"]


def _fixture(root):
    """Planted artifacts: a passing round, a >10% regression with
    attribution tables, a t=16k OOM failure resolved by a later round's
    evidence, a non-object artifact, a failed and a passing multichip."""
    def att(shares):
        return {"classes": {c: {"flops": 1, "bytes": 1, "est_ms": s,
                                "share": s, "bound": "memory"}
                            for c, s in shares.items()},
                "workload": "op=step|t=4096|dh=128|h=6|dt=bfloat16"
                            "|plat=gpu|remat=-", "est_ms_total": 1.0}

    arts = {
        "BENCH_r01.json": {"n": 1, "rc": 0, "parsed": {
            "metric": "gpt_train_tokens_per_sec_per_chip", "value": 100.0,
            "unit": "tok/s", "extra": {
                "gpt_mfu": 0.4, "gpt_attr_model_err_pct": -10.0,
                "gpt_attribution": att({"matmul": 0.6, "pallas": 0.4})}}},
        "BENCH_r02.json": {"n": 2, "rc": 0, "parsed": {
            "metric": "gpt_train_tokens_per_sec_per_chip", "value": 80.0,
            "unit": "tok/s", "extra": {
                "gpt_mfu": 0.41, "gpt_attr_model_err_pct": 25.0,
                "gpt_attribution": att({"matmul": 0.3, "pallas": 0.7})}}},
        "BENCH_r03.json": {"n": 3, "rc": 1, "parsed": None,
                           "tail": "bf16[6,16384,768] RESOURCE_EXHAUSTED"},
        "BENCH_r04.json": {"n": 4, "rc": 0, "parsed": {
            "metric": "gpt_train_tokens_per_sec_per_chip", "value": 101.0,
            "unit": "tok/s", "extra": {"gpt_t16k_tune_tok_s": 5.0}}},
        "BENCH_r05.json": [1, 2, 3],
        "MULTICHIP_r01.json": {"n": 1, "rc": 1, "ok": False},
        "MULTICHIP_r02.json": {"n": 2, "rc": 0, "ok": True, "tail":
                               '{"metric": "scaling", '
                               '"scaling_efficiency": 0.9}'},
    }
    for name, data in arts.items():
        with open(os.path.join(root, name), "w") as fh:
            json.dump(data, fh)
    return sorted(arts)


def test_bench_history_verdicts_are_the_references(tmp_path):
    names = _fixture(str(tmp_path))
    for name in names:
        path = str(tmp_path / name)
        assert bh.classify_artifact(path) == jbh.classify_artifact(path)
    known = {"MULTICHIP_r01.json": "root-caused",
             "BENCH_r02.json:gpt_mfu": "stale on purpose"}
    for kf in (None, known):
        got = bh.history(str(tmp_path), known_failures=kf)
        want = jbh.history(str(tmp_path), known_failures=kf)
        assert got == want
    summary, rows = got
    assert not summary["ok"] and "BENCH_r05.json" in summary["failed"]
    assert "BENCH_r03.json" in summary["resolved"]
    assert {r["metric"] for r in summary["regressions"]} == {
        "gpt_train_tokens_per_sec_per_chip", "gpt_attr_model_err_pct"}
    assert summary["regression_attribution"] and \
        summary["stale_acks"] == ["BENCH_r02.json:gpt_mfu"]
    assert bh.format_table(rows) == jbh.format_table(rows)
    stamp = bh.run_stamp()
    assert set(stamp) == set(jbh.run_stamp()) and \
        stamp["schema_version"] == bh.SCHEMA_VERSION == 1
    assert bh.stamp_row({"metric": "m"})["run_id"]


def test_a_tune_cache_entry_and_a_corpus_row_join_on_one_stamp(
        tmp_path, monkeypatch):
    """The tune cache, the reporter's run_meta and so the corpus rows of
    one checkout carry one ``git_sha``: ``bench_history.run_stamp``'s."""
    monkeypatch.setenv("PADDLE_TPU_TUNE_CACHE", str(tmp_path / "t.json"))
    tune.reset_cache()
    try:
        key = tune.WorkloadKey("gpt_step", 32, 32, 2, "float32", "cpu")
        cache = tune.get_cache()
        cache.put(key.s, {"policy": "none"},
                  measured={"median_s": 0.05, "flops": 1e9,
                            "hbm_high_water_bytes": 3e9,
                            "hbm_est_bytes": 2e9})
        cache.save()
        with open(tmp_path / "t.json") as fh:
            sha = json.load(fh)["git_sha"]
        assert sha == bh.run_stamp()["git_sha"]
        main, _s, _o = _gpt(tpt, ttr, "selective")
        att = attr.attribute_step(main, 4, flops=step_flops(main, 4),
                                  device="cpu")
        path = str(tmp_path / "run.jsonl")
        rep = tpt.MetricsReporter(log_every_n=0, jsonl_path=path)
        rep(EndIteration(0, 0.02, {"attribution": attr.summarize(att)}))
        rep.close()
        co = Corpus()
        assert co.ingest_trainer_jsonl(path) == 1
        assert co.ingest_tune_cache(cache) == 1
        run_row, cache_row = co.rows
        assert run_row["git_sha"] == sha
        assert cache_row["hbm_high_water_bytes"] == 3e9 and \
            cache_row["workload"] == key.s + "|kb=unknown"
    finally:
        tune.reset_cache()


def test_reporter_jsonl_carries_the_fold_in(tmp_path):
    from paddle_tpu_torch.observability import runlog

    main, startup, outs = _gpt(tpt, ttr, "selective")
    scope = tpt.Scope()
    exe = tpt.Executor("cpu")
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 61, (4, 32)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    path = str(tmp_path / "run.jsonl")
    rep = tpt.MetricsReporter(log_every_n=0, jsonl_path=path)
    for i in range(2):
        exe.run(main, feed=feed, fetch_list=[outs["avg_cost"]], scope=scope)
        rep(EndIteration(i, 0.05, exe.last_step_cost))
    rep.close()
    meta, = runlog.read_jsonl(path, event="run_meta")
    assert meta["git_sha"] == bh.run_stamp()["git_sha"] and meta["run_id"]
    for s in runlog.read_jsonl(path, event="step"):
        assert s["attr_coverage"] == 1.0 and s["attr_top"][0][0] in (
            "elementwise", "matmul", "pallas", "reduce")
        assert s["attr_workload"].endswith("remat=selective")
        assert s["attr_model_err_pct"] == attr.reconcile(
            exe.last_attribution, 0.05)["err_pct"]
        assert s["attr_classes"]["pallas"][0] > 0
        assert s["lint_findings"] == 0 and s["lint_errors"] == 0
        assert s["costmodel"] == {"mode": "analytic"}
        assert s["kernel_backends"] == {"flash_attention": "plain",
                                        "fused_ce": "plain"}
        assert s["bytes_accessed"] == exe.last_attribution["bytes_total"]


@pytest.mark.parametrize("name,cls", [
    ("flash_fwd_sm90_kernel(bf16*, ...)", "pallas"),
    ("void ce_dw_sm90_kernel<3>(...)", "pallas"),
    ("paged_split_kernel", "pallas"),
    ("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NNT", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize", "matmul"),
    ("cudnn::fprop_implicit_gemm", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "reduce"),
    ("void at::native::vectorized_layer_norm_kernel<float>", "reduce"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective.all-reduce"),
    ("ncclDevKernel_AllGather_RING_LL", "collective.all-gather"),
    ("Memcpy DtoD (Device -> Device)", "other"),
    ("void at::native::index_elementwise_kernel", "other"),
    ("mystery_kernel_xyz", None)])
def test_kernel_classifier(name, cls):
    assert attr.kernel_class(name) == cls


def test_kernel_table_and_the_cpu_refusal():
    events = [(0, 4_000_000, "flash_fwd_sm90_kernel"),
              (1, 3_000_000, "nvjet_hsh_gemm"),
              (2, 2_000_000, "at::native::vectorized_elementwise_kernel"),
              (3, 1_000_000, "mystery_kernel")]
    tab = attr.kernel_table(events, step_s=0.02)
    assert tab["total_ms"] == 10.0 and tab["accounted_ms"] == 9.0
    assert tab["accounted_share"] == 0.9 and tab["busy_share"] == 0.5
    assert tab["classes"]["pallas"] == {"ms": 4.0, "calls": 1,
                                        "share": 0.4}
    assert tab["classes"]["other"]["ms"] == 1.0
    assert tab["unmatched"] == [("mystery_kernel", 1.0)]
    assert attr.kernel_family("flash_fwd_sm90_kernel") == \
        "flash forward (sm90)"
    assert attr.kernel_family("vectorized_elementwise_kernel") is None
    with pytest.raises(ValueError, match="CPU"):
        attr.attribute_profile(lambda i: None, device="cpu")


def test_launched_families_name_each_hand_written_kernel():
    """Every wrapper's launches map to families of class ``pallas`` that
    ``kernel_family`` gives the ``csrc/`` kernels' own names, and every
    such kernel name has one."""
    from paddle_tpu_torch import kernels

    pallas = {f for f, _p, c in attr.KERNEL_FAMILIES if c == "pallas"}
    for name in kernels.KERNEL_NAMES:
        assert attr.kernel_family(name) in pallas, name
    fams = {c: {f: 1 for f in calls}
            for c, calls in kernels.family_counts().items()}
    every = attr.launched_families(
        {w: 1 for w in kernels.WRAPPERS}, fams)
    assert set(every) == pallas
    # the flagship step: sm90 forward, fused sm90 backward, sm90 CE
    got = attr.launched_families(
        {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
         "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dw": 1,
         "paged_attention": 0},
        {"flash_attention_fwd": {"sm90": 12, "simple": 0},
         "flash_attention_bwd": {"sm90": 12, "simple": 0},
         "fused_ce_fwd": {"sm90": 1}, "fused_ce_dx": {"sm90": 1},
         "fused_ce_dw": {"sm90": 1}, "paged_attention": {"split": 4}})
    assert got == ["CE dW (sm90)", "CE dx (sm90)", "CE forward (sm90)",
                   "flash backward (fused, sm90)", "flash forward (sm90)"]
