"""``python -m paddle_tpu_torch --costmodel-selftest`` — the learned cost
model's gate, the port's counterpart of
``paddle_tpu/tune/costmodel_selftest.py``.  It runs on the card unless
``device="cpu"`` is asked for; every file it writes lives in a temporary
directory.

The whole observability -> tuning loop proves itself:

1. SEED: two measured toy-GPT runs (different sequence lengths) stream
   through the production ``MetricsReporter`` into trainer JSONL; the
   corpus ingests them plus a bench-artifact fixture built from a real
   attribution table, classifying (not crashing on) a planted non-object
   artifact.
2. FIT: ``fit_and_save`` on that corpus; the fitted holdout error must
   STRICTLY improve on the analytic roofline's recorded error over the
   same held-out rows.
3. CONSULT: a fresh lowering records ``costmodel: fitted`` in
   ``last_step_cost`` and its trainer JSONL rows; the t=16k flagship
   static prune still rejects the known-OOM config and selects the SAME
   schedule as the analytic model (``predict_sched_ms`` is monotonic in
   flops — ordering preserved).
4. ROBUSTNESS: a corrupt, truncated, or schema-mismatched model file
   each degrades to the analytic defaults (``tune.costmodel_errors``
   counts; the attribution table of a fixed program stays bit-exact to
   the no-model baseline).
5. KILL SWITCH: ``PADDLE_TPU_COSTMODEL=0`` with a VALID fitted file on
   disk reproduces the no-model estimates bit-exact — the attribution
   table's floats, ``estimate_gpt_step_hbm``'s ints and the flagship
   static demo.

Where the reference's bit-exactness currency is a fixed HLO module, the
port's is the attribution table of a fixed three-op Program (a product,
a pointwise add, a reduction: three classes).
"""

import json
import os
import tempfile
import time

__all__ = ["run_selftest"]

_TOY = dict(vocab=61, n_layer=3, n_head=2, d_model=64, batch=4,
            dtype="float32")

# the flagship static demo's budget: between the policies' estimates at
# t=16k, so the prune both rejects and keeps candidates
_DEMO_BUDGET = 16 << 30


class EndIteration:
    """Duck-typed trainer event (the reporter dispatches on the class
    NAME): the selftest synthesizes the step stream so the production
    MetricsReporter writes genuine JSONL from measured walls and the
    Executor's real cost dicts, without trainer scaffolding."""

    def __init__(self, pass_id, batch_id, cost, wall_time, step_cost,
                 samples):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.wall_time = wall_time
        self.step_cost = step_cost
        self.samples = samples
        self.throughput = samples / wall_time if wall_time else None
        self.mfu = None
        self.reader_wait = None
        self.grad_norm = None


def _fixed_table(device):
    """The attribution table of a fixed Program of three op classes —
    the bit-exactness currency of the robustness and kill-switch
    checks."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import attribution as attr

    prog = pt.Program()
    blk = prog.global_block()
    for name in ("a", "b", "c", "d"):
        blk.create_var(name=name, shape=(64, 64), dtype="float32")
    blk.create_var(name="e", shape=(64,), dtype="float32")
    blk.append_op("mul", {"X": ["a"], "Y": ["b"]}, {"Out": ["c"]})
    blk.append_op("elementwise_add", {"X": ["c"], "Y": ["b"]},
                  {"Out": ["d"]})
    blk.append_op("reduce_sum", {"X": ["d"]}, {"Out": ["e"]},
                  {"dim": [1]})
    return attr.attribute_step(prog, 1, device=device)


def _build_toy(seq_len):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer

    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = 7
    with pt.program_guard(main_prog, startup):
        outs = transformer.build(
            vocab_size=_TOY["vocab"], n_layer=_TOY["n_layer"],
            n_head=_TOY["n_head"], d_model=_TOY["d_model"],
            max_len=seq_len, dropout_rate=0.0, dtype=_TOY["dtype"],
            fused_head=True)
        pt.memory_optimize(main_prog, policy="selective")
    return main_prog, startup, outs


def _measured_run(seq_len, steps, jsonl_path, run_id, device):
    """One toy-GPT run: a warm-up step, then ``steps`` measured steps
    (each ending in a host read of the loss), each streamed through a
    production MetricsReporter into ``jsonl_path``.  Returns the step's
    attribution table and last_step_cost.  On the CPU the steps run one
    intra-op thread: on a loaded host a threaded step's wall varies
    several-fold, which no fit can track."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import MetricsReporter

    main_prog, startup, outs = _build_toy(seq_len)
    rng = np.random.default_rng(seq_len)
    toks = rng.integers(0, _TOY["vocab"],
                        (_TOY["batch"], seq_len)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    scope = pt.Scope()
    reporter = MetricsReporter(log_every_n=0, jsonl_path=jsonl_path,
                               run_meta={"run_id": run_id})
    threads = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        exe = pt.Executor(device)
        exe.run(startup, scope=scope)
        # the warm-up pays the lowering outside the measured walls
        exe.run(main_prog, feed=feed, fetch_list=[outs["avg_cost"]],
                scope=scope)
        for i in range(steps):
            t0 = time.perf_counter()
            loss = exe.run(main_prog, feed=feed,
                           fetch_list=[outs["avg_cost"]], scope=scope)[0]
            wall = time.perf_counter() - t0
            reporter(EndIteration(0, i, float(np.asarray(loss).ravel()[0]),
                                  wall, dict(exe.last_step_cost),
                                  _TOY["batch"]))
        return exe.last_attribution, dict(exe.last_step_cost)
    finally:
        torch.set_num_threads(threads)
        reporter.close()


def _hbm_points():
    """The estimate_gpt_step_hbm probe set for the bit-exactness check
    (a large GPT at t=16k across the policy/accum grid)."""
    from paddle_tpu_torch.tune.space import estimate_gpt_step_hbm

    return [estimate_gpt_step_hbm(26, 5120, 40, 32000, 16384, 6,
                                  policy=p, accum=a)
            for p in ("none", "selective", "compact", "full", "offload")
            for a in (1, 2)]


def run_selftest(device=None):
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.observability import attribution as attr
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.observability.corpus import Corpus
    from paddle_tpu_torch.tune import costmodel as cm
    from paddle_tpu_torch.tune.cache import device_platform

    dev = resolve_device(device)
    plat = device_platform(dev)
    failures = []

    def check(cond, what):
        (failures.append(what) if not cond else None)
        print(("ok   " if cond else "FAIL ") + what, flush=True)

    tmp = tempfile.mkdtemp(prefix="ptt_costmodel_")
    old_env = {k: os.environ.get(k)
               for k in ("PADDLE_TPU_TUNE_CACHE", "PADDLE_TPU_COSTMODEL",
                         "PADDLE_TPU_COSTMODEL_PATH")}
    os.environ["PADDLE_TPU_TUNE_CACHE"] = os.path.join(tmp, "tuned.json")
    os.environ.pop("PADDLE_TPU_COSTMODEL", None)
    os.environ.pop("PADDLE_TPU_COSTMODEL_PATH", None)
    tune.reset_cache()
    cm.reset_model()
    reg = get_registry()
    try:
        # -- 0. the analytic baselines (no model file exists) -----------
        att_base = _fixed_table(dev)
        hbm_base = _hbm_points()
        demo_base = tune.flagship_static_demo(budget_bytes=_DEMO_BUDGET,
                                              device=dev)
        check(att_base.get("costmodel", {}).get("mode") == "analytic",
              "no model file: attribution runs analytic")

        # -- 1. seed the corpus from measured GPT-family runs ----------
        run_a = os.path.join(tmp, "run_a.jsonl")
        run_b = os.path.join(tmp, "run_b.jsonl")
        att_a, cost_a = _measured_run(128, 6, run_a, "costmodel-run-a",
                                      dev)
        _measured_run(64, 6, run_b, "costmodel-run-b", dev)
        check((cost_a.get("costmodel") or {}).get("mode") == "analytic",
              "pre-fit step records costmodel: analytic in "
              "last_step_cost")
        co = Corpus()
        n_a = co.ingest_trainer_jsonl(run_a)
        n_b = co.ingest_trainer_jsonl(run_b)
        check(n_a == 6 and n_b == 6,
              f"trainer JSONL ingests every measured step row "
              f"({n_a} + {n_b})")
        # a bench artifact built from the real attribution table; its
        # measured time is run A's median wall, a consistent 13th row
        walls = sorted(r["measured_ms"] for r in co.rows
                       if r["source"].endswith("run_a.jsonl"))
        rec = attr.reconcile(att_a, walls[len(walls) // 2] / 1e3)
        art = os.path.join(tmp, "BENCH_cm01.json")
        with open(art, "w", encoding="utf-8") as fh:
            json.dump({"n": 1, "rc": 0, "parsed": {
                "metric": "gpt_train_tokens_per_sec_per_chip",
                "value": 1.0, "unit": "tok/s",
                "extra": {
                    "gpt_attribution": {
                        "classes": att_a["classes"],
                        "workload": att_a.get("workload"),
                        "est_ms_total": att_a.get("est_ms_total")},
                    "gpt_attr_est_ms": rec["est_ms"],
                    "gpt_attr_model_err_pct": rec["err_pct"]}}}, fh)
        bad = os.path.join(tmp, "BENCH_cm02.json")
        with open(bad, "w", encoding="utf-8") as fh:
            fh.write("[1, 2, 3]")
        check(co.ingest_artifact(art) == 1,
              "bench artifact's attribution table becomes a corpus row")
        co.ingest_artifact(bad)
        check(any("not a JSON object" in reason
                  for _s, reason in co.skipped),
              f"non-object artifact classified, not crashed "
              f"({co.summary()['skip_reasons']})")
        check(len(co.rows) == 13 and all(
            r["platform"] == plat for r in co.rows),
            f"corpus holds 13 {plat} rows ({co.summary()})")

        # -- 2. fit: holdout error strictly beats the analytic model ---
        model = cm.fit_and_save(co)
        entry = model.entry(plat)
        check(entry is not None and entry["train_rows"] >= 8,
              f"fit produced a {plat} entry "
              f"(train_rows={entry and entry['train_rows']})")
        fit_err = entry and entry.get("holdout_err_pct")
        ana_err = entry and entry.get("analytic_err_pct")
        check(fit_err is not None and ana_err is not None
              and fit_err < ana_err,
              f"fitted holdout error strictly improves on the analytic "
              f"roofline ({fit_err}% < {ana_err}%)")
        st = cm.model_status(plat)
        check(st.get("mode") == "fitted"
              and st.get("train_rows") == entry["train_rows"],
              f"model_status reports the fit ({st})")

        # -- 3. consult points: fitted estimates + preserved ordering --
        run_c = os.path.join(tmp, "run_c.jsonl")
        _att_fit, cost_fit = _measured_run(64, 2, run_c,
                                           "costmodel-run-c", dev)
        check((cost_fit.get("costmodel") or {}).get("mode") == "fitted",
              "post-fit step records costmodel: fitted in "
              "last_step_cost")
        with open(run_c, encoding="utf-8") as fh:
            crows = [json.loads(ln) for ln in fh if ln.strip()]
        csteps = [r for r in crows if r.get("event") == "step"]
        check(bool(csteps) and all(
            (r.get("costmodel") or {}).get("mode") == "fitted"
            for r in csteps),
            "trainer JSONL rows carry the fitted costmodel status")
        att_fit = _fixed_table(dev)
        check(att_fit["est_ms_total"] != att_base["est_ms_total"],
              f"fitted model moves the roofline estimates "
              f"({att_fit['est_ms_total']} vs analytic "
              f"{att_base['est_ms_total']} ms)")
        demo_fit = tune.flagship_static_demo(budget_bytes=_DEMO_BUDGET,
                                             device=dev)
        check(demo_fit.get("gpt_t16k_rejected_r05_config") is not None,
              f"fitted model still rejects the known-OOM config "
              f"({demo_fit.get('gpt_t16k_rejected_r05_config')})")
        same_sel = all(
            demo_fit.get(k) == demo_base.get(k)
            for k in ("gpt_t16k_selected_policy",
                      "gpt_t16k_selected_accum",
                      "gpt_t16k_selected_block_q",
                      "gpt_t16k_selected_block_k"))
        check(same_sel and demo_base.get("gpt_t16k_selected_policy")
              is not None,
              f"tuner ordering preserved: the fitted model selects the "
              f"same schedule ({demo_fit.get('gpt_t16k_selected_policy')} "
              f"accum={demo_fit.get('gpt_t16k_selected_accum')})")

        # -- 4. robustness: corrupt/truncated/schema-mismatch ----------
        path = cm.costmodel_path()
        with open(path, encoding="utf-8") as fh:
            good = fh.read()
        corruptions = [
            ("garbage", "{not json"),
            ("truncated", good[: len(good) // 2]),
            ("schema-mismatch", json.dumps(
                {"schema_version": 999, "platforms": {}})),
        ]
        for name, payload in corruptions:
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(payload)
            e0 = reg.value("tune.costmodel_errors")
            cm.reset_model()
            m = cm.get_model()
            check(m.stale_reason is not None
                  and cm.active_entry(plat) is None
                  and reg.value("tune.costmodel_errors") == e0 + 1,
                  f"{name} model file degrades to analytic defaults "
                  f"({m.stale_reason}; tune.costmodel_errors +1)")
            att_c = _fixed_table(dev)
            check(json.dumps(att_c, sort_keys=True)
                  == json.dumps(att_base, sort_keys=True),
                  f"{name}: attribution bit-exact to the no-model "
                  f"baseline")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(good)
        cm.reset_model()
        check(cm.model_status(plat).get("mode") == "fitted",
              "restoring the good file restores the fit")

        # -- 5. kill switch: bit-exact with a valid fitted file --------
        os.environ["PADDLE_TPU_COSTMODEL"] = "0"
        cm.reset_model()
        att_off = _fixed_table(dev)
        check(json.dumps(att_off, sort_keys=True)
              == json.dumps(att_base, sort_keys=True),
              "PADDLE_TPU_COSTMODEL=0 attribution BIT-EXACT vs the "
              "no-model baseline (fitted file on disk)")
        check(_hbm_points() == hbm_base,
              "PADDLE_TPU_COSTMODEL=0 estimate_gpt_step_hbm ints "
              "bit-exact vs the no-model baseline")
        demo_off = tune.flagship_static_demo(budget_bytes=_DEMO_BUDGET,
                                             device=dev)
        check(demo_off == demo_base,
              "PADDLE_TPU_COSTMODEL=0 flagship static demo identical "
              "to the no-model baseline")
        check(cm.model_status(plat) == {"mode": "analytic"},
              "kill switch reports analytic status")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tune.reset_cache()
        cm.reset_model()

    print("costmodel selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0
