"""Command-line entry: ``python -m paddle_tpu_torch <command>`` (the port's
counterpart of ``python -m paddle_tpu``).

Reference: the ``paddle`` CLI (``paddle/scripts/submit_local.sh.in:4-13``;
binaries ``paddle/trainer/TrainerMain.cpp``,
``pserver/ParameterServer2Main.cpp``, Go ``go/cmd/{pserver,master}``).

Commands:
  train        drive a model-config script's training loop on the card
               (``--device cpu`` asks for the CPU; ``--job=checkgrad``
               finite-differences the whole model's gradients on one batch)
  pserver      serve a parameter-server shard over RPC (host code)
  master       serve the elastic dataset task dispatcher over RPC (host code)
  version      print the versions, the card and the native library's state
  dump_config  print a config's Program IR (``--startup``: the startup
               program too)
  merge_model  bundle an exported inference-model directory into one tar

Selftest flags, taken before any command, in the JAX package's order;
each runs on the card unless ``--device=cpu`` is given and exits 0 when
every check passes: ``--metrics-selftest``, ``--memory-selftest``,
``--lint-selftest``, ``--trace-selftest``, ``--resilience-selftest``,
``--tune-selftest``, ``--costmodel-selftest``,
``--attribution-selftest``, ``--spec-selftest``.  Two more take their
own arguments: ``--bench-history [--dir D] [--threshold T]
[--known-failures F]`` (the artifact trajectory gate; rc 1 on an
unacknowledged failure or regression) and ``--lint <config.py>
[--strict] [--json] [--levels ...] [--hbm-budget B] [--device D]`` (rc 1
on error findings, 2 under ``--strict``).  The JAX package's other flags
(``_UNPORTED``) exit 2 naming the ROADMAP.md item that ports them.

A model-config script is a Python file defining ``build() -> dict`` (with
"feed" and "avg_cost" entries, like ``paddle_tpu_torch.models.*.build``)
and ``train_reader()`` yielding samples — the v1 trainer-config
convention on the fluid-style DSL.  ``--flag=value`` tokens naming a
registered flag (``flags.py``) are taken before the command is parsed.
"""

import argparse
import importlib.util
import os
import sys
import threading

__version__ = "0.1.0"


def _load_config(path):
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_config",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(mod):
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        outs = mod.build()
    return main, startup, outs


def cmd_version(args):
    import torch

    from . import native

    print(f"paddle_tpu_torch {__version__}")
    print(f"torch {torch.__version__}; cuda {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"card: {torch.cuda.get_device_name(0)} "
              f"(count {torch.cuda.device_count()})")
    else:
        print("card: none")
    state = "available" if native.available() else (
        f"unavailable ({native._lib_err})")
    print(f"native: {state}")
    return 0


def _checkgrad(pt, mod, main, startup, outs, place, batch_size):
    """``--job=checkgrad`` (reference TrainerMain.cpp:54 ->
    Trainer.cpp:303 checkGradient) on one batch of the config's
    reader."""
    exe, scope = pt.Executor(place), pt.Scope()
    exe.run(startup, scope=scope)
    try:
        batch = next(iter(pt.reader.batch(mod.train_reader, batch_size)()))
    except StopIteration:
        raise SystemExit(
            f"train_reader yields fewer than --batch-size ({batch_size}) "
            f"samples; checkgrad needs one full batch")
    feed = pt.DataFeeder(outs["feed"], place).feed(batch)
    ok, report = pt.check_gradients(feed, outs["avg_cost"], program=main,
                                    scope=scope, executor=exe, verbose=True)
    for name, r in sorted(report.items()):
        print(f"{name}: max_rel_err={r['max_rel_err']:.3e} "
              f"(checked {r['checked']} elements)")
    print("checkgrad " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


def cmd_train(args):
    import numpy as np

    import paddle_tpu_torch as pt

    mod = _load_config(args.config)
    if not hasattr(mod, "train_reader"):
        raise SystemExit("config must define train_reader()")
    main, startup, outs = _build(mod)
    place = args.device
    pt.resolve_device(place)   # no card and no --device cpu: raise here
    if args.job == "checkgrad":
        return _checkgrad(pt, mod, main, startup, outs, place,
                          args.batch_size)
    with pt.scope_guard(pt.Scope()):
        trainer = pt.Trainer(
            outs["avg_cost"], outs["feed"], place=place,
            extra_fetch=[v for k, v in outs.items()
                         if k not in ("feed", "avg_cost")
                         and hasattr(v, "name")],
            main_program=main, startup_program=startup)

        def handler(ev):
            if isinstance(ev, pt.EndIteration):
                if args.log_period and ev.batch_id % args.log_period == 0:
                    print(f"pass {ev.pass_id} batch {ev.batch_id} "
                          f"cost {np.asarray(ev.cost).ravel()[0]:.6f}",
                          flush=True)
            elif isinstance(ev, pt.EndPass):
                print(f"pass {ev.pass_id} done", flush=True)

        if args.run_log:
            reporter = pt.MetricsReporter(log_every_n=0,
                                          jsonl_path=args.run_log)
            handler = reporter.chain(handler)
        try:
            trainer.train(pt.reader.batch(mod.train_reader, args.batch_size),
                          num_passes=args.num_passes, event_handler=handler,
                          checkpoint_dir=args.checkpoint_dir)
        finally:
            if args.run_log:
                reporter.close()
    return 0


def _serve(service, args, kind, store, label):
    """Serve ``service`` on ``--port``, register it in ``store`` under
    ``kind`` and print ``<label> serving on <endpoint>``; until killed."""
    from .distributed import rpc
    from .distributed.store import register_service

    server = rpc.Server(service, port=args.port).start()
    stop = register_service(store, kind, server.endpoint)
    print(f"{label} serving on {server.endpoint}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        stop()
        server.stop()
    return 0


def _store(args):
    from .distributed.store import FileStore, InMemStore

    return FileStore(args.store) if args.store else InMemStore()


def cmd_pserver(args):
    from .distributed.pserver import ParameterServer

    store = _store(args)
    ps = ParameterServer(
        index=args.index, num_trainers=args.num_trainers,
        sync=not args.async_sgd, store=store,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_n_updates=args.checkpoint_every)
    return _serve(ps, args, "pserver", store, f"pserver {args.index}")


def cmd_master(args):
    import glob

    from .distributed.master import MasterService

    store = _store(args)
    svc = MasterService(store=store, chunks_per_task=args.chunks_per_task,
                        timeout_sec=args.timeout)
    if args.dataset:
        paths = sorted(p for pat in args.dataset for p in glob.glob(pat))
        svc.set_dataset(paths)
        print(f"dataset: {len(paths)} files, {len(svc.todo)} tasks",
              flush=True)
    return _serve(svc, args, "master", store, "master")


def cmd_dump_config(args):
    if args.dot:
        raise SystemExit("dump_config --dot needs net_drawer, which is not "
                         "ported yet (ROADMAP.md A9)")
    main, startup, _ = _build(_load_config(args.config))
    print(main.to_string())
    if args.startup:
        print("\n// ---- startup program ----")
        print(startup.to_string())
    return 0


def cmd_merge_model(args):
    """Bundle an exported inference-model dir (the ``save_inference_model``
    layout) into a single tar (reference MergeModel.cpp)."""
    import tarfile

    if not os.path.isdir(args.model_dir):
        raise SystemExit(f"not a directory: {args.model_dir}")
    with tarfile.open(args.output, "w") as tar:
        for name in sorted(os.listdir(args.model_dir)):
            tar.add(os.path.join(args.model_dir, name), arcname=name)
    print(f"wrote {args.output}")
    return 0


def _checker():
    failures = []

    def check(cond, what):
        (failures.append(what) if not cond else None)
        print(("ok   " if cond else "FAIL ") + what, flush=True)

    return failures, check


def cmd_metrics_selftest(device=None):
    """``--metrics-selftest``: the registry end to end — counters, gauges,
    histograms, Prometheus text, the JSONL run log — and the Executor's
    lowering counter and cache-hit flag on a real (tiny) program."""
    import tempfile

    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import (MetricsRegistry, RunLog,
                                                get_registry, read_jsonl)

    failures, check = _checker()
    reg = MetricsRegistry()
    c = reg.counter("t.count")
    c.inc()
    c.inc(2)
    check(c.value == 3, "counter accumulates")
    g = reg.gauge("t.depth", shard="0")
    g.set(7)
    check(reg.value("t.depth", shard="0") == 7, "labeled gauge")
    h = reg.histogram("t.lat")
    for i in range(100):
        h.observe(i / 100.0)
    check(abs(h.percentile(50) - 0.49) < 0.05, "histogram percentile")
    text = reg.to_text()
    check("t_count 3" in text and 'shard="0"' in text,
          "prometheus exposition")
    reg.reset()
    check(c.value == 0 and h.count == 0, "reset zeroes metrics")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "run.jsonl")
        with RunLog(path, mode="w") as log:
            log.log("step", cost=np.float32(1.5), batch_id=0)
            log.log("pass", pass_id=0)
        recs = read_jsonl(path)
    check(len(recs) == 2 and recs[0]["cost"] == 1.5, "jsonl round trip")

    greg = get_registry()
    c0 = greg.value("executor.compile_count")
    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(main_prog, startup):
        x = pt.layers.data("x", shape=[4])
        y = pt.layers.fc(x, 2)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(device)
        exe.run(startup)
        feed = {"x": np.zeros((2, 4), np.float32)}
        exe.run(main_prog, feed=feed, fetch_list=[y])
        check(greg.value("executor.compile_count") >= c0 + 2,
              "lowering counter increments (startup + main)")
        check(exe.last_step_cost["cache_hit"] is False,
              "first run is a cache miss")
        check(exe.last_step_cost["flops"] is not None,
              "the step cost reports flops")
        exe.run(main_prog, feed=feed, fetch_list=[y])
        check(exe.last_step_cost["cache_hit"] is True,
              "second run hits the lowering cache")
    print("metrics selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


def cmd_trace_selftest(device=None):
    """``--trace-selftest``: span semantics (nesting, the disabled mode's
    shared null context, the ``host_timer.*`` fold-in), a real trainer
    run emitting the five step-phase spans into a valid Chrome trace,
    and a serving request's span tree whose TTFT decomposition (queue
    wait + prefill) matches ``serving.ttft_seconds`` within 10%.  The
    JAX selftest's last stage drives ``--bench-history``, which is not
    ported (ROADMAP.md A5); it is left out."""
    import json
    import tempfile

    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import get_registry, trace

    failures, check = _checker()
    t = trace.Tracer(enabled=True, registry=None)
    with t.span("outer", cat="t", k=1):
        with t.span("inner"):
            pass
    t.instant("mark")
    outer, inner = t.events(name="outer")[0], t.events(name="inner")[0]
    check(outer["ts"] <= inner["ts"] and
          inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3,
          "span nesting by ts containment")
    check(outer["args"] == {"k": 1}, "span attributes recorded")
    td = trace.Tracer(enabled=False)
    check(td.span("x") is td.span("y") and not td.events(),
          "disabled mode: shared null context, no events")
    t2 = trace.Tracer(enabled=True)
    with t2.span("trace_selftest_phase"):
        pass
    h = get_registry().get("host_timer.trace_selftest_phase")
    check(h is not None and h.count == 1,
          "span duration folds into host_timer.*")

    old = trace.set_tracer(trace.Tracer(enabled=True))
    try:
        from paddle_tpu_torch.models import lenet, transformer
        from paddle_tpu_torch.serving import ServingEngine

        pt.core.unique_name.reset()
        main_prog, startup = pt.Program(), pt.Program()
        with pt.program_guard(main_prog, startup), \
                pt.scope_guard(pt.Scope()):
            model = lenet.build(learning_rate=0.01)
            trainer = pt.Trainer(model["avg_cost"], model["feed"],
                                 place=device)
            rng = np.random.default_rng(0)

            def reader():
                for _ in range(3):
                    yield [(rng.normal(size=(1, 28, 28)).astype(
                        np.float32), int(rng.integers(0, 10)))
                        for _ in range(4)]

            trainer.train(reader, num_passes=1)
        gt = trace.get_tracer()
        for name in ("trainer.reader_wait", "trainer.feed_h2d",
                     "trainer.dispatch", "trainer.device_sync",
                     "trainer.opt_boundary"):
            check(len(gt.events(name=name)) == 3,
                  f"trainer emits {name} x3")
        steps = gt.events(name="trainer.step")
        check(len(steps) == 3, "trainer emits trainer.step x3")
        disp = gt.events(name="trainer.dispatch")
        check(all(any(
            s["tid"] == d["tid"] and s["ts"] <= d["ts"] and
            d["ts"] + d["dur"] <= s["ts"] + s["dur"] + 1e-3
            for s in steps) for d in disp),
            "phase spans nest inside trainer.step")

        pt.core.unique_name.reset()
        mp, sp = pt.Program(), pt.Program()
        with pt.program_guard(mp, sp), pt.scope_guard(pt.Scope()):
            transformer.build(vocab_size=64, n_layer=2, n_head=2,
                              d_model=64, max_len=32, dropout_rate=0.0,
                              is_test=True, dtype="float32")
            pt.Executor("cpu").run(sp)
            params = transformer.extract_params(program=mp)
        eng = ServingEngine(params, 2, 2, 64, max_len=32, max_slots=4,
                            decode_chunk=2, min_bucket=4, device=device)
        eng.generate_many([np.arange(1, 4, dtype=np.int32)],
                          max_new_tokens=2)        # warm-up
        reg = get_registry()
        for nm in ("serving.ttft_seconds", "serving.queue_wait"):
            reg.get(nm).reset()
        gt.clear()
        req = eng.submit(np.arange(1, 5, dtype=np.int32), max_new_tokens=6)
        eng.run_until_idle()
        st = eng.stats()
        check(st["serving.ttft_seconds"]["count"] == 1
              and st["serving.queue_wait"]["count"] == 1,
              "one timed request observed")
        q = st["serving.queue_wait"]["mean"]
        pre = req.prefill_t1 - req.prefill_t0
        ttft = st["serving.ttft_seconds"]["mean"]
        check(abs((q + pre) - ttft) <= 0.10 * ttft,
              f"TTFT decomposition within 10% (queue {q * 1e3:.3f}ms + "
              f"prefill {pre * 1e3:.3f}ms vs ttft {ttft * 1e3:.3f}ms)")
        roots = gt.events(name="serving.request")
        check(len(roots) == 1, "request root span emitted")
        if roots:
            root = roots[0]
            kids = [e for e in gt.events(cat="serving")
                    if e["name"].startswith("serving.req.")
                    and e["tid"] == root["tid"]]
            cover = sum(e["dur"] for e in kids)
            check({e["name"] for e in kids} >= {
                "serving.req.queue", "serving.req.prefill",
                "serving.req.decode_chunk", "serving.req.evict"},
                "request span tree has queue/prefill/decode/evict")
            check(0.5 * root["dur"] <= cover <= 1.001 * root["dur"],
                  f"span tree covers the request "
                  f"({cover / root['dur'] * 100:.1f}% of e2e)")

        # the Chrome export carries the trainer's nested step phases AND
        # the request lane
        for e in steps + disp:
            gt._push(e)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            n = gt.save(path)
            with open(path, "r", encoding="utf-8") as fh:
                obj = json.load(fh)
        xs = [e for e in obj.get("traceEvents", []) if e.get("ph") == "X"]
        check(bool(xs) and all(
            all(k in e for k in ("ph", "ts", "dur", "pid", "tid", "name"))
            for e in xs),
            f"chrome trace valid ({n} events, ph/ts/dur/pid/tid/name)")
        names = {e["name"] for e in xs}
        check("trainer.step" in names and "serving.request" in names,
              "chrome trace carries trainer steps + serving request lane")
    finally:
        trace.set_tracer(old)

    # the bench-history gate on a planted fixture, in process: one JSON
    # summary line on stdout, rc 1
    import contextlib
    import io

    fixture = tempfile.mkdtemp(prefix="ptt_benchhist_")
    for name, data in (
            ("BENCH_r01.json", {"n": 1, "rc": 0, "parsed": {
                "metric": "m", "value": 100.0, "unit": "u"}}),
            ("BENCH_r02.json", {"n": 2, "rc": 0, "parsed": {
                "metric": "m", "value": 42.0, "unit": "u"}}),  # regression
            ("BENCH_r03.json", {"n": 3, "rc": 1, "parsed": None})):
        with open(os.path.join(fixture, name), "w") as fh:
            json.dump(data, fh)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cmd_bench_history(["--bench-history", "--dir", fixture])
    check(rc != 0, f"--bench-history exits non-zero on the planted fixture "
                   f"(rc={rc})")
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    summary = None
    if len(lines) == 1:
        try:
            summary = json.loads(lines[0])
        except json.JSONDecodeError:
            summary = None
    check(summary is not None, "one parseable JSON summary row")
    if summary:
        check("BENCH_r03.json" in summary["failed"],
              "planted failed artifact classified")
        check(any(r["artifact"] == "BENCH_r02.json"
                  for r in summary["regressions"]),
              "planted regression flagged")
    print("trace selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


def _gpt(pt, policy, n_layer=5, t=12, d=32, vocab=29, dtype="float32"):
    """The selftests' small GPT (``transformer.build``, dropout 0), under
    ``memory_optimize(policy)`` when one is given."""
    from .models import transformer

    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = 7
    with pt.program_guard(main_prog, startup):
        outs = transformer.build(vocab_size=vocab, n_layer=n_layer,
                                 n_head=2, d_model=d, max_len=t,
                                 dropout_rate=0.0, dtype=dtype)
    if policy:
        pt.memory_optimize(main_prog, policy=policy)
    return main_prog, startup, outs["avg_cost"]


def _ragged_gpt(pt, policy, n_layer=5, t=12, d=32, vocab=29):
    """A GPT stack whose layers are not uniform (layer ``i``'s FFN is
    ``(i + 2) * d`` wide), under ``memory_optimize(policy)``: no two
    layers group, so each runs unrolled.  The planted
    ``jaxpr.scan-locality`` case."""
    from .layers import tensor as ltensor
    from .models import transformer

    layers = pt.layers
    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = 7
    with pt.program_guard(main_prog, startup):
        tokens = layers.data("tokens", shape=[t], dtype="int64")
        labels = layers.data("labels", shape=[t], dtype="int64")
        x = layers.embedding(tokens, size=[vocab, d], param_attr="tok_emb.w")
        for i in range(n_layer):
            x = transformer.transformer_block(
                x, d, 2, (i + 2) * d, 0.0, False, name=f"block{i}")
        logits = layers.fc(layers.layer_norm(x, begin_norm_axis=2),
                           vocab, num_flatten_dims=2, name="lm_head")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            ltensor.reshape(logits, [-1, vocab]),
            ltensor.reshape(labels, [-1, 1])))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    pt.memory_optimize(main_prog, policy=policy)
    return main_prog, startup, loss


def cmd_memory_selftest(device=None):
    """``--memory-selftest``: for every ``memory_optimize`` policy
    (selective / compact / full / offload) on a small GPT, the lowered
    step's remat plan and memory figure (``analysis.audit_program``):
    every flash op sits inside the plan's uniform layer group (at most
    one layer's outside), no kernel operand carries a layer-count axis,
    no value of the op records has the stacked ``[L, t, d]`` shape, the
    groups engaged, and the memory figure is reported
    (one step's ``max_memory_allocated`` on the card, the analytic
    estimate on the CPU).  Also holds ``offload``'s loss to
    ``selective``'s bit for bit."""
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis import audit_program

    failures, check = _checker()
    n_layer, t, d = 5, 12, 32
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 29, (2, t)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    losses = {}
    for policy in ("selective", "compact", "full", "offload"):
        main_prog, startup, loss = _gpt(pt, policy, n_layer, t, d)
        scope = pt.Scope()
        exe = pt.Executor(device)
        exe.run(startup, scope=scope)
        rep = audit_program(main_prog, feed, [loss], scope=scope,
                            layer_count=n_layer, device=device,
                            absent_shapes=[(n_layer, t, d)])
        if policy in ("selective", "offload"):
            losses[policy] = np.asarray(exe.run(
                main_prog, feed=feed, fetch_list=[loss], scope=scope)[0])
        check(rep["pallas_total"] > rep["pallas_outside_scan"]
              and rep["pallas_outside_scan"] <= 1,
              f"{policy}: flash ops inside the layer group "
              f"({rep['pallas_outside_scan']}/{rep['pallas_total']} "
              f"outside)")
        check(not rep["layer_stacked_pallas"],
              f"{policy}: no layer-stacked kernel operand "
              f"{rep['layer_stacked_pallas'][:2]}")
        check(all(n == 0 for n in rep["absent_shape_hits"].values()),
              f"{policy}: no [{n_layer},{t},{d}] value in the step")
        plan = rep["scan_remat_plan"]
        check(bool(plan), f"{policy}: layer groups engaged "
              f"({[(g['start'], g['period'], g['count']) for g in plan]})")
        check((rep.get("hbm_high_water_bytes") or 0) > 0,
              f"{policy}: memory figure {rep.get('hbm_high_water_bytes')} "
              f"B ({rep.get('memory_source')})")
    check(np.array_equal(losses["offload"], losses["selective"]),
          "offload loss bit-exact vs selective")
    print("memory selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


def _config_program(mod, path):
    """``(main, fetch_list)`` of a model-config script: ``build()`` (the
    train convention; fetch the cost and every other output) or
    ``build_program()`` -> ``(main, startup, fetch_list)``."""
    if hasattr(mod, "build"):
        main_prog, _startup, outs = _build(mod)
        fetch = [outs["avg_cost"]] if "avg_cost" in outs else []
        fetch += [v for k, v in outs.items()
                  if k not in ("feed", "avg_cost") and hasattr(v, "name")]
        return main_prog, fetch
    if hasattr(mod, "build_program"):
        main_prog, _startup, fetch = mod.build_program()
        return main_prog, fetch
    raise SystemExit(f"{path}: defines neither build() nor "
                     f"build_program(); see python -m paddle_tpu_torch "
                     f"--lint --help")


def cmd_lint(argv):
    """``--lint <config.py> [--strict] [--json] [--levels
    program,jaxpr,hlo] [--hbm-budget B] [--device D]``: build a
    model-config script's Program and run the static-analysis engine over
    it — the Program checks, the lowered step's and the run's (zeros of
    the declared shapes feed the step; on the card the hlo level runs one
    step for its memory figure).  One line per finding plus a summary; rc
    1 when error findings survive, 2 under ``--strict`` (the
    AnalysisError prints instead)."""
    import json as _json

    p = argparse.ArgumentParser(prog="paddle_tpu_torch --lint")
    p.add_argument("config",
                   help="model-config script: build() -> dict (the train "
                        "convention) or build_program() -> (main, "
                        "startup, fetch_list)")
    p.add_argument("--strict", action="store_true",
                   help="raise on error-severity findings (rc 2)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the full report as one JSON object")
    p.add_argument("--levels", default="program,jaxpr,hlo",
                   help="comma-separated artifact levels to run")
    p.add_argument("--hbm-budget", type=int, default=None,
                   help="device memory budget in bytes for the "
                        "hlo.hbm-preflight check (default: the card's "
                        "total_memory; the CPU has none)")
    p.add_argument("--device", default=None,
                   help="'cpu' to lower on the CPU; default: the card")
    args = p.parse_args([a for a in argv if a != "--lint"])

    from . import analysis

    main_prog, fetch = _config_program(_load_config(args.config),
                                       args.config)
    levels = tuple(x.strip() for x in args.levels.split(",") if x.strip())
    try:
        report = analysis.lint(main_prog, fetch_list=fetch, levels=levels,
                               strict=args.strict,
                               hbm_budget=args.hbm_budget,
                               device=args.device)
    except analysis.AnalysisError as e:
        print(e)
        return 2
    if args.as_json:
        print(_json.dumps(analysis.report_json(report, levels=levels)))
    else:
        for f in report:
            print(repr(f))
            if f.hint:
                print(f"    hint: {f.hint}")
        print("lint: " + report.summary())
    return 0 if report.ok else 1


# the model configs ``--lint-selftest`` writes and lints: the train
# command's convention (build() + train_reader()) over the model zoo
_LINT_CONFIGS = {
    "fit_a_line": "pt.models.fit_a_line.build()",
    "lenet": "pt.models.lenet.build()",
    "word2vec": "pt.models.word2vec.build(dict_size=50)",
    "ctr_dnn": ("pt.models.ctr_dnn.build(sparse_feature_dim=50, "
                "num_slots=2, embedding_size=4, dense_dim=3, hidden=(8,))"),
    "text_classification":
        "pt.models.text_classification.build(dict_dim=50)",
    "transformer": ("pt.models.transformer.build(vocab_size=29, n_layer=2, "
                    "n_head=2, d_model=32, max_len=12, dropout_rate=0.0, "
                    "dtype='float32')"),
}


def cmd_lint_selftest(device=None):
    """``--lint-selftest``: the static-analysis engine's gate — one
    planted Program per defect class (dead var/op, shape-dtype mismatch,
    read-before-write, fetch overwrite; an ungrouped layer stack, a bf16
    carried accumulator, tanh in a checkpointed region, degraded offload,
    plain kernels in a timed region; a step over its memory budget, state
    replaced rather than updated in place, an in-loop reduction) with
    the exact finding ids; a declared ``shard_activation`` that stays
    silent; ZERO findings on the clean GPT under no policy, ``selective``
    and ``offload``; strict mode raises; and the train command's configs
    over the model zoo lint clean."""
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import analysis, layers
    from paddle_tpu_torch.analysis.comm.plan import CommOp, CommPlan
    from paddle_tpu_torch.analysis.jaxpr_checks import timed_run
    from paddle_tpu_torch.parallel import api as papi

    failures, check = _checker()

    # -- planted Program-level defects ---------------------------------
    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(main_prog, startup):
        x = layers.data("x", shape=[4])
        y = layers.fc(x, 2, name="live")
        layers.fc(x, 3, name="deadfc")  # dead op chain
        blk = main_prog.global_block()
        blk.create_var(name="orphan", shape=(3,), dtype="float32")
        a = blk.create_var(name="a", shape=(-1, 4), dtype="float32")
        b = blk.create_var(name="b", shape=(-1, 8), dtype="float32")
        c = blk.create_var(name="c", shape=(-1, 4), dtype="float32")
        blk.append_op("elementwise_add", {"X": [a.name], "Y": [b.name]},
                      {"Out": [c.name]})
        blk.append_op("relu", {"X": [x.name]}, {"Out": [y.name]})
    rep = analysis.lint(main_prog, fetch_list=[y], levels=("program",))
    ids = set(rep.ids())
    check("program.dead-code" in ids, "planted dead var/op reported")
    check("program.shape-dtype" in ids, "planted shape mismatch reported")
    check("program.read-before-write" in ids,
          "planted read-before-write reported")
    check("program.fetch-overwritten" in ids,
          "planted fetch overwrite reported")
    try:
        analysis.lint(main_prog, fetch_list=[y], levels=("program",),
                      strict=True)
        check(False, "strict mode raises AnalysisError")
    except analysis.AnalysisError:
        check(True, "strict mode raises AnalysisError")

    # -- planted step-level defects ------------------------------------
    def step_ids(prog, fetch, **kw):
        return analysis.lint(prog, fetch_list=fetch, levels=("jaxpr",),
                             device=device, **kw).ids()

    mp, _sp, loss = _ragged_gpt(pt, "selective")
    check("jaxpr.scan-locality" in step_ids(mp, [loss], layer_count=5),
          "ungrouped layers (a non-uniform stack) reported")

    pt.core.unique_name.reset()
    mp, sp = pt.Program(), pt.Program()
    with pt.program_guard(mp, sp):
        xb = layers.data("xb", shape=[16, 8], dtype="bfloat16")
        init = layers.reduce_mean(xb, dim=1)
        rnn = layers.StaticRNN(name="acc")
        with rnn.step():
            xt = rnn.step_input(xb)
            acc = rnn.memory(init)
            new = acc + xt
            rnn.update_memory(acc, new)
            rnn.step_output(new)
        tot = layers.reduce_sum(rnn())
    check("jaxpr.bf16-accum" in step_ids(mp, [tot]),
          "bf16 carried accumulator reported")

    pt.core.unique_name.reset()
    mp, sp = pt.Program(), pt.Program()
    with pt.program_guard(mp, sp):
        xv = layers.data("x", shape=[16])
        h = xv
        for i in range(4):
            h = layers.fc(h, 16, act="tanh", name=f"l{i}")
        loss2 = layers.reduce_mean(layers.fc(h, 1, name="head"))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss2)
    pt.memory_optimize(mp, policy="full")
    check("jaxpr.tanh-gelu" in step_ids(mp, [loss2]),
          "tanh inside a checkpointed region reported")

    pt.core.unique_name.reset()
    mp, sp = pt.Program(), pt.Program()
    with pt.program_guard(mp, sp):
        xv = layers.data("x", shape=[16])
        h = layers.fc(xv, 12, act="relu", name="a1")
        h = layers.fc(h, 6, act="sigmoid", name="b1")
        loss3 = layers.reduce_mean(layers.fc(h, 1, name="c1"))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss3)
    pt.memory_optimize(mp, policy="offload")
    check("jaxpr.kernel-residual" in step_ids(mp, [loss3]),
          "offload degraded on a non-uniform program reported")

    mp, _sp, loss = _gpt(pt, "selective")
    with timed_run():
        got = step_ids(mp, [loss])
        snap = analysis.compile_findings(
            kernel_backends={"flash_attention": "simple-forced"})
    check("jaxpr.kernel-backend" in got
          or (pt.resolve_device(device).type == "cuda"
              and [f.check for f in snap] == ["jaxpr.kernel-backend"]),
          "stand-in kernels inside a timed-run region reported")
    blk = mp.global_block()
    flash = [op for op in blk.ops if op.type.startswith("flash_attention")]
    papi.shard_activation(blk._find_var(flash[1].outputs["Out"][0]),
                          papi.P(None, "sp", None))
    check("jaxpr.constraint-placement" not in step_ids(mp, [loss]),
          "a declared shard_activation inside a layer stays silent")

    # -- planted run-level defects -------------------------------------
    mp, _sp, loss = _gpt(pt, None)
    rep = analysis.lint(mp, fetch_list=[loss], levels=("hlo",),
                        hbm_budget=1, device=device)
    check("hlo.hbm-preflight" in rep.ids()
          and rep.by_check("hlo.hbm-preflight")[0].severity == "error",
          "a step over its memory budget reported")
    fs = analysis.donation_findings(
        {"argument_bytes": 5 << 20, "alias_bytes": 0}, True)
    check([f.check for f in fs] == ["hlo.donation-alias"]
          and not analysis.donation_findings(
              {"argument_bytes": 5 << 20, "alias_bytes": 4 << 20}, True),
          "in-place state audit")
    plan = CommPlan([CommOp("all-reduce", 4096, ("dp",), True, "bwd-scan"),
                     CommOp("all-reduce", 4096, ("dp",), False,
                            "boundary")], {"dp": 2})
    found = analysis.compile_findings(
        memstats={}, comm=plan.comm_report(), comm_plan=plan)
    inloop = [f for f in found if f.check == "hlo.inloop-collective"]
    check(bool(inloop) and inloop[0].severity == "error",
          "planted in-loop reduction reported")

    # -- clean program: the GPT, zero findings -------------------------
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 29, (2, 12)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    for policy in (None, "selective", "offload"):
        mp, _sp, loss = _gpt(pt, policy)
        rep = analysis.lint(mp, feed=feed, fetch_list=[loss],
                            layer_count=5, device=device)
        check(len(rep) == 0,
              f"clean GPT program (policy={policy}) has zero findings "
              f"({rep.ids()})")

    # -- the train command's configs lint clean ------------------------
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for name, call in sorted(_LINT_CONFIGS.items()):
            path = os.path.join(d, f"{name}.py")
            with open(path, "w") as fh:
                fh.write(f"import paddle_tpu_torch as pt\n\n\n"
                         f"def build():\n    return {call}\n\n\n"
                         f"def train_reader():\n    return iter(())\n")
            try:
                mp, fetch = _config_program(_load_config(path), path)
                rep = analysis.lint(mp, fetch_list=fetch,
                                    levels=("program",))
                check(not rep.errors and not rep.warnings,
                      f"config {name} lints clean ({rep.ids()})")
            except Exception as e:  # noqa: BLE001
                check(False, f"config {name} lint crashed: "
                             f"{type(e).__name__}: {e}")
    print("lint selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


def cmd_attribution_selftest(device=None):
    """``--attribution-selftest``: the per-op attribution engine and the
    crash flight recorder — the GPT family's step (flash attention, the
    fused CE head, ``selective``) folds an attribution table into
    ``exe.last_attribution`` whose product flops cover >= 95% of
    ``step_flops`` with ``matmul`` and ``pallas`` classes, shares summing
    to 1, a bound verdict per class and a tune-style workload key; the
    compact summary rides ``last_step_cost``; the estimate's error
    against the measured step is reported; on the card a profiled step's
    kernel time lands in the same classes; an injected NaN fault and a
    tripped watchdog each dump a loadable flight bundle; and a planted
    two-round bench-history regression is attributed to the class whose
    share moved.  ``ATTR_SELFTEST_*`` environment variables restore a
    full-size shape."""
    import json as _json
    import math
    import tempfile
    import time

    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.observability import attribution as attr
    from paddle_tpu_torch.observability import bench_history as bh
    from paddle_tpu_torch.observability import flight

    failures, check = _checker()
    dev = pt.resolve_device(device)
    n_layer = int(os.environ.get("ATTR_SELFTEST_LAYERS", "4"))
    d_model = int(os.environ.get("ATTR_SELFTEST_DMODEL", "64"))
    n_head = int(os.environ.get("ATTR_SELFTEST_HEADS", "2"))
    seq = int(os.environ.get("ATTR_SELFTEST_SEQ", "128"))
    vocab = int(os.environ.get("ATTR_SELFTEST_VOCAB", "512"))
    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = 7
    with pt.program_guard(main_prog, startup):
        outs = transformer.build(
            vocab_size=vocab, n_layer=n_layer, n_head=n_head,
            d_model=d_model, max_len=seq, dropout_rate=0.0,
            dtype="float32", fused_head=True)
    pt.memory_optimize(main_prog, policy="selective")
    scope = pt.Scope()
    exe = pt.Executor(device)
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, vocab, (2, seq)).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    fetch = [outs["avg_cost"]]
    exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    cost = exe.last_step_cost
    att = exe.last_attribution
    check(att is not None and att.get("classes"),
          "the first run folded exe.last_attribution")
    cov = (att or {}).get("coverage")
    check(cov is not None and cov >= 0.95,
          f"product flops cover >= 95% of step_flops (coverage={cov})")
    classes = (att or {}).get("classes", {})
    check("matmul" in classes and "pallas" in classes,
          f"table carries matmul + pallas kernel classes "
          f"({sorted(classes)})")
    share_sum = sum(r.get("share") or 0 for r in classes.values())
    check(abs(share_sum - 1.0) < 0.02,
          f"class shares sum to 1 ({share_sum:.4f})")
    check(all(r.get("bound") in ("compute", "memory")
              for r in classes.values()),
          "every class classified compute- or memory-bound")
    wk = (att or {}).get("workload") or ""
    check(wk.startswith("op=step|") and "remat=selective" in wk,
          f"tune-style workload key ({wk})")
    summ = (cost or {}).get("attribution") or {}
    check(bool(summ.get("top")) and summ.get("coverage") == cov,
          "compact summary rides last_step_cost (trainer JSONL channel)")

    def step(_i=0):
        exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)

    steps = 3
    t0 = time.perf_counter()
    for _ in range(steps):
        out = exe.run(main_prog, feed=feed, fetch_list=fetch, scope=scope)
    measured = (time.perf_counter() - t0) / steps
    rec = attr.reconcile(att, measured)
    check(rec is not None and math.isfinite(rec["err_pct"]),
          f"estimated-vs-measured step-time error reported "
          f"(est {rec['est_ms'] if rec else '?'} ms vs measured "
          f"{rec['measured_ms'] if rec else '?'} ms, "
          f"err {rec['err_pct'] if rec else '?'}%)")
    del out
    if dev.type == "cuda":
        prof = attr.attribute_profile(step, measured, dev)
        check(prof["total_ms"] > 0 and "pallas" in prof["classes"]
              and "matmul" in prof["classes"],
              f"a profiled step's kernel time by class "
              f"({ {c: r['ms'] for c, r in prof['classes'].items()} } ms; "
              f"accounted {prof['accounted_share']}, unmatched "
              f"{prof['unmatched'][:3]})")

    # -- flight recorder: injected NaN + watchdog trips ----------------
    tmpd = tempfile.mkdtemp(prefix="ptt_flight_")
    old_rec = flight.set_recorder(flight.FlightRecorder(out_dir=tmpd))
    try:
        pt.core.unique_name.reset()
        mp2, sp2 = pt.Program(), pt.Program()
        with pt.program_guard(mp2, sp2), pt.scope_guard(pt.Scope()):
            x = layers.data("x", shape=[8])
            yv = layers.data("y", shape=[1])
            h = layers.fc(x, 8, act="relu")
            loss2 = layers.reduce_mean(
                layers.square(layers.fc(h, 1) - yv))
            pt.optimizer.SGD(learning_rate=0.1).minimize(loss2)
            trainer = pt.Trainer(loss2, [x, yv], place=device,
                                 main_program=mp2, startup_program=sp2)
            rng2 = np.random.default_rng(0)

            def reader():
                for _ in range(4):
                    yield [(rng2.normal(size=(8,)).astype(np.float32),
                            rng2.normal(size=(1,)).astype(np.float32))
                           for _ in range(4)]

            os.environ["PADDLE_TPU_FAULT"] = "nan_grad:3"
            try:
                trainer.train(reader, num_passes=1)
            except FloatingPointError:
                pass
            finally:
                os.environ.pop("PADDLE_TPU_FAULT", None)
        rec_obj = flight.get_recorder()
        nan_dumps = [p for p in rec_obj.dumps if "nan_trip" in p]
        check(bool(nan_dumps),
              f"injected nan_grad fault dumped a flight bundle "
              f"({rec_obj.dumps})")
        if nan_dumps:
            b = flight.load_bundle(nan_dumps[0])
            steps_in = b.get("steps", [])
            trig = [s for s in steps_in
                    if isinstance(s.get("loss"), float)
                    and math.isnan(s["loss"])]
            check(bool(trig),
                  f"bundle contains the triggering (NaN-loss) step "
                  f"({len(steps_in)} step records)")
            check(b.get("reason") == "nan_trip" and b.get("spans")
                  is not None and b.get("metrics") is not None,
                  "bundle carries reason/spans/metrics")

        from paddle_tpu_torch.resilience.watchdog import Watchdog

        wd = Watchdog(deadline=0.15, label="attr-selftest")
        time.sleep(0.8)
        wd.stop()
        wd_dumps = [p for p in flight.get_recorder().dumps
                    if "watchdog" in p]
        check(bool(wd_dumps),
              "watchdog trip dumped a loadable flight bundle")
        if wd_dumps:
            b = flight.load_bundle(wd_dumps[0])
            check(b.get("reason") == "watchdog"
                  and b.get("context", {}).get("age_s") is not None,
                  "watchdog bundle carries the stall age")
    finally:
        flight.set_recorder(old_rec)

    # -- regression attribution on a planted two-round fixture ---------
    fixture = tempfile.mkdtemp(prefix="ptt_attr_hist_")

    def _att_extra(shares):
        return {"classes": {c: {"flops": 1, "bytes": 1, "est_ms": s,
                                "share": s, "bound": "memory"}
                            for c, s in shares.items()},
                "workload": "op=step|t=4096|dh=128|h=6|dt=bfloat16"
                            "|plat=gpu|remat=-",
                "coverage": 1.0, "est_ms_total": 1.0}

    for name, n, value, shares in (
            ("BENCH_r01.json", 1, 100.0,
             {"matmul": 0.6, "elementwise": 0.3,
              "collective.all-reduce": 0.1}),
            ("BENCH_r02.json", 2, 42.0,
             {"matmul": 0.35, "elementwise": 0.25,
              "collective.all-reduce": 0.4})):
        with open(os.path.join(fixture, name), "w") as fh:
            _json.dump({"n": n, "rc": 0, "parsed": {
                "metric": "gpt_train_tokens_per_sec_per_chip",
                "value": value, "unit": "tok/s",
                "extra": {"gpt_attribution": _att_extra(shares)}}}, fh)
    summary, _rows = bh.history(fixture)
    check(bool(summary["regressions"]), "planted >10% regression flagged")
    moved = summary.get("regression_attribution", {}).get(
        "BENCH_r02.json:gpt_train_tokens_per_sec_per_chip") or []
    check(bool(moved) and moved[0]["op_class"] == "collective.all-reduce",
          f"regression attributed to the op class whose share moved "
          f"({[m['op_class'] for m in moved]})")
    print("attribution selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


def cmd_costmodel_selftest(device=None):
    from .tune.costmodel_selftest import run_selftest

    return run_selftest(device)


def cmd_bench_history(argv):
    """``--bench-history [--dir D] [--threshold T] [--known-failures F]``:
    parse every ``BENCH_*.json`` / ``MULTICHIP_*.json`` artifact under the
    repo root (or ``--dir``) into one trajectory table (stderr), classify
    failed artifacts, flag metric regressions beyond ``--threshold``
    (default 10%) vs best-so-far, and print ONE parseable JSON summary
    row on stdout.  rc 1 when any failure or regression is not
    acknowledged in the known-failures file (default
    ``<dir>/tools/bench_known_failures.json``)."""
    import json as _json

    p = argparse.ArgumentParser(prog="paddle_tpu_torch --bench-history")
    p.add_argument("--dir", default=None,
                   help="artifact directory (default: the repo root "
                        "containing this package)")
    p.add_argument("--threshold", type=float, default=0.1,
                   help="regression threshold vs best-so-far (0.1 = "
                        "flag any metric >10%% below its best round)")
    p.add_argument("--known-failures", default=None,
                   help="JSON {artifact: reason} of acknowledged "
                        "failures/regressions (default: "
                        "<dir>/tools/bench_known_failures.json)")
    p.add_argument("--device", default=None,
                   help="accepted like every flag's; the gate reads "
                        "files only")
    args = p.parse_args([a for a in argv if a != "--bench-history"])

    from .observability import bench_history as bh

    root = args.dir or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    kf = args.known_failures
    if kf is None:
        cand = os.path.join(root, "tools", "bench_known_failures.json")
        kf = cand if os.path.exists(cand) else None
    known = {}
    if kf:
        with open(kf, "r", encoding="utf-8") as fh:
            known = _json.load(fh)
    summary, rows = bh.history(root, threshold=args.threshold,
                               known_failures=known)
    print(bh.format_table(rows), file=sys.stderr)
    for art, why in sorted(summary.get("resolved", {}).items()):
        print(f"RESOLVED: {art}: {why}", file=sys.stderr)
    for k in summary.get("stale_acks", []):
        print(f"WARNING: stale ack {k!r} in {kf or 'known-failures'}: "
              f"the acknowledged defect no longer exists — delete the "
              f"entry", file=sys.stderr)
    for r in summary["regressions"]:
        ack = (" (acknowledged)"
               if f"{r['artifact']}:{r['metric']}" in known else "")
        print(f"REGRESSION{ack}: {r['metric']} {r['value']:g} in "
              f"{r['artifact']} is {r['drop'] * 100:.1f}% below best "
              f"{r['best']:g} (round {r['best_round']})",
              file=sys.stderr)
    for key, moved in sorted(
            summary.get("regression_attribution", {}).items()):
        tops = "; ".join(
            f"{m['op_class']} share {m['share_best']} -> {m['share']}"
            for m in moved[:3])
        print(f"ATTRIBUTION: {key}: {tops}", file=sys.stderr)
    print(_json.dumps(summary))
    return 0 if summary["ok"] else 1


def cmd_resilience_selftest(device=None):
    from .resilience.selftest import run_selftest

    return run_selftest(device)


def cmd_tune_selftest(device=None):
    from .tune.selftest import run_selftest

    return run_selftest(device)


def cmd_spec_selftest(device=None):
    from .serving.spec_selftest import run_selftest

    return run_selftest(device)


# the JAX package's selftest flags, in its dispatch order
# (paddle_tpu/__main__.py main()); None: not ported, see _UNPORTED
SELFTESTS = (
    ("--metrics-selftest", cmd_metrics_selftest),
    ("--memory-selftest", cmd_memory_selftest),
    ("--multichip-selftest", None),
    ("--lint-selftest", cmd_lint_selftest),
    ("--sharding-selftest", None),
    ("--trace-selftest", cmd_trace_selftest),
    ("--resilience-selftest", cmd_resilience_selftest),
    ("--tune-selftest", cmd_tune_selftest),
    ("--kernels-selftest", None),
    ("--costmodel-selftest", cmd_costmodel_selftest),
    ("--attribution-selftest", cmd_attribution_selftest),
    ("--spec-selftest", cmd_spec_selftest),
    ("--bench-history", cmd_bench_history),
    ("--lint", cmd_lint),
)

# the flags that take the command line itself rather than a device
_TAKE_ARGV = ("--bench-history", "--lint")

_UNPORTED = {
    "--multichip-selftest": "ROADMAP.md A7 (analysis/comm/selftest.py)",
    "--sharding-selftest": "ROADMAP.md A7 (analysis/comm/selftest.py)",
    "--kernels-selftest": "ROADMAP.md A6 (the kernel registry)",
}


def _take_device(argv):
    """The ``--device=X`` / ``--device X`` token of a selftest flag
    (None: the card)."""
    for i, tok in enumerate(argv):
        if tok.startswith("--device="):
            return tok.split("=", 1)[1]
        if tok == "--device" and i + 1 < len(argv):
            return argv[i + 1]
    return None


def parser():
    p = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("train", help="train a model-config script")
    sp.add_argument("--job", choices=["train", "checkgrad"],
                    default="train",
                    help="checkgrad: finite-difference the whole model's "
                         "gradients on one batch instead of training")
    sp.add_argument("config")
    sp.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the card "
                         "(raises when there is none)")
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--num-passes", type=int, default=1)
    sp.add_argument("--log-period", type=int, default=10)
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--run-log", default=None,
                    help="write per-step telemetry JSONL (wall time, "
                         "throughput, MFU) to this path")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("pserver", help="run a parameter-server shard")
    sp.add_argument("--index", type=int, default=0)
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--num-trainers", type=int, default=1)
    sp.add_argument("--async-sgd", action="store_true")
    sp.add_argument("--store", default=None,
                    help="FileStore root for discovery/checkpoint metadata")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--checkpoint-every", type=int, default=0)
    sp.set_defaults(fn=cmd_pserver)

    sp = sub.add_parser("master", help="run the dataset task dispatcher")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--dataset", nargs="*", default=None,
                    help="recordio file globs")
    sp.add_argument("--chunks-per-task", type=int, default=1)
    sp.add_argument("--timeout", type=float, default=20.0)
    sp.add_argument("--store", default=None)
    sp.set_defaults(fn=cmd_master)

    sp = sub.add_parser("version")
    sp.set_defaults(fn=cmd_version)

    sp = sub.add_parser("dump_config", help="print a config's Program IR")
    sp.add_argument("config")
    sp.add_argument("--dot", action="store_true", help="graphviz output")
    sp.add_argument("--startup", action="store_true")
    sp.set_defaults(fn=cmd_dump_config)

    sp = sub.add_parser("merge_model",
                        help="bundle an inference-model dir into a tar")
    sp.add_argument("model_dir")
    sp.add_argument("output")
    sp.set_defaults(fn=cmd_merge_model)
    return p


def main(argv=None):
    from .flags import init_flags

    argv = init_flags(list(sys.argv[1:] if argv is None else argv))
    for flag, fn in SELFTESTS:
        if flag not in argv:
            continue
        if fn is None:
            print(f"{flag} is not ported yet: {_UNPORTED[flag]}",
                  file=sys.stderr)
            return 2
        if flag in _TAKE_ARGV:
            return fn(argv)
        return fn(_take_device(argv))
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
