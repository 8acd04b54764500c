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
every check passes: ``--metrics-selftest``, ``--trace-selftest``,
``--resilience-selftest``, ``--tune-selftest``, ``--spec-selftest``.
The JAX package's other flags (``_UNPORTED``) exit 2 naming the
ROADMAP.md item that ports them.

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
    print("left out: the --bench-history stage (ROADMAP.md A5)")
    print("trace selftest " + ("FAILED" if failures else "PASSED"))
    return 1 if failures else 0


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
    ("--memory-selftest", None),
    ("--multichip-selftest", None),
    ("--lint-selftest", None),
    ("--sharding-selftest", None),
    ("--trace-selftest", cmd_trace_selftest),
    ("--resilience-selftest", cmd_resilience_selftest),
    ("--tune-selftest", cmd_tune_selftest),
    ("--kernels-selftest", None),
    ("--costmodel-selftest", None),
    ("--attribution-selftest", None),
    ("--spec-selftest", cmd_spec_selftest),
    ("--bench-history", None),
    ("--lint", None),
)

_UNPORTED = {
    "--memory-selftest": "ROADMAP.md A4 (the selftest flags)",
    "--multichip-selftest": "ROADMAP.md A7 (analysis/comm/selftest.py)",
    "--lint-selftest": "ROADMAP.md A5 (the analysis/ lints)",
    "--sharding-selftest": "ROADMAP.md A7 (analysis/comm/selftest.py)",
    "--kernels-selftest": "ROADMAP.md A6 (the kernel registry)",
    "--costmodel-selftest": "ROADMAP.md A5 (attribution and the corpus)",
    "--attribution-selftest": "ROADMAP.md A5 (attribution)",
    "--bench-history": "ROADMAP.md A5 (bench_history)",
    "--lint": "ROADMAP.md A5 (the analysis/ lints)",
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
        return fn(_take_device(argv))
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
