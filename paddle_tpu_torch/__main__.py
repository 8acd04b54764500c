"""Command-line entry: ``python -m paddle_tpu_torch <command>`` (the port's
counterpart of ``python -m paddle_tpu``).

Reference: the ``paddle`` CLI (``paddle/scripts/submit_local.sh.in:4-13``;
binaries ``paddle/trainer/TrainerMain.cpp``,
``pserver/ParameterServer2Main.cpp``, Go ``go/cmd/{pserver,master}``).

Commands:
  train     drive a model-config script's training loop on the card
            (``--device cpu`` asks for the CPU; ``--job=checkgrad``
            finite-differences the whole model's gradients on one batch)
  pserver   serve a parameter-server shard over RPC (host code)
  master    serve the elastic dataset task dispatcher over RPC (host code)
  version   print the versions, the card and the native library's state

A model-config script is a Python file defining ``build() -> dict`` (with
"feed" and "avg_cost" entries, like ``paddle_tpu_torch.models.*.build``)
and ``train_reader()`` yielding samples — the v1 trainer-config
convention on the fluid-style DSL.  ``--flag=value`` tokens naming a
registered flag (``flags.py``) are taken before the command is parsed.
"""

import argparse
import importlib.util
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
    return p


def main(argv=None):
    from .flags import init_flags

    argv = init_flags(list(sys.argv[1:] if argv is None else argv))
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
