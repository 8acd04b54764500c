"""What the Executor's fold-in hook costs a first run.

    python -m paddle_tpu_torch.benchmarks.fold_in_cost [--device cpu|cuda]
        [--repeats N] [--pytest tests/test_x.py ...]

The fold-in (``core/executor.py: _fold_probe`` before a run and
``_fold_in`` after it) computes the attribution table and the lints at
the first run of a lowered step.  For each small GPT of ``CONFIGS``
(``transformer.build``, dropout 0, f32; a fresh Program and Executor each
time), the script times the first run after the startup program, with
both kill switches on (the hook's own seconds read from
``executor.fold_in_seconds``) and with ``PADDLE_TPU_ATTR=0`` and
``PADDLE_TPU_LINT=0``; one warm-up, then the median of ``--repeats``.

``--pytest FILE`` runs a test file in this process twice, switches on and
off, and reports the seconds spent in the two hook methods (every call,
the cheap probe of a cache hit included) against the session's wall.
"""

import argparse
import contextlib
import os
import statistics
import time

import numpy as np

# (name, n_layer, d_model, max_len, batch, memory_optimize policy or None)
CONFIGS = (("2L d32 t32 b4", 2, 32, 32, 4, None),
           ("2L d32 t32 b4 selective", 2, 32, 32, 4, "selective"),
           ("4L d64 t128 b2 selective", 4, 64, 128, 2, "selective"),
           ("3L d64 t64 b4 selective", 3, 64, 64, 4, "selective"))
VOCAB = 97
SWITCHES = ("PADDLE_TPU_ATTR", "PADDLE_TPU_LINT")


@contextlib.contextmanager
def switches(on):
    """Both kill switches on (unset) or off (``0``) inside the block."""
    old = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        if on:
            os.environ.pop(k, None)
        else:
            os.environ[k] = "0"
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def first_run(pt, device, cfg, seed=0):
    """``(wall, hook)`` seconds of one first run of ``cfg``'s GPT."""
    import torch

    from paddle_tpu_torch.observability import get_registry

    _name, n_layer, d, t, b, policy = cfg
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.program_guard(main, startup):
        model = pt.models.transformer.build(
            vocab_size=VOCAB, n_layer=n_layer, n_head=2, d_model=d,
            max_len=t, dropout_rate=0.0, dtype="float32")
    if policy:
        pt.memory_optimize(main, policy=policy)
    exe, scope = pt.Executor(device), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, t))
    feed = {"tokens": toks,
            "labels": np.concatenate([toks[:, 1:], -np.ones((b, 1), int)],
                                     axis=1)}
    hook = get_registry().histogram("executor.fold_in_seconds")
    h0 = hook.total
    if exe.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.run(main, feed=feed, fetch_list=[model["avg_cost"]], scope=scope)
    return time.perf_counter() - t0, hook.total - h0


def gpt_table(pt, device, repeats):
    print(f"first run of a small GPT on {device}, median of {repeats} "
          f"after a warm-up (ms)")
    print(f"{'config':26s} {'on':>9s} {'hook':>8s} {'share':>7s} "
          f"{'off':>9s}")
    for cfg in CONFIGS:
        rows = {}
        for on in (True, False):
            with switches(on):
                first_run(pt, device, cfg)
                runs = [first_run(pt, device, cfg) for _ in range(repeats)]
            rows[on] = (statistics.median(w for w, _h in runs),
                        statistics.median(h for _w, h in runs))
        (w_on, h_on), (w_off, _) = rows[True], rows[False]
        print(f"{cfg[0]:26s} {w_on * 1e3:9.2f} {h_on * 1e3:8.2f} "
              f"{h_on / w_on:7.2%} {w_off * 1e3:9.2f}")


def pytest_share(path):
    """Run ``path`` under pytest twice (switches on, then off), timing
    every call of the two hook methods."""
    import pytest

    from paddle_tpu_torch.core import executor as ex

    spent = [0.0, 0]

    def timed(fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t0
                spent[1] += 1
        return wrapped

    probe, fold = ex.Executor._fold_probe, ex.Executor._fold_in
    ex.Executor._fold_probe, ex.Executor._fold_in = timed(probe), timed(fold)
    try:
        for on in (True, False):
            spent[:] = [0.0, 0]
            with switches(on):
                t0 = time.perf_counter()
                rc = pytest.main(["-q", "-p", "no:cacheprovider",
                                  "-p", "no:xdist", path])
                wall = time.perf_counter() - t0
            print(f"{path} switches {'on' if on else 'off'}: rc {int(rc)}, "
                  f"the hook {spent[0]:.3f} s over {spent[1]} calls of a "
                  f"{wall:.1f} s session ({spent[0] / wall:.2%})")
    finally:
        ex.Executor._fold_probe, ex.Executor._fold_in = probe, fold


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--pytest", nargs="*", default=())
    args = ap.parse_args()
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.place import resolve_device

    device = resolve_device(args.device)
    gpt_table(pt, device, args.repeats)
    for path in args.pytest:
        pytest_share(path)


if __name__ == "__main__":
    main()
