"""``python -m paddle_tpu_torch --resilience-selftest`` — kill-and-resume
bit-exactness, the counterpart of ``paddle_tpu/resilience/selftest.py``.

The parent process does no torch work and never initialises the card:
it spawns trainer children (the port's ``Trainer``, on the card unless
the parent was given ``cpu``) and compares what they print and write:

1. **ref**    — 2 passes x 8 steps of an fc+dropout regression with
   async step checkpoints every 3 steps; each step's loss is written as
   ``float.hex()`` (bit-exact text) to ``losses_ref.txt``.
2. **crash**  — the same run under ``PADDLE_TPU_FAULT=sigkill:11``: the
   trainer is SIGKILLed entering step 10 (0-based), mid-pass 1, its async
   checkpoint writer dead mid-queue.  Its partial trajectory must be a
   bit-exact prefix of ref.
3. **resume** — the same command with ``resume=True``: it finds the
   latest LOADABLE checkpoint, restores parameters, optimizer moments,
   the generator state and the reader cursor, prints ``RESUMED_AT
   <step>`` and goes on; its losses must equal ``ref[<step>:]`` bit for
   bit.
4. **ckptcrash** — saves twice to one directory under
   ``PADDLE_TPU_FAULT=ckpt_crash:2``: the second publish dies between its
   two renames (exit code 23), leaving ``latest.old`` the only good copy.
5. **ckptverify** — loads ``latest`` anyway (the ``.old`` fallback) and
   must reproduce the digest printed after save #1.

The JAX selftest runs its children data-parallel on an 8-device virtual
CPU mesh; on the port that mesh would be eight gloo processes a child,
so the children here train unsharded (one process, one device).  The
mesh path's resume is held by ``tests/test_torch_mesh_*.py``.
"""

import hashlib
import os
import subprocess
import sys

PASSES = 2
STEPS_PER_PASS = 8
CKPT_EVERY = 3
KILL_AT = 11  # 1-based arrival: SIGKILL entering 0-based step 10
_FAULT_ENV = "PADDLE_TPU_FAULT"   # resilience.faults.ENV_VAR


# ---------------------------------------------------------------- children
def _build_model(pt):
    """An fc+dropout regression: dropout makes the trajectory depend on
    the step's generator, so a resume that failed to restore it forks."""
    pt.core.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 11
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", shape=[13], dtype="float32")
        y = pt.layers.data("y", shape=[1], dtype="float32")
        h = pt.layers.fc(x, size=16, act="relu")
        h = pt.layers.dropout(h, 0.3)
        pred = pt.layers.fc(h, size=1)
        cost = pt.layers.mean(pt.layers.square_error_cost(pred, y))
        pt.optimizer.Momentum(learning_rate=0.05,
                              momentum=0.9).minimize(cost)
    return main, startup, cost, x, y


def _make_reader(np):
    """Deterministic 8-batches-per-pass reader (seeded per call, so every
    pass and every process draws identical data)."""
    def reader():
        rng = np.random.default_rng(7)
        X = rng.normal(size=(STEPS_PER_PASS * 16, 13)).astype(np.float32)
        W = rng.normal(size=(13, 1)).astype(np.float32)
        Y = (X @ W).astype(np.float32)
        for i in range(STEPS_PER_PASS):
            lo = i * 16
            yield list(zip(X[lo:lo + 16], Y[lo:lo + 16]))

    return reader


def _state_digest(scope, program):
    """Order-stable digest over every persistable in the scope —
    parameters AND optimizer moments."""
    import numpy as np

    h = hashlib.sha256()
    names = sorted(v.name for v in program.global_block().vars.values()
                   if v.persistable and scope.find_var(v.name) is not None)
    for name in names:
        h.update(name.encode())
        h.update(np.ascontiguousarray(scope.numpy(name)).tobytes())
    return h.hexdigest()


def _child_train(mode, workdir, device):
    """ref / crash / resume trainer child."""
    import numpy as np

    import paddle_tpu_torch as pt

    main, startup, cost, x, y = _build_model(pt)
    losses = open(os.path.join(workdir, f"losses_{mode}.txt"), "w")

    def handler(ev):
        if isinstance(ev, pt.EndIteration):
            losses.write(float(ev.cost).hex() + "\n")
            losses.flush()
            os.fsync(losses.fileno())  # SIGKILL must not eat lines

    with pt.scope_guard(pt.Scope()):
        tr = pt.Trainer(cost, [x, y], place=device, main_program=main,
                        startup_program=startup)
        tr.train(_make_reader(np), num_passes=PASSES,
                 event_handler=handler,
                 checkpoint_dir=os.path.join(workdir, "ckpt"),
                 checkpoint_every_n_steps=CKPT_EVERY,
                 async_checkpoint=True, resume=(mode == "resume"))
    losses.close()
    if mode == "resume":
        st = tr.last_resume or {}
        print(f"RESUMED_AT {int(st.get('global_step', 0))}", flush=True)
    print(f"CHILD_OK {mode}", flush=True)
    return 0


def _child_ckptcrash(workdir, device):
    """Save twice to ONE directory; the armed ckpt_crash fault kills the
    process between the second publish's two renames."""
    import numpy as np

    import paddle_tpu_torch as pt

    main, startup, cost, x, y = _build_model(pt)
    feeder = pt.DataFeeder([x, y], device)
    rng = np.random.default_rng(3)
    X = rng.normal(size=(16, 13)).astype(np.float32)
    Y = (X @ rng.normal(size=(13, 1))).astype(np.float32)
    feed = feeder.feed(list(zip(X, Y)))
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(device)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[cost])
        ckpt = pt.io.AsyncCheckpointer()
        target = os.path.join(workdir, "latest")
        ckpt.save(target, main, extra_state={"global_step": 1})
        ckpt.wait()
        print(f"CKPT1_DIGEST {_state_digest(pt.global_scope(), main)}",
              flush=True)
        exe.run(main, feed=feed, fetch_list=[cost])
        ckpt.save(target, main, extra_state={"global_step": 2})
        ckpt.wait()
    print("CKPT2_PUBLISHED (fault did not fire?)", flush=True)
    return 1  # reaching here means the injected crash failed


def _child_ckptverify(workdir, device):
    """Load the torn-publish checkpoint (the .old fallback) and print the
    restored digest and train state."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.resilience import checkpoint as rckpt

    main, startup, cost, x, y = _build_model(pt)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(device)
        exe.run(startup)
        target = os.path.join(workdir, "latest")
        pt.io.load_persistables(exe, target, main)
        st = rckpt.load_train_state(target)
        print(f"RESTORED_STEP {st['global_step']}", flush=True)
        print(f"RESTORED_DIGEST {_state_digest(pt.global_scope(), main)}",
              flush=True)
    return 0


# ------------------------------------------------------------------ parent
def _child_env(fault=None):
    env = dict(os.environ)
    env.pop("PYTHONSAFEPATH", None)
    env.pop(_FAULT_ENV, None)
    if fault:
        env[_FAULT_ENV] = fault
    # one summation order in every child: separate processes must agree
    env["OMP_NUM_THREADS"] = "1"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run_child(mode, workdir, device, fault=None, timeout=600):
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.resilience.selftest",
         mode, workdir, device],
        env=_child_env(fault), timeout=timeout,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout


def _read_losses(workdir, mode):
    path = os.path.join(workdir, f"losses_{mode}.txt")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def run_selftest(device=None):
    """The parent: ``device`` is passed to the children as a string
    (``"cuda"`` when None), so this process never touches the card."""
    import shutil
    import signal
    import tempfile

    device = "cuda" if device is None else str(device)
    failures = []

    def check(cond, what):
        (failures.append(what) if not cond else None)
        print(("ok   " if cond else "FAIL ") + what, flush=True)

    workdir = tempfile.mkdtemp(prefix="ptt_resilience_")
    try:
        # 1. uninterrupted reference trajectory
        rc, out = _run_child("ref", workdir, device)
        check(rc == 0, f"reference run completes (rc={rc})")
        if rc != 0:
            print(out)
            return 1
        ref = _read_losses(workdir, "ref")
        total = PASSES * STEPS_PER_PASS
        check(len(ref) == total, f"reference wrote {len(ref)}/{total} steps")

        # 2. SIGKILL mid-pass
        shutil.rmtree(os.path.join(workdir, "ckpt"), ignore_errors=True)
        rc, out = _run_child("crash", workdir, device,
                             fault=f"sigkill:{KILL_AT}")
        check(rc == -signal.SIGKILL,
              f"fault-injected trainer died by SIGKILL (rc={rc})")
        crash = _read_losses(workdir, "crash")
        check(len(crash) == KILL_AT - 1,
              f"killed entering step {KILL_AT - 1}: {len(crash)} steps "
              f"completed (mid-pass {(KILL_AT - 1) // STEPS_PER_PASS})")
        check(crash == ref[:len(crash)],
              "the crashed run's partial trajectory is a bit-exact prefix "
              "of the reference")

        # 3. deterministic resume
        rc, out = _run_child("resume", workdir, device)
        check(rc == 0, f"resume run completes (rc={rc})")
        if rc != 0:
            print(out)
        resumed_at = None
        for line in out.splitlines():
            if line.startswith("RESUMED_AT "):
                resumed_at = int(line.split()[1])
        check(resumed_at is not None and resumed_at >= CKPT_EVERY,
              f"resume restored a mid-run step checkpoint "
              f"(RESUMED_AT {resumed_at})")
        if resumed_at:
            res = _read_losses(workdir, "resume")
            check(len(res) == total - resumed_at,
                  f"resume ran the remaining {len(res)} steps")
            check(res == ref[resumed_at:],
                  f"resumed loss trajectory BIT-EXACT vs the uninterrupted "
                  f"run from step {resumed_at} ({len(res)} steps compared)")

        # 4. crash DURING a checkpoint publish
        crashdir = os.path.join(workdir, "publish")
        os.makedirs(crashdir)
        rc, out = _run_child("ckptcrash", crashdir, device,
                             fault="ckpt_crash:2")
        check(rc == 23, f"the publish crash killed the writer (rc={rc})")
        d1 = None
        for line in out.splitlines():
            if line.startswith("CKPT1_DIGEST "):
                d1 = line.split()[1]
        check(d1 is not None, "first checkpoint digest captured")
        latest = os.path.join(crashdir, "latest")
        check(not os.path.exists(os.path.join(latest, "__manifest__.pkl"))
              and os.path.exists(os.path.join(latest + ".old",
                                              "__manifest__.pkl")),
              "torn publish on disk: only the .old fallback is complete")

        # 5. the torn checkpoint still loads (the .old fallback)
        rc, out = _run_child("ckptverify", crashdir, device)
        check(rc == 0, f"load after the torn publish succeeds (rc={rc})")
        d2 = step = None
        for line in out.splitlines():
            if line.startswith("RESTORED_DIGEST "):
                d2 = line.split()[1]
            if line.startswith("RESTORED_STEP "):
                step = int(line.split()[1])
        check(d1 is not None and d1 == d2,
              "restored state bit-identical to the last GOOD checkpoint")
        check(step == 1,
              f"the train-state sidecar fell back with it (step {step})")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    print("resilience selftest " + ("FAILED" if failures else "PASSED"),
          flush=True)
    return 1 if failures else 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        return run_selftest()
    mode, workdir, device = argv[0], argv[1], argv[2]
    if mode in ("ref", "crash", "resume"):
        return _child_train(mode, workdir, device)
    if mode == "ckptcrash":
        return _child_ckptcrash(workdir, device)
    if mode == "ckptverify":
        return _child_ckptverify(workdir, device)
    raise SystemExit(f"unknown selftest mode {mode!r}")


if __name__ == "__main__":
    sys.exit(main())
