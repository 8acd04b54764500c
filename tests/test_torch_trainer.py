"""The port's training loop (``Trainer``, ``Executor.run_steps``, step
checkpoints and resume) against the JAX package's, on the CPU.

Both packages build the 2-layer GPT (vocab 256, d_model 64, 2 heads,
t=64, batch 2, dropout 0, f32) with the fused cross-entropy head; the
reference's post-startup persistables are imported with
``load_numpy_state``.  The reference's attention and fused head run their
Pallas kernels in interpret mode, the port's the plain versions.

* Parity: four steps through both ``Trainer``s, unfused and with
  ``steps_per_call=2``: losses within ``ORACLE_TOL`` f32 (2e-4
  relative), parameters after the steps within the same tolerance of the
  tensor's largest magnitude — except the key-projection biases, whose
  gradient is zero analytically (``tests/test_torch_training.py``) — and
  the events in the same order with the same fields (the fused path's
  Begin..Begin End..End).
* The port alone, bit for bit: ``run_steps``, ``steps_per_call=2`` and
  ``"auto"`` against separate ``run`` calls; a resume from a step
  checkpoint against the uninterrupted run, in-process and after a
  SIGKILLed subprocess (the reference's resilience gate); a torn
  checkpoint skipped and the ``.old`` fallback honoured.  These use
  dropout 0.1, so the RNG state's threading and restore are part of
  what is compared.
* The same on the card (bf16, under ``torch.use_deterministic_algorithms``)
  and prefetch's side-stream copy are ``cuda`` cases of the jax-free
  ``tests/test_torch_cuda_kernels.py``.
"""

import inspect
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as tpt
from paddle_tpu.kernels.xla_ref import ORACLE_TOL
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.resilience import checkpoint as tckpt
from torch_ref_gauges import restore_reference_gauges  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB, N_LAYER, N_HEAD, D_MODEL, T, BATCH = 256, 2, 2, 64, 64, 2
TOL = ORACLE_TOL[("fused_ce", "float32")]["fwd"]          # 2e-4


@pytest.fixture(autouse=True, scope="module")
def _no_tune_cache(tmp_path_factory):
    """The reference reads tuned attention geometry from its tune cache;
    a fresh cache path holds none, so both packages build defaults."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tuned.json"))
        yield


def _cfg(dropout=0.0):
    return dict(vocab_size=VOCAB, n_layer=N_LAYER, n_head=N_HEAD,
                d_model=D_MODEL, max_len=T, dropout_rate=dropout,
                dtype="float32", fused_head=True, learning_rate=1e-3)


def _samples(n, seed=0):
    """A sample reader: next = tok + 1 (mod vocab) from seeded starts,
    with a label at every position.  (A token seen only at a masked
    position would have an embedding row whose gradient is zero
    analytically and roundoff in practice — the key-bias case of
    ``tests/test_torch_training.py``, which Adam turns into steps of either
    sign.)"""
    def reader():
        rng = np.random.default_rng(seed)
        for _ in range(n):
            toks = (rng.integers(0, VOCAB) + np.arange(T)) % VOCAB
            yield toks, (toks + 1) % VOCAB
    return reader


def _build(pkg, model, cfg):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup):
        out = model.build(**cfg)
    return main, startup, out


def _record(events):
    def handler(e):
        events.append(e)
    return handler


def _shape(events):
    """The event stream as (type, fields, pass, batch) tuples."""
    return [(type(e).__name__, tuple(sorted(vars(e))),
             getattr(e, "pass_id", None), getattr(e, "batch_id", None))
            for e in events]


def _costs(events):
    return [e.cost for e in events if type(e).__name__ == "EndIteration"]


def _jax_run(steps_per_call):
    """Four steps through the reference's Trainer; returns (post-startup
    persistables, events, parameters after the steps)."""
    main, startup, out = _build(pt, jtr, _cfg())
    scope = pt.Scope()
    with pt.core.scope.scope_guard(scope):
        tr = pt.trainer.Trainer(out["avg_cost"], out["feed"],
                                place=pt.CPUPlace(), main_program=main,
                                startup_program=startup)
        tr.init_params()
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in main.persistable_vars()}
        events = []
        tr.train(pt.reader.batch(_samples(8), BATCH), num_passes=1,
                 event_handler=_record(events),
                 steps_per_call=steps_per_call)
        params = {p.name: np.asarray(scope.find_var(p.name), np.float32)
                  for p in main.all_parameters()}
    return init, events, params


def _port_trainer(cfg, scope, init=None):
    main, startup, out = _build(tpt, ttr, cfg)
    with tpt.scope_guard(scope):
        tr = tpt.Trainer(out["avg_cost"], out["feed"], place=tpt.CPUPlace(),
                         main_program=main, startup_program=startup)
        tr.init_params()
    if init is not None:
        tpt.load_numpy_state(scope, init, device="cpu")
    return tr, main


def _port_run(init, steps_per_call=1, cfg=None, n=8, **kw):
    scope = tpt.Scope()
    tr, main = _port_trainer(cfg or _cfg(), scope, init)
    events = []
    with tpt.scope_guard(scope):
        tr.train(tpt.reader.batch(_samples(n), BATCH), num_passes=1,
                 event_handler=_record(events),
                 steps_per_call=steps_per_call, **kw)
    params = {p.name: scope.numpy(p.name) for p in main.all_parameters()}
    return events, params, tr, scope


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module", params=[1, 2], ids=["unfused", "fused2"])
def parity(request):
    init, jevents, jparams = _jax_run(request.param)
    tevents, tparams, _, _ = _port_run(init, request.param)
    return jevents, jparams, tevents, tparams, request.param


def test_trainer_losses_match_the_reference(parity):
    jevents, _, tevents, _, _ = parity
    jc, tc = _costs(jevents), _costs(tevents)
    assert len(tc) == 4
    for a, b in zip(tc, jc):
        assert abs(a - b) <= TOL * abs(b), (tc, jc)


def test_trainer_parameters_match_the_reference(parity):
    _, jparams, _, tparams, _ = parity
    assert set(tparams) == set(jparams)
    for n, want in jparams.items():
        if "_att_k.b" in n:        # zero gradient analytically
            continue
        assert _rel(tparams[n], want) <= TOL, n


def test_trainer_events_match_the_reference(parity):
    jevents, _, tevents, _, steps_per_call = parity
    assert _shape(tevents) == _shape(jevents)
    names = [type(e).__name__ for e in tevents]
    step = (["BeginIteration", "BeginIteration", "EndIteration",
             "EndIteration"] if steps_per_call == 2
            else ["BeginIteration", "EndIteration"] * 2)
    assert names == ["BeginPass"] + step * 2 + ["EndPass"]
    for e in tevents:
        if type(e).__name__ == "EndIteration":
            assert e.samples == BATCH and e.grad_norm > 0
            assert e.step_cost["flops"] > 0 and e.mfu is not None


@pytest.fixture(scope="module")
def port_init():
    main, startup, _ = _build(tpt, ttr, _cfg(0.1))
    scope = tpt.Scope()
    tpt.Executor(tpt.CPUPlace()).run(startup, scope=scope)
    return {v.name: scope.numpy(v.name) for v in main.persistable_vars()}


def _bitwise(params_a, params_b):
    return all(np.array_equal(params_a[n], params_b[n]) for n in params_a)


def test_run_steps_is_bitwise_n_runs(port_init):
    """Dropout 0.1: the RNG state threads through run_steps as through
    separate runs."""
    main, startup, out = _build(tpt, ttr, _cfg(0.1))
    feeder = tpt.DataFeeder(out["feed"], tpt.CPUPlace())
    feeds = [feeder.feed(b) for b in tpt.reader.batch(_samples(6), BATCH)()]
    exe = tpt.Executor(tpt.CPUPlace())
    fetch = [out["avg_cost"].name]
    results = []
    for mode in ("run", "run_steps"):
        scope = tpt.Scope()
        exe.run(startup, scope=scope)
        tpt.load_numpy_state(scope, port_init, device="cpu")
        if mode == "run":
            losses = [exe.run(main, feed=f, fetch_list=fetch,
                              scope=scope)[0] for f in feeds]
            losses = np.stack(losses)
        else:
            stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
            losses, = exe.run_steps(main, feed=stacked, fetch_list=fetch,
                                    scope=scope)
            assert exe.last_step_cost["steps"] == len(feeds)
        results.append((losses, {n: scope.numpy(n) for n in port_init},
                        scope.get("@RNG@").clone()))
    (la, pa, ra), (lb, pb, rb) = results
    assert losses.shape == (len(feeds), 1)
    assert np.array_equal(la, lb) and _bitwise(pa, pb) and torch.equal(ra, rb)
    with pytest.raises(ValueError, match="leading"):
        exe.run_steps(main, feed={k: v[:2] if k == "tokens" else v
                                  for k, v in stacked.items()},
                      fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("steps_per_call", [2, "auto"])
def test_steps_per_call_is_bitwise_the_plain_loop(port_init, steps_per_call):
    kw = {"fused_group": 2, "probe_samples": 3} if steps_per_call == "auto" \
        else {}
    ea, pa, _, _ = _port_run(port_init, 1, _cfg(0.1), n=20)
    eb, pb, _, _ = _port_run(port_init, steps_per_call, _cfg(0.1), n=20, **kw)
    assert _costs(ea) == _costs(eb) and _bitwise(pa, pb)


def _steps(ckdir):
    return sorted(d for d in os.listdir(ckdir) if d.startswith("step_"))


def _resumable_run(init, ckdir, resume=False, **kw):
    scope = tpt.Scope()
    tr, main = _port_trainer(_cfg(0.1), scope, init)
    events = []
    reader = tpt.reader.resumable(tpt.reader.batch(_samples(12), BATCH))
    with tpt.scope_guard(scope):
        tr.train(reader, num_passes=1, event_handler=_record(events),
                 checkpoint_dir=str(ckdir), checkpoint_every_n_steps=2,
                 keep_checkpoints=2, resume=resume, **kw)
    return (_costs(events), {p.name: scope.numpy(p.name)
                             for p in main.all_parameters()}, tr)


@pytest.mark.parametrize("async_checkpoint", [False, True],
                         ids=["sync", "async"])
def test_resume_is_bitwise_the_uninterrupted_run(port_init, tmp_path,
                                                 async_checkpoint):
    full, pfull, _ = _resumable_run(port_init, tmp_path / "a",
                                    async_checkpoint=async_checkpoint)
    # retention is best-effort under the async queue: a save still queued
    # when the next prune runs is pruned by the one after
    assert _steps(tmp_path / "a")[-2:] == ["step_4", "step_6"]
    # the step_6 checkpoint is lost: resume from step_4
    ck = tmp_path / "b"
    ck.mkdir()
    os.rename(tmp_path / "a" / "step_4", ck / "step_4")
    tail, ptail, tr = _resumable_run(port_init, ck, resume=True)
    assert tr.last_resume["global_step"] == 4
    assert tr.last_resume["rng_kind"] == "torch"
    assert tail == full[4:] and _bitwise(pfull, ptail)


def test_resume_after_sigkill_is_bitwise(port_init, tmp_path):
    """A subprocess SIGKILLed at its fifth step (PADDLE_TPU_FAULT) leaves
    step_2 and step_4; the resumed run finishes as the uninterrupted one
    did."""
    full, pfull, _ = _resumable_run(port_init, tmp_path / "full")
    np.savez(tmp_path / "init.npz", **port_init)
    # the same run in a process that imports the port alone (no jax)
    helpers = "\n\n".join(inspect.getsource(f) for f in (
        _cfg, _samples, _build, _record, _costs, _port_trainer, _steps,
        _resumable_run))
    script = f"""
import os, sys
import numpy as np
import paddle_tpu_torch as tpt
from paddle_tpu_torch.models import transformer as ttr
VOCAB, N_LAYER, N_HEAD, D_MODEL, T, BATCH = {VOCAB}, {N_LAYER}, {N_HEAD}, \
    {D_MODEL}, {T}, {BATCH}
{helpers}
init = dict(np.load({str(tmp_path / 'init.npz')!r}))
_resumable_run(init, {str(tmp_path / 'killed')!r})
"""
    env = dict(os.environ, PADDLE_TPU_FAULT="sigkill:5")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    assert _steps(tmp_path / "killed") == ["step_2", "step_4"]
    tail, ptail, _ = _resumable_run(port_init, tmp_path / "killed",
                                    resume=True)
    assert tail == full[4:] and _bitwise(pfull, ptail)


def test_torn_checkpoint_is_skipped_and_old_is_honoured(port_init, tmp_path):
    full, pfull, _ = _resumable_run(port_init, tmp_path,
                                    async_checkpoint=True)
    os.remove(tmp_path / "step_6" / "__done0__")     # a writer killed mid-save
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_4")
    # a crash between the two publish renames: only step_4.old is left
    os.rename(tmp_path / "step_4", tmp_path / "step_4.old")
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_4")
    tail, ptail, tr = _resumable_run(port_init, tmp_path, resume=True)
    assert tr.last_resume["path"] == str(tmp_path / "step_4")
    assert tail == full[4:] and _bitwise(pfull, ptail)


def test_reporter_jsonl_flight_and_trace(port_init, tmp_path):
    from paddle_tpu_torch.observability import flight, runlog

    rec = flight.FlightRecorder(out_dir=str(tmp_path))
    prev = flight.set_recorder(rec)
    rep = tpt.MetricsReporter(log_every_n=0,
                              jsonl_path=str(tmp_path / "run.jsonl"))
    try:
        scope = tpt.Scope()
        tr, main = _port_trainer(_cfg(0.1), scope, port_init)
        with tpt.scope_guard(scope):
            tr.train(tpt.reader.batch(_samples(8), BATCH), event_handler=rep,
                     trace_dir=str(tmp_path / "tr"), trace_start=1,
                     trace_steps=1, watchdog_deadline=60)
    finally:
        rep.close()
        flight.set_recorder(prev)
    steps = runlog.read_jsonl(str(tmp_path / "run.jsonl"), event="step")
    assert len(steps) == 4
    flops = texec.step_flops(main, BATCH)
    for s in steps:
        assert s["flops"] == flops and s["mfu"] > 0 and s["grad_norm"] > 0
        assert s["attr_top"] is None and s["compile_count"] >= 1
    assert [r["loss"] for r in rec.steps()] == [s["cost"] for s in steps]
    trace, = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / trace) as f:
        assert "train#1" in json.dumps(json.load(f))


def test_step_flops_counts_the_products():
    """The count by hand for the test model: per layer six d x d
    products... (q, k, v, out: 4 d^2; the FFN 8 d^2) times three (forward
    and both backward products), the causal attention's six products,
    and the head's three 2 N d V products; the first product of a chain
    fed by data takes no dx — none here, LayerNorm comes first."""
    main, _, _ = _build(tpt, ttr, _cfg())
    n = BATCH * T
    gemm = 3 * 2 * n * 12 * D_MODEL * D_MODEL * N_LAYER
    attn = 6 * 2 * BATCH * N_HEAD * (T * (T + 1) // 2) * (
        D_MODEL // N_HEAD) * N_LAYER
    head = 3 * 2 * n * D_MODEL * VOCAB
    assert texec.step_flops(main, BATCH) == gemm + attn + head
    test_prog = main.clone(for_test=True)
    assert texec.step_flops(test_prog, BATCH) == (gemm + attn + head) // 3


def test_deterministic_mode_takes_the_split_route():
    q = torch.randn(1, 16, 2, 8)
    args = (q, q.clone(), q.clone(), q.clone(), torch.zeros(2, 16), q.clone())
    before = dict(tfa.BWD_ROUTE_CALLS)
    tfa.flash_bwd(*args, causal=True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tfa.flash_bwd(*args, causal=True)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert tfa.BWD_ROUTE_CALLS["fused"] - before["fused"] == 1
    assert tfa.BWD_ROUTE_CALLS["split"] - before["split"] == 1


def test_product_ops_carry_a_flops_hook():
    """``step_flops`` sums the registrations' hooks: the matrix products
    (``mul``, ``matmul``, the recurrent ops' hidden products,
    ``sequence_conv``'s context product), the flash ops and the fused CE
    head have one, nothing else; ``scan_block`` says how many times a
    step runs its sub-block (a ``while`` loop's trips are known only once
    it has run: the run records them)."""
    from paddle_tpu_torch.core import registry

    hooked = {t for t in registry.registered_ops()
              if registry.get_op_impl(t).flops is not None}
    assert hooked == {"mul", "matmul", "flash_attention",
                      "flash_attention_packed", "fused_softmax_ce_head",
                      "lstm", "lstmp", "gru", "gru_unit", "sequence_conv"}
    trips = {t for t in registry.registered_ops()
             if registry.get_op_impl(t).trips is not None}
    assert trips == {"scan_block"}


def test_resume_on_the_card_warns_without_deterministic_algorithms():
    """Only a card without torch's deterministic algorithms warns (the
    helper reads the device's type; no card is touched)."""
    import warnings

    with pytest.warns(RuntimeWarning, match="use_deterministic_algorithms"):
        ttrainer._warn_if_not_bitwise(torch.device("cuda", 0))
    prev = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ttrainer._warn_if_not_bitwise(torch.device("cpu"))
        torch.use_deterministic_algorithms(True)
        try:
            ttrainer._warn_if_not_bitwise(torch.device("cuda", 0))
        finally:
            torch.use_deterministic_algorithms(prev)


def test_nan_guard_raises_before_the_update(port_init):
    scope = tpt.Scope()
    tr, main = _port_trainer(_cfg(), scope, port_init)
    scope.get("lm_head.w")[0, 0] = float("nan")
    before = scope.get("block0_ffn1.w").clone()
    feed = tr.feeder.feed(next(tpt.reader.batch(_samples(2), BATCH)()))
    with tpt.profiler.nan_guard(), pytest.raises(FloatingPointError):
        tr.exe.run(main, feed=feed, fetch_list=[tr.cost], scope=scope)
    assert torch.equal(scope.get("block0_ffn1.w"), before)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main, startup, out = _build(tpt, ttr, _cfg())
    for call in (lambda: tpt.Trainer(out["avg_cost"], out["feed"],
                                     main_program=main,
                                     startup_program=startup),
                 lambda: tpt.DataFeeder(out["feed"]),
                 lambda: tpt.reader.prefetch_to_device(_samples(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a mesh of several ranks needs its process group joined first
    with pytest.raises(RuntimeError, match="init_multihost"):
        tpt.Trainer(out["avg_cost"], out["feed"], place=tpt.CPUPlace(),
                    main_program=main, startup_program=startup,
                    mesh=tpt.parallel.make_mesh({"dp": 2}))


def test_watchdog_trips_on_a_stalled_loop(tmp_path):
    import time

    from paddle_tpu_torch.observability import flight, metrics
    from paddle_tpu_torch.resilience import Watchdog

    prev = flight.set_recorder(flight.FlightRecorder(out_dir=str(tmp_path)))
    reg = metrics.MetricsRegistry()
    try:
        with Watchdog(0.05, label="t", interval=0.01, registry=reg) as wd:
            time.sleep(0.3)
            wd.beat()
        assert wd.trips == 1
        assert reg.value("resilience.watchdog_trips", label="t") == 1
    finally:
        flight.set_recorder(prev)


def test_hardware_table_names_the_h100_alone(monkeypatch):
    """One row, from the H100 data sheet (SXM part): another card's name,
    the PCIe H100's included, gives no peak and so no mfu."""
    from paddle_tpu_torch.observability import hardware as hw

    for name, want in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", None),
                       ("NVIDIA A100-SXM4-80GB", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None, n=name: n)
        assert hw._lookup(torch.device("cuda", 0)) == want
    assert hw.mfu(2.9e13, 0.2, None) is None
    assert hw.mfu(2.9e13, 0.2, 989e12) == pytest.approx(0.1466, abs=1e-4)
