"""``python -m paddle_tpu_torch --tune-selftest`` — the autotune engine's
gate, the counterpart of ``paddle_tpu/tune/selftest.py``.  Runs on the
card unless ``--device=cpu`` is given; the cache lives in a temporary
directory (``PADDLE_TPU_TUNE_CACHE``), never at the default path.

A miniature measured search over a toy transformer checks the loop:

1. SEARCH: a winner comes out; the memory preflight rejects the
   save-everything schedules (``none``, ``selective``) under a budget set
   between the policies' estimates, and every measured candidate fits it;
2. CACHE: a second call is a cache hit that builds and runs nothing
   (``executor.compile_count`` and ``tune.candidates_measured`` flat);
3. the forced geometry (``forced_attention_config``) and the tuned one
   reach the flash op's attributes;
4. KILL SWITCH: ``PADDLE_TPU_TUNE=0`` with a populated cache gives the
   loss bits of an untuned run (empty cache);
5. ``tune_stats`` counts the hits, and ``Executor.last_step_cost["tune"]``
   carries them.

The JAX selftest's last stage, the t=16k static demonstration against
its 16 GiB TPU budget, has no counterpart: the card's budget is its own.
"""

import contextlib
import os
import shutil
import tempfile

__all__ = ["run_selftest"]

_TOY = dict(seq_len=128, n_layer=3, d_model=64, n_head=2, vocab=61,
            batch=8, dtype="float32", fused_head=True)
_POLICIES = ("none", "selective", "compact", "full")


def _build_toy(policy="auto"):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer

    pt.core.unique_name.reset()
    main_prog, startup = pt.Program(), pt.Program()
    main_prog.random_seed = 7
    with pt.program_guard(main_prog, startup):
        outs = transformer.build(
            vocab_size=_TOY["vocab"], n_layer=_TOY["n_layer"],
            n_head=_TOY["n_head"], d_model=_TOY["d_model"],
            max_len=_TOY["seq_len"], dropout_rate=0.0,
            dtype=_TOY["dtype"], fused_head=_TOY["fused_head"])
        if policy:
            pt.memory_optimize(main_prog, policy=policy)
    return main_prog, startup, outs


@contextlib.contextmanager
def _reproducible(device):
    """One reduction order run to run: deterministic algorithms (on the
    card the flash backward takes its split route, no atomics) and, on
    the CPU, one intra-op thread (a threaded BLAS splits its sums by the
    threads the host's load leaves it)."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.get_num_threads())
    torch.use_deterministic_algorithms(True, warn_only=True)
    if device.type == "cpu":
        torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.set_num_threads(prev[2])


def train_bits(device, policy="auto", steps=3):
    """The toy's loss trajectory as float bit patterns, run reproducibly,
    and its Executor."""
    import numpy as np

    import paddle_tpu_torch as pt

    device = pt.resolve_device(device)
    main_prog, startup, outs = _build_toy(policy=policy)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, _TOY["vocab"],
                        (_TOY["batch"], _TOY["seq_len"])).astype(np.int64)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    scope = pt.Scope()
    exe = pt.Executor(device)
    bits = []
    with _reproducible(device):
        exe.run(startup, scope=scope)
        for _ in range(steps):
            loss = exe.run(main_prog, feed=feed,
                           fetch_list=[outs["avg_cost"]], scope=scope)[0]
            bits.append(np.asarray(loss, np.float32).tobytes())
    return bits, exe


def flash_attrs(program):
    """(block_q, block_k) attrs of the program's first flash op."""
    for op in program.global_block().ops:
        if op.type in ("flash_attention_packed", "flash_attention"):
            return (op.attrs.get("block_q"), op.attrs.get("block_k"))
    return (None, None)


def run_selftest(device=None):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import tune
    from paddle_tpu_torch.observability import get_registry

    device = pt.resolve_device(device)
    failures = []

    def check(cond, what):
        (failures.append(what) if not cond else None)
        print(("ok   " if cond else "FAIL ") + what, flush=True)

    tmp = tempfile.mkdtemp(prefix="ptt_tune_")
    cache_file = os.path.join(tmp, "tuned.json")
    old_env = {k: os.environ.get(k)
               for k in ("PADDLE_TPU_TUNE", "PADDLE_TPU_TUNE_CACHE")}
    os.environ["PADDLE_TPU_TUNE_CACHE"] = cache_file
    os.environ["PADDLE_TPU_TUNE"] = "search"
    tune.reset_cache()
    reg = get_registry()
    try:
        # -- 1. measured search under a budget between the estimates ----
        est = {p: tune.estimate_gpt_step_hbm(
            _TOY["n_layer"], _TOY["d_model"], _TOY["n_head"],
            _TOY["vocab"], _TOY["seq_len"], _TOY["batch"], policy=p,
            dtype_size=4) for p in _POLICIES}
        budget = (est["selective"] + est["compact"]) // 2
        rep = tune.tune_gpt_step(
            **_TOY, steps=2, warmup=1, repeats=2, budget_bytes=budget,
            block_caps=(64,), policies=_POLICIES, accums=(1,),
            max_measure=8, device=device)
        check(rep["source"] == "search" and rep["entry"] is not None,
              f"search ran and produced a winner ({rep['source']})")
        rejected = [m for m in rep["measured"]
                    if m["verdict"] == "preflight_rejected"]
        measured = [m for m in rep["measured"]
                    if m["verdict"] == "measured"]
        check(sorted(m["policy"] for m in rejected) == ["none", "selective"]
              and rep["pruned_preflight"] == 2,
              f"preflight rejected the save-everything schedules under a "
              f"budget of {budget} B "
              f"({sorted(m['policy'] for m in rejected)})")
        check(len(measured) >= 2 and all(
            m["hbm_est_bytes"] <= budget for m in measured),
            f"every measured candidate's estimate fits the budget "
            f"(policy, estimate, high water: "
            f"{[(m['policy'], m['hbm_est_bytes'], m['hbm_high_water_bytes']) for m in measured]})")
        win = rep["entry"]["config"]
        meas = rep["entry"]["measured"]
        check(meas["median_s"] <= meas["worst_median_s"],
              f"winner ({win.get('policy')}, {meas['median_s']:.4f}s) "
              f"is the fastest measured ({meas['worst_median_s']:.4f}s "
              f"the slowest)")

        # -- 2. second call: a pure cache hit, nothing built or run ------
        os.environ["PADDLE_TPU_TUNE"] = "cached"
        c0 = reg.value("executor.compile_count")
        m0 = reg.value("tune.candidates_measured")
        h0 = reg.value("tune.cache_hits")
        rep2 = tune.tune_gpt_step(**_TOY, device=device)
        check(rep2["source"] == "cache"
              and rep2["entry"]["config"] == win,
              "second call serves the winner from the cache")
        check(reg.value("executor.compile_count") == c0
              and reg.value("tune.candidates_measured") == m0,
              "the cache hit built and ran no step")
        check(reg.value("tune.cache_hits") > h0,
              "tune.cache_hits incremented")

        # -- 3. forced and tuned geometry reach the op --------------------
        with tune.forced_attention_config({"block_q": 32, "block_k": 128}):
            forced, _, _ = _build_toy(policy=None)
        check(flash_attrs(forced) == (32, 128),
              f"forced geometry reaches the flash op ({flash_attrs(forced)})")
        tuned, _, _ = _build_toy(policy=None)
        check(flash_attrs(tuned) == (win["block_q"], win["block_k"]),
              f"tuned geometry reaches the flash op ({flash_attrs(tuned)} "
              f"== winner {win['block_q']}/{win['block_k']})")

        # -- 4. kill switch: TUNE=0 bit for bit an untuned run ------------
        os.environ["PADDLE_TPU_TUNE"] = "0"
        bits_off, exe_off = train_bits(device, steps=2)
        os.environ["PADDLE_TPU_TUNE"] = "cached"
        os.environ["PADDLE_TPU_TUNE_CACHE"] = os.path.join(
            tmp, "empty", "tuned.json")
        tune.reset_cache()
        bits_default, _ = train_bits(device, steps=2)
        check(bits_off == bits_default,
              "PADDLE_TPU_TUNE=0 with a populated cache is bit for bit the "
              "untuned run (empty cache)")
        check(exe_off.last_step_cost.get("tune", {}).get("mode") in (
            None, "off"), "the kill-switch run looked nothing up")

        # -- 5. tune_stats and the step cost ------------------------------
        os.environ["PADDLE_TPU_TUNE_CACHE"] = cache_file
        tune.reset_cache()
        h1 = reg.value("tune.cache_hits")
        _, exe_tuned = train_bits(device, steps=1)
        ts = exe_tuned.last_step_cost.get("tune") or {}
        check(reg.value("tune.cache_hits") > h1
              and ts.get("cache_hits", 0) == tune.tune_stats()["cache_hits"],
              f"tune_stats counts the hits, and last_step_cost carries "
              f"them ({ts})")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tune.reset_cache()
        shutil.rmtree(tmp, ignore_errors=True)

    print("tune selftest " + ("FAILED" if failures else "PASSED"),
          flush=True)
    return 1 if failures else 0
