"""Does ``torch.profiler`` lose kernel events of a training step, and
where?  Measured on the card at ``chip_smoke.py`` phase 7's step.

    python -m paddle_tpu_torch.benchmarks.profiler_loss [--rounds N]
        [--seed S]

The step: the GPT flagship at ``tune/search.py``'s dims (12 layers, d768,
6 heads, vocab 32768) at t=4096, batch 8, bf16, the fused head, Adam —
5,300-odd kernels, 39 of them hand-written (12 flash forwards, 12
pre-passes, 12 fused backwards, 3 CE kernels), each counted by its
wrapper (``kernels.launch_counts``).

Each round records the step three ways:

* ``cpu+cuda``: one step (the second of two; the first warms the
  profiler) under the CPU and CUDA activities, its device events read
  twice, from the raw kineto events and from ``key_averages()``'s device
  rows, so a loss in the trace and one in the aggregation tell apart;
* ``cuda``: the same under the CUDA activity alone;
* ``middle``: ``profiler.middle_call_kernels``, three steps with the card
  idle between them, the middle one counted (what ``chip_smoke.py``
  records); a round in which it raises counts as a detected loss.

For each it counts the device events and the hand-written ones
(``kernels.hand_written``) against the launch counters' count of the
recorded step, and prints one line a round, where a short recording lost
its events (the first and the last events of the step, when what it
holds is one run of the longest recording's events in order; "inside"
otherwise), and a JSON summary.
"""

import argparse
import json
import subprocess
import sys
import time


def _step(exe, main, scope, fetch, feed):
    exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)


def _profiled(torch, kernels, exe, main, scope, fetch, feed, mode):
    """One recorded step under ``mode``: ``{reader: (device events,
    hand-written events)}`` ({} when ``middle_call_kernels`` raised), the
    counters' launches of that step, and the raw event names in time
    order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    if mode == "middle":
        from paddle_tpu_torch.profiler import middle_call_kernels

        counted = []

        def run(i):
            if i == 1:
                kernels.reset_launches()
            _step(exe, main, scope, fetch, feed)
            if i == 1:
                counted.append(sum(kernels.launch_counts().values()))

        try:
            raw = [n for _, _, n in middle_call_kernels(run)]
        except RuntimeError as e:
            print(f"  middle: {e}", flush=True)
            return {}, counted[0], []
        return ({"raw": (len(raw), sum(1 for n in raw
                                       if kernels.hand_written(n)))},
                counted[0], raw)
    acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
            if mode == "cpu+cuda" else [ProfilerActivity.CUDA])
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for i in range(2):
            if i == 1:
                kernels.reset_launches()
            _step(exe, main, scope, fetch, feed)
            torch.cuda.synchronize()
            prof.step()
    launched = sum(kernels.launch_counts().values())
    raw = sorted((e.start_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA
                 and not e.name().startswith("ProfilerStep"))
    raw = [n for _, n in raw]
    seen = {"raw": (len(raw), sum(1 for n in raw
                                  if kernels.hand_written(n)))}
    if mode == "cpu+cuda":
        rows = [(e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")]
        seen["key_averages"] = (
            sum(c for c, _ in rows),
            sum(c for c, k in rows if kernels.hand_written(k)))
    return seen, launched, raw


def _where(whole, short):
    """Where ``short`` lost events of ``whole``: ``(first, last)`` counts
    when ``short`` is a run of ``whole`` in order, else None."""
    n = len(short)
    for i in range(len(whole) - n + 1):
        if whole[i:i + n] == short:
            return i, len(whole) - n - i
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profiler_loss: no CUDA device; this runs on the card",
              file=sys.stderr)
        return 1
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    pt.core.unique_name.reset()
    main_p, startup = pt.Program(), pt.Program()
    main_p.random_seed = startup.random_seed = args.seed
    t, b, vocab = 4096, 8, 32768
    with pt.program_guard(main_p, startup):
        model = pt.models.transformer.build(
            vocab_size=vocab, n_layer=12, n_head=6, d_model=768, max_len=t,
            dropout_rate=0.0, dtype="bfloat16", fused_head=True,
            learning_rate=1e-3)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(args.seed)
    toks = torch.as_tensor((rng.integers(0, 512, (b, 1))
                            + np.arange(t)[None, :]) % 512, device="cuda")
    feed = {"tokens": toks,
            "labels": torch.cat([toks[:, 1:],
                                 torch.full_like(toks[:, :1], -1)], dim=1)}
    fetch = [model["avg_cost"].name]
    for _ in range(2):
        _step(exe, main_p, scope, fetch, feed)
    torch.cuda.synchronize()

    rec = {"cpu+cuda": [], "cuda": [], "middle": []}
    orders = {}
    t0 = time.perf_counter()
    for r in range(args.rounds):
        for mode in rec:
            seen, launched, order = _profiled(torch, kernels, exe, main_p,
                                              scope, fetch, feed, mode)
            rec[mode].append((seen, launched))
            orders[(r, mode)] = order
            print(f"round {r} {mode}: launched {launched} hand-written; "
                  + "; ".join(f"{k} {tot} events, {own} hand-written"
                              for k, (tot, own) in seen.items()),
                  flush=True)
    whole = max(orders.values(), key=len)
    for (r, mode), order in orders.items():
        if order and len(order) < len(whole):
            at = _where(whole, order)
            print(f"round {r} {mode}: lost "
                  + (f"the first {at[0]} and the last {at[1]}" if at
                     else "events inside") + f" of {len(whole)}", flush=True)
    summary = {"device": smi, "rounds": args.rounds, "events": len(whole),
               "seconds": round(time.perf_counter() - t0, 1),
               "middle_raised": sum(1 for s, _ in rec["middle"] if not s)}
    for mode, runs in rec.items():
        runs = [(s, n) for s, n in runs if s]
        for reader in (runs[0][0] if runs else ()):
            tots = [s[reader][0] for s, _ in runs]
            summary[f"{mode}/{reader}"] = {
                "rounds_losing_hand_written": sum(
                    1 for s, n in runs if s[reader][1] < n),
                "rounds_short_of_the_most_events": sum(
                    1 for t in tots if t < len(whole)),
                "hand_written_seen_min": min(s[reader][1] for s, _ in runs),
                "launched": sorted({n for _, n in runs}),
                "events_min": min(tots), "events_max": max(tots)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
