"""Rank processes for the port's mesh tests (imported by the spawned
workers, so it imports torch, numpy and the port only — never jax).

``spawn(world, fn, *args)`` runs ``fn(rank, world, *args)`` in ``world``
processes joined into one gloo process group through a FileStore in a
fresh temporary directory (never a fixed TCP port: the tests run in
parallel) and returns every rank's result, in rank order; with
``init=False`` the ranks join a process group themselves."""

import contextlib
import os
import tempfile
import threading
from unittest import mock

import numpy as np
import torch

VOCAB, HEADS, SEQ, D_MODEL, N_LAYER, LR = 256, 2, 16, 64, 2, 2e-3


def _main(rank, world, path, fn, args, q, init):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if init:
            dist.init_process_group(
                "gloo", store=dist.FileStore(path, world), rank=rank,
                world_size=world)
        res = fn(rank, world, *args)
        dist.barrier()
        q.put((rank, res, None))
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        import traceback

        q.put((rank, None, traceback.format_exc()))
        raise


def spawn(world, fn, *args, timeout=240, init=True):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "store")
        procs = [ctx.Process(target=_main,
                             args=(r, world, path, fn, args, q, init))
                 for r in range(world)]
        # start() blocks until the child has imported the main module and
        # read its arguments: started from threads, the ranks come up
        # together
        starters = [threading.Thread(target=p.start) for p in procs]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        out = {}
        try:
            for _ in range(world):
                rank, res, err = q.get(timeout=timeout)
                if err:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                out[rank] = res
        finally:
            # a rank's process-group teardown at exit can take seconds:
            # the results are in, so the ranks are stopped
            for p in procs:
                p.join(timeout=2)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


def gpt_feed(batch=16, seed=5):
    """Tokens and labels shifted left, the last label of every row -1 —
    the same number of counted labels in every row, so every rank's loss
    has the same denominator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (batch, SEQ)).astype(np.int64)
    lbls = np.roll(toks, -1, axis=1)
    lbls[:, -1] = -1
    return {"tokens": toks, "labels": lbls}


@contextlib.contextmanager
def optimizer_patch(transformer_module, name):
    """Build with Momentum in place of the model's Adam."""
    if name == "adam":
        yield
        return
    opt = transformer_module.opt

    def momentum(learning_rate):
        return opt.Momentum(learning_rate=learning_rate, momentum=0.9)

    with mock.patch.object(opt, "Adam", momentum):
        yield


def build_gpt(pkg, transformer_module, opt="adam", memopt=False, accum=1):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with optimizer_patch(transformer_module, opt):
        with pkg.program_guard(main, startup):
            outs = transformer_module.build(
                vocab_size=VOCAB, n_layer=N_LAYER, n_head=HEADS,
                d_model=D_MODEL, max_len=SEQ, dropout_rate=0.0,
                dtype="float32", learning_rate=LR, fused_head=True)
    if memopt:
        pkg.memory_optimize(main, policy="selective")
    if accum > 1:
        pkg.gradient_accumulation(main, accum)
    return main, startup, outs


def annotate(main, startup, axes, fsdp=False):
    """The reference's annotations for ``axes``: tp rules, data
    parallelism over dp, FSDP tags."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import transformer

    if axes.get("tp", 1) > 1:
        for prog in (main, startup):
            parallel.shard_parameters_by_rule(prog, transformer.tp_rules())
    parallel.data_parallel(main, "dp", programs=(startup,))
    if fsdp:
        parallel.shard_fsdp(main, programs=(startup,))


def train_configs(rank, world, configs, state, feeds):
    """Each config ``(name, kw)`` trained from ``state`` on its mesh:
    the losses, the whole parameters after the steps (rank 0), each
    rank's contract violations and the last step's comm summary."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parallel.contracts import training_step_contract

    import time

    out = {}
    for name, kw in configs:
        t0 = time.perf_counter()
        env = kw.get("env", {})
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            main, startup, outs = build_gpt(
                pt, transformer, kw.get("opt", "adam"),
                kw.get("memopt", False), kw.get("accum", 1))
            axes = kw["axes"]
            annotate(main, startup, axes, kw.get("fsdp", False))
            mesh = parallel.make_mesh(axes)
            scope = pt.Scope()
            pt.load_numpy_state(scope, state[kw.get("opt", "adam")],
                                device="cpu")
            exe = pt.Executor(pt.CPUPlace(), mesh=mesh)
            losses = []
            for f in feeds:
                r = exe.run(main, feed=f, fetch_list=[outs["avg_cost"]],
                            scope=scope)
                losses.append(float(np.asarray(r[0]).reshape(-1)[0]))
            params = exe.gather_state(
                main, scope, [p.name for p in main.all_parameters()])
            cs = training_step_contract(
                mesh, accum=kw.get("accum", 1) > 1,
                fsdp=kw.get("fsdp", False) and kw.get("memopt", False),
                grad_rs=env.get("PADDLE_TPU_ZERO3_RS", "1") != "0")
            viol = [v["message"] for c in cs
                    for v in c.check(exe.last_comm_plan)]
            out[name] = {
                "losses": losses, "viol": viol,
                "plan": exe.last_step_cost["comm_plan"],
                "ref_plan": exe.last_comm_plan.summary(),
                "blocks": block_digests(exe, main, scope, mesh),
                "seconds": time.perf_counter() - t0,
                "params": ({k: v.numpy().copy() for k, v in params.items()}
                           if rank == 0 else None)}
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


def block_digests(exe, main, scope, mesh):
    """``{(name, ((axis, index), ...)): digest}`` of every parameter block
    this rank holds, keyed by its place on the axes the parameter is cut
    over: the ranks of one key hold replicas of one block."""
    import hashlib

    from paddle_tpu_torch.parallel.api import spec_axes

    coords = exe.comm.coords
    out = {}
    for p in main.all_parameters():
        cut = sorted(a for a in spec_axes(exe.shard_spec(main, p.name))
                     if mesh.shape.get(a, 1) > 1)
        t = scope.get(p.name).detach().contiguous().reshape(-1)
        out[(p.name, tuple((a, coords[a]) for a in cut))] = hashlib.sha256(
            t.view(torch.uint8).numpy()).hexdigest()
    return out


def tp_branches(rank, world, flash_in, ce_in):
    """The flash and fused-CE ops' tp rules on a dp x tp mesh, each rank
    on its tp block: the whole outputs and gradients (gathered over tp)."""
    from types import SimpleNamespace

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops import attention_ops, loss_ops
    from paddle_tpu_torch.parallel.collectives import MeshComm
    from paddle_tpu_torch.parallel.spmd import Spmd

    mesh = parallel.make_mesh({"dp": world // 2, "tp": 2}).bind(rank)
    comm = MeshComm(mesh, rank)
    sp = Spmd(comm, pt.Program(), {})
    res = {}

    q, k, v, g, n_head = (flash_in[n] for n in ("q", "k", "v", "g",
                                                "n_head"))
    loc = [comm.block(torch.from_numpy(a), "tp", 2).contiguous()
           .requires_grad_(True) for a in (q, k, v)]
    op = SimpleNamespace(type="flash_attention_packed",
                         outputs={"Out": ["o"]})
    out, pls = attention_ops._flash_tp(
        sp, op, dict(zip("QKV", loc)), {"Q": 2, "K": 2, "V": 2},
        {"n_head": n_head, "causal": True},
        lambda ins, attrs: attention_ops.flash_attention_packed_op(
            **ins, **attrs))
    o = out["Out"]
    (o * comm.block(torch.from_numpy(g), "tp", 2)).sum().backward()
    res["flash"] = {
        "out": comm.all_gather(o.detach(), "tp", 2).numpy(),
        "placement": pls["Out"],
        "grads": [comm.all_gather(t.grad, "tp", 2).numpy() for t in loc]}

    x = torch.from_numpy(ce_in["x"]).requires_grad_(True)
    w = comm.block(torch.from_numpy(ce_in["w"]), "tp", 1).contiguous() \
        .requires_grad_(True)
    y = torch.from_numpy(ce_in["y"])
    op = SimpleNamespace(type="fused_softmax_ce_head", inputs={"X": ["x"]},
                         outputs={"Loss": ["loss"]})
    out, _ = loss_ops._fused_ce_tp(
        sp, op, {"X": x, "W": w, "Label": y},
        {"X": None, "W": 1, "Label": None}, {}, None)
    loss = out["Loss"]
    (loss[..., 0] * torch.from_numpy(ce_in["g"])).sum().backward()
    res["ce"] = {"loss": loss.detach().numpy()[..., 0],
                 "dx": x.grad.numpy(),
                 "dw": comm.all_gather(w.grad, "tp", 1).numpy()}
    res["log"] = [(e["kind"], e["axes"]) for e in comm.take_log()]
    return res


def checkpoint_and_trainer(rank, world, store, state, feeds, jax_ckpt,
                           ckpt_dir, trainer_rows):
    """On 4 ranks joined by ``launch.init_multihost``: Momentum on dp4;
    a sharded checkpoint saved from dp2 x tp2 and loaded back on dp2 x
    fsdp2; the JAX package's checkpoint loaded on dp2 x tp2; a
    ``Trainer(mesh=...)`` with CPU prefetch on dp4."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.models import transformer

    launch.init_multihost(f"file://{store}", world, rank, backend="gloo")
    assert launch.is_initialized() and dist.get_world_size() == world
    t = torch.ones(1) * (rank + 1)
    dist.all_reduce(t)
    out = {"allreduce": float(t[0]),
           "mesh": launch.global_mesh({"dp": -1, "tp": 2}).shape}

    out["momentum"] = train_configs(
        rank, world, [("dp4_momentum", {"axes": {"dp": 4},
                                        "opt": "momentum"})],
        state, feeds)["dp4_momentum"]

    def run_on(axes, fsdp=False, load=None, steps=0, save=None):
        main, startup, outs = build_gpt(pt, transformer, memopt=fsdp)
        annotate(main, startup, axes, fsdp)
        exe = pt.Executor(pt.CPUPlace(), mesh=parallel.make_mesh(axes))
        scope = pt.Scope()
        with pt.scope_guard(scope):
            if load is None:
                pt.load_numpy_state(scope, state["adam"], device="cpu")
            else:
                pt.io.load_persistables(exe, load, main)
            for f in feeds[:steps]:
                exe.run(main, feed=f, fetch_list=[outs["avg_cost"]],
                        scope=scope)
            if save:
                pt.io.save_persistables(exe, save, main)
            whole = {n: v.numpy().copy()
                     for n, v in exe.gather_state(main, scope).items()}
            # a step's preparation cuts a loaded whole tensor to this
            # rank's block
            exe.run(main, feed=feeds[0], fetch_list=[], scope=scope)
            blocks = {n: tuple(scope.get(n).shape) for n in whole}
        return whole, blocks

    saved, blocks = run_on({"dp": 2, "tp": 2}, steps=1, save=ckpt_dir)
    loaded, lblocks = run_on({"dp": 2, "fsdp": 2}, fsdp=True, load=ckpt_dir)
    from_jax, _ = run_on({"dp": 2, "tp": 2}, load=jax_ckpt)
    out["ckpt"] = {"saved": saved if rank == 0 else None,
                   "loaded_max_err": max(
                       float(np.abs(loaded[n] - saved[n]).max())
                       for n in saved),
                   "from_jax": from_jax if rank == 0 else None,
                   "tp_block": blocks["block0_ffn1.w"],
                   "fsdp_block": lblocks["block0_ffn1.w"]}

    main, startup, outs = build_gpt(pt, transformer)
    annotate(main, startup, {"dp": 4})
    losses = []

    def on_event(e):
        if isinstance(e, pt.EndIteration):
            losses.append(float(np.asarray(e.cost).reshape(-1)[0]))

    def reader():
        for rows in trainer_rows:
            yield [tuple(r) for r in rows]

    scope = pt.Scope()
    with pt.scope_guard(scope):
        tr = pt.Trainer(outs["avg_cost"], outs["feed"], place=pt.CPUPlace(),
                        main_program=main, startup_program=startup,
                        mesh=parallel.make_mesh({"dp": 4}))
        pt.load_numpy_state(scope, state["adam"], device="cpu")
        tr._initialized = True
        tr.train(reader, num_passes=1, event_handler=on_event, prefetch=2)
        params = tr.exe.gather_state(
            main, scope, [p.name for p in main.all_parameters()])
    out["trainer"] = {
        "losses": losses,
        "params": ({k: v.numpy().copy() for k, v in params.items()}
                   if rank == 0 else None)}
    return out
