"""Rank processes for the port's repair, sequence, pipeline and expert
parallelism tests (imported by the spawned workers, so it imports torch,
numpy and the port only — never jax).  The ranks are started by
``torch_mesh_workers.spawn``."""

import contextlib
import importlib
import os
import time
from unittest import mock

import numpy as np
import torch

import torch_mesh_workers as W

CLIP_LR, CLIP_MOMENTUM, GLOBAL_CLIP, NORM_CLIP = 0.5, 0.9, 0.05, 0.02


@contextlib.contextmanager
def clip_optimizer(transformer_module, kind):
    """Build with Momentum (lr 0.5, momentum 0.9) in place of the model's
    Adam, clipped by ``GradientClipByGlobalNorm(0.05)`` (``kind ==
    "global"``) or by every parameter's ``GradientClipByNorm(0.02)``
    (``"norm"``) — small enough that every step clips."""
    opt = transformer_module.opt
    clip = importlib.import_module(opt.__package__ + ".clip")

    class NormClipped(opt.Momentum):
        def minimize(self, loss, *args, **kwargs):
            for p in loss.block.program.global_block().all_parameters():
                p.gradient_clip_attr = clip.GradientClipByNorm(NORM_CLIP)
            return super().minimize(loss, *args, **kwargs)

    def momentum(learning_rate):
        if kind == "global":
            return opt.Momentum(
                learning_rate=CLIP_LR, momentum=CLIP_MOMENTUM,
                global_clip=clip.GradientClipByGlobalNorm(GLOBAL_CLIP))
        return NormClipped(learning_rate=CLIP_LR, momentum=CLIP_MOMENTUM)

    with mock.patch.object(opt, "Adam", momentum):
        yield


def build_clipped_gpt(pkg, transformer_module, kind, memopt=False):
    with clip_optimizer(transformer_module, kind):
        return W.build_gpt(pkg, transformer_module, memopt=memopt)


RESNET = dict(depth=8, class_dim=10, image_shape=(3, 16, 16),
              dtype="float32", learning_rate=1e-3)


def build_resnet(pkg, model):
    pkg.core.unique_name.reset()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        out = model.build(**RESNET)
    return main, startup, out


def repair_configs(rank, world, configs, states, gpt_feeds, resnet_feeds):
    """Each config ``(name, kw)`` on its mesh from its state: the losses,
    the whole persistables after the steps (rank 0), each rank's
    contract violations, the last step's overlapped reductions and the
    boundary's comm rows, and the digests of every parameter block."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import resnet, transformer
    from paddle_tpu_torch.parallel.contracts import training_step_contract

    out = {}
    for name, kw in configs:
        t0 = time.perf_counter()
        env = kw.get("env", {})
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            axes, model = kw["axes"], kw["model"]
            if model == "resnet":
                main, startup, outs = build_resnet(pt, resnet)
                parallel.data_parallel(main, "dp", programs=(startup,))
                feeds = resnet_feeds
            else:
                main, startup, outs = build_clipped_gpt(
                    pt, transformer, model, kw.get("fsdp", False))
                W.annotate(main, startup, axes, kw.get("fsdp", False))
                feeds = gpt_feeds
            mesh = parallel.make_mesh(axes)
            scope = pt.Scope()
            pt.load_numpy_state(scope, states[model], device="cpu")
            exe = pt.Executor(pt.CPUPlace(), mesh=mesh)
            losses = []
            for f in feeds:
                r = exe.run(main, feed=f, fetch_list=[outs["avg_cost"]],
                            scope=scope)
                losses.append(float(np.asarray(r[0]).reshape(-1)[0]))
            names = [v.name for v in main.persistable_vars()
                     if v.name in states[model]]
            whole = exe.gather_state(main, scope, names)
            viol = []
            if model != "resnet":
                cs = training_step_contract(
                    mesh, fsdp=kw.get("fsdp", False), grad_rs=True)
                viol = [v["message"] for c in cs
                        for v in c.check(exe.last_comm_plan)]
            cost = exe.last_step_cost
            out[name] = {
                "losses": losses, "viol": viol,
                "overlapped": cost["overlapped_reductions"],
                "plan": cost["comm_plan"],
                "blocks": W.block_digests(exe, main, scope, mesh),
                "seconds": time.perf_counter() - t0,
                "state": ({k: v.numpy().copy() for k, v in whole.items()}
                          if rank == 0 else None)}
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


# -- sequence, pipeline and expert parallelism ---------------------------------

def _module(name):
    # the package re-exports functions under the modules' names
    return importlib.import_module(f"paddle_tpu_torch.parallel.{name}")


def ring_cases(rank, world, cases):
    """``ring_attention`` on an sp=world mesh for each case ``(key, q, k,
    v, g, causal, impl)`` (whole numpy inputs, each rank taking its
    block): the rank's output block, its dq/dk/dv blocks, its log's
    kinds, and its forward-kernel launches by the flash wrapper (the CPU
    path counts no launch, so the plain version's calls are counted)."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel.collectives import mesh_comm

    ra = _module("ring_attention")
    mesh = parallel.make_mesh({"sp": world})
    comm = mesh_comm(mesh)
    calls = []
    real = fa.flash_attention_with_lse

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    out = {}
    with mock.patch.object(fa, "flash_attention_with_lse", counted):
        for key, q, k, v, g, causal, impl in cases:
            calls.clear()
            loc = [comm.block(torch.from_numpy(a), "sp", 1).contiguous()
                   .requires_grad_(True) for a in (q, k, v)]
            o = ra.ring_attention(*loc, mesh, causal=causal, impl=impl,
                                  block_q=16, block_k=16)
            (o * comm.block(torch.from_numpy(g), "sp", 1)).sum().backward()
            log = comm.take_log()
            out[key] = {"o": o.detach().numpy(),
                        "grads": [t.grad.numpy() for t in loc],
                        "calls": list(calls),
                        "log": sorted({(e["kind"], e["phase"])
                                       for e in log}),
                        "shifts": sum(e["kind"] == "collective-permute"
                                      for e in log)}
    errors = {}
    try:
        ra.ring_attention(*loc, mesh, impl="falsh")
    except ValueError as e:
        errors["impl"] = str(e)
    out["errors"] = errors
    return out


def _mlp_stage(params, h):
    return h + torch.tanh(h @ params["w"] + params["b"])


def _embed(p, tok):
    return p["table"][tok]


def _head_loss(p, h, tgt):
    logp = torch.log_softmax(h @ p["w"], dim=-1)
    return -torch.mean(torch.gather(logp, -1, tgt[..., None]))


def _tree(d, requires_grad=True):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).clone()
            .requires_grad_(requires_grad) for k, v in d.items()}


def _attn_stage(heads, sp):
    ra = _module("ring_attention")

    def stage_fn(params, h):
        mb, tl, d = h.shape
        qkv = h @ params["w_qkv"]
        q, k, v = torch.split(qkv, d, dim=-1)
        shp = (mb, tl, heads, d // heads)
        o = ra.ring_attention_local(q.reshape(shp), k.reshape(shp),
                                    v.reshape(shp), sp, axis_name="sp",
                                    causal=True)
        return h + o.reshape(mb, tl, d) @ params["w_o"]

    return stage_fn


def pp_ep_cases(rank, world, pipe_cases, lm_cases, ppsp, moe_cases):
    """On ``world`` ranks: ``pipeline`` for each case (GPipe and
    interleaved; pp=world), ``pipeline_lm`` for each case, the pp2 x sp2
    composition, and ``moe_ffn`` on ep=world at each capacity.  Every
    case's outputs, loss and gradients (whole where they are the same on
    every rank; this rank's block where cut)."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel.collectives import mesh_comm

    P = _module("pipeline")
    M = _module("moe")
    out = {"pipe": {}, "lm": {}, "moe": {}, "errors": {}}
    mesh = parallel.make_mesh({"pp": world})
    comm = mesh_comm(mesh)
    for key, stacked, x, m, v in pipe_cases:
        loc = P.stage_params_from_numpy(stacked, mesh, virtual_stages=v,
                                        device="cpu")
        loc = {k: t.requires_grad_(True) for k, t in loc.items()}
        xt = torch.from_numpy(x)
        y = P.pipeline(_mlp_stage, loc, xt, mesh, num_microbatches=m,
                       virtual_stages=v)
        torch.mean(y ** 2).backward()
        out["pipe"][key] = {"y": y.detach().numpy(),
                            "grads": {k: t.grad.numpy()
                                      for k, t in loc.items()}}
    comm.take_log()
    for key, stacked, emb, head, tok, tgt, m, v in lm_cases:
        loc = P.stage_params_from_numpy(stacked, mesh, virtual_stages=v,
                                        device="cpu")
        loc = {k: t.requires_grad_(True) for k, t in loc.items()}
        e, h = _tree(emb), _tree(head)
        loss = P.pipeline_lm(_embed, _mlp_stage, _head_loss, e, loc, h,
                             torch.from_numpy(tok), torch.from_numpy(tgt),
                             mesh, num_microbatches=m, virtual_stages=v)
        loss.backward()
        log = comm.take_log()
        out["lm"][key] = {
            "loss": float(loss.detach()),
            "grads": {k: t.grad.numpy() for k, t in loc.items()},
            "embed": e["table"].grad.numpy(), "head": h["w"].grad.numpy(),
            "shifts": sum(x["kind"] == "collective-permute" for x in log)}
    # pp x sp: pipeline over pp=2, each stage ringing over sp=2
    stacked, x, y_t, heads = ppsp
    mesh2 = parallel.make_mesh({"pp": 2, "sp": world // 2})
    loc = P.stage_params_from_numpy(stacked, mesh2, device="cpu")
    loc = {k: t.requires_grad_(True) for k, t in loc.items()}
    xl = P.local_batch(torch.from_numpy(x), mesh2, 2, wire_spec=("sp", None))
    yl = P.local_batch(torch.from_numpy(y_t), mesh2, 2,
                       wire_spec=("sp", None))
    o = P.pipeline(_attn_stage(heads, world // 2), loc, xl, mesh2,
                   num_microbatches=2, wire_spec=("sp", None))
    # the reference's mean over the whole [b, t, d]: this rank's squared
    # errors over the whole count, summed over sp
    from paddle_tpu_torch.parallel.collectives import reduce_fwd
    c2 = mesh_comm(mesh2)
    part = torch.sum((o - yl) ** 2) / float(np.prod(x.shape))
    loss = reduce_fwd(part, c2, "sp")
    loss.backward()
    out["ppsp"] = {"loss": float(loss.detach()), "out": o.detach().numpy(),
                   "grads": {k: t.grad.numpy() for k, t in loc.items()}}
    # moe on ep=world
    mesh3 = parallel.make_mesh({"ep": world})
    for key, params, x, cf in moe_cases:
        p = M.moe_params_from_numpy(params, mesh3, device="cpu")
        p = {k: t.requires_grad_(True) for k, t in p.items()}
        xl = comm_block(mesh3, torch.from_numpy(x), "ep")
        xl.requires_grad_(True)
        y, aux = M.moe_ffn(p, xl, mesh3, capacity_factor=cf)
        (torch.sum(y ** 2) + 0.01 * aux).backward()
        out["moe"][key] = {"y": y.detach().numpy(),
                           "aux": float(aux.detach()),
                           "grads": {k: t.grad.numpy() for k, t in p.items()},
                           "dx": xl.grad.numpy()}
    # the reference's messages
    e = out["errors"]
    stk = {k: torch.zeros(2, 4, 4) for k in ("w",)}
    for what, fn in (
            ("microbatches", lambda: P.pipeline(
                _mlp_stage, stk, torch.zeros(4, 4), mesh, num_microbatches=2,
                virtual_stages=2)),
            ("divisible", lambda: P.pipeline(
                _mlp_stage, {"w": torch.zeros(1, 4, 4)}, torch.zeros(6, 4),
                mesh, num_microbatches=4)),
            ("stages", lambda: P.pipeline(
                _mlp_stage, {"w": torch.zeros(3, 4, 4)}, torch.zeros(8, 4),
                mesh, num_microbatches=4)),
            ("experts", lambda: M.moe_ffn(
                M.init_moe_params(0, 6, 4, 8, device="cpu"),
                torch.zeros(8, 4), mesh3))):
        try:
            fn()
        except ValueError as err:
            e[what] = str(err)
    return out


def comm_block(mesh, t, axis):
    from paddle_tpu_torch.parallel.collectives import mesh_comm

    return mesh_comm(mesh).block(t, axis, 0).contiguous().clone()
