"""Expert parallelism (mesh axis ``ep``) — the mixture-of-experts FFN
(the port's ``paddle_tpu/parallel/moe.py``).

Experts are cut over the ``ep`` mesh axis and tokens over the same axis
(data-parallel shards); two all-to-alls (:func:`~.collectives.all_to_all`)
move each token to the rank owning its routed expert and back.  Routing
is top-2 gating with a fixed per-expert capacity; overflow tokens fall
through (a zero output row, the residual path's to add).  A
load-balancing auxiliary loss (GShard's) is returned for the trainer to
add to the objective.

The reference runs ``moe_ffn`` inside ``shard_map`` on global arrays; the
port runs one process a rank, so ``moe_ffn`` takes this rank's tokens and
its experts' block of the parameters (:func:`moe_params_from_numpy` cuts
the reference's whole dict to it) and returns this rank's output rows.
The replicated ``gate``'s gradient is summed over ``ep`` in the backward
(:func:`~.collectives.reduce_grad`), as ``shard_map``'s transpose sums
it.  The products are plain ``torch.einsum``: the reference computes
them as XLA ops, outside any Pallas kernel.
"""

import torch
import torch.nn.functional as F

from .collectives import all_to_all, mesh_comm, reduce_fwd, reduce_grad

__all__ = ["init_moe_params", "moe_ffn", "moe_params_from_numpy"]

_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def init_moe_params(key, num_experts, d_model, d_hidden,
                    dtype=torch.float32, device=None):
    """Returns a dict of MoE FFN params, drawn from the ``torch.Generator``
    ``key`` (an int seeds a new one); cut the ``w1``/``b1``/``w2``/``b2``
    leading (expert) axis over ``ep`` (:func:`moe_params_from_numpy`, or
    ``spmd.local_block``); ``gate`` stays replicated.  ``device``: the
    card unless ``"cpu"`` is asked for."""
    from ..core.place import resolve_device

    dev = resolve_device(device)
    if not isinstance(key, torch.Generator):
        key = torch.Generator().manual_seed(int(key))
    s1 = (2.0 / d_model) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=key, dtype=torch.float32)

    gate = normal(d_model, num_experts) * s1
    w1 = normal(num_experts, d_model, d_hidden) * s1
    w2 = normal(num_experts, d_hidden, d_model) * (2.0 / d_hidden) ** 0.5
    params = {"gate": gate, "w1": w1,
              "b1": torch.zeros(num_experts, d_hidden),
              "w2": w2, "b2": torch.zeros(num_experts, d_model)}
    return {k: v.to(dtype=dtype, device=dev) for k, v in params.items()}


def moe_params_from_numpy(params, mesh=None, axis_name="ep", device=None):
    """The reference's MoE dict (``{name: array}``, whole) as this rank's
    tensors: the expert leaves cut to the rank's block of experts along
    ``axis_name`` of ``mesh`` (a bound Mesh or a MeshComm; None keeps
    them whole), ``gate`` whole.  ``device``: the card unless ``"cpu"``
    is asked for."""
    from ..core.scope import tensor_from_numpy
    from ..core.place import resolve_device

    dev = resolve_device(device)
    comm = mesh_comm(mesh) if mesh is not None else None
    out = {}
    for name, a in params.items():
        t = tensor_from_numpy(a)
        if comm is not None and name in _EXPERT_LEAVES:
            t = comm.block(t, axis_name, 0).contiguous().clone()
        out[name] = t.to(dev)
    return out


def _top2_dispatch(logits, capacity):
    """Build dispatch/combine tensors from gating logits.

    logits [n, E] -> dispatch [n, E, C] 0/1, combine [n, E, C] weights,
    aux load-balance loss.  Positions within each expert's buffer are
    cumulative counts (first come, first placed), tokens past capacity
    dropped; ties in the top-2 go to the first index.
    """
    n, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)

    g1_idx = torch.argmax(probs, dim=-1)                      # [n]
    mask1 = F.one_hot(g1_idx, e).to(probs.dtype)              # [n, E]
    probs2 = probs * (1.0 - mask1)
    g2_idx = torch.argmax(probs2, dim=-1)
    mask2 = F.one_hot(g2_idx, e).to(probs.dtype)

    # positions in each expert buffer (first-come order)
    pos1 = torch.cumsum(mask1, dim=0) - mask1                 # [n, E]
    keep1 = mask1 * (pos1 < capacity)
    pos2 = (torch.cumsum(mask2, dim=0) - mask2) + torch.sum(keep1, dim=0)
    keep2 = mask2 * (pos2 < capacity)

    w1 = torch.sum(probs * keep1, dim=-1)                     # [n]
    w2 = torch.sum(probs * keep2, dim=-1)
    denom = torch.clamp(w1 + w2, min=1e-9)
    w1, w2 = w1 / denom, w2 / denom

    def scatter(keep, pos, w):
        # [n, E, C]: token i -> slot pos[i, e] of expert e
        slot = F.one_hot(torch.sum(pos * keep, dim=-1).long(),
                         capacity).to(probs.dtype)            # [n, C]
        return (keep[:, :, None] * slot[:, None, :],
                (w[:, None, None] * keep[:, :, None]) * slot[:, None, :])

    d1, c1 = scatter(keep1, pos1, w1)
    d2, c2 = scatter(keep2, pos2, w2)
    dispatch = d1 + d2                                        # [n, E, C]
    combine = c1 + c2

    # GShard aux loss: E * mean_e(fraction routed) . mean_e(gate prob)
    density = torch.mean(mask1, dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_proxy) * e
    return dispatch, combine, aux


def moe_ffn(params, x, mesh, axis_name="ep", capacity_factor=2.0,
            activation=torch.relu):
    """Top-2 MoE feed-forward over this rank's tokens.

    x ``[n_local, d_model]``: this rank's rows of the token batch cut
    over ``ep``.  params: ``gate [d_model, E]`` whole, the expert leaves
    this rank's block ``[E / ep, ...]``.  ``mesh``: a bound Mesh or a
    MeshComm.  Returns (y ``[n_local, d_model]``, aux_loss scalar, the
    same on every rank).
    """
    comm = mesh_comm(mesh)
    ep = comm.size(axis_name)
    e = params["gate"].shape[-1]
    if e % ep:
        raise ValueError(f"{e} experts not divisible by ep={ep}")
    e_local = e // ep
    if params["w1"].shape[0] != e_local:
        raise ValueError(
            f"expert leaves hold {params['w1'].shape[0]} experts; this "
            f"rank's block of {e} over ep={ep} is {e_local} "
            f"(moe_params_from_numpy cuts it)")

    n_local, d = x.shape
    cap = int(max(1, capacity_factor * n_local / e))
    gate = reduce_grad(params["gate"], comm, axis_name, "gate")
    logits = x @ gate.to(x.dtype)
    dispatch, combine, aux = _top2_dispatch(logits, cap)

    # gather expert inputs: [E, C, d] on each (token-shard) rank
    expert_in = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), x)
    # ship token blocks to expert owners: [E, C, d] -> [ep, e_l, C, d]
    expert_in = expert_in.reshape(ep, e_local, cap, d)
    expert_in = all_to_all(expert_in, comm, axis_name, "expert_in")
    # now [ep(source shard), e_l, C, d]: every rank's tokens for MY
    # experts — the expert axis out front before flattening the buffers
    expert_in = expert_in.transpose(0, 1).reshape(e_local, ep * cap, d)

    w1 = params["w1"].to(x.dtype)
    b1 = params["b1"].to(x.dtype)
    w2 = params["w2"].to(x.dtype)
    b2 = params["b2"].to(x.dtype)
    h = activation(torch.einsum("end,edf->enf", expert_in, w1)
                   + b1[:, None, :])
    y = torch.einsum("enf,efd->end", h, w2) + b2[:, None, :]

    # ship results back and un-scatter
    y = y.reshape(e_local, ep, cap, d).transpose(0, 1)        # [ep, e_l, C, d]
    y = all_to_all(y.contiguous(), comm, axis_name, "expert_out")
    y = y.reshape(e, cap, d)
    out = torch.einsum("nec,ecd->nd", combine.to(y.dtype), y)
    aux = reduce_fwd(aux, comm, axis_name, "aux") / ep
    return out, aux
