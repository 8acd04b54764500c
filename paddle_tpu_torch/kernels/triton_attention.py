"""Flash attention as Triton kernels — the ``triton`` registry backend of
the ``flash_attention`` op class; the port's counterpart of
``paddle_tpu/kernels/triton_attention.py`` (``_fwd_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``).

The reference writes the standard Triton flash decomposition in Pallas so
that jax's Triton backend lowers it; here it is written in Triton itself,
three ``@triton.jit`` kernels with the reference's structure:

* the grid covers independent cells only — one (batch*head, q-block) for
  the forward and dq, one (batch*head, k-block) for dk/dv — and the
  reduction runs as a loop inside the body, the online-softmax state (or
  the gradient accumulators) in registers;
* a causal cell stops its loop at the diagonal (``_causal_hi`` in the
  reference) and the dk/dv loop starts there; the position mask (``q_pos
  >= k_pos``, positions from 0) runs on every visited tile, masked scores
  the finite ``NEG_INF = -1e30``;
* the backward recomputes from ``(q, k, v, o, lse)`` alone: ``delta =
  rowsum(do * o)`` (minus the ``lse`` cotangent) is computed inside both
  backward kernels, ``p = exp(s - lse)``, ``ds = p (dp - delta) scale``
  cast to the input dtype before its products, as the plain versions do.

Layout: the reference packs ``[b, t, h, d]`` by transpose into ``[b*h, t,
d]``; here the kernels index that same cell grid through the strides of
``[b, t, h, d]`` (the pack is a view, not a copy), and ``lse`` is the
``[b*h, t_q]`` f32 residual the ``cuda`` backend saves, so both backends
keep ``FLASH_BWD_RESIDUALS`` and ``memory_optimize`` treats them alike.
Products take bf16 or f32 operands with f32 accumulation (``ieee`` for
f32 operands, never TF32); ``o``, ``dq``, ``dk``, ``dv`` are stored in
the input dtype and ``lse`` in f32.

Tiles are ``tl.constexpr`` powers of two, at most ``MAX_BLOCK = 128``:
each kernel's own pair (:func:`tiles`), capped by the caller's
``block_q`` / ``block_k`` hints (rounded down to a power of two) and
masked at the ragged edge — the reference instead picks the largest
divisor of ``t``, which Triton's power-of-two ranges cannot take.

What bounds these kernels on an H100: the causal products (4 d flops a
score entry forward, 10 d backward) at the tensor cores' 989 TFLOP/s in
bf16.  This is the first, plain version: no warp specialisation, no TMA,
the backward's ``delta`` recomputed per tile as the reference does.
``chip_smoke.py`` phase 21 times it beside the ``cuda`` backend and SDPA.

The wrappers (:func:`flash_fwd_triton`, :func:`flash_bwd_dq_triton`,
:func:`flash_bwd_dkv_triton`) take the plain versions for CPU tensors
and launch the kernels for CUDA tensors, or raise; each launch adds one
to its ``.launches``.  ``triton`` is imported when the first kernel is
launched, never when this module is imported.
"""

import torch

from . import flash_attention as _fa
from .registry import register_kernel, triton_availability

__all__ = ["MAX_BLOCK", "KERNEL_NAMES", "tiles", "flash_fwd_triton",
           "flash_bwd_dq_triton", "flash_bwd_dkv_triton", "TritonKernels",
           "flash_attention", "flash_attention_with_lse",
           "flash_attention_packed"]

MAX_BLOCK = 128

# the @triton.jit functions, as a profiler names them
KERNEL_NAMES = ("triton_flash_fwd_kernel", "triton_flash_bwd_dq_kernel",
                "triton_flash_bwd_dkv_kernel",
                "triton_paged_attention_kernel")

# each kernel's (query rows, keys) tile at d <= 128 in bf16; halved for
# f32 operands and for d > 128 (registers and shared memory)
_BASE_TILES = {"fwd": (128, 64), "dq": (64, 64), "dkv": (64, 64)}


def _pow2_floor(n):
    return 1 << (max(1, int(n)).bit_length() - 1)


def _pow2_ceil(n):
    return 1 << (max(1, int(n)) - 1).bit_length()


def tiles(kind, t_q, t_k, d, dtype, block_q=None, block_k=None):
    """``(BLOCK_Q, BLOCK_K, BLOCK_D, num_warps)`` of kernel ``kind``
    (``"fwd"``, ``"dq"`` or ``"dkv"``): the kernel's base tile, halved for
    f32 and for ``d > 128``, capped by the caller's hints (at most
    ``MAX_BLOCK``) and by the sequence lengths, never below 16 (the
    smallest ``tl.dot`` side)."""
    bq, bk = _BASE_TILES[kind]
    block_d = max(16, _pow2_ceil(d))
    shrink = (2 if dtype == torch.float32 else 1) * (2 if block_d > 128
                                                     else 1)
    cap_q = _pow2_floor(min(int(block_q or MAX_BLOCK), MAX_BLOCK))
    cap_k = _pow2_floor(min(int(block_k or MAX_BLOCK), MAX_BLOCK))
    bq = max(16, min(bq // shrink, cap_q, _pow2_ceil(t_q)))
    bk = max(16, min(bk // shrink, cap_k, _pow2_ceil(t_k)))
    warps = 8 if block_d >= 128 and max(bq, bk) >= 64 else 4
    return bq, bk, block_d, warps


_JIT = None


def _jit():
    """Import ``triton`` and define the kernels (once, at the first
    launch).  ``tl`` is bound as a module global so that the kernels,
    defined here, resolve it as Triton expects."""
    global _JIT, tl
    if _JIT is not None:
        return _JIT
    import triton
    import triton.language as tl

    @triton.jit
    def triton_flash_fwd_kernel(
            Q, K, V, O, LSE, sm_scale, H, T_Q, T_K, D,
            sqb, sqt, sqh, skb, skt, skh,
            CAUSAL: tl.constexpr, BLOCK_Q: tl.constexpr,
            BLOCK_K: tl.constexpr, BLOCK_D: tl.constexpr,
            PREC: tl.constexpr):
        j = tl.program_id(0)
        bh = tl.program_id(1)
        q_off = (bh // H).to(tl.int64) * sqb + (bh % H) * sqh
        k_off = (bh // H).to(tl.int64) * skb + (bh % H) * skh
        rows = j * BLOCK_Q + tl.arange(0, BLOCK_Q)
        dcol = tl.arange(0, BLOCK_D)
        rmask = rows < T_Q
        dmask = dcol < D
        qmask = rmask[:, None] & dmask[None, :]
        q = tl.load(Q + q_off + rows[:, None] * sqt + dcol[None, :],
                    mask=qmask, other=0.0)
        m = tl.full([BLOCK_Q], -1e30, tl.float32)
        l = tl.zeros([BLOCK_Q], tl.float32)
        acc = tl.zeros([BLOCK_Q, BLOCK_D], tl.float32)
        hi = T_K
        if CAUSAL:
            hi = tl.minimum((j + 1) * BLOCK_Q, T_K)
        for k0 in range(0, hi, BLOCK_K):
            cols = k0 + tl.arange(0, BLOCK_K)
            cmask = cols < T_K
            kvp = k_off + cols[:, None] * skt + dcol[None, :]
            kvm = cmask[:, None] & dmask[None, :]
            kt = tl.load(K + kvp, mask=kvm, other=0.0)
            s = tl.dot(q, tl.trans(kt), input_precision=PREC) * sm_scale
            keep = cmask[None, :]
            if CAUSAL:
                keep = keep & (rows[:, None] >= cols[None, :])
            s = tl.where(keep, s, -1e30)
            m2 = tl.maximum(m, tl.max(s, 1))
            alpha = tl.exp(m - m2)
            p = tl.exp(s - m2[:, None])
            l = l * alpha + tl.sum(p, 1)
            vt = tl.load(V + kvp, mask=kvm, other=0.0)
            acc = acc * alpha[:, None] + tl.dot(
                p.to(vt.dtype), vt, input_precision=PREC)
            m = m2
        l_safe = tl.where(l == 0.0, 1.0, l)
        o = acc / l_safe[:, None]
        tl.store(O + q_off + rows[:, None] * sqt + dcol[None, :],
                 o.to(O.dtype.element_ty), mask=qmask)
        tl.store(LSE + bh.to(tl.int64) * T_Q + rows, m + tl.log(l_safe),
                 mask=rmask)

    @triton.jit
    def triton_flash_bwd_dq_kernel(
            Q, K, V, O, DO, LSE, DLSE, DQ, sm_scale, H, T_Q, T_K, D,
            sqb, sqt, sqh, skb, skt, skh,
            CAUSAL: tl.constexpr, HAS_DLSE: tl.constexpr,
            BLOCK_Q: tl.constexpr, BLOCK_K: tl.constexpr,
            BLOCK_D: tl.constexpr, PREC: tl.constexpr):
        j = tl.program_id(0)
        bh = tl.program_id(1)
        q_off = (bh // H).to(tl.int64) * sqb + (bh % H) * sqh
        k_off = (bh // H).to(tl.int64) * skb + (bh % H) * skh
        rows = j * BLOCK_Q + tl.arange(0, BLOCK_Q)
        dcol = tl.arange(0, BLOCK_D)
        rmask = rows < T_Q
        dmask = dcol < D
        qmask = rmask[:, None] & dmask[None, :]
        qp = q_off + rows[:, None] * sqt + dcol[None, :]
        q = tl.load(Q + qp, mask=qmask, other=0.0)
        do = tl.load(DO + qp, mask=qmask, other=0.0)
        o = tl.load(O + qp, mask=qmask, other=0.0)
        delta = tl.sum(do.to(tl.float32) * o.to(tl.float32), 1)
        lp = bh.to(tl.int64) * T_Q + rows
        if HAS_DLSE:
            delta = delta - tl.load(DLSE + lp, mask=rmask, other=0.0)
        lse = tl.load(LSE + lp, mask=rmask, other=0.0)
        dq = tl.zeros([BLOCK_Q, BLOCK_D], tl.float32)
        hi = T_K
        if CAUSAL:
            hi = tl.minimum((j + 1) * BLOCK_Q, T_K)
        for k0 in range(0, hi, BLOCK_K):
            cols = k0 + tl.arange(0, BLOCK_K)
            cmask = cols < T_K
            kvp = k_off + cols[:, None] * skt + dcol[None, :]
            kvm = cmask[:, None] & dmask[None, :]
            kt = tl.load(K + kvp, mask=kvm, other=0.0)
            vt = tl.load(V + kvp, mask=kvm, other=0.0)
            s = tl.dot(q, tl.trans(kt), input_precision=PREC) * sm_scale
            keep = cmask[None, :]
            if CAUSAL:
                keep = keep & (rows[:, None] >= cols[None, :])
            s = tl.where(keep, s, -1e30)
            p = tl.exp(s - lse[:, None])
            dp = tl.dot(do, tl.trans(vt), input_precision=PREC)
            ds = (p * (dp - delta[:, None]) * sm_scale).to(kt.dtype)
            dq += tl.dot(ds, kt, input_precision=PREC)
        tl.store(DQ + qp, dq.to(DQ.dtype.element_ty), mask=qmask)

    @triton.jit
    def triton_flash_bwd_dkv_kernel(
            Q, K, V, O, DO, LSE, DLSE, DK, DV, sm_scale, H, T_Q, T_K, D,
            sqb, sqt, sqh, skb, skt, skh,
            CAUSAL: tl.constexpr, HAS_DLSE: tl.constexpr,
            BLOCK_Q: tl.constexpr, BLOCK_K: tl.constexpr,
            BLOCK_D: tl.constexpr, PREC: tl.constexpr):
        i = tl.program_id(0)
        bh = tl.program_id(1)
        q_off = (bh // H).to(tl.int64) * sqb + (bh % H) * sqh
        k_off = (bh // H).to(tl.int64) * skb + (bh % H) * skh
        cols = i * BLOCK_K + tl.arange(0, BLOCK_K)
        dcol = tl.arange(0, BLOCK_D)
        cmask = cols < T_K
        dmask = dcol < D
        kvm = cmask[:, None] & dmask[None, :]
        kvp = k_off + cols[:, None] * skt + dcol[None, :]
        kt = tl.load(K + kvp, mask=kvm, other=0.0)
        vt = tl.load(V + kvp, mask=kvm, other=0.0)
        dk = tl.zeros([BLOCK_K, BLOCK_D], tl.float32)
        dv = tl.zeros([BLOCK_K, BLOCK_D], tl.float32)
        lo = 0
        if CAUSAL:
            # the first q block whose last row reaches this k block
            lo = (i * BLOCK_K) // BLOCK_Q * BLOCK_Q
        for q0 in range(lo, T_Q, BLOCK_Q):
            rows = q0 + tl.arange(0, BLOCK_Q)
            rmask = rows < T_Q
            qmask = rmask[:, None] & dmask[None, :]
            qp = q_off + rows[:, None] * sqt + dcol[None, :]
            q = tl.load(Q + qp, mask=qmask, other=0.0)
            do = tl.load(DO + qp, mask=qmask, other=0.0)
            o = tl.load(O + qp, mask=qmask, other=0.0)
            delta = tl.sum(do.to(tl.float32) * o.to(tl.float32), 1)
            lp = bh.to(tl.int64) * T_Q + rows
            if HAS_DLSE:
                delta = delta - tl.load(DLSE + lp, mask=rmask, other=0.0)
            lse = tl.load(LSE + lp, mask=rmask, other=0.0)
            s = tl.dot(q, tl.trans(kt), input_precision=PREC) * sm_scale
            keep = rmask[:, None] & cmask[None, :]
            if CAUSAL:
                keep = keep & (rows[:, None] >= cols[None, :])
            s = tl.where(keep, s, -1e30)
            p = tl.exp(s - lse[:, None])
            dv += tl.dot(tl.trans(p.to(do.dtype)), do, input_precision=PREC)
            dp = tl.dot(do, tl.trans(vt), input_precision=PREC)
            ds = (p * (dp - delta[:, None]) * sm_scale).to(q.dtype)
            dk += tl.dot(tl.trans(ds), q, input_precision=PREC)
        tl.store(DK + kvp, dk.to(DK.dtype.element_ty), mask=kvm)
        tl.store(DV + kvp, dv.to(DV.dtype.element_ty), mask=kvm)

    @triton.jit
    def triton_paged_attention_kernel(
            Q, PK, PV, TBL, POS, O, scale, W, H, DH, B, NB,
            sqs, sqw, sqh, spb, spt, sph, stbl, spos,
            WP: tl.constexpr, BP: tl.constexpr, DP: tl.constexpr):
        s = tl.program_id(0)
        w = tl.arange(0, WP)
        bb = tl.arange(0, BP)
        dcol = tl.arange(0, DP)
        wmask = w < W
        bmask = bb < B
        dmask = dcol < DH
        pos = tl.load(POS + s * spos + w, mask=wmask, other=-1)
        pmax = tl.max(pos, 0)
        # the chain entries holding a token <= the window's last position:
        # the rest are never read, so garbage there cannot reach a row
        hi = tl.where(pmax < 0, 0, tl.minimum(pmax // B + 1, NB))
        qm = wmask[:, None] & dmask[None, :]
        for hh in range(H):
            qp = s.to(tl.int64) * sqs + w[:, None] * sqw + hh * sqh \
                + dcol[None, :]
            qh = tl.load(Q + qp, mask=qm, other=0.0).to(tl.float32)
            m = tl.full([WP], -1e30, tl.float32)
            l = tl.zeros([WP], tl.float32)
            acc = tl.zeros([WP, DP], tl.float32)
            for nb in range(0, hi):
                blk = tl.load(TBL + s * stbl + nb)
                tok = nb * B + bb
                read = bmask & (tok <= pmax)
                kvp = blk.to(tl.int64) * spb + bb[:, None] * spt \
                    + hh * sph + dcol[None, :]
                kvm = read[:, None] & dmask[None, :]
                kb = tl.load(PK + kvp, mask=kvm, other=0.0).to(tl.float32)
                vb = tl.load(PV + kvp, mask=kvm, other=0.0).to(tl.float32)
                sc = tl.sum(qh[:, None, :] * kb[None, :, :], 2) * scale
                keep = (tok[None, :] <= pos[:, None]) & read[None, :]
                sc = tl.where(keep, sc, -1e30)
                m2 = tl.maximum(m, tl.max(sc, 1))
                alpha = tl.exp(m - m2)
                p = tl.where(keep, tl.exp(sc - m2[:, None]), 0.0)
                l = l * alpha + tl.sum(p, 1)
                acc = acc * alpha[:, None] + tl.sum(
                    p[:, :, None] * vb[None, :, :], 1)
                m = m2
            l_safe = tl.where(l == 0.0, 1.0, l)
            tl.store(O + qp, (acc / l_safe[:, None]).to(
                O.dtype.element_ty), mask=qm)

    from types import SimpleNamespace

    _JIT = SimpleNamespace(fwd=triton_flash_fwd_kernel,
                           dq=triton_flash_bwd_dq_kernel,
                           dkv=triton_flash_bwd_dkv_kernel,
                           paged=triton_paged_attention_kernel)
    return _JIT


def _prec(dtype):
    return "ieee" if dtype == torch.float32 else "tf32"


def _geom(q, k, d):
    b, t_q, h, _ = q.shape
    return (h, t_q, k.shape[1], d, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2))


def flash_fwd_triton(q, k, v, causal=False, sm_scale=None, block_q=None,
                     block_k=None):
    """``(o, lse [b*h, t_q] f32)`` of attention on ``[b, t, h, d]``.  CPU
    tensors take :func:`flash_attention.flash_attention_ref`; CUDA tensors
    launch ``triton_flash_fwd_kernel``, or raise."""
    _fa._check(q, k, v)
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return _fa.flash_attention_ref(q, k, v, causal, sm_scale)
    b, t_q, h, d = q.shape
    bq, bk, bd, warps = tiles("fwd", t_q, k.shape[1], d, q.dtype, block_q,
                              block_k)
    o = torch.empty_like(q)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    jit = _jit()
    with torch.cuda.device(q.device):
        jit.fwd[(-(-t_q // bq), b * h)](
            q, k, v, o, lse, float(sm_scale), *_geom(q, k, d),
            CAUSAL=bool(causal), BLOCK_Q=bq, BLOCK_K=bk, BLOCK_D=bd,
            PREC=_prec(q.dtype), num_warps=warps, num_stages=2)
    flash_fwd_triton.launches += 1
    return o, lse


flash_fwd_triton.launches = 0


def _bwd_args(q, k, v, o, lse, do, dlse, sm_scale):
    _fa._check_bwd(q, k, v, o, lse, do, dlse)
    return q.shape[-1] ** -0.5 if sm_scale is None else sm_scale


def flash_bwd_dq_triton(q, k, v, o, lse, do, dlse=None, causal=False,
                        sm_scale=None, block_q=None, block_k=None):
    """``dq`` (input dtype) from the saved ``(q, k, v, o, lse)`` and the
    cotangents ``do`` (and ``dlse [b*h, t_q]`` or None): a q-block grid,
    a loop over k blocks.  CPU tensors take the plain backward's ``dq``;
    CUDA tensors launch ``triton_flash_bwd_dq_kernel``, or raise."""
    sm_scale = _bwd_args(q, k, v, o, lse, do, dlse, sm_scale)
    if q.device.type == "cpu":
        return _fa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal,
                                           sm_scale)[0]
    b, t_q, h, d = q.shape
    bq, bk, bd, warps = tiles("dq", t_q, k.shape[1], d, q.dtype, block_q,
                              block_k)
    dq = torch.empty_like(q)
    jit = _jit()
    with torch.cuda.device(q.device):
        jit.dq[(-(-t_q // bq), b * h)](
            q, k, v, o, do, lse, lse if dlse is None else dlse, dq,
            float(sm_scale), *_geom(q, k, d), CAUSAL=bool(causal),
            HAS_DLSE=dlse is not None, BLOCK_Q=bq, BLOCK_K=bk, BLOCK_D=bd,
            PREC=_prec(q.dtype), num_warps=warps, num_stages=2)
    flash_bwd_dq_triton.launches += 1
    return dq


flash_bwd_dq_triton.launches = 0


def flash_bwd_dkv_triton(q, k, v, o, lse, do, dlse=None, causal=False,
                         sm_scale=None, block_q=None, block_k=None):
    """``(dk, dv)`` (input dtype): a k-block grid, a loop over q blocks
    from the diagonal.  CPU tensors take the plain backward's; CUDA
    tensors launch ``triton_flash_bwd_dkv_kernel``, or raise."""
    sm_scale = _bwd_args(q, k, v, o, lse, do, dlse, sm_scale)
    if q.device.type == "cpu":
        return _fa.flash_attention_bwd_ref(q, k, v, o, lse, do, dlse, causal,
                                           sm_scale)[1:]
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    bq, bk, bd, warps = tiles("dkv", t_q, t_k, d, q.dtype, block_q, block_k)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    jit = _jit()
    with torch.cuda.device(q.device):
        jit.dkv[(-(-t_k // bk), b * h)](
            q, k, v, o, do, lse, lse if dlse is None else dlse, dk, dv,
            float(sm_scale), *_geom(q, k, d), CAUSAL=bool(causal),
            HAS_DLSE=dlse is not None, BLOCK_Q=bq, BLOCK_K=bk, BLOCK_D=bd,
            PREC=_prec(q.dtype), num_warps=warps, num_stages=2)
    flash_bwd_dkv_triton.launches += 1
    return dk, dv


flash_bwd_dkv_triton.launches = 0


class TritonKernels:
    """The ``triton`` backend's pair for
    :class:`flash_attention.FlashAttentionFunction`: the forward kernel,
    and a backward that is always the dq kernel followed by the dk/dv
    kernel (the reference's Triton route; it has no fused backward)."""

    @staticmethod
    def fwd(q, k, v, causal, sm_scale, block_q, block_k):
        return flash_fwd_triton(q, k, v, causal, sm_scale, block_q, block_k)

    @staticmethod
    def bwd(q, k, v, o, lse, do, dlse, causal, sm_scale, block_q, block_k):
        dq = flash_bwd_dq_triton(q, k, v, o, lse, do, dlse, causal, sm_scale,
                                 block_q, block_k)
        dk, dv = flash_bwd_dkv_triton(q, k, v, o, lse, do, dlse, causal,
                                      sm_scale, block_q, block_k)
        return dq, dk, dv


flash_attention_with_lse, flash_attention, flash_attention_packed = (
    _fa.entry_points(TritonKernels))


class _FlashTriton:
    call = staticmethod(flash_attention)
    call_with_lse = staticmethod(flash_attention_with_lse)
    call_packed = staticmethod(flash_attention_packed)


register_kernel("flash_attention", "triton", _FlashTriton,
                available=triton_availability)
