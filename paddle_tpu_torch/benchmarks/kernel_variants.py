"""The design readings behind four Hopper kernels, measured on the card.

    python -m paddle_tpu_torch.benchmarks.kernel_variants [--seed N]

CE dW (``csrc/fused_ce_sm90.cu``) at the training path's shape (N=32768,
d=768, V=32768, bf16): the shipped kernel beside variants built from its
source with one decision changed, each by a text substitution (the
variants give wrong gradients; only their time is read):

* ``no_exchange``: no partial-score exchange (what the exchange costs);
* ``no_exchange_no_cluster``: that, launched without the cluster (what
  the cluster launch costs);
* ``cluster_release``: the remote arrival with a cluster-scope release;
* ``self_exchange``: each block copies its partial into its own receive
  slots and signals itself (what the copies' round trip costs, as
  against waiting for the other blocks);
* ``eighth_payload``: an eighth of the exchanged bytes (what the bytes,
  as against the meeting, cost).

CE forward and dx (``csrc/fused_ce_fwd_dx_sm90.cu``) at the same shape:
the shipped kernels (the forward a GEMM mainloop streaming x and w
chunks through a 6-stage ring, each w chunk multicast by TMA into the
two row blocks of a cluster; dx with d split between the block's two
warpgroups, x resident, 32-column w tiles through a 2-stage ring) beside
variants of the same source, each one decision changed by a text
substitution, every variant held to the shipped kernels' outputs (2e-2
of max |out|; only the tile change reassociates a sum):

* ``fwd_no_multicast``: the forward without clusters, each block loading
  its own w chunks;
* ``fwd_resident_x``: the forward's x resident ([128, 768], 192 KB, w
  alone re-read from L2) with a 2-stage ring of w chunks;
* ``fwd_stream_x4`` / ``fwd_stream_x7``: the forward's ring 4 or 7
  stages deep;
* ``dx_multicast``: dx's w tiles multicast into clusters of two;
* ``dx_bv64``: dx with 64-column w tiles in the 128-byte swizzle, which
  leaves room for one stage and one exchange slot.

* ``dx_cluster_mirror``: dx built as the dW kernel's mirror
  (``benchmarks/ce_dx_cluster.cu``, a source of its own that nothing
  else builds): d over a cluster of 256-wide slices, the partial scores
  exchanged through distributed shared memory.

Paged attention (``csrc/paged_attention.cu``, the split family) at the
serving shapes: the verify window's heads (S=32, h=8, dh=32, f32) at W =
1, 2, 4, 6, and the decode heads (h=6, dh=128, bf16) at W = 1, 4.

Prints the card's ``nvidia-smi`` name and power limit, one line a
reading, and one JSON line of all of them.  Needs a CUDA card; the
variants build with ``nvcc`` into ``paddle_tpu_torch/_build/variants``.
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

from ..kernels import _build
from ..kernels import fused_ce as ce
from ..kernels import paged_attention as pa

_RELEASE = """
__device__ __forceinline__ void arrive_release_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
      : "memory");
}
"""


def _substitute(text, old, new, count=-1):
    if old not in text:
        raise ValueError(f"the source no longer holds {old!r}")
    return text.replace(old, new, count)


def dw_variants():
    """``{name: source}`` of the shipped dW kernel and its variants."""
    with open(os.path.join(_build.SRC_DIR, "fused_ce_sm90.cu")) as f:
        src = f.read()
    no_x = _substitute(src, "if (c > 1) {", "if (false) {")
    return {
        "shipped": src,
        "no_exchange": no_x,
        "no_exchange_no_cluster": _substitute(
            no_x, "attr[0].val.clusterDim.x = c;",
            "attr[0].val.clusterDim.x = 1;"),
        "cluster_release": _substitute(
            _substitute(src, "mbar_arrive_remote(", "arrive_release_cluster("),
            "namespace {\n", "namespace {\n" + _RELEASE, 1),
        "self_exchange": _substitute(_substitute(_substitute(
            src, "mapa(rx_base + (r - (r > q)) * kPartBytes, q)",
            "mapa(rx_base + (q - (q > r)) * kPartBytes, r)"),
            "mapa(smem_u32(&recvd[wg]), q)", "mapa(smem_u32(&recvd[wg]), r)"),
            "mapa(smem_u32(&freed[wg]), q)", "mapa(smem_u32(&freed[wg]), r)"),
        "eighth_payload": _substitute(
            _substitute(src, "smem_u32(tx - t), kPartBytes,",
                        "smem_u32(tx - t), kPartBytes / 8,"),
            "(c - 1) * kPartBytes);", "(c - 1) * kPartBytes / 8);"),
    }


def ce_variants():
    """``{name: source}`` of the shipped forward and dx kernels and their
    variants."""
    with open(os.path.join(_build.SRC_DIR, "fused_ce_fwd_dx_sm90.cu")) as f:
        src = f.read()
    return {
        "shipped": src,
        "fwd_no_multicast": _substitute(src, "constexpr int kFwdMc = 2;",
                                        "constexpr int kFwdMc = 1;"),
        "fwd_resident_x": _substitute(
            src, "constexpr bool kStreamX = true;",
            "constexpr bool kStreamX = false;"),
        "fwd_stream_x4": _substitute(src, "kStreamX ? 6 : 2",
                                     "kStreamX ? 4 : 2"),
        "fwd_stream_x7": _substitute(src, "kStreamX ? 6 : 2",
                                     "kStreamX ? 7 : 2"),
        "dx_multicast": _substitute(src, "constexpr int kDxMc = 1;",
                                    "constexpr int kDxMc = 2;"),
        "dx_bv64": _substitute(_substitute(_substitute(
            src, "constexpr int kDxBV = 32;", "constexpr int kDxBV = 64;"),
            "constexpr int kDxStages = 2;", "constexpr int kDxStages = 1;"),
            "constexpr int kXchSlots = 2;", "constexpr int kXchSlots = 1;"),
    }


def build_variants(sources, tag, entries):
    """Compile every source in parallel into ``_build/variants/<tag>_*``;
    ``{name: {entry: ctypes function}}`` for the C ``entries``
    (``{entry: number of pointer arguments}``), each taking its pointers,
    then N, D, V, the dtype code and the stream."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{tag}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = ([_build.nvcc_path()] + _build.NVCC_FLAGS
               + ["-I", _build.SRC_DIR, cu, "-o", cu[:-3] + ".so"])
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        for line in log.splitlines():
            if "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"  ptxas {tag} {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"{tag}_{name}.so"))
        fns[name] = {}
        for entry, n_ptrs in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name][entry] = fn
    return fns


def device_ms(fn, n, reps=3):
    """Median device ms of ``n`` queued calls of ``fn(i)``, per call; a
    sleep kernel holds the stream while the host enqueues."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000_000)
        e0.record()
        for i in range(n):
            fn(i)
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) / n)
    return sorted(out)[len(out) // 2]


def paged_inputs(gen, S, W, h, dh, dtype, B=32, nb=16):
    """Decode-geometry inputs: distinct blocks per chain, ``pos`` random in
    [0, 511], entries past it naming the trash block 0."""
    num_blocks = S * nb + 1
    shape = (num_blocks, B, h, dh)
    pk = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    pv = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((S, W, h, dh), generator=gen, device="cuda").to(dtype)
    base = torch.randint(0, nb * B - W + 1, (S, 1), generator=gen,
                         device="cuda")
    pos = (base + torch.arange(W, device="cuda")).to(torch.int32)
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    table = perm[: S * nb].reshape(S, nb).to(torch.int32)
    live = pos.max(dim=1).values // B
    table[torch.arange(nb, device="cuda")[None, :] > live[:, None]] = 0
    return q, pk, pv, table.contiguous(), pos.contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants measures the card: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    readings = {}

    n, d, v = 32768, 768, 32768
    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((d, v), generator=gen, device="cuda")
         * d ** -0.5).to(torch.bfloat16)
    y = torch.randint(0, v, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    g = torch.randn((n,), generator=gen, device="cuda")
    _, lse = ce.ce_fwd(x, w, y)
    dw = torch.empty_like(w)
    stream = torch.cuda.current_stream().cuda_stream
    ce_libs = build_variants(ce_variants(), "ce",
                             {"fused_ce_fwd_sm90": 5, "fused_ce_dx_sm90": 6})
    with open(os.path.join(os.path.dirname(__file__),
                           "ce_dx_cluster.cu")) as f:
        mirror = build_variants({"dx_cluster_mirror": f.read()}, "ce",
                                {"fused_ce_dx_cluster": 6})
    ce_libs["dx_cluster_mirror"] = {
        "fused_ce_fwd_sm90": ce_libs["shipped"]["fused_ce_fwd_sm90"],
        "fused_ce_dx_sm90": mirror["dx_cluster_mirror"]["fused_ce_dx_cluster"]}
    for name, fns in build_variants(dw_variants(), "dw",
                                    {"fused_ce_dw_sm90": 6}).items():
        fn = fns["fused_ce_dw_sm90"]

        def call(i, fn=fn):
            err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), lse.data_ptr(),
                     g.data_ptr(), dw.data_ptr(), n, d, v, 1, stream)
            if err:
                raise RuntimeError(f"dW variant {name}: cudaError {err}")
        readings[f"dw_{name}_ms"] = device_ms(call, 3)
        print(f"CE dW {name} (N={n} d={d} V={v} bf16): "
              f"{readings[f'dw_{name}_ms']:.4f} ms", flush=True)
    loss, lse2 = torch.empty_like(lse), torch.empty_like(lse)
    dx = torch.empty_like(x)
    outs = {}
    for name, fns in ce_libs.items():
        fwd, dxk = fns["fused_ce_fwd_sm90"], fns["fused_ce_dx_sm90"]

        def call_fwd(i, fwd=fwd):
            err = fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                      loss.data_ptr(), lse2.data_ptr(), n, d, v, 1, stream)
            if err:
                raise RuntimeError(f"forward variant {name}: cudaError {err}")

        def call_dx(i, dxk=dxk):
            err = dxk(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                      lse.data_ptr(), g.data_ptr(), dx.data_ptr(), n, d, v,
                      1, stream)
            if err:
                raise RuntimeError(f"dx variant {name}: cudaError {err}")

        call_fwd(0)
        call_dx(0)
        torch.cuda.synchronize()
        got = (lse2.clone(), loss.clone(), dx.clone())
        outs.setdefault("shipped", got)
        for a, b, what in zip(got, outs["shipped"], ("lse", "loss", "dx")):
            rel = ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            if not rel <= 2e-2:
                raise RuntimeError(f"CE variant {name}: {what} rel {rel:.3e} "
                                   f"from the shipped kernel's")
        for kind, fn_ in (("fwd", call_fwd), ("dx", call_dx)):
            readings[f"ce_{kind}_{name}_ms"] = device_ms(fn_, 3)
        print(f"CE forward / dx {name} (N={n} d={d} V={v} bf16): "
              f"{readings[f'ce_fwd_{name}_ms']:.4f} / "
              f"{readings[f'ce_dx_{name}_ms']:.4f} ms", flush=True)
    del loss, lse2, dx, outs
    del x, w, y, g, lse, dw
    torch.cuda.empty_cache()

    for label, h, dh, dtype, windows in (
            ("verify", 8, 32, torch.float32, (1, 2, 4, 6)),
            ("decode", 6, 128, torch.bfloat16, (1, 4))):
        for W in windows:
            cases = [paged_inputs(gen, 32, W, h, dh, dtype) for _ in range(8)]
            ms = device_ms(lambda i: pa.paged_attention(*cases[i % 8]), 64)
            readings[f"paged_{label}_W{W}_ms"] = ms
            print(f"paged attention, {label} heads (S=32 h={h} dh={dh} "
                  f"{str(dtype)[6:]}) W={W}: {ms:.4f} ms "
                  f"({pa.paged_family(dtype, 32, W, h, dh, 32, (0,))})",
                  flush=True)
    print(json.dumps({"card": card, "readings": readings}), flush=True)


if __name__ == "__main__":
    main()
